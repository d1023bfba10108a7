"""Launchers: the train and serve entry points (``python -m
repro_torch.launch.train`` / ``.serve``; the train launcher over a mesh of
``torchrun`` ranks) and the meshes (``launch.mesh``: ``make_mesh``,
``make_production_mesh``, the H100's constants).  The reference's multi-pod
dry-run and HLO statistics are still to come (ROADMAP A14c)."""
