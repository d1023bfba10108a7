"""Launchers: the train and serve entry points (``python -m
repro_torch.launch.train`` / ``.serve``).  The reference's multi-pod
dry-run, HLO statistics and production meshes belong to the second half of
the ML stack (ROADMAP A14b)."""
