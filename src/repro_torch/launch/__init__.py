"""Launchers: the train and serve entry points (``python -m
repro_torch.launch.train`` / ``.serve``; the train launcher over a mesh of
``torchrun`` ranks), the meshes (``launch.mesh``: ``make_mesh``,
``make_production_mesh``, the H100's constants), the multi-pod dry run
(``python -m repro_torch.launch.dryrun``: every arch × shape cell run on
one rank of a fake world, counted) and its collective statistics
(``launch.collective_stats``, the counterpart of the reference's
``hlo_stats``)."""
