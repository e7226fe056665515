"""repro_torch.launch — entry points: ``python -m repro_torch.launch.serve``
and ``python -m repro_torch.launch.train``; meshes and sharding rules."""
