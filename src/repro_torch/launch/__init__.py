"""Command-line entry points: `train` (python -m repro_torch.launch.train)
and `cross_pod` (python -m repro_torch.launch.cross_pod)."""
