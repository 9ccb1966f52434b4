"""Command-line entry points of the port: ``python -m
repro_torch.launch.serve`` (a server behind the length-bucketed scheduler)
and ``python -m repro_torch.launch.train`` (the fault-tolerant trainer)."""
