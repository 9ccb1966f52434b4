"""Entry points and launch machinery of the port: ``python -m
repro_torch.launch.serve`` (a server behind the length-bucketed scheduler),
``python -m repro_torch.launch.train`` (the fault-tolerant trainer),
``python -m repro_torch.launch.dryrun`` (every arch x shape x mesh cell's
step traced over a fake 256/512-rank process group: FLOPs, bytes,
collectives and memory a rank), ``python -m repro_torch.launch.enrich``
(the analytic blocks added to its artifacts) and ``python -m
repro_torch.launch.hillclimb`` (the reference's plan variants re-traced);
``mesh`` (the mesh factories), ``specs`` (the abstract inputs and their
placements), ``analytics`` (closed-form roofline terms) and ``hw`` (the
H100's data-sheet constants and the card's own properties)."""
