"""The port's examples — the counterparts of the reference's ``examples/``
scripts, each a module run as

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

  ``quickstart``           the paper's bucketed OETS word sort, the OETS row
                           kernel at (8, 256), the chunked ingest and the
                           Granite-MoE smoke forward;
  ``serve_lm``             MiniCPM3's smoke config (MLA) served through the
                           length-bucketed scheduler;
  ``train_lm``             a smoke config trained with snapshots and a
                           simulated failure and recovery;
  ``distributed_sort``     the mesh engines (odd-even, sample sort) and the
                           word pipeline over 8 gloo ranks;
  ``moe_expert_parallel``  ``ep_moe`` over 8 gloo ranks against ``moe``.

Each runs on the card unless ``--device cpu`` is given; the default raises
where there is no card. Each demo is also a function that returns what it
computed. The two 8-rank examples start their ranks themselves
(``_ranks.run_ranks``), on ``cuda:0`` all of them with ``--device cuda``.
"""
