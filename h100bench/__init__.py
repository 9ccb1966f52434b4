"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on an NVIDIA
H100.

One command runs one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON line::

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric is a file of its own, found by its name:

* ``configs/<config>.json``: the sizes as they run, the source, what was cut;
* ``traffic/<traffic>.json``: the parameters one generator of ``traffic/``
  reads;
* ``workloads/<cell>.json``: the driver, the sampling of the check, the
  limits of the numbers compared;
* ``drivers/<driver>.py``: set-up, the measured window and the comparison of
  one entry point of the port;
* ``metrics/<metric>.py``: a reader of one per-layer metric.

The yardstick (traffic, the plain references in ``reference/``, the trace
reduction, the peaks) lives here and takes nothing from the port but its
entry points, its kernels' names and its launch counters.
"""
