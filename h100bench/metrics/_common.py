"""What several readers share: device time of a set of kernel functions
from the trace, per unit of work traced, and the idle share."""

from __future__ import annotations

# the port's kernels by CUDA function, as the trace names them
BUCKET_SORT = ("oets_warp_kernel", "oets_rows_kernel",          # B1
               "bitonic_window_kernel", "bitonic_regs_kernel",  # B2
               "merge_window_kernel", "merge_regs_kernel")      # B4
RUN_COMBINE = ("runmerge_kernel", "runmerge_starts_kernel",     # B5, split
               "kway_kernel", "kway_split_kernel",              # B6, split
               "kway_round_kernel", "kway_cursor_kernel",
               "kway_gather_kernel")


def device_ms_per(records, functions, unit: str):
    """Device milliseconds of ``functions`` over the traced window, per
    ``unit`` counted there; ``None`` where none of them ran or nothing was
    traced."""
    tr = records.get("trace")
    if not tr:
        return None
    n = tr["counts"].get(unit, 0)
    seen = [s for fn, (s, _) in tr["ops"].items() if fn in functions]
    if not seen or not n:
        return None
    return 1e3 * sum(seen) / n


def idle_percent(records):
    tr = records.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def span_median_ms(records, label: str):
    """Median ms of the benchmark's host spans labelled ``label``."""
    import statistics
    xs = [(b - a) * 1e-6 for lab, a, b in records.get("spans", ())
          if lab == label]
    return statistics.median(xs) if xs else None
