"""Device ms a prefill in the sort kernels (B1, B2, B4) while serving: the
MoE dispatch's sorts of every layer (``kernels.ops.sort_kv``), with the
admission's and the decode steps' sorts that run in the same traced
window, over the prefills traced."""

from h100bench.metrics._common import BUCKET_SORT, device_ms_per


def read(records):
    return device_ms_per(records, BUCKET_SORT, "prefills")
