"""Device ms a sort call in the bucket sort's kernels (B1, B2 and B4: the
in-bucket sorts and blocksort's merge rounds), from the trace."""

from h100bench.metrics._common import BUCKET_SORT, device_ms_per


def read(records):
    return device_ms_per(records, BUCKET_SORT, "calls")
