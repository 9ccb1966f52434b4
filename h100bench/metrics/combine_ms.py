"""Device ms a sort call in the run combine (B5 and its split; B6, its
split's rounds and cursors, and the gather of the runs' lanes), from the
trace."""

from h100bench.metrics._common import RUN_COMBINE, device_ms_per


def read(records):
    return device_ms_per(records, RUN_COMBINE, "calls")
