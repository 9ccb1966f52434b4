"""Median host-clock ms of a prefill (``Engine._prefill``), each ended by
a ``torch.cuda.synchronize()`` in the benchmark's wrapper."""

from h100bench.metrics._common import span_median_ms


def read(records):
    return span_median_ms(records, "prefill")
