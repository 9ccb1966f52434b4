"""The share of the traced window of serving in which no kernel, copy or
memset ran on the card, in %."""

from h100bench.metrics._common import idle_percent


def read(records):
    return idle_percent(records)
