"""The whole serving step's share of the H100's bf16 peak, in %: the
model FLOPs of the window's real tokens (prompt and generated, padding
left out; counted from the configuration, not from any kernel) over the
window's seconds and 989e12 FLOP/s."""

from h100bench.peaks import BF16_FLOPS


def read(records):
    flops, window = records.get("model_flops"), records.get("window_s")
    if not flops or not window:
        return None
    return 100.0 * flops / window / BF16_FLOPS
