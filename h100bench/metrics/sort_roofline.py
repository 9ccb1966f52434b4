"""The whole sort's share of its roofline, in %: the least bytes of the
window's calls (each word's key lanes read once; its length, sorted lanes
and packed rank keys written once; counted from the words, not from any
kernel's shapes) over the H100's HBM rate, against the window's length.
Bytes bound the sort: it does no arithmetic worth counting."""

from h100bench.peaks import HBM_BYTES_PER_S


def read(records):
    calls, window = records.get("calls"), records.get("window_s")
    if not calls or not window:
        return None
    least_s = calls * records["least_bytes_per_call"] / HBM_BYTES_PER_S
    return 100.0 * least_s / window
