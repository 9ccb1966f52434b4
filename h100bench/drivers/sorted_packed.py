"""The paper's sort in one call: ``core.bucketing.sorted_packed(keys,
return_packed=True)`` on host keys (distribute, the bucket tensor,
blocksort's B2 and B4 rounds past 1,024 words a bucket, compaction and the
packed rank keys)."""

from __future__ import annotations

from . import _words


def _call(keys, device):
    from repro_torch.core.bucketing import sorted_packed
    return sorted_packed(keys, return_packed=True, device=device)


def setup(cell, seed, device):
    return _words.setup(cell, seed, device, _call)


window = _words.window
check = _words.check
control = _words.control
