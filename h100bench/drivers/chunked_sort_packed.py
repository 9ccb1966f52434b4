"""The bounded-memory sort: ``pipeline.ingest.chunked_sort_packed(keys,
chunk_size=...)`` with its defaults (``validate='off'``,
``merge_engine='auto'``) on host keys: one sort a chunk at the chunk's
worst-case capacity, staged by the one-worker prefetch, then one k-way
merge of the runs (the gather, the split's rounds and B6). The merged run
carries no packed rank keys (``SortedRun.from_lanes``), so its lengths and
key lanes are what the check compares."""

from __future__ import annotations

from . import _words


def setup(cell, seed, device):
    from repro_torch.pipeline.ingest import chunked_sort_packed
    chunk = cell.traffic["chunk_size"]

    def call(keys, dev):
        run = chunked_sort_packed(keys, chunk_size=chunk, device=dev)
        return run.lengths, run.keys, run.packed

    return _words.setup(cell, seed, device, call)


window = _words.window
check = _words.check
control = _words.control
