"""Sharded spill storage: per-destination sorted outputs as atomic disk
shards — the counterpart of ``repro.pipeline.shards``, on the same files.

The mesh tier's shard-combining chunked sort
(``core.distributed.distributed_chunked_sort_lex``) writes each
destination's merged output here the moment its k-way merge completes, so
a job killed during the combine keeps every finished destination.
:class:`ShardStore` is a :class:`~repro_torch.pipeline.manifest.RunStore`
keyed by destination index instead of chunk id:

  * the per-shard manifest is a :class:`~repro_torch.pipeline.manifest.
    RunManifest` — count, shortlex min/max key, per-length histogram, and
    the order-independent additive content digest — exactly the metadata a
    resume needs to decide "this shard is done" without loading it, and the
    global gate (``pipeline.validate.check_sharded``) needs to prove
    boundary ordering + count/digest conservation without rescanning data;
  * :class:`ShardedRun` is the spilled result handle: shard-at-a-time
    access for out-of-core consumers, or :meth:`ShardedRun.to_run` to
    materialise the full sorted run on a device when it does fit.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Tuple

import torch

from ..interop import resolve_device
from .manifest import RunManifest, RunStore
from .validate import check_run

__all__ = ["ShardStore", "ShardedRun"]


class ShardStore(RunStore):
    """Directory of per-destination output shards, keyed by destination
    index. Identical snapshot format and atomicity to :class:`~repro_torch.
    pipeline.manifest.RunStore` (``step_<dest>/manifest.json + *.npy``, one
    ``os.replace`` per shard, ``.tmp_*`` droppings swept on open); the
    separate type keeps ingest-run and output-shard directories from being
    confused for one another in call sites and error messages."""

    def drop(self, shard_id: int) -> None:
        """Remove one landed shard (e.g. after it failed validation and
        must recompute, or after a consumer has drained it)."""
        shutil.rmtree(os.path.join(self.directory, f"step_{shard_id}"),
                      ignore_errors=True)


@dataclass(frozen=True)
class ShardedRun:
    """The spilled result of a shard-combining sort: the destination-ordered
    shard manifests plus the store they landed in. The concatenation of the
    shards in manifest order is the globally sorted output; consumers
    stream it shard at a time (:meth:`load_shard`) or materialise it whole
    (:meth:`to_run`)."""

    store: ShardStore
    manifests: Tuple[RunManifest, ...]

    @property
    def count(self) -> int:
        return sum(m.count for m in self.manifests)

    def load_shard(self, i: int, validate: str = "off", device="cuda"):
        """Load destination ``i``'s :class:`~repro_torch.pipeline.ingest.
        SortedRun` onto ``device`` (``validate``: ``'off'|'cheap'|'full'``
        reconciles it against its manifest via ``check_run`` first)."""
        from .ingest import _run_from_arrays
        man = self.manifests[i]
        run = _run_from_arrays(*self.store.load(man.chunk_id, device),
                               device=device)
        if validate != "off":
            check_run(run, man, mode=validate)
        return run

    def to_run(self, validate: str = "off", device="cuda"):
        """Materialise the full sorted run on ``device``: every shard in
        destination order, concatenated there."""
        from .ingest import SortedRun
        dev = resolve_device(device)
        runs = [self.load_shard(i, validate=validate, device=dev)
                for i in range(len(self.manifests))]
        if not runs:
            return SortedRun(
                lengths=torch.zeros(0, dtype=torch.int32, device=dev),
                keys=torch.zeros((0, 0), dtype=torch.uint32, device=dev))
        return SortedRun(
            lengths=torch.cat([r.lengths for r in runs]),
            keys=torch.cat([r.keys.view(torch.int32) for r in runs])
            .view(torch.uint32))
