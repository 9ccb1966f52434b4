"""Length-bucketed admission scheduler — the paper's technique at the
serving layer; the counterpart of ``repro.serve.scheduler``.

The paper's pre-processing statistic: requests are distributed into
buckets by prompt length, and each bucket forms dense batches that decode
together, padded to the batch's longest prompt, not the global one. Within
a bucket, requests are ordered length-then-alphabetic by the lexicographic
kernel front-end (``kernels.ops.sort_lex``: a length lane and two
prompt-prefix token lanes, the request index as payload), so each batch
groups near-equal lengths, and equal-length prompts admit in token order.

The admission key is the reference's exactly — int32 lanes, ``int32`` max
padding to ``max(128, next power of two)`` — so the port runs the same
kernel tier (B1 up to 128, B2 up to 1024, blocksort's B2 and B4 beyond)
and gives the same permutation. ``admission_mesh`` (a ``DeviceMesh``)
routes the sort through ``core.distributed.distributed_sort_lex``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..data.bucketing import plan_buckets
from ..interop import resolve_device
from ..kernels.ops import sort_lex
from ..pipeline.histogram import assign_buckets
from .engine import Engine, GenerationResult

__all__ = ["Request", "BucketedScheduler"]


@dataclasses.dataclass
class Request:
    request_id: object
    prompt: List[int]
    max_new: int = 16


class BucketedScheduler:
    """Batches requests by prompt-length bucket and runs them through an
    :class:`Engine`. ``bounds=None`` plans quantile buckets from the first
    wave; the admission sort runs on the engine's device."""

    def __init__(self, engine: Engine, batch_size: int = 8,
                 bounds: Optional[Sequence[int]] = None, n_buckets: int = 4,
                 admission_mesh=None, admission_axis: str = "data"):
        self.engine = engine
        self.batch_size = batch_size
        self.bounds = list(bounds) if bounds else None
        self.n_buckets = n_buckets
        self.admission_mesh = admission_mesh
        self.admission_axis = admission_axis

    def run(self, requests: List[Request]) -> List[GenerationResult]:
        if not requests:
            return []
        lengths = [len(r.prompt) for r in requests]
        bounds = self.bounds or plan_buckets(lengths, self.n_buckets)

        # the shared phase-1 statistic (pipeline.histogram): over-long
        # prompts clamp to the last bucket
        buckets: dict[int, list] = {i: [] for i in range(len(bounds))}
        for r, b in zip(requests, assign_buckets(lengths, bounds, clamp=True)):
            buckets[int(b)].append(r)

        results = []
        for rs in buckets.values():
            rs = self._order_by_length(rs, mesh=self.admission_mesh,
                                       axis=self.admission_axis,
                                       device=self.engine.device)
            for start in range(0, len(rs), self.batch_size):
                chunk = rs[start:start + self.batch_size]
                outs = self.engine.generate(
                    [r.prompt for r in chunk],
                    max_new=max(r.max_new for r in chunk))
                for r, toks in zip(chunk, outs):
                    results.append(GenerationResult(r.request_id,
                                                    toks[:r.max_new]))
        return results

    # prefix tokens folded into the admission key after the length lane
    _PREFIX_LANES = 2

    @staticmethod
    def _order_by_length(rs: List[Request], mesh=None, axis: str = "data",
                         device="cuda") -> List[Request]:
        """Length-then-alphabetic order of ``rs`` by one lex sort on
        ``device``: int32 lanes of the prompt length, then the first two
        prompt tokens (-1 where absent; shorter prompts already order first
        on the length lane), the request index as the payload and final
        tie-break (prompts equal through the key keep queue order). The
        queue pads with int32 max, which sorts to the tail, to ``max(128,
        next power of two)``, so a server meets few distinct shapes.
        ``mesh``: sort over its ``axis`` through
        ``core.distributed.distributed_sort_lex`` instead."""
        n = len(rs)
        if n < 2:
            return rs
        dev = resolve_device(device)
        n_pad = max(128, 1 << (n - 1).bit_length())
        lanes = np.full((1 + BucketedScheduler._PREFIX_LANES, n_pad),
                        np.iinfo(np.int32).max, np.int32)
        lanes[0, :n] = [len(r.prompt) for r in rs]
        for k in range(BucketedScheduler._PREFIX_LANES):
            lanes[1 + k, :n] = [r.prompt[k] if len(r.prompt) > k else -1
                                for r in rs]
        idx = torch.arange(n_pad, dtype=torch.int32, device=dev)
        if mesh is not None:
            from ..core.distributed import distributed_sort_lex
            _, perm = distributed_sort_lex(list(lanes), mesh, axis=axis,
                                           vals=idx, device=dev)
        else:
            _, perm = sort_lex([torch.from_numpy(l).to(dev) for l in lanes],
                               vals=idx)
        return [rs[int(j)] for j in perm[:n].cpu().numpy()]

    @staticmethod
    def padding_stats(requests: List[Request], bounds: Sequence[int]):
        """Padded-token fraction under bucketing against one global batch.
        A request longer than every bound lands in the last bucket and
        pads nothing (its contribution clamps at zero)."""
        lens = np.array([len(r.prompt) for r in requests])
        global_waste = 1.0 - lens.sum() / (len(lens) * lens.max())
        bound_arr = np.asarray(bounds)[assign_buckets(lens, bounds,
                                                      clamp=True)]
        padded = np.maximum(bound_arr - lens, 0).sum()
        bucket_waste = padded / (padded + lens.sum())
        return {"global_waste": float(global_waste),
                "bucketed_waste": float(bucket_waste)}
