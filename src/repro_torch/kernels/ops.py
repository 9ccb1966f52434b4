"""Public wrappers around the port's sorting kernels — the counterpart of
``repro.kernels.ops`` for the main path.

Entry points:
  * ``sort(x)`` / ``sort_kv(keys, vals)`` / ``sort_lex(keys_lanes, vals)`` —
    sort 1-D tensors or each row of ``(rows, cols)`` batches, lane 0 most
    significant, ``vals`` the final tie-break. ``choose_plan`` picks the
    tier: the OETS kernel (B1) up to 128 columns, the bitonic kernel (B2) up
    to 1024, and beyond that ``core/blocksort`` (B2 locally, then rounds of
    the merge kernel, B4). ``choose_lex_engine`` picks the lane engine:
    'lanes', or 'packed', which sorts the tuple's rank keys
    (``keypack.pack_rank_keys``) in fewer lanes.
  * ``segmented_sort(keys, counts)`` — one batched sort of the paper's
    ``(num_buckets, capacity, lanes)`` bucket tensor.
  * ``distribute(keys)`` / ``bucketize(keys, capacity)`` /
    ``scatter_to_buckets`` — the paper's distribute phase: the distribute
    kernel (B3), then one scatter into the bucket tensor.
  * ``sort_rows_lex`` / ``sort_rows`` / ``sort_rows_kv`` — the
    single-block row sorts.
  * ``partition_rows(keys, splitters)`` — bucket ids and per-row
    histograms against a splitter list: the partition kernel (B7).
  * ``merge_sorted_lex(a, b)`` / ``merge_sorted`` — merge two sorted runs:
    the merge-path kernel (B5) or the packed rank + scatter tier;
    ``merge_runs_lex(runs)`` — merge k sorted runs in one pass: the k-way
    kernel (B6) or the torch 'take' tier. ``choose_merge_engine`` and
    ``choose_kway_engine`` pick: the kernel for runs on a CUDA device past
    two output blocks, the torch tier otherwise — the reference's TPU rule
    with CUDA in its place.

Every op dispatches on its tensors' device: on the CPU it runs the kernels'
plain PyTorch versions, on a CUDA device it launches the kernels, and it
never falls back from one to the other. The padding contract is the
reference's (``repro/kernels/ops.py:687``): each array pads with its *own*
type's lex-maximal sentinel (``lex.sentinel_for``), never with zero, and
real elements equal to the sentinel still sort right because every array
takes part in the compare. float32 lanes follow the canonical total order:
NaNs above ``+inf``, ``-0.0 == +0.0``, and every output a bit-level
permutation of its input.

Rows are not padded to the TPU's 8 sublanes; they never change a row's
result. ``uint32`` data is ``torch.uint32`` at these functions and an int32
view inside them. Narrow integer lanes (int8, int16, uint8, uint16) are
widened into int32 lanes before a kernel and narrowed back after it
(``lex.as_bits``/``lex.from_bits``); widening keeps order and loses
nothing, so every result is the reference's bit for bit.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Sequence

import torch

from ..runtime.failure import CapacityOverflow
from .bitonic_kernel import bitonic_rows_lex
from .distribute_kernel import distribute_rows
from .keypack import (merge_take_packed, pack_rank_keys, plan_pack,
                      unpack_rank_keys)
from .kway_kernel import (MAX_RUNS, merge_runs_kway_kernel,
                          merge_runs_kway_take)
from .lex import (F32, as_bits, dtype_code, from_bits, lex_merge_take,
                  pad_bits, sentinel_bits)
from .oets_kernel import oets_rows_lex
from .partition_kernel import partition_rows as partition_rows_kernel
from .runmerge_kernel import (DEFAULT_MERGE_BLOCK, check_runs,
                              merge_runs_lex_kernel)

__all__ = ["sort", "sort_kv", "sort_lex", "segmented_sort", "distribute",
           "bucketize", "BucketizeResult", "scatter_to_buckets",
           "choose_plan", "choose_lex_engine", "execution_provenance",
           "sort_rows_lex", "sort_rows", "sort_rows_kv", "partition_rows",
           "choose_merge_engine", "merge_sorted_lex", "merge_sorted",
           "choose_kway_engine", "merge_runs_lex", "DEFAULT_MERGE_BLOCK"]

log = logging.getLogger("repro_torch.kernels")

_LANES = 128
# widest row the single-block kernels take before blocksort: the reference's
# tier bound, kept until the H100 crossover is measured (ROADMAP)
_MAX_SINGLE_BLOCK = 1024


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def execution_provenance(device=None) -> dict:
    """Where the ops of this module run for ``device`` (default: the card
    if there is one, else the CPU): the backend, the device's name, its
    compute capability, the kernels' language and the torch version."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        return {"backend": "cuda", "device_kind": props.name,
                "compute_capability": f"{props.major}.{props.minor}",
                "kernels": "cuda-c++ sm_90a", "torch": torch.__version__,
                "cuda": torch.version.cuda}
    return {"backend": dev.type, "device_kind": dev.type,
            "compute_capability": None, "kernels": "plain-torch",
            "torch": torch.__version__, "cuda": torch.version.cuda}


def choose_plan(cols: int, algorithm: str = "auto",
                block_size: int | None = None):
    """Pick ``(algorithm, block_size)`` for ``cols``-wide rows: 'oets' up to
    one 128-lane tile, 'bitonic' up to 1024 pow2-padded columns,
    'blocksort' beyond. An explicit ``algorithm`` overrides."""
    if algorithm != "auto":
        return algorithm, block_size
    if cols <= _LANES:
        return "oets", None
    if _next_pow2(cols) <= _MAX_SINGLE_BLOCK:
        return "bitonic", None
    return "blocksort", block_size


def choose_lex_engine(dtypes, max_values=None, engine: str = "auto") -> str:
    """Pick the lane engine for :func:`sort_lex`: 'packed' exactly when the
    rank-key packing is lossless and shrinks the lane count, else 'lanes'
    (``repro.kernels.ops.choose_lex_engine``'s rule)."""
    if engine not in ("auto", "lanes", "packed"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "lanes":
        return "lanes"
    try:
        plan = plan_pack(tuple(dtypes), max_values)
    except TypeError:
        return "lanes"
    if not plan.exact:
        return "lanes"
    if engine == "packed":
        return "packed"
    return "packed" if plan.n_packed < len(tuple(dtypes)) else "lanes"


def _pad_stack(views: Sequence[torch.Tensor], codes: Sequence[int],
               target: int) -> torch.Tensor:
    """A fresh ``(A, R, target)`` int32 tensor: array ``a`` is ``views[a]``
    (R, C) followed by its own sentinel."""
    rows, cols = views[0].shape
    x = torch.empty((len(views), rows, target), dtype=torch.int32,
                    device=views[0].device)
    for a, (v, code) in enumerate(zip(views, codes)):
        x[a, :, :cols] = v
        x[a, :, cols:] = sentinel_bits(code)
    return x


def _sort_rows_views(views, codes, algorithm: str) -> torch.Tensor:
    """Sort the rows of int32 lane views with one single-block kernel;
    returns the ``(A, R, C)`` result."""
    cols = views[0].shape[1]
    if algorithm == "oets":
        x = _pad_stack(views, codes, max(_LANES, -(-cols // _LANES) * _LANES))
        oets_rows_lex(x, codes)
    elif algorithm == "bitonic":
        x = _pad_stack(views, codes, max(_LANES, _next_pow2(cols)))
        bitonic_rows_lex(x, codes)
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return x[:, :, :cols]


def _sort_views(views, codes, algorithm: str, block_size: int | None):
    """Sort the rows of int32 lane views by the tier ``choose_plan`` picks;
    returns the ``(A, R, C)`` result."""
    algo, block = choose_plan(views[0].shape[1], algorithm, block_size)
    if algo == "blocksort":
        from ..core.blocksort import block_sort_views  # core imports kernels
        return block_sort_views(views, codes, block_size=block)
    return _sort_rows_views(views, codes, algo)


def _unstack(x: torch.Tensor, dtypes) -> tuple:
    return tuple(from_bits(x[a].contiguous(), dt) for a, dt in enumerate(dtypes))


def _as_rows(x: torch.Tensor):
    """Promote a 1-D tensor to one row; returns ``(2-D view, was_1d)``."""
    if x.dim() == 1:
        return x[None, :], True
    if x.dim() == 2:
        return x, False
    raise ValueError("expected a 1-D or 2-D tensor")


def sort_rows_lex(arrs, algorithm: str = "oets"):
    """Row-wise lexicographic sort of same-shape ``(rows, cols)`` tensors
    through one single-block kernel ('oets' or 'bitonic'); returns the
    sorted list. Every array pads with its own type's sentinel (see the
    module docstring)."""
    arrs = list(arrs)
    codes = [dtype_code(a.dtype) for a in arrs]
    out = _sort_rows_views([as_bits(a) for a in arrs], codes, algorithm)
    return list(_unstack(out, [a.dtype for a in arrs]))


def sort_rows(x: torch.Tensor, algorithm: str = "oets") -> torch.Tensor:
    """Sort each row of a ``(rows, cols)`` tensor ascending with one
    single-block kernel: 'oets' (the paper's) or 'bitonic'."""
    (out,) = sort_rows_lex([x], algorithm=algorithm)
    return out


def sort_rows_kv(keys: torch.Tensor, vals: torch.Tensor,
                 algorithm: str = "oets"):
    """Row-wise key-value :func:`sort_rows`; ``vals`` shares ``keys``'
    shape and breaks ties."""
    if keys.shape != vals.shape:
        raise ValueError("keys and vals must have identical shapes")
    ok, ov = sort_rows_lex([keys, vals], algorithm=algorithm)
    return ok, ov


def sort(x: torch.Tensor, algorithm: str = "auto",
         block_size: int | None = None) -> torch.Tensor:
    """Sort a 1-D tensor or each row of a ``(rows, cols)`` tensor ascending.
    ``algorithm``: 'auto', 'oets', 'bitonic' or 'blocksort';
    ``block_size``: the blocksort block (a power of two >= 128)."""
    (out,) = sort_lex((x,), algorithm=algorithm, block_size=block_size)
    return out


def sort_kv(keys: torch.Tensor, vals: torch.Tensor, algorithm: str = "auto",
            block_size: int | None = None):
    """Key-value counterpart of :func:`sort`; ``vals`` rides the keys'
    permutation as the final lex tie-break."""
    if keys.shape != vals.shape:
        raise ValueError("keys and vals must have identical shapes")
    lanes, ov = sort_lex((keys,), vals=vals, algorithm=algorithm,
                         block_size=block_size)
    return lanes[0], ov


def sort_lex(keys_lanes, vals=None, algorithm: str = "auto",
             block_size: int | None = None, engine: str = "auto",
             max_values=None):
    """Lexicographic sort of same-shape 1-D or ``(rows, cols)`` tensors,
    lane 0 most significant; ``vals`` rides the permutation as the final
    tie-break. Returns the tuple of sorted lanes, or ``(lanes, vals)``.

    ``engine``: 'lanes' (every lane a comparator lane), 'packed' (sort the
    tuple's 1-2 rank-key lanes, ``keypack.pack_rank_keys``, then unpack —
    or, when a float lane is present, sort ``(rank keys, iota)`` and gather
    every original lane and ``vals`` through the permutation, which keeps
    every float bit; honoured only when the packing is lossless, else
    'lanes'), or 'auto' (:func:`choose_lex_engine`). ``max_values``:
    optional per-lane upper bounds that tighten the packed widths. The main
    path's full uint32 word lanes never pack losslessly, so they resolve to
    'lanes'."""
    lanes = list(keys_lanes)
    if not lanes:
        raise ValueError("need at least one key lane")
    arrs = lanes + ([vals] if vals is not None else [])
    if any(a.shape != arrs[0].shape for a in arrs[1:]):
        raise ValueError("all lanes (and vals) must have identical shapes")
    if choose_lex_engine([a.dtype for a in lanes], max_values,
                         engine) == "packed":
        return _sort_lex_packed(lanes, vals, algorithm, block_size,
                                max_values)
    views = [_as_rows(a) for a in arrs]
    vec = views[0][1]
    a2 = [v[0] for v in views]
    if 0 in a2[0].shape:
        out = tuple(arrs)
    else:
        codes = [dtype_code(a.dtype) for a in arrs]
        x = _sort_views([as_bits(a) for a in a2], codes, algorithm, block_size)
        out = _unstack(x, [a.dtype for a in arrs])
        if vec:
            out = tuple(o[0] for o in out)
    if vals is None:
        return out
    return out[:-1], out[-1]


def _sort_lex_packed(lanes, vals, algorithm, block_size, max_values):
    """:func:`sort_lex`'s packed engine (``repro/kernels/ops.py:282-307``)."""
    packed = pack_rank_keys(lanes, max_values)
    if any(dtype_code(a.dtype) == F32 for a in lanes):
        # the float order bits are compare-only (NaN payloads collapse,
        # -0.0 normalises), so sort (rank keys, iota) and gather the
        # original lanes through the permutation
        x0 = lanes[0]
        iota = torch.arange(x0.shape[-1], dtype=torch.int32,
                            device=x0.device).expand(x0.shape).contiguous()
        perm = sort_lex(tuple(packed.lanes) + (iota,), algorithm=algorithm,
                        block_size=block_size, engine="lanes")[-1].long()

        def gather(a):
            return from_bits(as_bits(a).gather(-1, perm), a.dtype)

        out = tuple(gather(a) for a in lanes)
        return out if vals is None else (out, gather(vals))
    out_packed = sort_lex(packed.lanes, vals=vals, algorithm=algorithm,
                          block_size=block_size, engine="lanes")
    if vals is not None:
        out_packed, out_vals = out_packed
    out = tuple(unpack_rank_keys(out_packed, [a.dtype for a in lanes],
                                 max_values))
    return out if vals is None else (out, out_vals)


def segmented_sort(keys: torch.Tensor, counts: torch.Tensor | None = None,
                   algorithm: str = "auto", block_size: int | None = None):
    """One batched sort over the paper's bucket tensor.

    ``keys``: ``(num_buckets, capacity, lanes)``, lane-major significance.
    ``counts``: ``(num_buckets,)`` real slots per bucket; slots at or past a
    bucket's count are masked to the sentinel so they sink to its tail
    (``None`` trusts the tensor's padding). Rows = buckets, cols = capacity,
    one comparator lane per key lane. Returns the sorted tensor."""
    if keys.dim() != 3:
        raise ValueError("keys must be (num_buckets, capacity, lanes)")
    if 0 in keys.shape:
        return keys
    code = dtype_code(keys.dtype)
    bits = as_bits(keys)
    if counts is not None:
        slot = torch.arange(keys.shape[1], device=keys.device)
        mask = slot[None, :] >= counts.to(keys.device)[:, None]
        bits = torch.where(mask[..., None], pad_bits(keys.dtype), bits)
    n_lanes = keys.shape[2]
    x = _sort_views([bits[..., l] for l in range(n_lanes)], [code] * n_lanes,
                    algorithm, block_size)
    return from_bits(x.permute(1, 2, 0).contiguous(), keys.dtype)


def distribute(keys: torch.Tensor):
    """The distribute pass over packed words ``(n, lanes)`` (uint32 or their
    int32 bits). Returns ``(dest, rank, counts)`` int32: each word's byte
    length, which is its bucket id; its stable slot within the bucket; and
    the length histogram over ``4 * lanes + 1`` buckets."""
    n, lanes = keys.shape
    num_buckets = 4 * lanes + 1
    if n == 0:
        z = torch.zeros(0, dtype=torch.int32, device=keys.device)
        return z, z.clone(), torch.zeros(num_buckets, dtype=torch.int32,
                                         device=keys.device)
    return distribute_rows(as_bits(keys).contiguous())


def _optimistic_capacity(n: int, num_buckets: int) -> int:
    """First-shot capacity of the two-tier autotune: a uniform length
    spread with 4x headroom, a power of two, clamped at ~n/2 (the
    reference's rule, ``repro/kernels/ops.py:546``)."""
    return max(1, min(n, _next_pow2(-(-4 * n // num_buckets)),
                      _next_pow2(-(-n // 2))))


class BucketizeResult(NamedTuple):
    """Result of :func:`bucketize`: ``buckets`` ``(num_buckets, capacity,
    lanes)`` uint32 — bucket ``l`` holds the words of byte length ``l`` in
    arrival order, unused slots at the sentinel; ``counts`` ``(num_buckets,)``
    int32 true per-bucket counts; ``dropped`` — the number of elements
    clipped out under ``on_overflow='clip'`` (0 on every other path)."""

    buckets: torch.Tensor
    counts: torch.Tensor
    dropped: int


def bucketize(keys: torch.Tensor, capacity: int | None = None,
              on_overflow: str = "clip") -> BucketizeResult:
    """Scatter packed words ``(n, lanes)`` into the dense per-length bucket
    tensor: one distribute launch and one scatter.

    ``capacity=None`` runs the two-tier autotune: the scatter goes out at
    an optimistic capacity before the histogram is read back, and only a
    skewed length distribution pays a second scatter at the true maximum.
    ``on_overflow`` — the policy when an explicit ``capacity`` is exceeded:
    'clip' (drop the excess, warn, report it in ``dropped``), 'raise'
    (:class:`CapacityOverflow` with the required capacity) or 'retry'
    (re-scatter once at the exact capacity)."""
    if on_overflow not in ("clip", "raise", "retry"):
        raise ValueError(f"unknown on_overflow policy {on_overflow!r}")
    n, lanes = keys.shape
    num_buckets = 4 * lanes + 1
    dest, rank, counts = distribute(keys)
    if capacity is None:
        if n == 0:
            capacity = 0
        else:
            capacity = _optimistic_capacity(n, num_buckets)
            buckets = scatter_to_buckets(keys, dest, rank,
                                         num_buckets=num_buckets,
                                         capacity=capacity)
            true_max = int(counts.max())  # syncs after the scatter is queued
            if true_max <= capacity:
                return BucketizeResult(buckets, counts, 0)
            capacity = true_max
        return BucketizeResult(
            scatter_to_buckets(keys, dest, rank, num_buckets=num_buckets,
                               capacity=capacity), counts, 0)
    dropped = int((counts - capacity).clamp(min=0).sum()) if n else 0
    if dropped:
        true_max = int(counts.max())
        if on_overflow == "raise":
            raise CapacityOverflow(
                f"bucketize overflow: largest bucket holds {true_max} and "
                f"exceeds capacity {capacity} ({dropped} element(s) would "
                f"drop)", capacity, required=true_max, dropped=dropped)
        if on_overflow == "retry":
            log.warning("bucketize overflow: capacity %d -> %d (exact-count "
                        "retry, %d element(s) would have dropped)",
                        capacity, true_max, dropped)
            capacity, dropped = true_max, 0
        else:
            log.warning("bucketize overflow: dropping %d element(s) past "
                        "capacity %d (max bucket holds %d) — pass "
                        "on_overflow='raise'|'retry' for a lossless policy",
                        dropped, capacity, true_max)
    return BucketizeResult(
        scatter_to_buckets(keys, dest, rank, num_buckets=num_buckets,
                           capacity=capacity), counts, dropped)


def scatter_to_buckets(keys: torch.Tensor, dest: torch.Tensor,
                       rank: torch.Tensor, *, num_buckets: int,
                       capacity: int) -> torch.Tensor:
    """Place word ``i`` at ``buckets[dest[i], rank[i]]``: one scatter into a
    sentinel-filled ``(num_buckets, capacity, lanes)`` uint32 tensor; ranks
    past ``capacity`` and padding ids go to a discard slot."""
    n, lanes = keys.shape
    flat = torch.full((num_buckets * capacity + 1, lanes), -1,
                      dtype=torch.int32, device=keys.device)
    keep = (rank < capacity) & (dest < num_buckets)
    slot = torch.where(keep, dest.long() * capacity + rank,
                       num_buckets * capacity)
    flat[slot] = as_bits(keys)
    return flat[: num_buckets * capacity].reshape(
        num_buckets, capacity, lanes).view(torch.uint32)


def _on_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def choose_merge_engine(total: int, engine: str = "auto",
                        device=None) -> str:
    """Pick the two-run merge engine for a ``total``-element merge on
    ``device``: 'kernel' (the merge-path kernel, B5) for runs on a CUDA
    device past two output blocks, else 'packed' (rank-key searchsorted
    ranks and one scatter per lane) — ``repro.kernels.ops``'s rule with
    CUDA in place of the TPU; where the H100's crossover lies is measured in
    PERF.md. 'lanes', the broadcast oracle, is never chosen by 'auto'. An
    explicit ``engine`` overrides."""
    if engine != "auto":
        if engine not in ("lanes", "packed", "kernel"):
            raise ValueError(f"unknown engine {engine!r}")
        return engine
    if _on_cuda(device) and total > 2 * DEFAULT_MERGE_BLOCK:
        return "kernel"
    return "packed"


def merge_sorted_lex(a_lanes, b_lanes, engine: str = "auto",
                     n_cmp: int | None = None, max_values=None,
                     block_size: int | None = None) -> tuple:
    """Merge two *sorted* lex-tuple runs (tuples of parallel 1-D 32-bit
    tensors, any lengths) into one sorted run; every lane takes part in the
    order (trailing lanes break ties) and equal tuples keep a before b.

    ``engine``: 'packed' (rank keys, searchsorted ranks, one scatter),
    'kernel' (the merge-path kernel, B5; its plain version on the CPU),
    'lanes' (the broadcast oracle ``lex.lex_merge_take``), 'kway' (the
    pair through :func:`merge_runs_lex`), or 'auto'
    (:func:`choose_merge_engine`). ``n_cmp``: the leading ``n_cmp`` lanes
    are pre-packed compare lanes to rank on as they are; ``max_values``:
    per-lane packing bounds; ``block_size``: the kernels' output block."""
    if engine == "kway":
        return merge_runs_lex([a_lanes, b_lanes], n_cmp=n_cmp,
                              max_values=max_values, block_size=block_size)
    a_lanes, b_lanes = check_runs([a_lanes, b_lanes])
    if a_lanes[0].shape[0] == 0:
        return b_lanes
    if b_lanes[0].shape[0] == 0:
        return a_lanes
    eng = choose_merge_engine(a_lanes[0].shape[0] + b_lanes[0].shape[0],
                              engine, a_lanes[0].device)
    if eng == "lanes":
        return tuple(lex_merge_take(a_lanes, b_lanes))
    if eng == "packed":
        return tuple(merge_take_packed(a_lanes, b_lanes, n_cmp=n_cmp,
                                       max_values=max_values))
    return merge_runs_lex_kernel(a_lanes, b_lanes, n_cmp=n_cmp,
                                 max_values=max_values, block=block_size)


def merge_sorted(a: torch.Tensor, b: torch.Tensor, engine: str = "auto",
                 block_size: int | None = None) -> torch.Tensor:
    """Key-only :func:`merge_sorted_lex`: merge two sorted 1-D tensors."""
    (out,) = merge_sorted_lex((a,), (b,), engine=engine,
                              block_size=block_size)
    return out


def choose_kway_engine(total: int, engine: str = "auto", device=None,
                       n_runs: int = 2) -> str:
    """Pick the k-way merge tier for ``n_runs`` non-empty runs of ``total``
    elements: 'kernel' (the one-launch k-way kernel, B6) for runs on a CUDA
    device past two output blocks, as long as one launch takes them all
    (``kway_kernel.MAX_RUNS``), else 'take' (one stable sort of the compare
    lanes and one gather per lane) — the rule of :func:`choose_merge_engine`;
    past ``MAX_RUNS`` runs 'take', the reference's own tier off the TPU. An
    explicit ``engine`` overrides (and 'kernel' past ``MAX_RUNS`` raises)."""
    if engine != "auto":
        if engine not in ("take", "kernel"):
            raise ValueError(f"unknown k-way engine {engine!r}")
        return engine
    if (_on_cuda(device) and total > 2 * DEFAULT_MERGE_BLOCK
            and n_runs <= MAX_RUNS):
        return "kernel"
    return "take"


def merge_runs_lex(runs, engine: str = "auto", n_cmp: int | None = None,
                   max_values=None, block_size: int | None = None) -> tuple:
    """Merge k *sorted* lex-tuple runs (equal-arity tuples of parallel 1-D
    32-bit tensors, any lengths; empty runs drop) into one sorted run in a
    single pass; compare-equal elements keep run order, then in-run order.
    ``engine``: 'take', 'kernel' (the k-way kernel, B6; its plain version on
    the CPU) or 'auto' (:func:`choose_kway_engine`). ``n_cmp``,
    ``max_values`` and ``block_size`` as in :func:`merge_sorted_lex`."""
    runs = check_runs(runs)
    nonempty = [r for r in runs if r[0].shape[0]]
    if not nonempty:
        return runs[0]
    if len(nonempty) == 1:
        return nonempty[0]
    total = sum(r[0].shape[0] for r in nonempty)
    if choose_kway_engine(total, engine, nonempty[0][0].device,
                          len(nonempty)) == "kernel":
        return merge_runs_kway_kernel(nonempty, n_cmp=n_cmp,
                                      max_values=max_values, block=block_size)
    return merge_runs_kway_take(nonempty, n_cmp=n_cmp, max_values=max_values)


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast to int32 as ``astype(jnp.int32)`` casts it: 32-bit lanes
    keep their bits (uint32 wraps), narrow ints widen, floats truncate
    toward zero."""
    if x.dtype in (torch.int32, torch.uint32, torch.uint16):
        return as_bits(x)
    return x.to(torch.int32)


def partition_rows(keys: torch.Tensor, splitters: torch.Tensor):
    """Bucket each element of ``(rows, cols)`` ``keys`` by ``splitters``
    (the paper's distribute-into-sub-arrays step), both cast to int32:
    ``bucket id = #{j : key >= splitters[j]}`` — ``searchsorted(side=
    'right')`` for sorted splitters, a count for any. Returns ``(bucket_ids
    (rows, cols), counts (rows, len(splitters) + 1))``, both int32, from the
    partition kernel (B7)."""
    if keys.dim() != 2 or splitters.dim() != 1:
        raise ValueError("expected (rows, cols) keys and 1-D splitters")
    return partition_rows_kernel(_as_int32(keys).contiguous(),
                                 _as_int32(splitters).contiguous())
