"""Run combiner: merge of sorted lex-tuple runs on the device — the
counterpart of ``repro.pipeline.merge``.

A *run* is a tuple of parallel 1-D tensors sorted by the lane-by-lane
lexicographic order (``kernels/lex.py``); for the word pipeline the tuple
is ``(length, key_lane_0, ..., key_lane_L-1)``, shortlex. The default
combine is one k-way pass (``kernels.ops.merge_runs_lex``): the k-way
kernel (B6) for runs on a CUDA device, the torch 'take' tier on the CPU.
``engine='tournament'`` keeps the pairwise tree, ceil(log2 k) rounds of
``merge_sorted_lex`` — the merge-path kernel (B5) on a CUDA device.

Both paths work in the *extended* representation: each run's compare lanes
(1-2 packed rank keys and keypack's tie-break suffix) lead its data lanes,
so ranking never re-packs; ``cmp_runs`` hands over rank keys the per-chunk
sort already computed. The kernels compare only those leading lanes and
carry a source index, whatever the tuple's width.
"""

from __future__ import annotations

from ..kernels.keypack import packed_cmp_lanes
from ..kernels.ops import merge_runs_lex, merge_sorted_lex
from ..runtime import trace
from .validate import ValidationError

__all__ = ["merge_two", "merge_runs"]

_ENGINES = ("auto", "kway", "kway_kernel", "tournament")


def merge_two(a_lanes, b_lanes, engine: str = "auto", max_values=None):
    """Merge two sorted lex-tuple runs (tuples of parallel 1-D tensors, any
    lengths) into one: ``kernels.ops.merge_sorted_lex``."""
    return merge_sorted_lex(tuple(a_lanes), tuple(b_lanes), engine=engine,
                            max_values=max_values)


def merge_runs(runs, engine: str = "auto", max_values=None, cmp_runs=None,
               manifests=None, supervisor=None,
               block_size: int | None = None):
    """k-way merge of sorted runs of equal arity into one; an empty list
    returns ``()`` and a single run comes back as it is.

    ``engine``:

    - ``'kway'`` (and ``'auto'``, which resolves to it): one call of
      ``ops.merge_runs_lex`` — one pass for any k, the k-way kernel (B6)
      on a CUDA device past two output blocks and up to
      ``kway_kernel.MAX_RUNS`` non-empty runs, the 'take' tier past them;
    - ``'kway_kernel'``: the same, the kernel forced (its plain version on
      the CPU);
    - ``'tournament'``: ceil(log2 k) rounds of pairwise
      ``ops.merge_sorted_lex`` — the merge-path kernel (B5) on a CUDA
      device past two output blocks.

    Outputs are bit-identical across engines. ``cmp_runs``: per run, its
    pre-packed compare lanes (``SortedRun.cmp_lanes()``); ``None`` packs
    them here with ``max_values``. ``manifests``: per run, a
    ``RunManifest``-like whose count each run must match before any device
    work (:class:`ValidationError` otherwise). ``supervisor``: a
    ``runtime.SortSupervisor``; the k-way pass runs as its
    ``'streaming_combine'`` stage and each tournament round as a
    ``'merge_round'`` stage — both pure functions of their input runs, so
    a failed stage simply re-executes. ``block_size``: the kernels' output
    block."""
    if engine not in _ENGINES:
        raise ValueError(f"unknown merge_runs engine {engine!r}")
    runs = [tuple(r) for r in runs]
    if manifests is not None:
        if len(manifests) != len(runs):
            raise ValueError("manifests must parallel runs")
        for r, m in zip(runs, manifests):
            if r and int(r[0].shape[0]) != m.count:
                raise ValidationError(
                    f"run {m.chunk_id}: {int(r[0].shape[0])} element(s) "
                    f"but manifest records {m.count} — refusing to merge")
    if not runs:
        return ()
    if len(runs) == 1:
        return runs[0]
    arity = len(runs[0])
    if any(len(r) != arity for r in runs):
        raise ValueError("runs must have the same lane arity")
    if cmp_runs is None:
        cmp_runs = [packed_cmp_lanes(list(r), max_values) for r in runs]
    ext = [tuple(c) + r for c, r in zip(cmp_runs, runs)]
    n_cmp = len(ext[0]) - arity

    if engine != "tournament":
        def combine(ext_rs):
            return merge_runs_lex(
                ext_rs, engine="kernel" if engine == "kway_kernel" else "auto",
                n_cmp=n_cmp, block_size=block_size)

        with trace.span("merge.kway", runs=len(ext)):
            if supervisor is None:
                merged = combine(ext)
            else:
                merged = supervisor.run_stage("streaming_combine", combine,
                                              ext)
        return tuple(merged[n_cmp:])

    def one_round(ext_rs):
        nxt = [merge_sorted_lex(ext_rs[i], ext_rs[i + 1], n_cmp=n_cmp,
                                block_size=block_size)
               for i in range(0, len(ext_rs) - 1, 2)]
        if len(ext_rs) % 2:
            nxt.append(ext_rs[-1])
        return nxt

    while len(ext) > 1:
        with trace.span("merge.round", runs=len(ext)):
            if supervisor is None:
                ext = one_round(ext)
            else:
                ext = supervisor.run_stage("merge_round", one_round, ext)
    return tuple(ext[0][n_cmp:])
