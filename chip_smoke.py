#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of ``jax`` or ``repro``. Phases, each fatal on failure:

  1. build — compile the seven CUDA sources of ``src/repro_torch/kernels/
     csrc`` with ``nvcc`` for ``sm_90a``, one process per source, and print
     ``-Xptxas -v``'s registers, shared memory and spills per kernel;
  2. kernels — run every kernel at the shapes its path gives it, on the
     path's data and on adversarial inputs (sentinel-colliding uint32,
     duplicate-heavy, float32 NaN/±0/±inf with a payload lane; for the run
     merges also empty and one-element runs and the 18-array tuple of
     32-byte words), require its bits to equal its plain PyTorch version's
     on the card and its output to be in order (for the row sorts a chain
     of stable ``torch.sort`` passes is the independent check; for the run
     merges the torch tier and the total-order contract), and time kernel,
     plain version and library call or torch tier. The bitonic kernel (B2)
     also runs at every power-of-two column count from 1 to its
     shared-memory cap, and the merge kernel (B4) at every power-of-two
     block, at offsets 0 and ``block``, both for 1, 2, 3, 4, 5, 8 and 9
     lanes of each code and fill; B2 is timed at the run tier's chunk
     blocks (4, 136, 512) beside DS2's local blocks. The distribute kernel
     (B3) runs at 0 to 1,048,577 words of 1 to 8 lanes, with ``n_valid``
     0, ``n - 777`` and ``n``, on words of spread, single and per-warp
     alternating lengths. The OETS kernel (B1) also runs at 1, 17, 33 and
     133 rows of 100, 128 (one warp a row) and 256 columns (a block a row)
     for the same lane counts, codes and fills, each output also the stable
     sort. The merge-path kernel (B5) and its split run at the last
     tournament round of DS2 chunked at 4096 words, and at every
     compare-lane count from 1 to 15 for each fill at the co-rank edges of
     ``adversarial.MERGE_EDGES``, blocks 128 and 256; the k-way kernel (B6),
     its split (the key tournament's rounds on the card) and the gather of
     the runs' lanes at DS2's 57 runs, the split held to its plain version
     and to the torch oracle ``kway_cursors(kway_ranks(...))``, and all
     three at 2, 3, 8, 57, 64, 257 and 1,024 runs of each fill
     (``adversarial.kway_case``), blocks 128 and 256;
  3. main path — sort a 500-word chunk (OETS tier), a 3,000-word chunk
     (bitonic tier) and the paper's DS1 and DS2 (blocksort: bitonic + merge)
     through ``bucketed_sort_words`` and ``sorted_packed``; then the run
     tier: ``chunked_sort_words`` of DS2 at chunk 4096 with the k-way merge
     and with the tournament, and ``chunked_sort_packed`` of 1,048,576
     synthetic words at chunk 16,384 with ``validate='full'``. Every launch
     counter is set to 0 just before each run and read just after; each
     result must equal Python's shortlex ``sorted``, DS1's packed lanes must
     equal the plain path's on the CPU, and every kernel must have run on
     its path;
  3b. fault tolerance — the same chunked sorts with a ``RunStore`` and a
     ``SortSupervisor`` in a temporary directory (``phase_fault_tolerance``):
     DS2 with a store, timed against none, and a resume that sorts no
     chunk; a job failing every chunk sort from chunk 30 on and its
     resume (27 chunk sorts); a damaged store (3 chunk sorts) and a flipped
     bit caught by ``validate='full'``; a supervisor with no fault, timed
     against none, and injected failures of ``ingest_chunk``,
     ``streaming_combine`` and (tournament) ``merge_round``, each
     recovered bit-identically; the million words with a store and its
     resume; a ``ShardStore`` of the merged DS2 run;
  4. partition and the repaired sorts — ``partition_rows`` (B7) on DS2's
     first packed lane as (8, 28,750) with 7 and 127 splitters, on the
     million-word corpus's first lane as (64, 16,384) with 127, and on
     DS2's byte lengths (1, 230,000) with splitters 1..16, whose counts
     must equal B3's histogram; ``sort`` of 230,000 int8, int16, uint8 and
     uint16 keys (blocksort: B2, B4) and ``sort_lex`` through the packed
     engine on two bounded int32 lanes and on a float32 lane of NaN
     payloads and ±0 beside an int32 lane, each equal to the CPU port's
     result. The counters are read around those calls; then B7 is held to
     its plain version bit for bit on each input and on adversarial ones
     (int32 extremes, keys equal to splitters, duplicated and unsorted
     splitters, none, C = 130 with R = 1, uint32 keys past 2^31, and a
     sweep of splitter counts from 0 to ``MAX_SPLITTERS`` at ragged column
     counts), and timed beside its plain version and ``torch.bucketize``
     plus a scatter-add;
  5. mesh — ``distributed_chunked_sort_lex`` at 8 destinations of the
     card, its spill, resumes, speculation and chaos soak, and the engines
     over NCCL at world size 1 and in 4 gloo rank processes
     (``phase_mesh``);
  6. serve — Granite-MoE 1B at its published width (bf16, weights drawn on
     the card from seed 0) serving 32 requests through
     ``BucketedScheduler(Engine(..., sort_impl='pallas')).run``: every
     request answered with 16 tokens, the admission sort on B1 and the MoE
     dispatch on B1 (decode) and blocksort's B2 and B4 (prefill), with
     tokens/s, prefill and decode medians, padding waste and peak memory;
     then the admission permutation at 32, 200 and 2,000 requests against
     the plain versions' on the CPU, the kernels' dispatch permutation at
     each of the 24 layers of an 8 x 512 prefill against the stable
     argsort's of the same assignments and that prefill's logits against
     the 'xla' dispatch's, and the engine's greedy tokens on the card
     against the CPU's at the smoke config in float32 (``phase_serve``);
  7. families — the MLA and state-space families (``phase_families``):
     MiniCPM3-4B (MLA) and Zamba2-1.2B (Mamba2 and the shared-block
     hybrid) at their published widths and depths, bf16 weights drawn on
     the card, serving the same wave (every request answered with 16
     tokens, the admission on B1), Zamba2's cache bytes against a GQA
     cache of its depth; deepseek-v2 at its published width with its depth
     cut to 3 layers (its dense layer and two MoE layers of 160 experts
     top-6) through one 8 x 512 prefill with each dispatch (the kernels'
     permutation at both MoE layers against the stable argsort's, logits
     within the phase-6 tolerance) and 4 decode steps (B1 dispatches of 48
     assignments); and the engine's greedy tokens at the smoke configs of
     minicpm3-4b, deepseek-v2-236b, mamba2-370m, zamba2-1.2b and glm4-9b on
     the card
     against the CPU's, the batch holding a 2-token prompt;
  8. train — Granite-MoE 1B at its published width and depth (bf16,
     weights drawn on the card from seed 0, remat 'dots') through
     ``launch.train.train_loop``: 8 steps of 8 x 512 tokens with the
     kernels' dispatch, a snapshot of ~13.9 GB every 4 steps, a failure at
     step 6 and the resume from step 4 (one recovery, 10 finite losses, the
     last snapshot read back bit-equal), each step's B2 and B4 launches
     held to 48 dispatches' worth (24 forward, 24 recomputed), with the
     median step, tokens/s, peak memory and the snapshots' save, write and
     restore times; one step's loss and gradients with 'pallas' twice and
     'xla' twice, bit-identical, every dispatch's permutation the stable
     argsort's; Zamba2-1.2B at its published width and depth, 4 steps on
     one repeated batch, losses finite and falling; and three float32
     train steps of seven smoke configs (qwen2-vl-2b among them) on the
     card against the CPU
     (``phase_train``);
  9. plan — the parallel plan (``phase_plan``): 4 gloo ranks of this card
     (``--plan-rank`` processes) as a ``(data 2, model 2)`` mesh. Granite-MoE
     1B at its published width and depth in bf16, drawn from seed 0 in
     every rank and placed by ``shard_lm`` (each rank's bytes printed; the
     vocab of 49,155 stays replicated): an 8 x 512 prefill (its collective
     bytes through the host counted, then timed bare), 4 greedy decode
     steps on a sharded cache and one train step (remat 'dots') with the
     kernels' dispatch (B2 and B4, then B1, in every rank; every dispatch
     permutation the stable argsort's), beside the unsharded runs (their
     differences and phase 6's 0.125 bound printed: the random-init model
     is chaotic in bf16); the same weights in float32, an 8 x 256 prefill
     and 4 decode steps sharded against unsharded with each block and the
     head fed the unsharded run's input, every block's output (at the
     tokens whose experts are unchanged) and the logits held to
     ``PLAN_F32_RTOL``, and the check shown to fail with one weight's
     shards misplaced; one
     float32 train step sharded against unsharded at Granite's smoke config
     and at its published width cut to 2 layers (loss, gradient norm, each
     parameter's change, the moments); the glm4, minicpm3 and zamba2 smoke
     configs' prefill and decode sharded against unsharded; and
     ``ring_all_reduce``, ``ring_all_gather``, ``pipeline_forward``,
     ``compressed_psum`` and ``ep_moe`` at Granite's width on CUDA tensors
     against their one-process counterparts; and the sharded Granite served
     through ``Engine.generate`` (8 prompts, 4 new tokens, 'pallas': C8,
     the engine under ``no_grad`` for a sharded LM), its greedy tokens
     counted against the unsharded engine's;
 10. launch — the launchers and the conformance kit (``phase_launch``):
     ``launch.hw.device_properties()`` beside ``nvidia-smi`` (an H100, its
     memory within 10% of the data sheet's 80 GB); the conformance matrix
     of ``repro_torch.testing`` in ``torch-cpu``, ``cuda-kernel`` and
     ``cuda-graph`` (every cell conforming, B1-B6 each launched); and
     ``launch.dryrun.run_cell`` of Granite at full width on fake (1, 1)
     and (2, 2) groups at phase 8's train cell (8 x 512) and phase 6's
     prefill (8 x 512): FLOPs, bytes, collectives and memory a rank, the
     (2, 2) parameters held to phase 9's 742,891,520 B, the predicted train
     peak printed beside phase 8's measured one;
 11. examples — the port's examples and the entry points at the published
     configs no other phase runs (``phase_examples``): each module of
     ``repro_torch.examples`` through its ``main`` on the card (quickstart,
     serve_lm, ``train_lm --steps 300 --fail-at 150``; distributed_sort and
     moe_expert_parallel through their own launch of 8 gloo ranks on
     ``cuda:0``), each printing its ``complete`` line, its time and its
     kernels' launches (an 8-rank example's summed over its ranks), each
     launching the kernels it must; then ``launch.serve.main`` of glm4-9b
     and mamba2-370m at their published configs (bf16 weights drawn on the
     card from seed 0; 24 requests, 8 new tokens, max_seq 128, the kernels'
     dispatch): every request answered with 8 tokens, tokens/s, prefill and
     decode medians, peak memory and the parameter count; and
     ``launch.train.main`` of qwen2-vl-2b and musicgen-large at their
     published configs (4 steps of 4 x 32): 4 finite losses, the median
     step, peak memory and the parameter count.

Every kernel row carries ``ms`` (CUDA events around 20 back-to-back calls,
so the host's time per call counts where it is longer) and ``device_ms``
(the device's own time per call, from ``torch.profiler`` over the same
calls, traced again where a window lost events; ``device_ms_source`` says
whether the profiler or the CUDA-graph fallback gave it).

Then it prints the card's name and power limit as ``nvidia-smi`` gives them,
one JSON line with every kernel's numbers, and last
``{"ok": true, "device": {...}}``. It exits non-zero, printing no result,
when there is no card or any check fails.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA's data sheet): HBM3 bandwidth, and the float32 rate
# outside the tensor cores — the table's only non-tensor rate, so compares
# counted against it give a lower bound on their time
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12
KERNEL_ITERS = 20
PLAIN_ITERS = 3
E2E_RUNS = 5
# the kernels of sorted_packed and bucketed_sort_words
MAIN_PATH = ("oets_rows_lex", "bitonic_rows_lex", "distribute_rows",
             "merge_adjacent_lex")
NARROW_N = 230_000
# the CUDA functions behind each kernel's C entry point, as the profiler
# names them
DEVICE_NAMES = {
    # one warp a row up to 128 columns, a block a row beyond
    "oets_rows_lex": ("oets_warp_kernel", "oets_rows_kernel"),
    "bitonic_rows_lex": ("bitonic_window_kernel", "bitonic_regs_kernel"),
    # the kernel and the zeroing of its look-back scratch, in one call
    "distribute_rows": ("distribute_kernel", "Memset"),
    "merge_adjacent_lex": ("merge_window_kernel", "merge_regs_kernel"),
    "merge_runs_lex": ("runmerge_kernel",),
    "merge_path_starts": ("runmerge_starts_kernel",),
    "merge_runs_kway": ("kway_kernel",),
    # a round's split and merge, and the cursors after the last round
    "kway_split": ("kway_split_kernel", "kway_round_kernel",
                   "kway_cursor_kernel"),
    "kway_gather": ("kway_gather_kernel",),
    "partition_rows": ("partition_prep_kernel", "partition_kernel"),
}
SWEEP_LANES = (1, 2, 3, 4, 5, 8, 9)
# B1's sweep: 133 rows leave the warp kernel's last block three warps
# without a row; 100 and 128 columns run one warp a row, 256 a block a row
OETS_SWEEP_ROWS = (1, 17, 33, 133)
OETS_SWEEP_COLS = (100, 128, 256)
MERGE_SWEEP_BLOCKS = (128, 256)
DISTRIBUTE_SWEEP_N = (0, 1, 31, 32, 33, 1023, 1024, 1025, 4096, 65_537,
                      230_000, 1_048_577)
SPLITTER_SWEEP = (0, 1, 2, 31, 32, 33, 127, 128, 1000)   # and MAX_SPLITTERS
SPLITTER_SWEEP_COLS = (1, 3, 130, 16_385)
# the chunks of the fault-tolerance phase: the reference's DEFAULT_CHUNK on
# DS2 (57 runs) and the run tier's 16,384 on the million words (64 runs)
FT_CHUNK = 4096
FT_BIG_CHUNK = 16_384
# phase 5: the mesh chunked sort's destinations on this card, the gloo
# ranks of the engine run, the chaos soak's seeds, the engine inputs' seed
MESH_DESTS = 8
MESH_RANKS = 4
MESH_SOAK_SEEDS = 25
MESH_SEED = 11
# phase 6: Granite-MoE 1B served at full width, its admission queues (B1,
# B2, blocksort), one full-width prefill batch's length, and the tolerance
# of its logits between the 'pallas' and 'xla' dispatch, whose permutations
# are equal: two bf16 forwards of the same permutations (at 2^-3, 16 bf16
# steps at 1.0)
SERVE_ARCH = "granite-moe-1b-a400m"
SERVE_REQUESTS = 32
SERVE_MAX_NEW = 16
SERVE_BATCH = 8
SERVE_MAX_SEQ = 1024
ADMISSION_QUEUES = (32, 200, 2000)
DISPATCH_SEQ = 512
DISPATCH_LOGIT_ATOL = 0.125
# the kernels of the serving path: the admission sort and the MoE dispatch
SERVE_PATH = ("oets_rows_lex", "bitonic_rows_lex", "merge_adjacent_lex")
# phase 6's smoke prompt lengths, and a 2-token prompt whose Mamba2 conv
# window is the batch's padding rows (the reference's wrapped slice)
SMOKE_PROMPTS = (3, 17, 9, 30, 2)
# phase 7: the full-width MLA and hybrid archs, deepseek-v2 cut to its
# dense layer and two MoE layers, and the archs held card against CPU
FAMILY_ARCHS = ("minicpm3-4b", "zamba2-1.2b")
DEEPSEEK_ARCH = "deepseek-v2-236b"
DEEPSEEK_LAYERS = 3
DEEPSEEK_DECODE_STEPS = 4
SMOKE_ARCHS = ("minicpm3-4b", "deepseek-v2-236b", "mamba2-370m",
               "zamba2-1.2b", "glm4-9b")

# phase 8: training — Granite-MoE 1B at full width through train_loop with
# a failure and a resume, one step with each dispatch, Zamba2-1.2B at full
# width, and the smoke configs on the card against the CPU
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_STEPS = 8
TRAIN_BATCH = 8
TRAIN_SEQ = 512
TRAIN_CKPT_EVERY = 4
TRAIN_FAIL_AT = (6,)
TRAIN_HYPER = dict(lr=1e-4, warmup=2, total_steps=TRAIN_STEPS,
                   sort_impl="pallas")
TRAIN_PATH = ("bitonic_rows_lex", "merge_adjacent_lex")
ZAMBA_ARCH = "zamba2-1.2b"
ZAMBA_STEPS = 4
ZAMBA_HYPER = dict(lr=1e-3, warmup=1, total_steps=ZAMBA_STEPS)
TRAIN_SMOKE_ARCHS = ("glm4-9b", "granite-moe-1b-a400m", "minicpm3-4b",
                     "mamba2-370m", "zamba2-1.2b", "musicgen-large",
                     "qwen2-vl-2b")
TRAIN_SMOKE_STEPS = 3
TRAIN_SMOKE_SHAPE = (2, 32)           # 128 assignments: the B1 tier
# card against CPU in float32 with TF32 off (the port makes no cuDNN
# call): cuBLAS and the CPU sum in other orders, ~1e-6 relative a product,
# and AdamW's first update is sign(g) * lr, so an element whose gradient is
# near 0 may move by 2 * lr on one side only; three steps keep the losses
# within 1e-4 and the gradient norms within 5e-4 (both under 1e-3)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GNORM_RTOL = 5e-4

# phase 9: the parallel plan, 4 gloo ranks of this card as (data 2, model 2)
PLAN_RANKS = 4
PLAN_MESH = ((2, 2), ("data", "model"))
PLAN_ARCH = "granite-moe-1b-a400m"
PLAN_DECODE_STEPS = 4
PLAN_DECODE_SEQ = 1024
PLAN_PATH = ("oets_rows_lex", "bitonic_rows_lex", "merge_adjacent_lex")
PLAN_SMOKE_SHAPE = (8, 64)
# the plan is held in float32 at Granite's full width and depth, block by
# block: in the sharded run each block and the head take the unsharded
# run's input, since this random-init model amplifies a float32 rounding
# ~1.4x a layer (its decode logits 7e-3 apart after 24 layers with no
# routing change) and a routing change is a jump (in float32 2 assignments
# of layer 0's change, then 86% of layer 23's when the blocks feed each
# other: PERF.md). Each block's output is compared, relative to its largest
# element, at the tokens whose experts are unchanged there: a reordered
# float32 sum rounds at ~1e-6, a misplaced or unreduced shard is off by
# ~1e-2 to 1. At each layer at most PLAN_F32_FLIPS (a count, or that
# share) of the assignments may move to another expert (a rounding moves a
# few near a tie, a misplaced router most)
PLAN_F32_RTOL = 1e-3
PLAN_F32_FLIPS = (4, 0.01)
PLAN_F32_SEQ = 256
PLAN_F32_STEP_LAYERS = 2
# one float32 train step sharded against unsharded at lr 1e-3 (step 1 after
# a one-step warm-up: AdamW's first update moves each element by ~1e-3,
# lr * sign(g)): each element's change within PLAN_DELTA_ATOL of the
# unsharded step's, but where a gradient element lies within rounding of 0
# and changes sign. At Granite's full width one float32 ulp moves the
# gradients by ~1e-3 of a leaf's largest and so ~4e-5 of the elements
# (PERF.md; the step prints this floor); a skipped or sign-flipped update
# is off at most of a leaf's elements, a wrong gradient in its moments by
# ~1 of the largest
PLAN_STEP_HYPER = dict(lr=1e-3, warmup=1, total_steps=5, sort_impl="pallas")
PLAN_DELTA_ATOL = 5e-5
PLAN_LEAF_OUTLIERS = (8, 1e-2)        # a count, or that share of a leaf
PLAN_STEP_OUTLIERS = 1e-3             # the share of all elements
PLAN_MOMENT_RTOL = 1e-2
PLAN_SMOKE_ARCHS = ("glm4-9b", "minicpm3-4b", "zamba2-1.2b")
PLAN_SMOKE_ATOL = 2e-3                # the CPU tests' (float32)
PLAN_EP_TOKENS = 4 * 512              # a rank's tokens
PLAN_EP_CAPACITY = 4.0                # 2,048 slots an expert: none drops
PLAN_TIMEOUT = 420
# phase 9's serving through Engine.generate on the sharded LM (C8)
PLAN_GEN_PROMPTS = (5, 17, 9, 30, 12, 3, 24, 8)
PLAN_GEN_NEW = 4
PLAN_GEN_MAX_SEQ = 64

# phase 10: the launch layer and the conformance kit — the card's own
# properties against hw's data sheet (memory within HW_MEMORY_RTOL), the
# conformance matrix in every mode (B1-B6 launched), and the dry run of
# Granite at full width on fake (1, 1) and (2, 2) meshes at phase 8's train
# cell and phase 6's prefill cell; phase 9 measured 742,891,520 B of
# parameters a rank of the (2, 2) mesh on the card
HW_MEMORY_RTOL = 0.1
CONFORMANCE_KERNELS = ("oets_rows_lex", "bitonic_rows_lex", "distribute_rows",
                       "merge_adjacent_lex", "merge_runs_lex",
                       "merge_runs_kway")
DRYRUN_ARCH = "granite-moe-1b-a400m"
DRYRUN_MESHES = ((1, 1), (2, 2))
DRYRUN_PARAM_BYTES = {(2, 2): 742_891_520}

# phase 11: the examples of repro_torch.examples, each with the kernels it
# must launch (the 8-rank ones counted over their ranks; train_lm's glm4-9b
# smoke config is dense, and moe_expert_parallel sorts its dispatch with
# torch.argsort in ep_moe and moe's 'xla' path, as the reference's
# example does, so neither reaches a kernel), and the CLIs at
# the published configs no other phase runs: two served (24 requests, 8 new
# tokens, max_seq 128), two trained (4 steps of 4 x 32)
EXAMPLES = (
    ("quickstart", (), ("oets_rows_lex", "distribute_rows",
                        "merge_runs_kway")),
    ("serve_lm", (), ("oets_rows_lex",)),
    ("train_lm", ("--steps", "300", "--fail-at", "150"), ()),
    ("distributed_sort", (), ("oets_rows_lex", "bitonic_rows_lex",
                              "merge_adjacent_lex", "merge_runs_lex")),
    ("moe_expert_parallel", (), ()),
)
CLI_SERVE_ARCHS = ("glm4-9b", "mamba2-370m")
CLI_REQUESTS = 24
CLI_MAX_NEW = 8
CLI_TRAIN_ARCHS = ("qwen2-vl-2b", "musicgen-large")
CLI_TRAIN_STEPS = 4


def cuda_time(fn, iters: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn(i)`` from CUDA events around ``iters``
    calls after ``warmup`` calls."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time(kernel_name: str, fn, iters: int = KERNEL_ITERS,
                tries: int = 3):
    """Device milliseconds per call of ``fn(i)`` spent in the CUDA functions
    of ``kernel_name`` (:data:`DEVICE_NAMES`), where the number comes from,
    and its split by function: ``torch.profiler``'s CUDA time by kernel
    name over ``iters`` calls after a warm-up ('profiler'), or, where no
    window shows every launch, CUDA events around the replay of a CUDA
    graph of ``iters`` calls, which takes the host's launch cost out of the
    window ('graph events', no split). Every call launches each of its
    functions the same number of times, so a window in which some
    function's event count is not a multiple of ``iters`` (or that shows no
    device time) lost events, and is traced again, up to ``tries``
    windows: a window that lost most of B6's events read it at a quarter
    of its time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    names = DEVICE_NAMES[kernel_name]
    fn(0)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        split, whole = {}, True
        for ev in prof.key_averages():
            name = next((n for n in names if n in ev.key), None)
            if name is not None:
                t = getattr(ev, "device_time_total", None)
                t = t if t is not None else ev.cuda_time_total
                split[name] = split.get(name, 0.0) + t / iters / 1e3
                whole = whole and ev.count % iters == 0
        if whole and sum(split.values()) > 0:
            return sum(split.values()), "profiler", split
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    return (cuda_time(lambda i: graph.replay(), 5, 1) / iters,
            "graph events", None)


def device_fields(kernel_name: str, fn) -> dict:
    """``device_ms`` and its source, and for a kernel of more than one CUDA
    function its split by function."""
    ms, source, split = device_time(kernel_name, fn)
    out = {"device_ms": ms, "device_ms_source": source}
    if split and len(DEVICE_NAMES[kernel_name]) > 1:
        out["device_ms_by_function"] = split
    return out


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def shortlex(words):
    return sorted(words, key=lambda w: (len(w.encode()), w.encode()))


def lib_sort(x, keys):
    """The rows of stacked ``x`` ``(A, R, C)`` sorted by stacked int32
    ``keys`` (signed lex order) through a chain of stable ``torch.sort``
    passes from the last lane to the first — the library yardstick."""
    import torch
    perm = torch.arange(x.shape[-1], device=x.device).expand(
        x.shape[1], -1).contiguous()
    for a in reversed(range(keys.shape[0])):
        _, idx = torch.sort(keys[a].gather(-1, perm), dim=-1, stable=True)
        perm = perm.gather(-1, idx)
    return torch.stack([lane.gather(-1, perm) for lane in x])


def bits_err(a, b) -> int:
    """Largest difference between two int32 bit tensors read as uint32."""
    import torch
    if a.numel() == 0:
        return 0
    return int(((a.to(torch.int64) & 0xFFFFFFFF)
                - (b.to(torch.int64) & 0xFFFFFFFF)).abs().max())


class Report:
    """Per-kernel numbers for the final JSON line: one row for every kernel
    of the package."""

    def __init__(self):
        from repro_torch.kernels import KERNELS
        self.rows = {k.name: {
            "name": k.name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{k.source}",
            "replaces": k.replaces, "launches": 0, "max_abs_err": 0}
            for k in KERNELS.values()}
        # phase 8's measured peak, beside phase 10's predicted one
        self.train_peak = None

    def add(self, kernel, err: int, **numbers):
        row = self.rows[kernel.name]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row.update(numbers)


def bound(bytes_moved: float, ops: float) -> dict:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NON_TENSOR_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# --- phase 1 ----------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] nvcc for sm_90a, {len(_build.SOURCES)} sources in "
          f"parallel: {time.perf_counter() - t0:.1f} s")
    for source, text in _build.ptxas_report().items():
        for line in text.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "error", "warning")):
                print(f"[build] {source}: {line.strip()}")


# --- phase 2 ----------------------------------------------------------------

def stacked_buckets(keys_np, device, width=None):
    """The main path's sort input for packed words: the bucket tensor masked
    past each count and stacked lane-major ``(lanes, buckets, width)``,
    ``width`` a function of the capacity (default: the capacity)."""
    import torch
    from repro_torch import to_device
    from repro_torch.kernels import lex, ops
    keys = to_device(keys_np, device)
    buckets, counts, _ = ops.bucketize(keys)
    bits = lex.as_bits(buckets)
    cap = int(counts.max())
    bits = bits[:, :cap]
    slot = torch.arange(cap, device=device)
    bits = torch.where((slot[None, :] >= counts[:, None])[..., None], -1, bits)
    n_lanes = bits.shape[2]
    return ops._pad_stack([bits[..., l] for l in range(n_lanes)],
                          [lex.U32] * n_lanes, width(cap) if width else cap)


def adversarial(kind, shape, rng, device):
    """``(x, codes)``: a stacked input of ``shape`` = (lanes, rows, cols)."""
    import numpy as np
    import torch
    from repro_torch.kernels import lex
    a, r, c = shape
    if kind == "sentinel":
        v = rng.integers(0, 1 << 32, (a, r, c), dtype=np.uint64)
        v[rng.random((a, r, c)) < 0.3] = 0xFFFFFFFF
        codes = [lex.U32] * a
    elif kind == "dup_heavy":
        v = rng.integers(0, 4, (a, r, c), dtype=np.uint64)
        codes = [lex.U32] * a
    else:  # float32 key lanes with NaN/±0/±inf, an int32 lane, a payload
        f = rng.normal(scale=10.0, size=(a - 1, r, c)).astype(np.float32)
        pick = rng.random(f.shape)
        f[pick < 0.15] = np.inf
        f[(pick >= 0.15) & (pick < 0.25)] = -np.inf
        f[(pick >= 0.25) & (pick < 0.35)] = 0.0
        f[(pick >= 0.35) & (pick < 0.45)] = -0.0
        pats = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7F800001,
                         0xFFFFFFFF], np.uint32).view(np.float32)
        nan = pick >= 0.85
        f[nan] = pats[rng.integers(0, len(pats), int(nan.sum()))]
        v = f.view(np.uint32).astype(np.uint64)
        v[-1] = rng.integers(-3, 3, (r, c)).astype(np.int32).view(np.uint32)
        payload = np.stack([rng.permutation(c) for _ in range(r)])[None]
        v = np.concatenate([v, payload.astype(np.uint64)])
        codes = [lex.F32] * (a - 2) + [lex.I32, lex.I32]
    x = torch.from_numpy(v.astype(np.uint32).view(np.int32)).to(device)
    return x.contiguous(), codes


def check_sorted(kernel_name, x_in, out, codes):
    """``out`` must hold the rows of ``x_in`` in total order: its order keys
    equal those of the library sort, and each row's tuples are a bit-level
    permutation of the input row's."""
    import torch
    from repro_torch.kernels import lex
    ref = lib_sort(x_in, lex.order_keys(x_in, codes))
    if not torch.equal(lex.order_keys(out, codes), lex.order_keys(ref, codes)):
        raise AssertionError(f"{kernel_name}: output not in total order")
    if not torch.equal(lib_sort(out, out), lib_sort(x_in, x_in)):
        raise AssertionError(f"{kernel_name}: output is not a permutation "
                             "of the input")


def check_row_kernel(kernel, wrapper, plain, x, codes, label, **kw):
    """Kernel vs plain version (bits) and vs the library sort (order);
    returns the bit error. ``kw`` goes to the wrapper (the merge block)."""
    import torch
    got = wrapper(x.clone(), codes, **kw)
    want = plain(x.clone(), codes, **kw)
    torch.cuda.synchronize()
    err = bits_err(got, want)
    print(f"[kernels] {kernel.name} {label} {tuple(x.shape)}: "
          f"max_abs_err {err}")
    if err:
        raise AssertionError(f"{kernel.name} {label}: kernel and plain "
                             "version differ")
    return err, got


def time_row_kernel(kernel, wrapper, plain, lib, x, codes, **kw):
    """Kernel over distinct fresh copies (in place), its device time over
    the same calls, plain version, library."""
    copies = [x.clone() for _ in range(min(KERNEL_ITERS, 8))]

    def call(i):
        return wrapper(copies[i % len(copies)].copy_(x), codes, **kw)

    ms = cuda_time(call, KERNEL_ITERS)
    copy_ms = cuda_time(lambda i: copies[i % len(copies)].copy_(x),
                        KERNEL_ITERS)
    device = device_fields(kernel.name, call)
    plain_ms = cuda_time(lambda i: plain(x, codes, **kw), PLAIN_ITERS, 1)
    library_ms = cuda_time(lambda i: lib(x), KERNEL_ITERS)
    return {"ms": ms - copy_ms, **device, "plain_ms": plain_ms,
            "library_ms": library_ms}


def merge_sweep(device) -> int:
    """B4 against its plain version at every power-of-two block from 1 to
    the shared-memory cap, at offsets 0 and ``block``, for every lane count
    of :data:`SWEEP_LANES` and each code and fill: the in-thread,
    shuffle and shared-memory stages of its network, and the register-only
    kernel. Returns the largest bit error."""
    import numpy as np
    import torch
    from repro_torch.kernels import adversarial, lex, merge_kernel
    rng = np.random.default_rng(4)
    worst = 0
    for n in SWEEP_LANES:
        cap = merge_kernel.max_merge_block(n)
        for code_name, code in (("u32", lex.U32), ("i32", lex.I32),
                                ("f32", lex.F32)):
            codes = [code] * n
            for fill in adversarial.FILLS:
                err, block = 0, 1
                while block <= cap:
                    x = torch.from_numpy(adversarial.lane_bits(
                        rng, (n, 3, 7 * block), code, fill)).to(device)
                    xb = x.view(n, -1, block)
                    x = lib_sort(xb, lex.order_keys(xb, codes)).reshape(
                        n, 3, -1).contiguous()
                    for lo in (0, block):
                        got = merge_kernel.merge_adjacent_lex(
                            x.clone(), codes, block=block, lo=lo)
                        want = x.clone()
                        want[..., lo:lo + 6 * block] = \
                            merge_kernel.merge_network_plain(
                                x[..., lo:lo + 6 * block], codes, block)
                        torch.cuda.synchronize()
                        err = max(err, bits_err(got, want))
                    block *= 2
                print(f"[kernels] merge_adjacent_lex sweep {n} lanes "
                      f"{code_name} {fill}, blocks 1..{cap}, lo 0 and "
                      f"block: max_abs_err {err}")
                if err:
                    raise AssertionError(f"merge_adjacent_lex sweep {n} "
                                         f"{code_name} {fill}: kernel and "
                                         "plain version differ")
                worst = max(worst, err)
    return worst


def bitonic_sweep(device) -> int:
    """B2 against its plain version at every power-of-two column count from
    1 to the shared-memory cap, for every lane count of :data:`SWEEP_LANES`
    and each code and fill: the register-only kernel (up to 128 columns),
    then the in-thread, shuffle and shared-memory stages of the window
    kernel. Returns the largest bit error."""
    import numpy as np
    import torch
    from repro_torch.kernels import adversarial, bitonic_kernel, lex
    from repro_torch.kernels._build import SMEM_LIMIT
    rng = np.random.default_rng(6)
    worst = 0
    for n in SWEEP_LANES:
        cap = 1 << ((SMEM_LIMIT // (4 * n)).bit_length() - 1)
        for code_name, code in (("u32", lex.U32), ("i32", lex.I32),
                                ("f32", lex.F32)):
            codes = [code] * n
            for fill in adversarial.FILLS:
                err, cols = 0, 1
                while cols <= cap:
                    x = torch.from_numpy(adversarial.lane_bits(
                        rng, (n, 3, cols), code, fill)).to(device)
                    got = bitonic_kernel.bitonic_rows_lex(x.clone(), codes)
                    want = bitonic_kernel.bitonic_rows_lex_plain(x, codes)
                    torch.cuda.synchronize()
                    err = max(err, bits_err(got, want))
                    cols *= 2
                print(f"[kernels] bitonic_rows_lex sweep {n} lanes "
                      f"{code_name} {fill}, columns 1..{cap}: max_abs_err "
                      f"{err}")
                if err:
                    raise AssertionError(f"bitonic_rows_lex sweep {n} "
                                         f"{code_name} {fill}: kernel and "
                                         "plain version differ")
                worst = max(worst, err)
    return worst


def distribute_sweep(device) -> int:
    """B3 against its plain version at every word count of
    :data:`DISTRIBUTE_SWEEP_N`, for 1 to 8 lanes and each fill of
    ``adversarial.WORD_FILLS``, with ``n_valid`` 0, ``n - 777`` (where
    positive) and ``n``; at 4 and 8 lanes also words that are not 16-byte
    aligned (the scalar loads). Returns the largest error."""
    import numpy as np
    import torch
    from repro_torch.kernels import adversarial, distribute_kernel as dk
    rng = np.random.default_rng(7)
    worst = 0
    top = max(DISTRIBUTE_SWEEP_N)
    for lanes in range(1, 9):
        for fill in adversarial.WORD_FILLS:
            words = torch.from_numpy(adversarial.packed_words(
                rng, top, lanes, fill)).to(device)
            err = 0
            for n in DISTRIBUTE_SWEEP_N:
                cases = [words[:n]]
                if lanes % 4 == 0 and n == 1025:
                    shifted = torch.empty(n * lanes + 1, dtype=torch.int32,
                                          device=device)
                    cases.append(shifted[1:].view(n, lanes).copy_(words[:n]))
                for keys in cases:
                    for n_valid in sorted({0, max(n - 777, 0), n}):
                        got = dk.distribute_rows(keys, n_valid)
                        want = dk.distribute_rows_plain(keys, n_valid)
                        torch.cuda.synchronize()
                        err = max(err, max(bits_err(g, w)
                                           for g, w in zip(got, want)))
            print(f"[kernels] distribute_rows sweep {lanes} lanes {fill}, "
                  f"n {DISTRIBUTE_SWEEP_N[0]}..{top}, n_valid 0, n - 777 and "
                  f"n: max_abs_err {err}")
            if err:
                raise AssertionError(f"distribute_rows sweep {lanes} lanes "
                                     f"{fill}: kernel and plain version "
                                     "differ")
            worst = max(worst, err)
    return worst


def oets_sweep(device) -> int:
    """B1 against its plain version for every lane count of
    :data:`SWEEP_LANES`, each code and fill, at every row count of
    :data:`OETS_SWEEP_ROWS` and column count of :data:`OETS_SWEEP_COLS`:
    the warp kernel and the shared-memory kernel. Each output must also be
    the stable sort (a chain of stable ``torch.sort`` passes), which
    adjacent swaps on a strict compare give. Returns the largest bit
    error."""
    import numpy as np
    import torch
    from repro_torch.kernels import adversarial, lex, oets_kernel
    rng = np.random.default_rng(8)
    worst = 0
    for n in SWEEP_LANES:
        for code_name, code in (("u32", lex.U32), ("i32", lex.I32),
                                ("f32", lex.F32)):
            codes = [code] * n
            for fill in adversarial.FILLS:
                err = 0
                for rows in OETS_SWEEP_ROWS:
                    for cols in OETS_SWEEP_COLS:
                        x = torch.from_numpy(adversarial.lane_bits(
                            rng, (n, rows, cols), code, fill)).to(device)
                        got = oets_kernel.oets_rows_lex(x.clone(), codes)
                        want = oets_kernel.oets_rows_lex_plain(x, codes)
                        stable = lib_sort(x, lex.order_keys(x, codes))
                        torch.cuda.synchronize()
                        err = max(err, bits_err(got, want))
                        if not torch.equal(got, stable):
                            raise AssertionError(
                                f"oets_rows_lex sweep {n} {code_name} {fill} "
                                f"({rows}, {cols}): not the stable sort")
                print(f"[kernels] oets_rows_lex sweep {n} lanes {code_name} "
                      f"{fill}, rows {OETS_SWEEP_ROWS} x columns "
                      f"{OETS_SWEEP_COLS}: max_abs_err {err}")
                if err:
                    raise AssertionError(f"oets_rows_lex sweep {n} "
                                         f"{code_name} {fill}: kernel and "
                                         "plain version differ")
                worst = max(worst, err)
    return worst


def runmerge_sweep(device) -> int:
    """B5's split and merge against their plain versions for every
    compare-lane count from 1 to ``MAX_CMP_LANES`` and each fill, at every
    co-rank edge of ``adversarial.MERGE_EDGES`` (empty runs, runs of one
    element, equal runs, one run wholly below the other, totals on and off
    a block multiple) and blocks :data:`MERGE_SWEEP_BLOCKS`: the starts
    bit for bit, the merged lanes bit for bit. Returns the largest bit
    error."""
    import numpy as np
    import torch
    from repro_torch.kernels import adversarial, runmerge_kernel as rk
    rng = np.random.default_rng(9)
    worst = 0
    for n_cmp in range(1, rk.MAX_CMP_LANES + 1):
        for fill in adversarial.FILLS:
            err = 0
            for edge in adversarial.MERGE_EDGES:
                a, b, codes = adversarial.merge_case(rng, n_cmp, fill, edge)
                da, db = (torch.from_numpy(np.stack(r)).to(device)
                          for r in (a, b))
                sa, sb = da[:n_cmp], db[:n_cmp]
                for block in MERGE_SWEEP_BLOCKS:
                    starts = rk.merge_path_starts(sa, sb, block, codes)
                    want = rk.merge_path_starts_plain(sa, sb, codes, block)
                    got = rk.runmerge(sa, sb, da, db, starts, codes, block)
                    ref = rk.runmerge_plain(sa, sb, da, db, want, codes,
                                            block)
                    torch.cuda.synchronize()
                    err = max(err, bits_err(starts, want), bits_err(got, ref))
            print(f"[kernels] merge_runs_lex sweep {n_cmp} compare lanes "
                  f"{fill}, edges {'/'.join(adversarial.MERGE_EDGES)}, "
                  f"blocks {MERGE_SWEEP_BLOCKS}: split and merge "
                  f"max_abs_err {err}")
            if err:
                raise AssertionError(f"merge_runs_lex sweep {n_cmp} {fill}: "
                                     "kernels and plain versions differ")
            worst = max(worst, err)
    return worst


def kway_sweep(device) -> int:
    """The k-way split's rounds, the gather and B6 against their plain
    versions at every run count of ``adversarial.KWAY_SWEEP`` (2 to
    ``MAX_RUNS``) for each fill, on runs of 0 to 90 elements (empty and
    one-element runs among them), blocks :data:`MERGE_SWEEP_BLOCKS`: the
    cursors bit for bit those of the plain split and of the torch oracle
    (``kway_cursors(kway_ranks(...))``), the gathered lanes the plain
    concatenation's, the merge the plain merge tree's. Returns the largest
    bit error."""
    import numpy as np
    import torch
    from repro_torch import to_device
    from repro_torch.kernels import adversarial, kway_kernel as kk
    worst = 0
    for k in adversarial.KWAY_SWEEP:
        for fill in adversarial.FILLS:
            rng = np.random.default_rng([k, len(fill), 17])
            n_cmp = 1 + k % 5
            runs, codes = adversarial.kway_case(rng, n_cmp, fill, k, 90)
            runs = [tuple(to_device(r, device)) for r in runs]
            ns = [r[0].shape[0] for r in runs]
            oracle = kk.kway_ranks([r[:n_cmp] for r in runs])
            err = 0
            for block in MERGE_SWEEP_BLOCKS:
                cmp, data, cursors, _ = kk.kway_operands(runs, n_cmp, None,
                                                         block)
                got = kk.kway_merge(cmp, data, cursors, codes, block)
                flat = kk.kway_gather_plain(runs)
                plain = kk.kway_starts_plain(flat[:n_cmp], ns, codes, block)
                want = kk.kway_merge_plain(flat[:n_cmp], flat, plain, codes,
                                           block)
                torch.cuda.synchronize()
                err = max(err, bits_err(data, flat), bits_err(cursors, plain),
                          bits_err(cursors, kk.kway_cursors(oracle, block)),
                          bits_err(got, want))
            print(f"[kernels] kway_split sweep k={k} {fill}, {n_cmp} compare "
                  f"lanes, blocks {MERGE_SWEEP_BLOCKS}: split (plain and "
                  f"oracle), gather and merge max_abs_err {err}")
            if err:
                raise AssertionError(f"k-way sweep k={k} {fill}: kernels and "
                                     "plain versions differ")
            worst = max(worst, err)
    return worst


def phase_kernels(report, device, ds2_keys, chunk500_keys, chunk3000_keys):
    import numpy as np
    import torch
    from repro_torch.core.blocksort import default_block_size
    from repro_torch.kernels import (bitonic_kernel, distribute_kernel, lex,
                                     merge_kernel, oets_kernel, ops)
    rng = np.random.default_rng(0)
    U4 = [lex.U32] * 4

    def plain_oets(x, codes):
        return oets_kernel.oets_rows_lex_plain(x, codes)

    def plain_bitonic(x, codes):
        return bitonic_kernel.bitonic_rows_lex_plain(x, codes)

    def plain_merge(x, codes, block):
        return merge_kernel.merge_network_plain(x, codes, block)

    def merge(x, codes, block):
        return merge_kernel.merge_adjacent_lex(x, codes, block=block)

    # B1 at the OETS tier's shape: the 500-word chunk's buckets, width 128
    x = stacked_buckets(chunk500_keys, device, lambda cap: 128)
    k = oets_kernel.KERNEL
    err, got = check_row_kernel(k, oets_kernel.oets_rows_lex, plain_oets, x,
                                U4, "chunk-500 buckets")
    check_sorted(k.name, x, got, U4)
    for kind in ("sentinel", "dup_heavy", "float"):
        xa, ca = adversarial(kind, (5 if kind == "float" else 4,) + x.shape[1:],
                             rng, device)
        e, got = check_row_kernel(k, oets_kernel.oets_rows_lex, plain_oets,
                                  xa, ca, kind)
        check_sorted(k.name, xa, got, ca)
        err = max(err, e)
    err = max(err, oets_sweep(device))
    a, r, c = x.shape
    report.add(k, err, shape=list(x.shape),
               **time_row_kernel(k, oets_kernel.oets_rows_lex, plain_oets,
                                 lambda t: lib_sort(t, t ^ (-1 << 31)), x, U4),
               **bound(2 * a * r * c * 4, r * c * (c - 1) // 2 * a))

    # B2 as the bitonic tier (3,000-word chunk) and as blocksort's local
    # sort at DS2 (the timed shape)
    k = bitonic_kernel.KERNEL
    x = stacked_buckets(chunk3000_keys, device, ops._next_pow2)
    err, got = check_row_kernel(k, bitonic_kernel.bitonic_rows_lex,
                                plain_bitonic, x, U4, "chunk-3000 buckets")
    check_sorted(k.name, x, got, U4)
    sizes = {}

    def blocks(cap):
        sizes["block"] = default_block_size(cap, n_arrays=4)
        sizes["nb"] = -(-cap // sizes["block"])
        return sizes["nb"] * sizes["block"]

    x = stacked_buckets(ds2_keys, device, blocks)
    block, nb = sizes["block"], sizes["nb"]
    xl = x.view(4, -1, block)
    e, got = check_row_kernel(k, bitonic_kernel.bitonic_rows_lex,
                              plain_bitonic, xl, U4, "DS2 local blocks")
    check_sorted(k.name, xl, got, U4)
    err = max(err, e)
    for kind in ("sentinel", "dup_heavy", "float"):
        xa, ca = adversarial(kind, (5 if kind == "float" else 4, 64, block),
                             rng, device)
        e, got = check_row_kernel(k, bitonic_kernel.bitonic_rows_lex,
                                  plain_bitonic, xa, ca, kind)
        check_sorted(k.name, xa, got, ca)
        err = max(err, e)
    # the run tier's chunk shape: a 4096-word chunk bucketed at capacity
    # 4096, blocksort's local sort at its block
    run_block = default_block_size(4096, n_arrays=4)
    xr = stacked_buckets(ds2_keys[:4096], device, lambda cap: 4096).view(
        4, -1, run_block)
    e, got = check_row_kernel(k, bitonic_kernel.bitonic_rows_lex,
                              plain_bitonic, xr, U4, "run-tier chunk blocks")
    check_sorted(k.name, xr, got, U4)
    err = max(err, e, bitonic_sweep(device))

    def bitonic_bound(t):
        a, r, c = t.shape
        m = c.bit_length() - 1
        return bound(2 * a * r * c * 4, r * (c // 2) * m * (m + 1) // 2 * a)

    def lib(t):
        return lib_sort(t, t ^ (-1 << 31))

    run_tier = time_row_kernel(k, bitonic_kernel.bitonic_rows_lex,
                               plain_bitonic, lib, xr, U4)
    run_tier.update(bitonic_bound(xr))
    print(f"[kernels] {k.name} run-tier chunk {tuple(xr.shape)}: " + ", ".join(
        f"{key} {run_tier.get(key)}" for key in (
            "ms", "device_ms", "device_ms_source", "device_ms_by_function",
            "plain_ms", "library_ms", "bound_ms")))
    report.add(k, err, shape=list(xl.shape),
               **time_row_kernel(k, bitonic_kernel.bitonic_rows_lex,
                                 plain_bitonic, lib, xl, U4),
               **bitonic_bound(xl), run_tier_shape=list(xr.shape),
               run_tier={key: run_tier[key] for key in (
                   "ms", "device_ms", "device_ms_source", "plain_ms",
                   "library_ms", "bound_ms")})

    # B4 at DS2: the first (even) merge round over the locally sorted blocks
    k = merge_kernel.KERNEL
    xs = bitonic_kernel.bitonic_rows_lex(xl.clone(), U4).view(4, x.shape[1], -1)
    npairs = nb // 2
    xm = xs[:, :, :npairs * 2 * block].contiguous()
    err, got = check_row_kernel(k, merge, plain_merge, xm, U4,
                                f"DS2 round, block {block}", block=block)
    check_sorted(k.name, xm.view(4, -1, 2 * block),
                 got.view(4, -1, 2 * block), U4)
    for kind in ("sentinel", "dup_heavy", "float"):
        xa, ca = adversarial(kind, (5 if kind == "float" else 4, 32, block),
                             rng, device)
        xa = bitonic_kernel.bitonic_rows_lex(xa, ca).view(xa.shape[0], 16, -1)
        e, got = check_row_kernel(k, merge, plain_merge, xa, ca, kind,
                                  block=block)
        check_sorted(k.name, xa, got, ca)
        err = max(err, e)
    err = max(err, merge_sweep(device))
    a, r, c = xm.shape
    report.add(k, err, shape=list(xm.shape), block=block,
               **time_row_kernel(
                   k, merge, plain_merge,
                   lambda t: lib_sort(t.view(a, -1, 2 * block),
                                      t.view(a, -1, 2 * block) ^ (-1 << 31)),
                   xm, U4, block=block),
               **bound(2 * a * r * c * 4,
                       r * (c // 2) * (block.bit_length()) * a))

    # B3 at DS2: the packed words, plus words with interior NUL bytes and
    # 0xFF bytes and a padded tail
    k = distribute_kernel.KERNEL
    from repro_torch import to_device
    keys = lex.as_bits(to_device(ds2_keys, device)).contiguous()
    raw = rng.integers(0, 1 << 32, (100_003, 4), dtype=np.uint64)
    byte_mask = rng.random((100_003, 4, 4)) < 0.5
    for j in range(4):
        raw &= ~(byte_mask[..., j].astype(np.uint64) << (24 - 8 * j))
    adv = torch.from_numpy(raw.astype(np.uint32).view(np.int32)).to(device)
    err = 0
    for label, kk, n_valid in (("DS2 words", keys, keys.shape[0]),
                               ("NUL/0xFF bytes, padded tail", adv,
                                adv.shape[0] - 777)):
        got = distribute_kernel.distribute_rows(kk, n_valid)
        want = distribute_kernel.distribute_rows_plain(kk, n_valid)
        torch.cuda.synchronize()
        e = max(bits_err(g, w) for g, w in zip(got, want))
        hist = torch.bincount(got[0][:n_valid].long(), minlength=17)[:17]
        print(f"[kernels] {k.name} {label} {tuple(kk.shape)}: "
              f"max_abs_err {e}")
        if e or not torch.equal(hist.to(torch.int32), got[2]):
            raise AssertionError(f"{k.name} {label}: kernel and plain "
                                 "version differ")
        err = max(err, e)
    err = max(err, distribute_sweep(device))

    def distribute_times(words):
        n = words.shape[0]
        return dict(
            ms=cuda_time(lambda i: distribute_kernel.distribute_rows(words),
                         KERNEL_ITERS),
            **device_fields(k.name, lambda i: distribute_kernel.distribute_rows(
                words)),
            plain_ms=cuda_time(lambda i: distribute_kernel.distribute_rows_plain(
                words, n), PLAIN_ITERS, 1),
            library_ms=None,
            **bound(n * 4 * 4 + 2 * n * 4 + 17 * 4, n * 4))

    # the run tier's chunk: 4096 words, four tiles
    chunk = distribute_times(keys[:4096])
    print(f"[kernels] {k.name} run-tier chunk (4096, 4): " + ", ".join(
        f"{key} {chunk.get(key)}" for key in (
            "ms", "device_ms", "device_ms_source", "device_ms_by_function",
            "plain_ms", "bound_ms")))
    report.add(k, err, shape=list(keys.shape), **distribute_times(keys),
               run_tier_shape=[4096, 4],
               run_tier={key: chunk[key] for key in (
                   "ms", "device_ms", "device_ms_source", "plain_ms",
                   "bound_ms")})
    for name in MAIN_PATH:
        row = report.rows[name]
        print(f"[kernels] {name}: " + ", ".join(
            f"{key} {row.get(key)}" for key in (
                "shape", "ms", "device_ms", "device_ms_by_function",
                "plain_ms", "library_ms", "bound_ms", "bound_by")))


def ext_runs(keys, device, chunk=4096):
    """Packed words chunked at ``chunk`` and sorted on the card: the runs
    the run tier merges, as extended tuples (compare lanes, then data
    lanes), and the compare-lane count."""
    from repro_torch.pipeline import sorted_run
    runs = [sorted_run(keys[s:s + chunk], capacity=chunk, device=device)
            for s in range(0, len(keys), chunk)]
    ext = [tuple(r.cmp_lanes()) + tuple(r.lanes()) for r in runs]
    return ext, len(ext[0]) - len(runs[0].lanes())


def sorted_lanes_runs(kind, sizes, rng, device):
    """Sorted runs of an adversarial ``kind`` on the card and the
    compare-lane count to merge them with (None: pack them)."""
    import numpy as np
    import torch
    from repro_torch import to_device
    from repro_torch.core import packing
    from repro_torch.pipeline import sorted_run
    from repro_torch.pipeline.validate import order_bits_view
    if kind == "words-32-bytes":
        runs = []
        for n in sizes:
            words = ["".join(rng.choice(list("abcz"), int(ln)))
                     for ln in rng.integers(1, 33, n)]
            r = sorted_run(packing.pack_words(words, width=32), device=device)
            runs.append(tuple(r.cmp_lanes()) + tuple(r.lanes()))
        return runs, len(runs[0]) - 9
    runs = []
    for n in sizes:
        if kind == "float":
            f = rng.normal(scale=10.0, size=n).astype(np.float32)
            pick = rng.random(n)
            f[pick < 0.15] = np.nan
            f[(pick >= 0.15) & (pick < 0.3)] = -0.0
            f[(pick >= 0.3) & (pick < 0.45)] = 0.0
            f[(pick >= 0.45) & (pick < 0.5)] = -np.inf
            pats = np.array([0x7FC00001, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                            np.uint32).view(np.float32)
            m = pick >= 0.9
            f[m] = pats[rng.integers(0, len(pats), int(m.sum()))]
            p = rng.integers(-3, 3, n).astype(np.int32)
            order = np.lexsort((p, order_bits_view(f)))
            runs.append((to_device(f[order], device),
                         to_device(p[order], device)))
            continue
        v = rng.integers(0, 4 if kind == "dup_heavy" else 1 << 32, (3, n),
                         dtype=np.uint64).astype(np.uint32)
        if kind == "sentinel":
            v[rng.random((3, n)) < 0.3] = 0xFFFFFFFF
        order = np.lexsort(v[::-1])
        runs.append(tuple(to_device(np.ascontiguousarray(l[order]), device)
                          for l in v))
    return runs, (3 if kind == "dup_heavy" else None)


def front_end_events(run, expected, tries: int = 5):
    """The names of the device events of one ``run()`` (a warm call
    first), from ``torch.profiler``, from the first window that holds
    ``expected[name]`` events of each CUDA function ``name`` (a window
    that lost events is traced again, up to ``tries`` windows); None when
    no window held them all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = [e.name.split("(")[0].replace("void ", "")
                 for e in prof.events() if e.device_type == DeviceType.CUDA]
        if all(sum(f in n for n in names) == c for f, c in expected.items()):
            return names
    return None


def check_merge_contract(name, got, runs):
    """``got`` (stacked int32, the merged lanes) holds the runs' tuples bit
    for bit and is sorted under the total order."""
    import numpy as np
    import torch
    from repro_torch import to_numpy
    from repro_torch.kernels import lex
    from repro_torch.pipeline.validate import check_lanes_sorted
    flat = torch.stack([torch.cat([lex.as_bits(r[l]) for r in runs])
                        for l in range(len(runs[0]))])
    if not torch.equal(lib_sort(flat[:, None], flat[:, None]),
                       lib_sort(got[:, None], got[:, None])):
        raise AssertionError(f"{name}: output is not a permutation of the "
                             "input")
    typed = [to_numpy(lex.from_bits(got[l].contiguous(), runs[0][l].dtype))
             for l in range(len(runs[0]))]
    check_lanes_sorted([np.asarray(t) for t in typed], what=name)


def check_merge_kernel(kernel, label, fn, plain, args, block, runs=None):
    """Kernel vs plain version on the same operands (bits); with ``runs``,
    also the total-order contract. Returns the bit error and the output."""
    import torch
    got = fn(*args, block)
    want = plain(*args, block)
    torch.cuda.synchronize()
    err = bits_err(got, want)
    print(f"[kernels] {kernel.name} {label}: max_abs_err {err}")
    if err:
        raise AssertionError(f"{kernel.name} {label}: kernel and plain "
                             "version differ")
    if runs is not None:
        check_merge_contract(f"{kernel.name} {label}", got, runs)
    return err, got


def phase_run_merges(report, device, ds2_keys):
    """B5 and B6 at the run tier's own shapes, on adversarial runs, and
    timed beside their plain versions and the torch tiers."""
    import math
    import numpy as np
    import torch
    from repro_torch.kernels import keypack, kway_kernel as kk, lex, \
        runmerge_kernel as rk
    rng = np.random.default_rng(1)
    ext, n_cmp = ext_runs(ds2_keys, device)
    n_arr, k = len(ext[0]), len(ext)

    # B6 at DS2's 57 runs of <= 4096: the operands come through the
    # gather and the split's rounds on the card
    blk = kk.DEFAULT_KWAY_BLOCK
    ops = kk.kway_operands(ext, n_cmp, block=blk)
    total = ops[1].shape[1]
    cmp_runs = [r[:n_cmp] for r in ext]
    ns = [r[0].shape[0] for r in ext]
    codes = ops[3]
    flat = kk.kway_gather_plain(ext)
    plain_cursors = kk.kway_starts_plain(ops[0], ns, codes, blk)
    oracle = kk.kway_cursors(kk.kway_ranks(cmp_runs), blk)
    torch.cuda.synchronize()
    gather_err = bits_err(ops[1], flat)
    split_err = max(bits_err(ops[2], plain_cursors), bits_err(ops[2], oracle))
    print(f"[kernels] kway_gather DS2 {k} runs, {n_arr} arrays: max_abs_err "
          f"{gather_err}; kway_split DS2 {k} runs, {n_cmp} compare lanes: "
          f"max_abs_err {split_err} (plain split and oracle)")
    if gather_err or split_err:
        raise AssertionError("kway_gather or kway_split: kernel and plain "
                             "version differ")
    err, got = check_merge_kernel(kk.KERNEL, f"DS2 {k} runs, {n_arr} arrays",
                                  kk.kway_merge, kk.kway_merge_plain, ops, blk)
    take = kk.merge_runs_kway_take(ext, n_cmp=n_cmp)
    if bits_err(got, torch.stack([lex.as_bits(t) for t in take])):
        raise AssertionError("merge_runs_kway: kernel and torch tier differ")
    for kind, sizes in (("sentinel", (5000, 3000, 1, 2500)),
                        ("dup_heavy", (4096,) * 9),
                        ("empty and single", (0, 1, 0, 4096, 1, 700, 0)),
                        ("words-32-bytes", (3000, 2000, 500)),
                        ("float", (3000, 1, 2000))):
        gen = "dup_heavy" if kind == "empty and single" else kind
        runs, nc = sorted_lanes_runs(gen, sizes, rng, device)
        runs = [r for r in runs if r[0].shape[0]]
        e, _ = check_merge_kernel(kk.KERNEL, f"{kind} {sizes}", kk.kway_merge,
                                  kk.kway_merge_plain,
                                  kk.kway_operands(runs, nc), blk, runs)
        err = max(err, e)
    sweep_err = kway_sweep(device)
    ms_engine = cuda_time(lambda i: kk.merge_runs_kway_kernel(
        ext, n_cmp=n_cmp), 3, 1)
    rounds = math.ceil(math.log2(k))
    # one front-end call's device events: every round's split and merge,
    # the cursors, the gather and B6 (the launch counters say how many)
    _, counts = launch_counts(lambda: kk.merge_runs_kway_kernel(
        ext, n_cmp=n_cmp))
    expected = {"kway_split_kernel": counts[kk.SPLIT_KERNEL.name],
                "kway_round_kernel": counts[kk.SPLIT_KERNEL.name],
                "kway_cursor_kernel": 1,
                "kway_gather_kernel": counts[kk.GATHER_KERNEL.name],
                "kway_kernel": counts[kk.KERNEL.name]}
    events = front_end_events(lambda: kk.merge_runs_kway_kernel(
        ext, n_cmp=n_cmp), expected)
    if events is None:
        print(f"[kernels] merge_runs_kway_kernel front end, DS2 {k} runs: "
              "device events not measured (no profiler window held every "
              "launch)")
    else:
        launched = [n for n in events
                    if not n.startswith(("Memcpy", "Memset"))]
        print(f"[kernels] merge_runs_kway_kernel front end, DS2 {k} runs: "
              f"{len(events)} device events, {len(launched)} kernels (at "
              f"most {2 * rounds + 4}): {sorted(Counter(events).items())}")
        if len(launched) > 2 * rounds + 4:
            raise AssertionError("merge_runs_kway_kernel launched more "
                                 "kernels than the split's rounds, the "
                                 "gather and B6")
    nblocks = -(-total // blk)
    report.add(kk.KERNEL, max(err, sweep_err), shape=[n_arr, total], runs=k,
               block=blk,
               ms=cuda_time(lambda i: kk.kway_merge(*ops, blk), KERNEL_ITERS),
               **device_fields(kk.KERNEL.name,
                               lambda i: kk.kway_merge(*ops, blk)),
               plain_ms=cuda_time(lambda i: kk.kway_merge_plain(*ops, blk),
                                  PLAIN_ITERS, 1),
               torch_tier_ms=cuda_time(lambda i: kk.merge_runs_kway_take(
                   ext, n_cmp=n_cmp), KERNEL_ITERS),
               engine_ms=ms_engine,
               front_end_device_events=None if events is None else len(events),
               library_ms=None,
               **bound(2 * n_arr * total * 4 + ops[2].numel() * 4,
                       total * rounds * n_cmp))

    def split(i):
        return kk.kway_starts(ops[0], ns, codes, blk)

    # the kernels alone, on a plan uploaded once: the device's own time,
    # and what a CUDA graph can replay
    lanes = kk._word_lanes(ext)
    rounds_plan = kk.split_plan(ns)
    plan, addr = kk._device_plan(device, rounds_plan, kk._bases(ns), lanes)

    def split_kernels(i):
        return kk._split_rounds(ops[0], codes, rounds_plan, addr, k, blk)

    def gather_kernel(i):
        return kk._gather(lanes, addr, total, device)

    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    split(0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base_bytes
    report.add(kk.SPLIT_KERNEL, max(split_err, sweep_err),
               shape=[n_cmp, total], runs=k, block=blk,
               ms=cuda_time(split, KERNEL_ITERS),
               **device_fields(kk.SPLIT_KERNEL.name, split_kernels),
               plain_ms=cuda_time(lambda i: kk.kway_starts_plain(
                   ops[0], ns, codes, blk), PLAIN_ITERS, 1),
               # the yardstick: the torch split the port ran before these
               # kernels (kway_ranks' merge_take_packed rounds, then a
               # searchsorted a run)
               library_ms=cuda_time(lambda i: kk.kway_cursors(
                   kk.kway_ranks(cmp_runs), blk), PLAIN_ITERS, 1),
               # the least: the compare lanes read once, the cursors
               # written; the design's floor: every round reads and writes
               # the compare lanes' keys and the index lane
               **bound((n_cmp * total + k * (nblocks + 1)) * 4,
                       total * rounds * n_cmp),
               rounds_bound_ms=2 * (n_cmp + 1) * total * 4 * rounds
               / HBM_BYTES_PER_S * 1e3,
               peak_bytes=peak)
    gather_err = max(gather_err, bits_err(kk.kway_gather(ext), flat))
    report.add(kk.GATHER_KERNEL, max(gather_err, sweep_err),
               shape=[n_arr, total], runs=k,
               ms=cuda_time(lambda i: kk.kway_gather(ext), KERNEL_ITERS),
               **device_fields(kk.GATHER_KERNEL.name, gather_kernel),
               plain_ms=cuda_time(lambda i: kk.kway_gather_plain(ext),
                                  KERNEL_ITERS),
               # no one PyTorch call concatenates many runs' lanes into a
               # stack (the plain version is a torch.cat a lane)
               library_ms=None,
               **bound(2 * n_arr * total * 4, 0))

    # B5 at the last tournament round of the same runs: the merge of runs
    # [0, 32) against runs [32, 57), each side merged first
    half = 1 << ((k - 1).bit_length() - 1)
    a = kk.merge_runs_kway_take(ext[:half], n_cmp=n_cmp)
    b = kk.merge_runs_kway_take(ext[half:], n_cmp=n_cmp)
    blk = rk.DEFAULT_MERGE_BLOCK
    ops = rk.merge_operands(a, b, n_cmp, block=blk)
    err, got = check_merge_kernel(
        rk.KERNEL, f"DS2 last round {a[0].shape[0]} + {b[0].shape[0]}, "
        f"{n_arr} arrays", rk.runmerge, rk.runmerge_plain, ops, blk)
    if bits_err(got, torch.stack([lex.as_bits(t) for t in take])):
        raise AssertionError("merge_runs_lex: kernel and the k-way merge "
                             "differ")
    for kind, sizes in (("sentinel", (5000, 3000)),
                        ("dup_heavy", (4096, 4000)),
                        ("empty and single", (1, 5000)),
                        ("single", (700, 1)),
                        ("words-32-bytes", (3000, 2000)),
                        ("float", (3000, 2000))):
        gen = "dup_heavy" if kind in ("empty and single", "single") else kind
        runs, nc = sorted_lanes_runs(gen, sizes, rng, device)
        e, _ = check_merge_kernel(rk.KERNEL, f"{kind} {sizes}", rk.runmerge,
                                  rk.runmerge_plain,
                                  rk.merge_operands(*runs, nc), blk, runs)
        err = max(err, e)
        empty = tuple(x[:0] for x in runs[0])
        out = rk.merge_runs_lex_kernel(empty, runs[1], nc)
        if not all(x is y for x, y in zip(out, runs[1])):
            raise AssertionError("merge_runs_lex: an empty run changed the "
                                 "other")
    err = max(err, runmerge_sweep(device))

    # the split at the same merge: the kernel's starts (merge_operands ran
    # it) against the plain torch split's, then both timed
    sk = rk.SPLIT_KERNEL
    sa, sb, codes = ops[0], ops[1], ops[5]
    split_err = bits_err(ops[4], rk.merge_path_starts_plain(sa, sb, codes,
                                                            blk))
    print(f"[kernels] {sk.name} DS2 last round, {len(codes)} compare lanes: "
          f"max_abs_err {split_err}")
    if split_err:
        raise AssertionError(f"{sk.name}: kernel and plain version differ")
    nbounds = ops[4].shape[1]
    steps = min(sa.shape[1], sb.shape[1]).bit_length()

    def split(i):
        return rk.merge_path_starts(sa, sb, blk, codes)

    def torch_split(i):
        return rk.merge_path_starts_plain(sa, sb, codes, blk)

    report.add(sk, split_err, shape=[len(codes), sa.shape[1], sb.shape[1]],
               block=blk, ms=cuda_time(split, KERNEL_ITERS),
               **device_fields(sk.name, split),
               plain_ms=cuda_time(torch_split, PLAIN_ITERS, 1),
               # the yardstick: the torch split (the plain version) on the
               # card, the split the port ran before this kernel
               library_ms=cuda_time(torch_split, KERNEL_ITERS),
               # the least: a boundary's search reads one lane of a and of
               # b a step, then writes its two starts
               **bound(nbounds * (steps * 2 + 2) * 4, nbounds * steps))

    total = got.shape[1]
    report.add(rk.KERNEL, err, shape=[n_arr, total], block=blk,
               ms=cuda_time(lambda i: rk.runmerge(*ops, blk), KERNEL_ITERS),
               **device_fields(rk.KERNEL.name,
                               lambda i: rk.runmerge(*ops, blk)),
               plain_ms=cuda_time(lambda i: rk.runmerge_plain(*ops, blk),
                                  PLAIN_ITERS, 1),
               torch_tier_ms=cuda_time(lambda i: keypack.merge_take_packed(
                   a, b, n_cmp=n_cmp), KERNEL_ITERS),
               engine_ms=cuda_time(lambda i: rk.merge_runs_lex_kernel(
                   a, b, n_cmp=n_cmp), 3, 1),
               library_ms=None,
               **bound(2 * n_arr * total * 4 + ops[4].numel() * 4,
                       total * n_cmp))
    for name in (rk.KERNEL.name, rk.SPLIT_KERNEL.name, kk.KERNEL.name,
                 kk.SPLIT_KERNEL.name, kk.GATHER_KERNEL.name):
        row = report.rows[name]
        print(f"[kernels] {name}: " + ", ".join(
            f"{key} {row.get(key)}" for key in (
                "shape", "ms", "device_ms", "device_ms_by_function",
                "plain_ms", "library_ms", "torch_tier_ms", "engine_ms",
                "bound_ms", "bound_by", "rounds_bound_ms", "peak_bytes")))


# --- phase 3 ----------------------------------------------------------------

def phase_main_path(report, device, datasets):
    """Each dataset through the main path once, checked, with the launch
    counters set to 0 just before and read just after; then timed."""
    import numpy as np
    import torch
    from repro_torch import bucketed_sort_words, sorted_packed, to_numpy
    from repro_torch.core import packing
    from repro_torch.kernels import KERNELS
    total = dict.fromkeys(KERNELS, 0)
    for name, words in datasets:
        oracle = shortlex(words)
        keys = packing.pack_words(words)
        capacity = max(Counter(len(w.encode()) for w in words).values())
        for k in KERNELS.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = bucketed_sort_words(words, device=device)
        lens, sk, packed = sorted_packed(keys, return_packed=True,
                                         device=device)
        torch.cuda.synchronize()
        runs = {n: k.launches for n, k in KERNELS.items()}
        peak = torch.cuda.max_memory_allocated()
        for n, c in runs.items():
            total[n] += c
        if out != oracle:
            raise AssertionError(f"{name}: bucketed_sort_words is not the "
                                 "shortlex order")
        want = packing.pack_words(oracle, width=keys.shape[1] * 4)
        if not (np.array_equal(to_numpy(sk), want) and np.array_equal(
                to_numpy(lens), [len(w.encode()) for w in oracle])):
            raise AssertionError(f"{name}: sorted_packed differs from the "
                                 "shortlex oracle")
        if name == "DS1":
            cpu = sorted_packed(keys, return_packed=True, device="cpu")
            for g, w in zip((lens, sk) + packed, cpu[:2] + cpu[2]):
                if not np.array_equal(to_numpy(g), to_numpy(w)):
                    raise AssertionError("DS1: the card's packed lanes "
                                         "differ from the plain CPU path")
        e2e, dev = [], []
        for _ in range(E2E_RUNS):
            t0 = time.perf_counter()
            bucketed_sort_words(words, device=device)
            e2e.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            sorted_packed(keys, return_packed=True, device=device)
            torch.cuda.synchronize()
            dev.append(time.perf_counter() - t0)
        t_e2e, t_dev = statistics.median(e2e), statistics.median(dev)
        print(f"[main] {name}: {len(words)} words, capacity {capacity}, "
              f"launches of one bucketed_sort_words + one sorted_packed "
              f"{runs}; bucketed_sort_words median {t_e2e * 1e3:.3f} ms "
              f"({len(words) / t_e2e:.0f} words/s), sorted_packed median "
              f"{t_dev * 1e3:.3f} ms ({len(words) / t_dev:.0f} words/s), "
              f"max_memory_allocated {peak} B, shortlex oracle: equal")
    for name, count in total.items():
        report.rows[name]["launches"] = count
        if count == 0 and name in MAIN_PATH:
            raise AssertionError(f"{name} was never launched on the main "
                                 "path")


def launch_counts(run):
    """``run()`` with every launch counter set to 0 just before and read
    just after; returns ``(result, {kernel: launches})``."""
    import torch
    from repro_torch.kernels import KERNELS
    for k in KERNELS.values():
        k.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {n: k.launches for n, k in KERNELS.items()}


def phase_run_tier(report, device, ds2_words, big_words):
    """The run tier end to end: the chunked sorts through their entry
    points, each checked against the shortlex oracle with the launch
    counters read around it, then timed: the whole call (median), and the
    same work in its two stages, the chunk sorts and the combine."""
    import numpy as np
    import torch
    from repro_torch import to_numpy
    from repro_torch.core import packing
    from repro_torch.kernels import KERNELS
    from repro_torch.pipeline import (chunked_sort_packed, chunked_sort_words,
                                      merge_runs, sorted_run)
    ds2_oracle = shortlex(ds2_words)
    big_keys = packing.pack_words(big_words)
    big_oracle = packing.pack_words(shortlex(big_words), width=16)
    cases = (
        ("DS2 chunked, k-way", ds2_words, 4096, "auto",
         ("merge_runs_kway", "kway_split", "kway_gather"),
         lambda: chunked_sort_words(ds2_words, chunk_size=4096,
                                    merge_engine="auto", device=device)),
        ("DS2 chunked, tournament", ds2_words, 4096, "tournament",
         ("merge_runs_lex", "merge_path_starts"),
         lambda: chunked_sort_words(ds2_words, chunk_size=4096,
                                    merge_engine="tournament",
                                    device=device)),
        ("1M words chunked, k-way, validate=full", big_words, 16384, "auto",
         ("merge_runs_kway", "kway_split", "kway_gather"),
         lambda: chunked_sort_packed(big_keys, chunk_size=16384,
                                     validate="full", device=device)),
    )
    for name, words, chunk, engine, merge_kernels, run in cases:
        torch.cuda.reset_peak_memory_stats()
        out, counts = launch_counts(run)
        peak = torch.cuda.max_memory_allocated()
        if isinstance(out, list):
            ok = out == ds2_oracle
        else:
            ok = np.array_equal(to_numpy(out.keys), big_oracle)
        if not ok:
            raise AssertionError(f"{name}: not the shortlex order")
        for kname in ("distribute_rows", "bitonic_rows_lex",
                      "merge_adjacent_lex") + merge_kernels:
            if counts[kname] == 0:
                raise AssertionError(f"{name}: {kname} never launched")
        for kname, c in counts.items():
            report.rows[kname]["launches"] += c
        reps = 3 if len(words) < 500_000 else 1
        total = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            total.append(time.perf_counter() - t0)
        keys = packing.pack_words(words)
        t0 = time.perf_counter()
        runs = [sorted_run(keys[s:s + chunk], capacity=chunk, device=device)
                for s in range(0, len(keys), chunk)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        merge_runs([r.lanes() for r in runs], engine=engine,
                   cmp_runs=[r.cmp_lanes() for r in runs])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        t = statistics.median(total)
        print(f"[run tier] {name}: {len(words)} words, {len(runs)} runs, "
              f"launches {counts}; total median {t * 1e3:.3f} ms "
              f"({len(words) / t:.0f} words/s) over {reps}; staged: chunk "
              f"sorts {(t1 - t0) * 1e3:.3f} ms, combine "
              f"{(t2 - t1) * 1e3:.3f} ms; max_memory_allocated {peak} B; "
              "shortlex oracle: equal")


def wall(run, reps: int = 1):
    """Median host seconds of ``reps`` calls of ``run()``, each ended by a
    synchronize."""
    import torch
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def dir_bytes(root) -> int:
    return sum(f.stat().st_size for f in Path(root).rglob("*") if f.is_file())


def phase_fault_tolerance(report, device, ds2_words, big_words):
    """The fault-tolerant chunked sort through its entry points
    (``store=``, ``supervisor=``), in a temporary directory, every result
    checked against Python's shortlex order and every run's chunk sorts
    counted by B3's launches (one a chunk sort): DS2 with a ``RunStore``
    (timed against no store, its bytes on disk, one ``put``), a resume of
    the full store (no chunk sort), a kill from chunk 30 on and its resume
    (27 chunk sorts), a damaged store (a lost run, a half-written one, a
    truncated file: 3 chunk sorts) and a flipped bit that
    ``validate='full'`` must catch, a supervisor with no fault (timed
    against none) and injected transient failures of each stage, the
    million words with a store and its resume; then a ``ShardStore`` of
    the merged DS2 run, gated by ``check_sharded`` and read back whole."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch import to_numpy
    from repro_torch.core import packing
    from repro_torch.pipeline import (RunManifest, RunStore, ShardedRun,
                                      ShardStore, SortedRun, ValidationError,
                                      check_sharded, chunked_sort_packed,
                                      chunked_sort_words, sorted_run)
    from repro_torch.runtime import (RetryPolicy, SortSupervisor,
                                     StageFailure, StageFailureInjector)
    t_phase = time.perf_counter()
    oracle = shortlex(ds2_words)
    ds2_keys = packing.pack_words(ds2_words)
    big_keys = packing.pack_words(big_words)
    big_oracle = packing.pack_words(shortlex(big_words), width=16)
    kway = ("merge_runs_kway", "kway_split", "kway_gather")
    n_chunks = -(-len(ds2_words) // FT_CHUNK)

    def drive(name, run, sorts, want=oracle, merge_kernels=kway):
        """``run()`` once with the counters read around it; its output
        must be ``want`` (words, or a run's packed keys) and its chunk
        sorts ``sorts``."""
        out, counts = launch_counts(run)
        ok = (out == want if isinstance(want, list) else
              np.array_equal(to_numpy(out.keys), want))
        if not ok:
            raise AssertionError(f"{name}: not the shortlex order")
        if counts["distribute_rows"] != sorts:
            raise AssertionError(f"{name}: {counts['distribute_rows']} "
                                 f"chunk sorts, expected {sorts}")
        for kname in merge_kernels:
            if counts[kname] == 0:
                raise AssertionError(f"{name}: {kname} never launched")
        for kname, c in counts.items():
            report.rows[kname]["launches"] += c
        print(f"[fault] {name}: {sorts} chunk sorts, launches {counts}; "
              "shortlex oracle: equal")
        return out

    def words(**kw):
        return lambda: chunked_sort_words(ds2_words, chunk_size=FT_CHUNK,
                                          device=device, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ds2")
        # 1. a store: the first call writes every run
        drive("DS2 chunked, k-way, store", words(store=RunStore(root)),
              n_chunks)
        if RunStore(root).completed() != list(range(n_chunks)):
            raise AssertionError("the store does not hold every run")
        t_plain, t_store = [], []
        for i in range(3):        # in turns; each store call writes anew
            t_plain.append(wall(words()))
            t_store.append(wall(words(store=RunStore(
                os.path.join(tmp, f"timed{i}")))))
        chunk0 = sorted_run(ds2_keys[:FT_CHUNK], capacity=FT_CHUNK,
                            device=device)
        man0 = RunManifest.from_run(chunk0, 0)
        copies, writes = [], []
        for i in range(5):        # the two halves of a put, as ingest runs it
            put_store = RunStore(os.path.join(tmp, f"put{i}"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            on_host = SortedRun(lengths=to_numpy(chunk0.lengths),
                                keys=to_numpy(chunk0.keys),
                                packed=tuple(to_numpy(chunk0.packed)))
            t1 = time.perf_counter()
            put_store.put(man0, on_host)
            writes.append(time.perf_counter() - t1)
            copies.append(t1 - t0)
        print(f"[fault] DS2 chunked, k-way: whole call median "
              f"{statistics.median(t_plain) * 1e3:.3f} ms without a store "
              f"{[round(t * 1e3, 3) for t in t_plain]}, "
              f"{statistics.median(t_store) * 1e3:.3f} ms with one "
              f"{[round(t * 1e3, 3) for t in t_store]}; {n_chunks} runs, "
              f"{dir_bytes(root)} B on disk; one put of a {FT_CHUNK}-word "
              f"run from the card, medians over 5: the copy to the host "
              f"{statistics.median(copies) * 1e3:.3f} ms "
              f"{[round(t * 1e3, 3) for t in copies]}, the files "
              f"{statistics.median(writes) * 1e3:.3f} ms "
              f"{[round(t * 1e3, 3) for t in writes]}")
        # 2. a resume of the full store sorts nothing
        drive("DS2 resume of the full store", words(store=RunStore(root)), 0)
        t_resume = wall(words(store=RunStore(root)), reps=3)
        print(f"[fault] DS2 resume of the full store: median "
              f"{t_resume * 1e3:.3f} ms over 3")
        # 3. a job that dies at chunk 30, and its resume
        kill = os.path.join(tmp, "kill")
        sup = SortSupervisor(policy=RetryPolicy(max_retries=0),
                             injector=StageFailureInjector(fail_at={
                                 "ingest_chunk": set(range(30, n_chunks))}))
        try:
            words(store=RunStore(kill), supervisor=sup)()
            raise AssertionError("the injected failure did not stop the job")
        except StageFailure:
            pass
        if RunStore(kill).completed() != list(range(30)):
            raise AssertionError("the killed job's store does not hold "
                                 "exactly runs 0..29")
        drive("DS2 resume after a kill at chunk 30",
              words(store=RunStore(kill)), n_chunks - 30)
        if RunStore(kill).completed() != list(range(n_chunks)):
            raise AssertionError("the resume did not complete the store")
        # 4. damage: a lost run, a half-written one, a truncated file
        shutil.rmtree(os.path.join(root, "step_5"))
        os.rename(os.path.join(root, "step_12"),
                  os.path.join(root, ".tmp_12"))
        victim = os.path.join(root, "step_20", "keys.npy")
        with open(victim, "r+b") as f:
            f.truncate(os.path.getsize(victim) // 2)
        drive("DS2 resume of a damaged store", words(store=RunStore(root)),
              3)
        keys_file = os.path.join(root, "step_40", "keys.npy")
        good = np.load(keys_file)
        bad = good.copy()
        bad[3, 0] ^= np.uint32(1 << 7)
        np.save(keys_file, bad)
        try:
            words(store=RunStore(root), validate="full")()
            raise AssertionError("a flipped bit in a stored run passed "
                                 "validate='full'")
        except ValidationError as e:
            print(f"[fault] a flipped bit in run 40's keys.npy: "
                  f"ValidationError ({e})")
        np.save(keys_file, good)
        # 5. the supervisor: no fault against none, then injected failures
        t_none, t_sup = [], []
        for _ in range(3):
            t_none.append(wall(words()))
            t_sup.append(wall(words(supervisor=SortSupervisor())))
        print(f"[fault] DS2 chunked, k-way: whole call median "
              f"{statistics.median(t_none) * 1e3:.3f} ms without a "
              f"supervisor {[round(t * 1e3, 3) for t in t_none]}, "
              f"{statistics.median(t_sup) * 1e3:.3f} ms with one and no "
              f"fault {[round(t * 1e3, 3) for t in t_sup]}")
        for engine, fail_at, kernels in (
                ("auto", {"ingest_chunk": {0, 2}, "streaming_combine": {0}},
                 kway),
                ("tournament", {"merge_round": {1}},
                 ("merge_runs_lex", "merge_path_starts"))):
            sleeps = []
            sup = SortSupervisor(injector=StageFailureInjector(
                fail_at=fail_at), sleep=sleeps.append)
            drive(f"DS2 chunked, {engine}, failures at {fail_at}",
                  words(supervisor=sup, merge_engine=engine), n_chunks,
                  merge_kernels=kernels)
            want = [(stage, "retry") for stage in fail_at
                    for _ in fail_at[stage]]
            got = [(e.stage, e.action) for e in sup.events]
            if got != want or sleeps:
                raise AssertionError(f"supervisor events {got} (sleeps "
                                     f"{sleeps}), expected {want}")
        # 6. the million words with a store, and its resume
        big = os.path.join(tmp, "big")

        def big_run():
            return chunked_sort_packed(big_keys, chunk_size=FT_BIG_CHUNK,
                                       validate="full", store=RunStore(big),
                                       device=device)

        t0 = time.perf_counter()
        drive("1M words chunked, validate=full, store", big_run,
              -(-len(big_words) // FT_BIG_CHUNK), big_oracle)
        t_big = time.perf_counter() - t0
        t0 = time.perf_counter()
        drive("1M words resume of the full store", big_run, 0, big_oracle)
        t_big_resume = time.perf_counter() - t0
        print(f"[fault] 1M words chunked, validate=full: first call with a "
              f"store {t_big * 1e3:.3f} ms, {dir_bytes(big)} B on disk; "
              f"full resume {t_big_resume * 1e3:.3f} ms (one call each, "
              "counters read)")
        # the shard store: the merged DS2 run (the packed front end resumes
        # the words front end's store) cut into four destinations
        merged = drive("DS2 packed, resume of the words' store",
                       lambda: chunked_sort_packed(ds2_keys,
                                                   chunk_size=FT_CHUNK,
                                                   store=RunStore(root),
                                                   device=device), 0,
                       packing.pack_words(oracle))
        shards = ShardStore(os.path.join(tmp, "shards"))
        n = len(ds2_words)
        cuts = [0, 1, n // 4, n // 4, n]
        shard_mans = []
        for dest, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
            part = SortedRun(lengths=merged.lengths[lo:hi],
                             keys=merged.keys[lo:hi])
            shard_mans.append(RunManifest.from_run(part, dest))
            shards.put(shard_mans[-1], part)
        store = RunStore(root)
        check_sharded([store.manifest(i) for i in store.completed()],
                      shard_mans, mode="full")
        whole = ShardedRun(store=shards, manifests=tuple(shard_mans)).to_run(
            validate="full", device=device)
        if not (torch.equal(whole.lengths, merged.lengths) and torch.equal(
                whole.keys.view(torch.int32), merged.keys.view(torch.int32))):
            raise AssertionError("ShardedRun.to_run differs from the run")
        print("[fault] ShardStore of the merged DS2 run (4 destinations, "
              "one empty): check_sharded('full') passed, to_run on the "
              "card equal")
    print(f"[fault] phase took {time.perf_counter() - t_phase:.1f} s")


# --- phase 4 ----------------------------------------------------------------

def quantiles(x, n_spl: int):
    """``n_spl`` int32 splitters at the (j + 1) / (n_spl + 1) quantiles of
    ``x``'s values, as a sample sort draws them."""
    import torch
    s = torch.sort(x.reshape(-1)).values
    idx = (torch.arange(1, n_spl + 1, device=x.device) * s.numel()
           // (n_spl + 1))
    return s[idx].contiguous()


def partition_adversarial(device):
    """``(label, keys, splitters)`` adversarial inputs of B7, int32."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2)
    info = np.iinfo(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    ext = rng.integers(-5, 5, (4, 3000)).astype(np.int32)
    ext[:, ::3], ext[:, 1::3] = info.max, info.min
    eq = rng.choice(np.array([-7, 0, 9, 100], np.int32), (3, 5000))
    small = rng.integers(-1000, 1000, (16, 4096)).astype(np.int32)
    wrap = rng.integers(0, 1 << 32, (2, 5000), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    return [
        ("int32 extremes", t(ext), t([info.min, -1, 0, 4, info.max])),
        ("keys equal to splitters", t(eq), t([-7, 0, 9, 100])),
        ("duplicated splitters", t(small), t([-5, -5, -5, 0, 0, 700, 700])),
        ("unsorted splitters", t(small), t(rng.permutation(
            np.arange(-990, 1000, 30)))),
        ("no splitters", t(small), t(np.zeros(0))),
        ("C = 130, R = 1", t(small[:1, :130]), t([-500, 0, 500])),
        ("uint32 keys past 2^31", t(wrap), t(np.sort(rng.integers(
            info.min, info.max, 31)))),
    ]


def partition_sweep(device) -> int:
    """B7 against its plain version for every splitter count of
    :data:`SPLITTER_SWEEP` and ``MAX_SPLITTERS``, unsorted with duplicates
    (and both int32 extremes), on three rows of keys of which a third equal
    a splitter and a tenth sit at INT32_MIN or INT32_MAX, at ragged column
    counts that leave a vector tail; the ids must also be the upper bounds
    over the sorted splitters. Returns the largest error."""
    import torch
    from repro_torch.kernels import adversarial, partition_kernel as pk
    worst = 0
    for n_spl in SPLITTER_SWEEP + (pk.MAX_SPLITTERS,):
        for cols in SPLITTER_SWEEP_COLS:
            x, s = (torch.from_numpy(a).to(device) for a in
                    adversarial.partition_case(n_spl, cols, seed=5))
            bid, cnt = pk.partition_rows(x, s)
            want = pk.partition_rows_plain(x, s)
            torch.cuda.synchronize()
            e = max(bits_err(bid, want[0]), bits_err(cnt, want[1]))
            ref = torch.searchsorted(torch.sort(s).values, x, right=True)
            print(f"[partition] {pk.KERNEL.name} sweep {n_spl} splitters, "
                  f"(3, {cols}): max_abs_err {e}")
            if e or not torch.equal(bid.long(), ref):
                raise AssertionError(f"partition_rows sweep {n_spl} "
                                     f"splitters, {cols} columns: kernel, "
                                     "plain version and the upper bound "
                                     "differ")
            worst = max(worst, e)
    return worst


def phase_partition_and_repairs(report, device, ds2_words, big_words):
    """B7 behind ``partition_rows`` and the narrow-lane and packed sorts, on
    the card with the counters read around them; then B7 checked against
    its plain version and timed."""
    import numpy as np
    import torch
    from repro_torch import to_device
    from repro_torch.core import packing
    from repro_torch.kernels import lex, ops, partition_kernel as pk
    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    ds2_keys = packing.pack_words(ds2_words)
    ds2_lane = to_device(ds2_keys[:, 0].view(np.int32).reshape(8, -1), device)
    big_lane = to_device(packing.pack_words(big_words)[:, 0].view(np.int32)
                         .reshape(64, -1), device)
    lens = to_device(np.array([[len(w.encode()) for w in ds2_words]],
                              np.int32), device)
    cases = [("DS2 lane 0 (8, 28750), 7 splitters", ds2_lane,
              quantiles(ds2_lane, 7)),
             ("DS2 lane 0 (8, 28750), 127 splitters", ds2_lane,
              quantiles(ds2_lane, 127)),
             ("1M lane 0 (64, 16384), 127 splitters", big_lane,
              quantiles(big_lane, 127)),
             ("DS2 byte lengths (1, 230000), splitters 1..16", lens,
              torch.arange(1, 17, dtype=torch.int32, device=device))]
    narrow = {}
    for dt in (torch.int8, torch.int16, torch.uint8, torch.uint16):
        info = torch.iinfo(dt)
        v = rng.integers(info.min, info.max, NARROW_N, endpoint=True)
        v[:2] = (info.max, info.min)
        narrow[dt] = lex.from_bits(torch.from_numpy(v.astype(np.int32)), dt)
    bounded = [torch.from_numpy(rng.integers(0, 1024, NARROW_N).astype(
        np.int32)) for _ in range(2)]
    f = rng.normal(scale=10.0, size=NARROW_N).astype(np.float32)
    pick = rng.random(NARROW_N)
    f[pick < 0.15] = np.nan
    f[(pick >= 0.15) & (pick < 0.25)] = -0.0
    f[(pick >= 0.25) & (pick < 0.35)] = 0.0
    pats = np.array([0x7FC00001, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                    np.uint32).view(np.float32)
    nan = pick >= 0.9
    f[nan] = pats[rng.integers(0, len(pats), int(nan.sum()))]
    floats = [torch.from_numpy(f), torch.from_numpy(
        rng.integers(-3, 3, NARROW_N).astype(np.int32))]

    def on_card(t):
        return lex.from_bits(lex.as_bits(t).to(device), t.dtype)

    def path():
        return ([ops.partition_rows(x, s) for _, x, s in cases],
                {dt: ops.sort(on_card(x)) for dt, x in narrow.items()},
                ops.sort_lex([on_card(t) for t in bounded],
                             max_values=(1023, 1023)),
                ops.sort_lex([on_card(t) for t in floats], engine="packed"))

    if ops.choose_lex_engine([torch.int32] * 2, (1023, 1023)) != "packed":
        raise AssertionError("sort_lex: bounded int32 lanes do not resolve "
                             "to the packed engine")
    (parts, sorted_narrow, packed_int, packed_float), counts = \
        launch_counts(path)
    for kname in ("partition_rows", "bitonic_rows_lex", "merge_adjacent_lex"):
        if counts[kname] == 0:
            raise AssertionError(f"partition and repaired sorts: {kname} "
                                 "never launched")
    for kname, c in counts.items():
        report.rows[kname]["launches"] += c
    print(f"[partition] launches of the path: {counts}")

    # the repaired sorts against the CPU port and torch.sort
    for dt, got in sorted_narrow.items():
        want = ops.sort(narrow[dt])
        lib = torch.sort(lex.as_bits(narrow[dt])).values
        if not (got.dtype == dt and torch.equal(lex.as_bits(got).cpu(),
                                                lex.as_bits(want))
                and torch.equal(lex.as_bits(want), lib)):
            raise AssertionError(f"sort of {NARROW_N} {dt} keys: the card, "
                                 "the CPU port and torch.sort differ")
        print(f"[partition] sort of {NARROW_N} {dt} keys: equal to the CPU "
              "port and to torch.sort")
    lanes_out = ops.sort_lex([on_card(t) for t in bounded], engine="lanes")
    cpu_out = ops.sort_lex(bounded, max_values=(1023, 1023))
    for g, w, c in zip(packed_int, lanes_out, cpu_out):
        if not (torch.equal(g, w) and torch.equal(g.cpu(), c)):
            raise AssertionError("sort_lex packed: differs from the lanes "
                                 "engine or the CPU port")
    cpu_out = ops.sort_lex(floats, engine="packed")
    for g, w in zip(packed_float, cpu_out):
        if not torch.equal(lex.as_bits(g).cpu(), lex.as_bits(w)):
            raise AssertionError("sort_lex packed float: differs from the "
                                 "CPU port")
    got = torch.stack([lex.as_bits(g) for g in packed_float])[:, None]
    inp = torch.stack([lex.as_bits(on_card(t)) for t in floats])[:, None]
    check_sorted("sort_lex packed float", inp, got, [lex.F32, lex.I32])
    print(f"[partition] sort_lex packed: bounded int32 lanes equal the lanes "
          f"engine and the CPU port; float32 NaN/±0 lane a bit-level "
          f"permutation in total order, equal to the CPU port")

    # B7 against its plain version
    err = 0
    hist = ops.distribute(to_device(ds2_keys, device))[2]
    for (label, x, s), (bid, cnt) in zip(cases, parts):
        want = pk.partition_rows_plain(x, s)
        e = max(bits_err(bid, want[0]), bits_err(cnt, want[1]))
        lib = torch.bucketize(x, s, right=True)
        if e or not torch.equal(bid.long(), lib) or not bool(
                (cnt.sum(dim=1) == x.shape[1]).all()):
            raise AssertionError(f"partition_rows {label}: kernel, plain "
                                 "version and torch.bucketize differ")
        err = max(err, e)
        print(f"[partition] {pk.KERNEL.name} {label}: max_abs_err {e}")
    if not torch.equal(parts[3][0], lens) or not torch.equal(parts[3][1][0],
                                                            hist):
        raise AssertionError("partition_rows of DS2's byte lengths: the ids "
                             "are not the lengths or the counts are not "
                             "B3's histogram")
    print("[partition] DS2 byte lengths: ids equal the lengths, counts "
          "equal B3's histogram")
    for label, x, s in partition_adversarial(device):
        if label.startswith("uint32"):
            bid, cnt = ops.partition_rows(x.view(torch.uint32), s)
        else:
            bid, cnt = pk.partition_rows(x, s)
        want = pk.partition_rows_plain(x, s)
        e = max(bits_err(bid, want[0]), bits_err(cnt, want[1]))
        print(f"[partition] {pk.KERNEL.name} {label} {tuple(x.shape)}, "
              f"{s.numel()} splitters: max_abs_err {e}")
        if e:
            raise AssertionError(f"partition_rows {label}: kernel and plain "
                                 "version differ")
        err = max(err, e)
    err = max(err, partition_sweep(device))

    # times at the million-word shape
    _, x, s = cases[2]
    r, c = x.shape
    n_spl = s.numel()
    ones = torch.ones_like(x, dtype=torch.int64)

    def library(i):
        ids = torch.bucketize(x, s, right=True)
        return torch.zeros((r, n_spl + 1), dtype=torch.int64,
                           device=x.device).scatter_add_(1, ids, ones)

    report.add(pk.KERNEL, err, shape=[r, c], splitters=n_spl,
               ms=cuda_time(lambda i: pk.partition_rows(x, s), KERNEL_ITERS),
               **device_fields(pk.KERNEL.name,
                               lambda i: pk.partition_rows(x, s)),
               plain_ms=cuda_time(lambda i: pk.partition_rows_plain(x, s),
                                  PLAIN_ITERS, 1),
               library_ms=cuda_time(library, KERNEL_ITERS),
               # the least work: a binary search over the splitters sorted
               # once (the count does not depend on their order), then one
               # histogram add per key
               **bound(2 * r * c * 4 + n_spl * 4 + r * (n_spl + 1) * 4,
                       r * c * (n_spl.bit_length() + 1)))
    row = report.rows[pk.KERNEL.name]
    print(f"[partition] {pk.KERNEL.name}: " + ", ".join(
        f"{key} {row.get(key)}" for key in (
            "shape", "splitters", "ms", "device_ms", "device_ms_by_function",
            "plain_ms", "library_ms", "bound_ms", "bound_by")))
    print(f"[partition] phase took {time.perf_counter() - t0:.1f} s")


# --- phase 5 ----------------------------------------------------------------

def mesh_engine_inputs(workdir):
    """The engine runs' inputs, ``(name, lanes)``: DS2's shortlex tuple
    (length, 4 key lanes, an iota payload), read from ``ds2_tuple.npz`` in
    ``workdir``; 8 x 4096 int32 keys; and 10,001 int32 keys (not divisible
    by the ranks)."""
    import numpy as np
    rng = np.random.default_rng(MESH_SEED)
    ds2 = np.load(Path(workdir) / "ds2_tuple.npz")
    return [("DS2 shortlex tuple", [ds2[f"lane{i}"]
                                    for i in range(len(ds2.files))]),
            ("8 x 4096 int32", [rng.integers(-10**6, 10**6, 8 * 4096)
                                .astype(np.int32)]),
            ("10,001 int32", [rng.integers(0, 50, 10_001).astype(np.int32)])]


def ds2_tuple(ds2_words):
    """DS2's shortlex tuple as numpy lanes: byte lengths (int32), the 4
    packed key lanes (uint32) and an iota payload (uint32)."""
    import numpy as np
    from repro_torch.core import packing
    keys = packing.pack_words(ds2_words)
    lengths = np.asarray([len(w.encode()) for w in ds2_words], np.int32)
    return ([lengths] + [np.ascontiguousarray(keys[:, l])
                         for l in range(keys.shape[1])]
            + [np.arange(len(ds2_words), dtype=np.uint32)])


def check_engine_output(name, lanes, out):
    """``out`` must be ``lanes`` lex-sorted (lane 0 most significant): the
    whole tuple is distinct or integer, so the order is unique."""
    import numpy as np
    from repro_torch import to_numpy
    order = np.lexsort(tuple(reversed(lanes)))
    for i, (got, lane) in enumerate(zip(out, lanes)):
        if not np.array_equal(to_numpy(got), lane[order]):
            raise AssertionError(f"{name}: lane {i} is not the lex order")


MESH_ENGINES = (("odd_even", "bitonic"), ("odd_even", "take"),
                ("odd_even", "resort"), ("sample", "bitonic"))


def mesh_rank(rank: int, world: int, workdir: str) -> int:
    """One rank of phase 5's engine run: joins a gloo group of ``world``
    processes on ``cuda:0`` (its collectives staged through the host), runs
    both engines and every odd-even merge on each input of
    :func:`mesh_engine_inputs`, checks its own output, and prints its
    kernel launches and its times."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.core.distributed import distributed_sort_lex
    from repro_torch.parallel import make_mesh
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh((world,), ("data",), "cpu")
        times = {}
        for name, lanes in mesh_engine_inputs(workdir):
            for engine, merge in MESH_ENGINES:
                out, counts = launch_counts(lambda: distributed_sort_lex(
                    lanes, mesh, engine=engine, merge=merge, device=device))
                check_engine_output(f"rank {rank}, {name}, {engine}, "
                                    f"{merge}", lanes, out)
                times[f"{name}, {engine}, {merge}"] = wall(
                    lambda: distributed_sort_lex(lanes, mesh, engine=engine,
                                                 merge=merge, device=device))
                print("MESH_LAUNCHES " + json.dumps(counts), flush=True)
        print("MESH_TIMES " + json.dumps(times), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def run_mesh_ranks(world: int, workdir: str, timeout: float = 240,
                   flag: str = "--mesh-rank"):
    """Start ``world`` ranks of :func:`mesh_rank` (or, with ``flag``
    ``--plan-rank``, of :func:`plan_rank`) on this card and join them
    within ``timeout`` seconds; kill them all and fail if one fails.
    Returns each rank's output (kept in ``workdir/rank<r>.log``)."""
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), flag,
         str(r), str(world), workdir], stdout=logs[r],
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"mesh ranks {bad} failed (codes "
                             f"{[procs[r].returncode for r in bad]}):\n"
                             + outs[bad[0]][-16000:])
    return outs


def phase_mesh(report, device, ds2_words, big_words):
    """The mesh tier through its entry points (``core.distributed``), the
    launch counters read around every driven run: DS2 and the million words
    through ``distributed_chunked_sort_lex`` at 8 destinations of this card
    (k-way and tournament combines, ``validate='full'`` once), each equal
    to ``chunked_sort_packed`` and to Python's shortlex order, DS2 timed
    whole (median of 3) and staged (ingest, exchange, combine); a
    ``ShardStore`` spill and its resume (no destination merge), a kill
    between the exchange and the combine and its resume, a speculative
    combine with one slow destination, and the 25-seed chaos soak; then the
    engines: ``distributed_sort_lex`` at world size 1 over NCCL in this
    process, and in ``MESH_RANKS`` processes on this card over gloo (both
    engines, every odd-even merge; each rank checks its own output and
    reports its launches)."""
    import datetime
    import tempfile
    from unittest import mock

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import to_numpy
    from repro_torch.core import packing
    from repro_torch.core.distributed import (_exchange, _ingest_runs,
                                              distributed_chunked_sort_lex,
                                              distributed_sort_lex)
    from repro_torch.parallel import make_mesh
    from repro_torch.pipeline import (ShardedRun, ShardStore, RunStore,
                                      chunked_sort_packed)
    from repro_torch.pipeline import merge as merge_mod
    from repro_torch.runtime import (ProcessKilled, SortSupervisor,
                                     SpeculationPolicy, StageFailureInjector,
                                     StragglerMonitor, chaos_soak)
    t_phase = time.perf_counter()
    devs = [device] * MESH_DESTS
    ds2_keys = packing.pack_words(ds2_words)
    ds2_oracle = packing.pack_words(shortlex(ds2_words))
    ds2_chunked = chunked_sort_packed(ds2_keys, device=device)
    kway = ("merge_runs_kway", "kway_split", "kway_gather")
    tourney = ("merge_runs_lex", "merge_path_starts")

    def drive(name, run, want, merge_kernels=(), sorts=None):
        """``run()`` once with the counters read around it; its gathered
        (or materialised) keys must be ``want``."""
        out, counts = launch_counts(run)
        got = out.to_run(device=device) if isinstance(out, ShardedRun) \
            else out
        if not np.array_equal(to_numpy(got.keys), want):
            raise AssertionError(f"{name}: not the shortlex order")
        for kname in merge_kernels:
            if counts[kname] == 0:
                raise AssertionError(f"{name}: {kname} never launched")
        if sorts is not None and counts["distribute_rows"] != sorts:
            raise AssertionError(f"{name}: {counts['distribute_rows']} "
                                 f"chunk sorts, expected {sorts}")
        for kname, c in counts.items():
            report.rows[kname]["launches"] += c
        print(f"[mesh] {name}: launches {counts}; shortlex oracle: equal")
        return got

    def mesh_sort(keys, **kw):
        return lambda: distributed_chunked_sort_lex(keys, devices=devs, **kw)

    # DS2 across 8 destinations, each engine
    for label, engine, kernels, kw in (
            ("k-way", "auto", kway, {}),
            ("tournament", "tournament", tourney, {}),
            ("k-way, validate=full", "auto", kway, {"validate": "full"})):
        name = f"DS2 at {MESH_DESTS} destinations, {label}"
        run = mesh_sort(ds2_keys, merge_engine=engine, **kw)
        got = drive(name, run, ds2_oracle, kernels, MESH_DESTS)
        if not (torch.equal(got.lengths, ds2_chunked.lengths) and torch.equal(
                got.keys.view(torch.int32),
                ds2_chunked.keys.view(torch.int32))):
            raise AssertionError(f"{name}: differs from chunked_sort_packed")
        times = [wall(run) for _ in range(3)]
        t0 = time.perf_counter()
        runs, _ = _ingest_runs(ds2_keys, devs, algorithm="pallas",
                               on_overflow="raise", store=None,
                               supervisor=None, need_manifest=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        per_dest = _exchange([r.lanes() for r in runs],
                             [r.cmp_lanes() for r in runs], devs, 8)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for sub_lanes, sub_cmps in per_dest:
            merge_mod.merge_runs(sub_lanes, engine=engine, cmp_runs=sub_cmps)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        incoming = [sum(int(s[0].shape[0]) for s in sub)
                    for sub, _ in per_dest]
        print(f"[mesh] {name}: whole call median "
              f"{statistics.median(times) * 1e3:.3f} ms "
              f"{[round(t * 1e3, 3) for t in times]} "
              f"({len(ds2_words) / statistics.median(times):.0f} words/s); "
              f"staged: ingest {(t1 - t0) * 1e3:.3f} ms, exchange "
              f"{(t2 - t1) * 1e3:.3f} ms, combine {(t3 - t2) * 1e3:.3f} ms; "
              f"destinations receive {incoming}; chunked_sort_packed: equal")

    # the million words at 8 destinations
    big_keys = packing.pack_words(big_words)
    big_oracle = packing.pack_words(shortlex(big_words), width=16)
    big_run = mesh_sort(big_keys)
    drive(f"1M words at {MESH_DESTS} destinations, k-way", big_run,
          big_oracle, kway, MESH_DESTS)
    print(f"[mesh] 1M words at {MESH_DESTS} destinations, k-way: one call "
          f"{wall(big_run) * 1e3:.3f} ms")

    def counting_merges():
        return mock.patch.object(merge_mod, "merge_runs",
                                 side_effect=merge_mod.merge_runs)

    with tempfile.TemporaryDirectory() as tmp:
        # the spill, and a resume that merges no destination
        shards = os.path.join(tmp, "spill")
        drive("DS2 spill to a ShardStore, validate=full",
              mesh_sort(ds2_keys, shard_store=ShardStore(shards),
                        validate="full"), ds2_oracle, kway, MESH_DESTS)
        with counting_merges() as merges:
            drive("DS2 spill resume", mesh_sort(
                ds2_keys, shard_store=ShardStore(shards), validate="full"),
                ds2_oracle, (), MESH_DESTS)
        if merges.call_count != 0:
            raise AssertionError(f"the spill resume merged "
                                 f"{merges.call_count} destination(s)")
        # a kill between the exchange and the combine, and its resume
        runs_dir, kill_dir = (os.path.join(tmp, "runs"),
                              os.path.join(tmp, "kill"))
        sup = SortSupervisor(injector=StageFailureInjector(
            kill_at={"streaming_combine": {2}}))
        try:
            mesh_sort(ds2_keys, store=RunStore(runs_dir),
                      shard_store=ShardStore(kill_dir), supervisor=sup)()
            raise AssertionError("the injected kill did not stop the job")
        except ProcessKilled:
            pass
        if ShardStore(kill_dir).completed() != [0, 1]:
            raise AssertionError("the killed job's shard store does not "
                                 "hold exactly destinations 0 and 1")
        with counting_merges() as merges:
            drive("DS2 resume after a kill in the combine", mesh_sort(
                ds2_keys, store=RunStore(runs_dir),
                shard_store=ShardStore(kill_dir), validate="full"),
                ds2_oracle, kway, 0)
        if merges.call_count != MESH_DESTS - 2:
            raise AssertionError(f"the resume merged {merges.call_count} "
                                 f"destinations, expected {MESH_DESTS - 2}")
        # a speculative combine with one slow destination
        inj = StageFailureInjector(slow_at={"streaming_combine": {5: 0.5}})
        sup = SortSupervisor(injector=inj, speculation=SpeculationPolicy(
            monitor=StragglerMonitor(warmup=3, min_ratio=3.0),
            min_wait=0.05))
        drive("DS2 speculative combine, destination 5 slow",
              mesh_sort(ds2_keys, supervisor=sup, validate="full"),
              ds2_oracle, kway, MESH_DESTS)
        actions = [e.action for e in sup.events]
        if "speculate" not in actions or \
                "speculation_confirmed" not in actions:
            raise AssertionError(f"no confirmed speculation: {actions}")
        # the chaos soak
        soak_keys = packing.pack_words(synthetic_soak_words())
        t0 = time.perf_counter()
        reports, counts = launch_counts(lambda: chaos_soak(
            soak_keys, seeds=range(MESH_SOAK_SEEDS),
            workdir=os.path.join(tmp, "soak"), devices=devs,
            num_devices=MESH_DESTS))
        bad = [(r.seed, r.first_error, r.detail) for r in reports
               if not r.ok]
        if bad:
            raise AssertionError(f"chaos soak: {bad}")
        for kname, c in counts.items():
            report.rows[kname]["launches"] += c
        print(f"[mesh] chaos soak: {MESH_SOAK_SEEDS} seeds over "
              f"{MESH_DESTS} destinations of this card, every seed ok "
              f"({sum(r.resumed for r in reports)} resumed, "
              f"{sum(len(r.fired) for r in reports)} faults fired, "
              f"{sum(len(r.damaged) for r in reports)} damages) in "
              f"{time.perf_counter() - t0:.1f} s; launches {counts}")

    # the engines: world size 1 over NCCL in this process
    lanes = ds2_tuple(ds2_words)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            mesh = make_mesh((1,), ("data",), "cuda")
            for engine in ("odd_even", "sample"):
                name = f"DS2 shortlex tuple, {engine}, 1 rank over NCCL"
                out, counts = launch_counts(lambda: distributed_sort_lex(
                    lanes, mesh, engine=engine, device=device))
                check_engine_output(name, lanes, out)
                for kname, c in counts.items():
                    report.rows[kname]["launches"] += c
                t = wall(lambda: distributed_sort_lex(
                    lanes, mesh, engine=engine, device=device), reps=3)
                print(f"[mesh] {name}: median {t * 1e3:.3f} ms over 3; "
                      f"launches {counts}; lex order: equal")
        finally:
            dist.destroy_process_group()
        # ... and MESH_RANKS processes on this card over gloo
        np.savez(os.path.join(tmp, "ds2_tuple.npz"),
                 **{f"lane{i}": a for i, a in enumerate(lanes)})
        t0 = time.perf_counter()
        outs = run_mesh_ranks(MESH_RANKS, tmp)
        total = Counter()
        for r, text in enumerate(outs):
            for line in text.splitlines():
                if line.startswith("MESH_LAUNCHES "):
                    total.update(json.loads(line.split(" ", 1)[1]))
                elif line.startswith("MESH_TIMES ") and r == 0:
                    times = json.loads(line.split(" ", 1)[1])
                    for case, t in times.items():
                        print(f"[mesh] {MESH_RANKS} gloo ranks on this card, "
                              f"{case}: {t * 1e3:.3f} ms (rank 0, one call; "
                              "collectives staged through the host)")
        for kname, c in total.items():
            report.rows[kname]["launches"] += c
        for kname in ("bitonic_rows_lex", "merge_adjacent_lex",
                      "merge_runs_lex"):
            if total[kname] == 0:
                raise AssertionError(f"the gloo ranks never launched "
                                     f"{kname}")
        print(f"[mesh] {MESH_RANKS} gloo ranks: every rank's output in lex "
              f"order; launches over all ranks {dict(total)}; "
              f"{time.perf_counter() - t0:.1f} s with the processes' start")
    print(f"[mesh] phase took {time.perf_counter() - t_phase:.1f} s")


# --- phase 6 ----------------------------------------------------------------

def serve_prompts(vocab: int):
    """The wave's prompts: lengths ``default_rng(0).integers(16, 513)``,
    tokens from the same generator."""
    import numpy as np
    rng = np.random.default_rng(0)
    lengths = rng.integers(16, 513, SERVE_REQUESTS)
    return [rng.integers(1, vocab, int(l)).tolist() for l in lengths]


def admission_queue(n: int, seed: int):
    """``n`` requests whose lengths, first and second tokens tie often (a
    few values each), so the payload tie-break decides."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, 4, int(rng.integers(16, 20))).tolist())
            for i in range(n)]


def timed(fn, times: list):
    """``fn`` with its calls timed on the host clock between two device
    synchronizations, each time appended to ``times`` in ms."""
    import torch

    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    return run


def full_width(device, arch: str = SERVE_ARCH, n_layers: int = 0):
    """``arch`` at its published dimensions (bfloat16) on ``device`` —
    its depth cut to ``n_layers`` where given — weights drawn from a
    seeded ``torch.Generator``, its parameters counted on the ``meta``
    device first; returns ``(cfg, lm, seconds)``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    cfg = get_config(arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    n = sum(p.numel() for p in init_lm(cfg, device="meta").parameters())
    print(f"[model] {cfg.name}: {n} parameters counted on meta "
          f"({n * 2 / 1e9:.2f} GB in bf16)")
    t0 = time.perf_counter()
    lm = init_lm(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    return cfg, lm, time.perf_counter() - t0


def used(runs: dict) -> dict:
    """The launch counts of the kernels that ran."""
    return {k: c for k, c in runs.items() if c}


def recorded_dispatches():
    """Patch ``models.moe._sort_assignments`` to keep, for every call, its
    ``(sorted expert ids, permutation)`` and those of ``sort_impl='xla'``
    (a stable ``torch.argsort``) on the same assignments; returns the list
    and the undo."""
    from repro_torch.models import moe
    real, seen = moe._sort_assignments, []

    def rec(flat_e, payload, impl):
        out = real(flat_e, payload, impl)
        seen.append((out, real(flat_e, payload, "xla")))
        return out
    moe._sort_assignments = rec

    def undo():
        moe._sort_assignments = real
    return seen, undo


def serve_wave(report, engine, path, tag="serve"):
    """Serve the wave (:func:`serve_prompts`, 16 new tokens each) through
    ``BucketedScheduler(engine).run`` with every launch counter read around
    it; require every request answered with 16 tokens and each kernel of
    ``path`` launched; print tokens/s, prefill and decode medians, padding
    waste and peak memory. The timed wrappers are taken off the engine
    again: they refer to it, and the cycle would keep its model on the card
    after the caller drops it."""
    import torch
    from repro_torch.data import plan_buckets
    from repro_torch.serve import BucketedScheduler, Request
    cfg = engine.cfg
    engine.generate([[1, 2, 3]], max_new=2)            # cuBLAS and caches
    times = {"prefill": [], "decode": []}
    engine._prefill = timed(engine._prefill, times["prefill"])
    engine._decode = timed(engine._decode, times["decode"])
    prompts = serve_prompts(cfg.vocab_size)
    reqs = [Request(i, p, max_new=SERVE_MAX_NEW) for i, p in enumerate(prompts)]
    sched = BucketedScheduler(engine, batch_size=SERVE_BATCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        results, runs = launch_counts(lambda: sched.run(reqs))
    finally:
        del engine._prefill, engine._decode
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for kname, c in runs.items():
        report.rows[kname]["launches"] += c
    if sorted(r.request_id for r in results) != list(range(len(reqs))) \
            or any(len(r.tokens) != SERVE_MAX_NEW for r in results):
        raise AssertionError(f"{tag}: not every request was answered with "
                             f"{SERVE_MAX_NEW} tokens")
    for kname in path:
        if runs[kname] == 0:
            raise AssertionError(f"{tag}: {kname} was never launched")
    tokens = sum(len(r.tokens) for r in results)
    bounds = plan_buckets([len(p) for p in prompts], sched.n_buckets)
    waste = BucketedScheduler.padding_stats(reqs, bounds)
    print(f"[{tag}] {cfg.name}: {len(results)} requests, {tokens} tokens in "
          f"{wall:.3f} s ({tokens / wall:.1f} tokens/s); bounds {bounds}; "
          f"{len(times['prefill'])} prefill batches, median "
          f"{statistics.median(times['prefill']):.2f} ms a batch; "
          f"{len(times['decode'])} decode steps, median "
          f"{statistics.median(times['decode']):.2f} ms a step; padding "
          f"waste global {waste['global_waste']:.4f} bucketed "
          f"{waste['bucketed_waste']:.4f}; max_memory_allocated {peak} B; "
          f"launches {used(runs)}")


def check_dispatch(report, cfg, lm, device, tag="serve"):
    """One full-width prefill batch of ``SERVE_BATCH x DISPATCH_SEQ`` seeded
    tokens with the 'xla' and the 'pallas' dispatch: the kernels'
    permutation at every MoE layer against the stable argsort's of the
    same assignments, and the two forwards' logits within
    ``DISPATCH_LOGIT_ATOL``."""
    import numpy as np
    import torch
    from repro_torch.models import forward
    from repro_torch.parallel.sharding import Rules
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (SERVE_BATCH, DISPATCH_SEQ))).to(device)}
    logits = {}
    for impl in ("xla", "pallas"):
        ms = []
        with torch.inference_mode():
            out, runs = launch_counts(lambda: timed(forward, ms)(
                cfg, lm, batch, Rules(), sort_impl=impl))
        if impl == "pallas":
            for kname, c in runs.items():
                report.rows[kname]["launches"] += c
        logits[impl] = out[0].float()
        del out
        print(f"[{tag}] prefill {SERVE_BATCH} x {DISPATCH_SEQ} with "
              f"sort_impl={impl!r}: {ms[0]:.2f} ms; launches {used(runs)}")
    seen, undo = recorded_dispatches()
    try:
        with torch.inference_mode():
            forward(cfg, lm, batch, Rules(), sort_impl="pallas")
    finally:
        undo()
    n_moe = cfg.n_layers - cfg.moe.first_dense
    if len(seen) != n_moe:
        raise AssertionError(f"{tag}: expected one sort a MoE layer")
    for layer, (got, want) in enumerate(seen):
        if not all(torch.equal(g.long(), w.long())
                   for g, w in zip(got, want)):
            raise AssertionError(f"{tag}: MoE layer {layer}'s permutation "
                                 "differs between 'pallas' and 'xla'")
    diff = float((logits["pallas"] - logits["xla"]).abs().max())
    scale = float(logits["xla"].abs().max())
    print(f"[{tag}] dispatch: {n_moe} MoE layers' permutations of "
          f"{SERVE_BATCH * DISPATCH_SEQ * cfg.moe.top_k} assignments over "
          f"{cfg.moe.n_experts} experts identical to the stable argsort's; "
          f"logits max abs difference {diff} (max |logit| {scale}, "
          f"tolerance {DISPATCH_LOGIT_ATOL})")
    if not diff <= DISPATCH_LOGIT_ATOL:
        raise AssertionError(f"{tag}: the logits differ past the bf16 "
                             "tolerance")


def check_engine_card_against_cpu(arch, lengths, device):
    """The engine's greedy tokens at ``arch``'s smoke config in float32 on
    the card against the CPU's (TF32 off), the MoE dispatch on the
    kernels."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_lm
    from repro_torch.serve import Engine
    small = get_smoke_config(arch)
    cpu_lm = init_lm(small, seed=0, device="cpu")
    prompts = [list(range(1, 1 + n)) for n in lengths]
    want = Engine(small, cpu_lm, max_seq=64, sort_impl="pallas").generate(
        prompts, max_new=8)
    got = Engine(small, cpu_lm.to(device), max_seq=64,
                 sort_impl="pallas").generate(prompts, max_new=8)
    if got != want:
        raise AssertionError(f"engine {arch}: the card's greedy tokens {got} "
                             f"differ from the CPU's {want}")


def phase_serve(report, device):
    """Serve Granite-MoE 1B at full width through the scheduler and the
    engine with the kernels' dispatch ('pallas'), then check the admission
    permutation, the dispatch and the engine against the plain versions."""
    import torch
    from repro_torch.serve import BucketedScheduler, Engine
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, lm, t_init = full_width(device)
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
          f"{n_params} parameters in {lm.embed.dtype}, drawn on the card in "
          f"{t_init:.2f} s")

    # 1. serve 32 requests
    engine = Engine(cfg, lm, max_seq=SERVE_MAX_SEQ, sort_impl="pallas")
    serve_wave(report, engine, SERVE_PATH)

    # 2. the admission permutation on the card against the CPU
    for n in ADMISSION_QUEUES:
        queue = admission_queue(n, seed=n)
        got, runs = launch_counts(lambda: BucketedScheduler._order_by_length(
            queue, device=device))
        want = BucketedScheduler._order_by_length(queue, device="cpu")
        for kname, c in runs.items():
            report.rows[kname]["launches"] += c
        if [r.request_id for r in got] != [r.request_id for r in want]:
            raise AssertionError(f"admission of {n}: the card's permutation "
                                 "differs from the plain versions' on the "
                                 "CPU")
        print(f"[serve] admission of {n} requests: permutation equal to the "
              f"CPU's; launches {used(runs)}")

    # 3. the dispatch: one full-width prefill batch, 'pallas' and 'xla'
    check_dispatch(report, cfg, lm, device)
    del lm, engine
    torch.cuda.empty_cache()

    # 4. the engine on the card against the CPU, smoke config in float32
    check_engine_card_against_cpu(SERVE_ARCH, SMOKE_PROMPTS[:4], device)
    print(f"[serve] engine at the smoke config in float32: greedy tokens "
          f"equal on the card and the CPU")
    print(f"[serve] phase took {time.perf_counter() - t_phase:.1f} s")


# --- phase 7 ----------------------------------------------------------------

def cache_bytes(cache) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for leaves in cache.values() for leaf in leaves.values())


def phase_families(report, device):
    """The MLA and state-space families on the card: MiniCPM3-4B and
    Zamba2-1.2B at their published widths and depths serving the wave;
    deepseek-v2 at its published width, its depth cut to its dense layer
    and two MoE layers, through one 8 x 512 prefill with each dispatch and
    a few decode steps; the four archs' smoke configs in float32 on the
    card against the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache
    from repro_torch.serve import Engine
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1-2. MiniCPM3-4B and Zamba2-1.2B serve the wave
    for arch in FAMILY_ARCHS:
        cfg, lm, t_init = full_width(device, arch)
        print(f"[families] {cfg.name}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.family} / {cfg.attn}, drawn on the card "
              f"in {t_init:.2f} s")
        serve_wave(report, Engine(cfg, lm, max_seq=SERVE_MAX_SEQ,
                                  sort_impl="pallas"),
                   ("oets_rows_lex",), tag="families")
        held, _ = init_cache(cfg, SERVE_BATCH, SERVE_MAX_SEQ, abstract=True)
        gqa = (2 * cfg.n_layers * SERVE_BATCH * SERVE_MAX_SEQ
               * cfg.n_kv_heads * cfg.head_dim * 2)
        print(f"[families] {cfg.name}: decode cache at batch {SERVE_BATCH}, "
              f"max_seq {SERVE_MAX_SEQ}: {cache_bytes(held)} B "
              f"({', '.join(f'{n}: {sorted(l)}' for n, l in held.items())}) "
              f"against {gqa} B for a GQA cache of {cfg.n_layers} layers of "
              f"{cfg.n_kv_heads} x {cfg.head_dim}")
        del lm
        torch.cuda.empty_cache()

    # 3. deepseek-v2: MLA + 160 experts top-6 at full width, depth cut
    published = get_config(DEEPSEEK_ARCH).n_layers
    cfg, lm, t_init = full_width(device, DEEPSEEK_ARCH, DEEPSEEK_LAYERS)
    print(f"[families] {cfg.name}: n_layers {published} → {cfg.n_layers} "
          f"(first_dense {cfg.moe.first_dense} + "
          f"{cfg.n_layers - cfg.moe.first_dense} MoE), d_model "
          f"{cfg.d_model}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
          f"drawn on the card in {t_init:.2f} s")
    check_dispatch(report, cfg, lm, device, tag="families")
    engine = Engine(cfg, lm, max_seq=SERVE_MAX_SEQ, sort_impl="pallas")
    engine.generate([[1, 2, 3]], max_new=2)
    times = []
    engine._decode = timed(engine._decode, times)
    prompts = [list(range(1, 17))] * SERVE_BATCH
    try:
        out, runs = launch_counts(lambda: engine.generate(
            prompts, max_new=DEEPSEEK_DECODE_STEPS + 1))
    finally:
        del engine._decode
    for kname, c in runs.items():
        report.rows[kname]["launches"] += c
    n_moe = cfg.n_layers - cfg.moe.first_dense
    if runs["oets_rows_lex"] != DEEPSEEK_DECODE_STEPS * n_moe \
            or any(len(t) != DEEPSEEK_DECODE_STEPS + 1 for t in out):
        raise AssertionError(f"families: {DEEPSEEK_DECODE_STEPS} decode steps "
                             f"of {n_moe} MoE layers made "
                             f"{runs['oets_rows_lex']} B1 dispatches")
    print(f"[families] {cfg.name} decode: {DEEPSEEK_DECODE_STEPS} steps of "
          f"{SERVE_BATCH * cfg.moe.top_k} assignments a MoE layer, median "
          f"{statistics.median(times):.2f} ms a step; launches {used(runs)}")
    del lm, engine
    torch.cuda.empty_cache()

    # 4. the smoke configs on the card against the CPU
    for arch in SMOKE_ARCHS:
        check_engine_card_against_cpu(arch, SMOKE_PROMPTS, device)
        print(f"[families] engine {arch} at the smoke config in float32, "
              f"prompts of {SMOKE_PROMPTS} tokens: greedy tokens equal on "
              "the card and the CPU")
    print(f"[families] phase took {time.perf_counter() - t_phase:.1f} s")


# --- phase 8 ----------------------------------------------------------------

def train_batch(cfg, batch: int, seq: int, device, index: int = 0):
    """Batch ``index`` of the training loop's stream (``TokenStream``, or
    seeded frames for the frames archs) on ``device``."""
    from repro_torch.interop import to_device
    from repro_torch.launch.train import _make_batch_iter
    it = _make_batch_iter(cfg, batch, seq)
    for _ in range(index):
        next(it)
    return {k: to_device(v, device) for k, v in next(it).items()}


def dispatch_launches(device, n: int, n_experts: int) -> dict:
    """The kernel launches of one 'pallas' dispatch sort of ``n`` seeded
    expert ids — what the code's tier plan gives at ``n``."""
    import torch
    from repro_torch.models import moe
    gen = torch.Generator(device=device).manual_seed(2)
    e = torch.randint(0, n_experts, (n,), generator=gen, device=device,
                      dtype=torch.int32)
    iota = torch.arange(n, dtype=torch.int32, device=device)
    return used(launch_counts(
        lambda: moe._sort_assignments(e, iota, "pallas"))[1])


def timed_steps(train_mod, times: list, per_step: list):
    """Replace ``train_mod.make_train_step`` so each step it builds is timed
    (host clock between two synchronizations) and its kernel launches
    read (the counters are not reset); returns the undo."""
    from repro_torch.kernels import KERNELS
    real = train_mod.make_train_step

    def make(*args, **kw):
        step_fn = timed(real(*args, **kw), times)

        def counted(*a, **kw_):
            before = {n: k.launches for n, k in KERNELS.items()}
            out = step_fn(*a, **kw_)
            per_step.append({n: k.launches - before[n]
                             for n, k in KERNELS.items()
                             if k.launches != before[n]})
            return out
        return counted
    train_mod.make_train_step = make

    def undo():
        train_mod.make_train_step = real
    return undo


def timed_checkpoints(train_mod, times: dict):
    """Replace ``train_mod.CheckpointManager`` with one whose ``save``
    (the copy to the host), its writes (on the writer thread), its wait
    for a write in flight and its restore are timed; returns the undo."""
    from repro_torch.checkpoint import manager
    real_cls, real_save = train_mod.CheckpointManager, manager.save

    def write(*args, **kw):
        t0 = time.perf_counter()
        out = real_save(*args, **kw)
        times["write"].append(time.perf_counter() - t0)
        return out

    class Timed(real_cls):
        def save(self, step, tree, extra=None):
            t0 = time.perf_counter()
            super().save(step, tree, extra)
            times["save"].append(time.perf_counter() - t0)

        def restore_latest(self, target, device="cuda"):
            t0 = time.perf_counter()
            self.wait()
            t1 = time.perf_counter()
            out = super().restore_latest(target, device)
            times["wait"].append(t1 - t0)
            times["restore"].append(time.perf_counter() - t1)
            return out

    train_mod.CheckpointManager, manager.save = Timed, write

    def undo():
        train_mod.CheckpointManager, manager.save = real_cls, real_save
    return undo


def train_full_width(report, device, workdir):
    """Granite-MoE 1B at its published width and depth through
    ``train_loop``: 8 steps of 8 x 512 tokens, snapshots every 4 steps, a
    failure at step 6 and the resume from step 4; the kernels' launches a
    step held to the code's count; the last snapshot read back."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint import restore
    from repro_torch.configs import get_config
    from repro_torch.interop import lm_to_reference, named_from_reference
    from repro_torch.launch import train as train_mod
    from repro_torch.models import init_lm
    from repro_torch.training import Hyper
    cfg = get_config(TRAIN_ARCH)
    n_params = sum(p.numel() for p in init_lm(cfg, device="meta")
                   .parameters())
    snap_bytes = n_params * (2 + 4 + 4)     # bf16 weights, float32 m and v
    free = shutil.disk_usage(workdir).free
    print(f"[train] {cfg.name}: {n_params} parameters counted on meta; a "
          f"snapshot {snap_bytes} B ({n_params * 2} B of bf16 weights, "
          f"{n_params * 8} B of float32 moments); {free} B free in the "
          f"temporary directory")
    if free < 2.2 * snap_bytes:
        raise AssertionError("train: too little disk for two snapshots")
    n_moe = cfg.n_layers - cfg.moe.first_dense
    n_assign = TRAIN_BATCH * TRAIN_SEQ * cfg.moe.top_k
    per_dispatch = dispatch_launches(device, n_assign, cfg.moe.n_experts)
    want_step = {k: 2 * n_moe * c for k, c in per_dispatch.items()}
    print(f"[train] one 'pallas' dispatch of {n_assign} assignments: "
          f"launches {per_dispatch}; a step's forward and recompute "
          f"({2 * n_moe} dispatches) should launch {want_step}")

    times, per_step = [], []
    ck = {"save": [], "write": [], "wait": [], "restore": []}
    undo_steps = timed_steps(train_mod, times, per_step)
    undo_ckpt = timed_checkpoints(train_mod, ck)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        (lm, losses, events), runs = launch_counts(
            lambda: train_mod.train_loop(
                cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                ckpt_dir=workdir, ckpt_every=TRAIN_CKPT_EVERY,
                fail_at=TRAIN_FAIL_AT, hyper=Hyper(**TRAIN_HYPER),
                verbose=False, device=device))
    finally:
        undo_steps()
        undo_ckpt()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    report.train_peak = peak
    for kname, c in runs.items():
        report.rows[kname]["launches"] += c
    n_first = TRAIN_FAIL_AT[0]
    resumed = TRAIN_STEPS - TRAIN_CKPT_EVERY
    if len(events) != 1 or events[0].step != TRAIN_CKPT_EVERY:
        raise AssertionError(f"train: recovery events {events}, expected "
                             f"one restore of step {TRAIN_CKPT_EVERY}")
    if len(losses) != n_first + resumed or not np.isfinite(losses).all():
        raise AssertionError(f"train: losses {losses}")
    for kname in TRAIN_PATH:
        if runs[kname] == 0:
            raise AssertionError(f"train: {kname} was never launched")
    if any(s != want_step for s in per_step):
        raise AssertionError(f"train: launches a step {per_step}, expected "
                             f"{want_step}")
    steps_on_disk = sorted(os.listdir(workdir))
    on_disk = {d: dir_bytes(os.path.join(workdir, d)) for d in steps_on_disk}
    target = {"params": lm_to_reference(lm)}      # the leaves' shapes
    t1 = time.perf_counter()
    back = named_from_reference(restore(workdir, TRAIN_STEPS, target,
                                        device=device)["params"])
    read_back = time.perf_counter() - t1
    mismatched = [k for k, p in lm.state_dict().items()
                  if not torch.equal(back[k].view(torch.int16),
                                     p.view(torch.int16))]
    if mismatched or steps_on_disk != [f"step_{TRAIN_CKPT_EVERY}",
                                       f"step_{TRAIN_STEPS}"]:
        raise AssertionError(f"train: snapshots {steps_on_disk}; leaves "
                             f"read back unequal: {mismatched[:5]}")
    med = statistics.median(times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[train] {cfg.name} train_loop: {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, failure at {TRAIN_FAIL_AT}, "
          f"{len(events)} recovery (restored step {events[0].step}); "
          f"{len(losses)} finite losses {[round(l, 5) for l in losses]}; "
          f"{wall:.2f} s in all")
    print(f"[train] steps: {len(times)} timed, median {med:.2f} ms a step "
          f"(first {times[0]:.2f} ms, all {[round(t, 2) for t in times]}), "
          f"{tokens / (med / 1e3):.1f} tokens/s at {tokens} tokens a step; "
          f"max_memory_allocated {peak} B")
    print(f"[train] launches a step {per_step[0]} in every step (expected "
          f"{want_step}); the loop's launches {used(runs)}")
    print(f"[train] snapshots: save (the copy to the host) "
          f"{[round(t, 3) for t in ck['save']]} s, writes "
          f"{[round(t, 3) for t in ck['write']]} s, the restore's wait for "
          f"a write in flight {[round(t, 3) for t in ck['wait']]} s, restore "
          f"{[round(t, 3) for t in ck['restore']]} s; on disk {on_disk} B; "
          f"step {TRAIN_STEPS}'s weights read back onto the card in "
          f"{read_back:.3f} s, bit-equal to the trained ones")
    del lm, back
    return cfg


def train_dispatch(report, cfg, device):
    """One full-width step's loss and gradients (``lm_loss`` and its
    backward, remat 'dots') from the weights of seed 0 and the loop's first
    batch: 'pallas' twice and 'xla' twice, all bit-identical; the kernels'
    permutation at every dispatch of the forward and the recompute equal
    to the stable argsort's."""
    import torch
    from repro_torch.models import init_lm, lm_loss
    from repro_torch.parallel.sharding import Rules
    lm = init_lm(cfg, seed=0, device=device)
    batch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, device)
    names, params = zip(*lm.named_parameters())

    def grads(impl):
        loss, _ = lm_loss(cfg, lm, batch, Rules(), sort_impl=impl)
        return loss.detach(), torch.autograd.grad(loss, params)

    seen, undo = recorded_dispatches()
    try:
        want_loss, want = grads("pallas")
    finally:
        undo()
    n_moe = cfg.n_layers - cfg.moe.first_dense
    if len(seen) != 2 * n_moe:
        raise AssertionError(f"train: {len(seen)} dispatch sorts in a step, "
                             f"expected {2 * n_moe} (forward and recompute)")
    for i, (got, ref) in enumerate(seen):
        if not all(torch.equal(g.long(), r.long()) for g, r in zip(got, ref)):
            raise AssertionError(f"train: dispatch {i}'s permutation differs "
                                 "from the stable argsort's")
    print(f"[train] one step, 'pallas': {len(seen)} dispatch sorts (forward "
          f"and recompute of {n_moe} MoE layers), every permutation equal to "
          "the stable argsort's")
    for impl in ("pallas", "xla", "xla"):
        ms = []
        (loss, g), runs = launch_counts(lambda: timed(grads, ms)(impl))
        diff = [n for n, a, b in zip(names, g, want)
                if not torch.equal(a.view(torch.int16), b.view(torch.int16))]
        if diff or not torch.equal(loss, want_loss):
            raise AssertionError(f"train: sort_impl={impl!r} gives other "
                                 f"bits: loss {float(loss)} against "
                                 f"{float(want_loss)}; gradients {diff[:5]}")
        print(f"[train] loss and {len(g)} gradients with "
              f"sort_impl={impl!r}: bit-identical to the first 'pallas' "
              f"run; {ms[0]:.2f} ms; launches {used(runs)}")
        del g
    del lm, want


def train_zamba(device):
    """Zamba2-1.2B at its published width and depth: ``ZAMBA_STEPS`` train
    steps on one repeated 8 x 512 batch (the SSD's backward pass at full
    width; no kernel runs); the losses finite and falling."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.optim import init_opt_state
    from repro_torch.parallel.sharding import Rules
    from repro_torch.training import Hyper, make_train_step
    cfg = get_config(ZAMBA_ARCH)
    lm = init_lm(cfg, seed=0, device=device)
    opt = init_opt_state(lm)
    step = timed(make_train_step(cfg, Rules(), Hyper(**ZAMBA_HYPER)), [])
    batch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, device)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for s in range(ZAMBA_STEPS):
        t0 = time.perf_counter()
        lm, opt, m = step(lm, opt, batch, s)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(l) for l in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train: {cfg.name}'s losses {losses} are not "
                             "finite and falling")
    print(f"[train] {cfg.name}: {ZAMBA_STEPS} steps on one repeated "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} batch, losses "
          f"{[round(l, 5) for l in losses]}; median "
          f"{statistics.median(times):.2f} ms a step (all "
          f"{[round(t, 2) for t in times]}); max_memory_allocated {peak} B")
    del lm, opt


def train_smoke_card_against_cpu(device):
    """Each of ``TRAIN_SMOKE_ARCHS`` at its smoke config in float32: three
    train steps with the kernels' dispatch from the same weights on the
    card and on the CPU; losses and gradient norms within the stated
    tolerances."""
    import copy
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_lm
    from repro_torch.optim import init_opt_state
    from repro_torch.parallel.sharding import Rules
    from repro_torch.training import Hyper, make_train_step
    for arch in TRAIN_SMOKE_ARCHS:
        small = get_smoke_config(arch)
        hyper = Hyper(lr=1e-3, warmup=1, total_steps=TRAIN_SMOKE_STEPS,
                      sort_impl="pallas")
        cpu_lm = init_lm(small, seed=0, device="cpu")
        card_lm = copy.deepcopy(cpu_lm).to(device)
        out = {}
        for dev, lm in (("cpu", cpu_lm), ("card", card_lm)):
            opt = init_opt_state(lm)
            step = make_train_step(small, Rules(), hyper)
            out[dev] = []
            for s in range(TRAIN_SMOKE_STEPS):
                batch = train_batch(small, *TRAIN_SMOKE_SHAPE,
                                    lm.final_norm.w.device, index=s)
                lm, opt, m = step(lm, opt, batch, s)
                out[dev].append((float(m["loss"]), float(m["grad_norm"])))
        rel = [(abs(c[0] - w[0]) / abs(w[0]), abs(c[1] - w[1]) / abs(w[1]))
               for c, w in zip(out["card"], out["cpu"])]
        loss_err = max(r[0] for r in rel)
        gnorm_err = max(r[1] for r in rel)
        print(f"[train] {arch} smoke, float32, {TRAIN_SMOKE_STEPS} steps of "
              f"{TRAIN_SMOKE_SHAPE}: card (loss, grad_norm) {out['card']}, "
              f"CPU {out['cpu']}; largest relative differences: loss "
              f"{loss_err:.3g} (tolerance {TRAIN_LOSS_RTOL}), grad_norm "
              f"{gnorm_err:.3g} ({TRAIN_GNORM_RTOL})")
        if not (loss_err <= TRAIN_LOSS_RTOL and gnorm_err <= TRAIN_GNORM_RTOL):
            raise AssertionError(f"train: {arch}'s steps on the card differ "
                                 "from the CPU's past the tolerance")


def phase_train(report, device):
    """Training on the card (``phase_train``): Granite-MoE 1B at full width
    trained, killed and resumed; one step with each dispatch bit for bit;
    Zamba2-1.2B at full width; seven smoke archs card against CPU."""
    import gc
    import tempfile
    import torch
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as workdir:
        cfg = train_full_width(report, device, workdir)
    gc.collect()
    torch.cuda.empty_cache()
    train_dispatch(report, cfg, device)
    gc.collect()
    torch.cuda.empty_cache()
    train_zamba(device)
    gc.collect()
    torch.cuda.empty_cache()
    train_smoke_card_against_cpu(device)
    print(f"[train] phase took {time.perf_counter() - t_phase:.1f} s")


# --- phase 9 ----------------------------------------------------------------

def collective_bytes():
    """A ``TorchDispatchMode`` that adds up, on this rank, the bytes of
    every c10d collective run inside it (each operand's input and output:
    what gloo copies between the card and the host) in ``.bytes`` and
    counts the calls by op in ``.calls``. A ``DTensor`` op is let through
    first (``NotImplemented``), so that the collectives of its
    redistributions come back through the mode (``CommDebugMode``'s
    way)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Mode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes, self.calls = 0, Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if isinstance(func, torch._ops.HigherOrderOperator):
                return func(*args, **kwargs)
            if any(t is DTensor for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            name = func.__name__
            if func.namespace in ("_c10d_functional", "c10d") \
                    and not name.startswith(("wait_tensor", "_wrap")):
                self.calls[name] += 1
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in tree_leaves((args, kwargs, out))
                                  if isinstance(t, torch.Tensor))
            return out
    return Mode()


def plan_scalar(x) -> float:
    """A 0-d tensor or ``DTensor`` (every rank calls it) as a float."""
    return float(x.full_tensor() if hasattr(x, "full_tensor") else x)


def plan_rows(mesh, t):
    """``(rows, start)``: this rank's rows of ``t`` whole along every
    other axis and the first row's index: a ``DTensor``'s batch split over
    ``data`` only (a redistribution, which every rank runs), a plain
    tensor's all of them from 0."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return t, 0
    local = t.redistribute(mesh, (Shard(0), Replicate())).to_local()
    return local, mesh.get_local_rank("data") * local.shape[0]


def plan_rows_err(mesh, got, want) -> float:
    """The largest ``|got - want|`` over the ranks: ``got`` a ``DTensor``
    split on its batch axis over ``data`` only, ``want`` the whole tensor,
    each rank comparing its own rows."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.parallel.compat import pmax
    if tuple(got.placements) != (Shard(0), Replicate()):
        raise AssertionError(f"plan: placements {got.placements}, expected "
                             "the batch split over data")
    local, start = plan_rows(mesh, got)
    err = (local.float() - want[start:start + local.shape[0]].float()).abs()
    return float(pmax(err.max(), None))


def routed(run):
    """``run()`` with the expert ids of every MoE dispatch recorded (each
    the whole assignment list); returns ``(result, [ids])``."""
    from repro_torch.models import moe
    real, ids = moe._sort_assignments, []

    def rec(flat_e, payload, impl):
        ids.append(flat_e.clone())
        return real(flat_e, payload, impl)
    moe._sort_assignments = rec
    try:
        return run(), ids
    finally:
        moe._sort_assignments = real


def layered(mesh, run, feed=None):
    """``run()`` with every transformer block's and the head's input
    recorded whole (the unsharded run's), every block's output as this
    rank's rows (:func:`plan_rows`), and every MoE dispatch's expert id and
    kept flag of each assignment (token-major, the whole list). With
    ``feed`` (an unsharded run's inputs), each block and the head take
    their input from it instead, placed as their own input: each is then
    held alone, whatever the blocks before it did. Returns ``(result,
    inputs, [(rows, start)], [(ids, kept)])``."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.models import model, moe
    real = model.transformer_block, model._head, moe._pack
    ins, xs, picks = [], [], []

    def fed(args):
        args, x = list(args), args[2]
        if feed is None:
            ins.append(x.clone())
        else:
            x_in = feed[len(ins)]
            ins.append(x_in)
            args[2] = distribute_tensor(
                x_in, x.device_mesh, x.placements, src_data_rank=None) \
                if isinstance(x, DTensor) else x_in
        return args

    def block(*args, **kw):
        out = real[0](*fed(args), **kw)
        rows, start = plan_rows(mesh, out[0])
        xs.append((rows.clone(), start))
        return out

    def head(*args, **kw):
        return real[1](*fed(args), **kw)

    def pack(xf, top_k, sorted_e, perm, n_experts, cap):
        buf, slot = real[2](xf, top_k, sorted_e, perm, n_experts, cap)
        ids, kept = torch.empty_like(sorted_e), torch.empty_like(perm,
                                                                 dtype=bool)
        ids[perm], kept[perm] = sorted_e, slot < n_experts * cap
        picks.append((ids, kept))
        return buf, slot
    model.transformer_block, model._head, moe._pack = block, head, pack
    try:
        out = run()
    finally:
        model.transformer_block, model._head, moe._pack = real
    return out, ins, xs, picks


def plan_block_check(mesh, got, want, top_k: int):
    """Float32 calls ``got`` (sharded, each block and the head fed the
    unsharded inputs) against ``want`` (unsharded), each of
    :func:`layered`, Granite's every layer a MoE layer: each block's output
    at the tokens whose experts and kept flags there are the unsharded
    run's (elsewhere the output jumps), and the logits at every token, in
    this rank's rows, relative to the largest element compared. Returns
    per output the relative difference and the tokens compared over the
    ranks (each row once), and per layer the assignments whose expert
    changed and all of them."""
    import torch
    from repro_torch.parallel.compat import pmax, psum
    n = len(want[0][2])
    dev = want[0][0].device
    rel, seen = torch.zeros(n + 1, device=dev), torch.zeros(n + 1,
                                                            device=dev)
    moved, total = [0] * n, [0] * n

    def compare(i, rows, start, whole, ok):
        ok = ok[start:start + len(rows)]
        if ok.any():
            g, w = rows[ok], whole[start:start + len(rows)][ok]
            rel[i] = torch.maximum(rel[i], (g - w).abs().max()
                                   / w.abs().max())
            seen[i] += ok.sum()
    for (g_lg, _, g_xs, g_picks), (w_lg, _, w_xs, w_picks) in zip(
            got, want, strict=True):
        b, sq = w_lg.shape[:2]
        for i, ((gi, gk), (wi, wk)) in enumerate(zip(g_picks, w_picks,
                                                     strict=True)):
            ids = (gi != wi).reshape(b, sq, top_k)
            moved[i] += int(ids.sum())
            total[i] += ids.numel()
            same = ~(ids | (gk != wk).reshape(b, sq, top_k)).any(-1)
            compare(i, *g_xs[i], w_xs[i][0], same)
        compare(n, *plan_rows(mesh, g_lg), w_lg,
                torch.ones((b, sq), dtype=torch.bool, device=dev))
    copies = mesh.size() // mesh.size(mesh.mesh_dim_names.index("data"))
    return (pmax(rel, None).tolist(),
            [round(c / copies) for c in psum(seen, None).tolist()], moved,
            total)


def plan_block_held(rel, seen, moved, total) -> bool:
    """Whether :func:`plan_block_check`'s results hold: every output
    compared at some token and within ``PLAN_F32_RTOL``, and at each layer
    at most ``PLAN_F32_FLIPS`` of the assignments moved to another expert
    (a rounding moves a few near a tie, a misplaced router most)."""
    return min(seen) > 0 and max(rel) <= PLAN_F32_RTOL and all(
        m <= max(PLAN_F32_FLIPS[0], PLAN_F32_FLIPS[1] * t)
        for m, t in zip(moved, total))


def plan_granite(rank, mesh, device, out):
    """Granite-MoE 1B at full width on the (data 2, model 2) mesh in bf16,
    the issue's run: the unsharded prefill and greedy decode in every rank,
    the unsharded train step in rank 0, then the same weights (redrawn
    from seed 0) placed by ``shard_lm``, and the sharded prefill (counted,
    then timed bare), decode and train step beside them. bf16 at this
    width and random weights is chaotic (the routing of most assignments
    changes by the last layer), so the two runs' differences and phase 6's
    bound are printed, not held: :func:`plan_granite_f32` holds the same
    plan in float32."""
    import gc
    import numpy as np
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models import decode_step, forward, init_cache, init_lm
    from repro_torch.models.param import distribute_tree, shard_lm
    from repro_torch.optim import init_opt_state
    from repro_torch.parallel.compat import set_mesh
    from repro_torch.parallel.sharding import Rules
    from repro_torch.serve import Engine
    from repro_torch.training import Hyper, make_train_step
    rules, say = Rules(), out["say"]
    cfg, lm, secs = full_width(device, PLAN_ARCH)
    whole = sum(p.numel() * p.element_size() for p in lm.parameters())
    tokens = plan_tokens(cfg, DISPATCH_SEQ, device)
    batch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, device)
    hyper = Hyper(**TRAIN_HYPER)
    with torch.inference_mode():
        ref_logits, ref_ids = routed(lambda: forward(
            cfg, lm, {"tokens": tokens}, rules, sort_impl="pallas")[0])
        cache, cache_axes = init_cache(cfg, SERVE_BATCH, PLAN_DECODE_SEQ,
                                       device=device)
        fed, ref_dec = [tokens[:, :1]], []
        for i in range(PLAN_DECODE_STEPS):
            lg = decode_step(cfg, lm, cache, fed[i], i, rules,
                             sort_impl="pallas")[0]
            ref_dec.append(lg)
            nxt = lg[:, -1].argmax(-1, keepdim=True).to(tokens.dtype)
            torch.distributed.broadcast(nxt, 0)    # rank 0's, in every rank
            fed.append(nxt)
        del cache
    prompts = plan_prompts(cfg)
    ref_gen = Engine(cfg, lm, max_seq=PLAN_GEN_MAX_SEQ,
                     sort_impl="pallas").generate(prompts, PLAN_GEN_NEW)
    if rank == 0:
        ms = []
        m = timed(make_train_step(cfg, rules, hyper), ms)(
            lm, init_opt_state(lm), batch, 0)[2]
        ref_step = (plan_scalar(m["loss"]), plan_scalar(m["grad_norm"]))
        say(f"unsharded train step in rank 0 (remat {cfg.remat!r}): loss "
            f"{ref_step[0]}, grad_norm "
            f"{ref_step[1]}, {ms[0]:.2f} ms")
        del m, lm
        gc.collect()
        torch.cuda.empty_cache()
        lm = init_lm(cfg, seed=0, device=device)      # the step moved it

    # ---- placed on the mesh ----
    t0 = time.perf_counter()
    shard_lm(lm, rules, mesh, src_data_rank=None)
    torch.cuda.synchronize()
    local = sum(p.to_local().numel() * p.element_size()
                for p in lm.parameters())
    want = {"embed": (Shard(1), Replicate()), "head": (Shard(0), Replicate())}
    for name, pl in want.items():
        if tuple(getattr(lm, name).placements) != pl:
            raise AssertionError(f"plan: {name} placed "
                                 f"{getattr(lm, name).placements}, expected "
                                 f"{pl} (vocab {cfg.vocab_size} replicated)")
    say(f"shard_lm in {time.perf_counter() - t0:.2f} s: {local} B of the "
        f"{whole} B of weights in this rank ({local / whole:.4f}); vocab "
        f"{cfg.vocab_size} does not divide by 2, so embed is "
        f"{want['embed']} and head {want['head']} (the vocab axis "
        "replicated)")
    out["param_bytes"] = local
    # the sharded runs under no_grad: under inference_mode torch 2.11's
    # DTensor raises in every redistribution (no sharding strategy for the
    # aten.detach_ that its autograd Function takes there)
    with torch.no_grad():           # the cache the decode steps write
        cache_s = distribute_tree(
            init_cache(cfg, SERVE_BATCH, PLAN_DECODE_SEQ, device=device)[0],
            cache_axes, rules, mesh, src_data_rank=None)
    launches = Counter()
    with set_mesh(mesh):
        seen, undo = recorded_dispatches()
        mode = collective_bytes()
        try:
            with torch.no_grad(), mode:
                (logits, ids), runs = launch_counts(lambda: routed(
                    lambda: forward(cfg, lm, {"tokens": tokens}, rules,
                                    sort_impl="pallas")[0]))
        finally:
            undo()
        launches.update(runs)
        err = plan_rows_err(mesh, logits, ref_logits)
        if rank == 0:
            mine = logits.to_local().float()
            d = (mine - ref_logits[:mine.shape[0]].float()).abs()
            flips = [int((a != b).sum()) for a, b in zip(ids, ref_ids)]
            say(f"prefill, rank 0's rows: sharded against unsharded max "
                f"{float(d.max())}, mean {float(d.mean())}, share over "
                f"{DISPATCH_LOGIT_ATOL} "
                f"{float((d > DISPATCH_LOGIT_ATOL).float().mean())}; routing"
                f" changed at {flips} of "
                f"{SERVE_BATCH * DISPATCH_SEQ * cfg.moe.top_k} assignments, "
                "layer by layer")
            del mine, d
        del logits
        if not all(torch.isfinite(t).all() for t in (ref_logits,)):
            raise AssertionError("plan: the unsharded logits are not finite")
        n_moe = cfg.n_layers - cfg.moe.first_dense
        if len(seen) != n_moe or not all(
                torch.equal(g.long(), w.long())
                for got, ref in seen for g, w in zip(got, ref)):
            raise AssertionError("plan: a dispatch's permutation differs from "
                                 "the stable argsort's")
        del seen
        out["prefill_bytes"] = mode.bytes
        ms = []
        with torch.no_grad():       # bare: no mode, nothing recorded
            logits, runs = launch_counts(lambda: timed(forward, ms)(
                cfg, lm, {"tokens": tokens}, rules, sort_impl="pallas")[0])
        launches.update(runs)
        finite = bool(torch.isfinite(logits.to_local()).all())
        del logits
        say(f"sharded prefill {SERVE_BATCH} x {DISPATCH_SEQ}, 'pallas': "
            f"{ms[0]:.2f} ms (a second call, bare); logits max abs "
            f"difference from the unsharded over every rank's rows {err} "
            f"(phase 6's {DISPATCH_LOGIT_ATOL}: "
            f"{'held' if err <= DISPATCH_LOGIT_ATOL else 'missed'}); "
            f"launches {used(runs)}; {n_moe} dispatch permutations in this "
            f"rank equal to the stable argsort's; its collectives move "
            f"{mode.bytes} B through the host in this rank "
            f"({dict(mode.calls)}), counted on the first call")
        if not finite:
            raise AssertionError("plan: the sharded logits are not finite")
        errs, ms = [], []
        for i in range(PLAN_DECODE_STEPS):
            with torch.no_grad():
                lg, runs = launch_counts(lambda: timed(decode_step, ms)(
                    cfg, lm, cache_s, fed[i], i, rules, sort_impl="pallas")[0])
            launches.update(runs)
            errs.append(plan_rows_err(mesh, lg, ref_dec[i]))
        steps = ", ".join(f"{t:.2f}" for t in ms)
        say(f"sharded decode, {PLAN_DECODE_STEPS} steps on the sharded cache "
            f"fed the unsharded run's tokens: {steps} ms; logits max abs "
            f"differences over every rank's rows {errs} "
            f"(phase 6's {DISPATCH_LOGIT_ATOL}: "
            f"{'held' if max(errs) <= DISPATCH_LOGIT_ATOL else 'missed'})")
        if not all(np.isfinite(errs)):
            raise AssertionError("plan: the sharded decode is not finite")
        del cache_s
        # C8: the engine serves the sharded LM (under no_grad: torch 2.11's
        # DTensor raises under inference_mode)
        ms = []
        gen, runs = launch_counts(lambda: timed(Engine(
            cfg, lm, max_seq=PLAN_GEN_MAX_SEQ, sort_impl="pallas").generate,
            ms)(prompts, PLAN_GEN_NEW))
        launches.update(runs)
        same = sum(a == b for g, w in zip(gen, ref_gen) for a, b in zip(g, w))
        say(f"Engine.generate on the sharded LM (no_grad, C8): "
            f"{len(prompts)} prompts of {list(PLAN_GEN_PROMPTS)} tokens, "
            f"{PLAN_GEN_NEW} new tokens, 'pallas': {ms[0]:.2f} ms; {same} of "
            f"{len(prompts) * PLAN_GEN_NEW} greedy tokens equal to the "
            f"unsharded engine's (bf16 at random init is chaotic: printed; "
            f"the gpu test holds them in float32); launches {used(runs)}")
        if [len(g) for g in gen] != [PLAN_GEN_NEW] * len(prompts):
            raise AssertionError(f"plan: the sharded engine answered {gen}")
        out["peak_before_step"] = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        opt = init_opt_state(lm)
        ms = []
        (_, _, m), runs = launch_counts(lambda: timed(
            make_train_step(cfg, rules, hyper), ms)(lm, opt, batch, 0))
        launches.update(runs)
        step = (plan_scalar(m["loss"]), plan_scalar(m["grad_norm"]))
    out["train_peak"] = torch.cuda.max_memory_allocated(device)
    say(f"sharded train step (remat {cfg.remat!r}, 'pallas'): loss {step[0]},"
        f" grad_norm {step[1]}, {ms[0]:.2f} ms; peak {out['train_peak']} B "
        f"in this rank; launches {used(runs)}")
    if rank == 0:
        rel = (abs(step[0] - ref_step[0]) / abs(ref_step[0]),
               abs(step[1] - ref_step[1]) / abs(ref_step[1]))
        say(f"train step sharded against unsharded: relative differences "
            f"loss {rel[0]:.3g}, grad_norm {rel[1]:.3g} (bf16, printed)")
    if not all(np.isfinite(step)):
        raise AssertionError("plan: the sharded step is not finite")
    out["launches"] = dict(launches)
    del lm, opt, m
    gc.collect()
    torch.cuda.empty_cache()


def plan_prompts(cfg):
    """The engine's prompts, of ``PLAN_GEN_PROMPTS`` tokens, from seed 3."""
    import numpy as np
    rng = np.random.default_rng(3)
    return [rng.integers(1, cfg.vocab_size, n).tolist()
            for n in PLAN_GEN_PROMPTS]


def plan_tokens(cfg, seq: int, device):
    """The prefill's ``(SERVE_BATCH, seq)`` tokens, from seed 1."""
    import numpy as np
    import torch
    return torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (SERVE_BATCH, seq))).to(device)


def plan_config(n_layers: int = 0):
    """Granite-MoE 1B's published config in float32, its depth cut to
    ``n_layers`` where given."""
    from repro_torch.configs import get_config
    cfg = get_config(PLAN_ARCH).replace(param_dtype="float32",
                                        compute_dtype="float32")
    return cfg.replace(n_layers=n_layers) if n_layers else cfg


def plan_granite_f32(mesh, device, out):
    """The plan's check at Granite's full width and depth: the same
    weights in float32, unsharded then placed by ``shard_lm``, an
    ``SERVE_BATCH`` x ``PLAN_F32_SEQ`` prefill and ``PLAN_DECODE_STEPS``
    decode steps (teacher-forced) with the kernels' dispatch; in the
    sharded runs every block and the head take the unsharded run's input
    (:func:`layered`), so each is held alone by :func:`plan_block_check`:
    the model amplifies a float32 rounding through its depth whatever the
    plan. Then the check is shown to fail at decode step 0 when layer 0's
    experts' weights have the rows of every shard rolled by one."""
    import gc
    import torch
    from torch.distributed.tensor import Shard
    from repro_torch.models import decode_step, forward, init_cache, init_lm
    from repro_torch.models.param import distribute_tree, shard_lm
    from repro_torch.parallel.compat import set_mesh
    from repro_torch.parallel.sharding import Rules
    rules, say = Rules(), out["say"]
    cfg = plan_config()
    lm = init_lm(cfg, seed=0, device=device)
    tokens = plan_tokens(cfg, PLAN_F32_SEQ, device)
    seq = PLAN_DECODE_STEPS

    def prefill():
        return forward(cfg, lm, {"tokens": tokens}, rules,
                       sort_impl="pallas")[0]

    def decode(cache, i):
        return decode_step(cfg, lm, cache, tokens[:, i:i + 1], i, rules,
                           sort_impl="pallas")[0]

    def report(what, got, want_, ms=""):
        res = plan_block_check(mesh, got, want_, cfg.moe.top_k)
        rel, seen, moved, total = res
        say(f"float32 at full width, {what} sharded against unsharded, "
            f"each block fed the unsharded input{ms}: experts changed at "
            f"{moved} of {total[0]} assignments, layer by layer; tokens "
            f"compared {seen} (every block, then the logits), largest "
            f"relative difference {max(rel):.3g} (bound {PLAN_F32_RTOL}), by"
            f" output {[float(f'{r:.3g}') for r in rel]}")
        return plan_block_held(*res)
    with torch.no_grad():
        want = [layered(mesh, prefill)]
        cache, axes = init_cache(cfg, SERVE_BATCH, seq, device=device)
        want += [layered(mesh, lambda: decode(cache, i)) for i in range(seq)]
        del cache
        shard_lm(lm, rules, mesh, src_data_rank=None)
        gc.collect()
        torch.cuda.empty_cache()

        def sharded_cache():
            return distribute_tree(
                init_cache(cfg, SERVE_BATCH, seq, device=device)[0], axes,
                rules, mesh, src_data_rank=None)
        with set_mesh(mesh):
            ms = []
            got = [layered(mesh, timed(prefill, ms), want[0][1])]
            cache = sharded_cache()
            got += [layered(mesh, timed(lambda: decode(cache, i), ms),
                            want[1 + i][1]) for i in range(seq)]
            held = [report(f"prefill {SERVE_BATCH} x {PLAN_F32_SEQ}",
                           got[:1], want[:1],
                           f" ({ms[0]:.2f} ms, recording included)"),
                    report(f"{seq} decode steps", got[1:], want[1:],
                           f" ({', '.join(f'{t:.2f}' for t in ms[1:])} ms)")]
            if not all(held):
                raise AssertionError("plan: the float32 sharded runs differ")
            del got
            # the check's power: a misplaced shard must fail it (the
            # experts' weights: at step 0 the one key makes the attention's
            # output v whatever the query)
            w = lm.blocks[0].moe.w_in
            dim = next(q.dim for q in w.placements if isinstance(q, Shard))
            shard = w.to_local()
            shard.copy_(shard.roll(1, dim))
            held = report(
                f"decode step 0 with blocks.0.moe.w_in {tuple(w.placements)}"
                " rolled by a row in every shard",
                [layered(mesh, lambda: decode(sharded_cache(), 0),
                         want[1][1])], want[1:2])
            shard.copy_(shard.roll(-1, dim))
            if held:
                raise AssertionError("plan: the float32 check passed a "
                                     "misplaced weight")
    del lm, want
    gc.collect()
    torch.cuda.empty_cache()


def plan_step_diff(init, want, got):
    """Per leaf of one float32 step ``got`` against ``want`` (each
    ``(params, opt)``, from ``init``'s weights: ``init`` a dict, or a
    pair of dicts where ``got`` started from other ones), each rank on its
    own shards of ``got``'s ``DTensor``s: ``{name: [elements whose change
    is off by more than PLAN_DELTA_ATOL, elements whose change in want is
    above it, elements, the largest difference of changes, the largest
    moment difference over the leaf's largest]}``, counts summed over the
    ranks with each element once."""
    import math
    import torch
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    from repro_torch.parallel.compat import pmax, psum
    (p0, o0), (p1, o1) = want, got
    i0, i1 = init if isinstance(init, tuple) else (init, init)
    out, sharded = {}, False
    with torch.no_grad():
        for k, w0 in i0.items():
            g = p1[k]
            if isinstance(g, DTensor):
                sharded = True
                copies = math.prod(         # the ranks holding an element
                    g.device_mesh.size(i) for i, q in enumerate(g.placements)
                    if not isinstance(q, Shard))

                def mine(t, g=g):   # this rank's shard of a whole tensor
                    return distribute_tensor(t.detach(), g.device_mesh,
                                             g.placements,
                                             src_data_rank=None).to_local()

                def local(t):
                    return t.to_local()
            else:
                copies = 1

                def mine(t):
                    return t.detach()
                local = mine
            d_want = mine(p0[k]) - mine(w0)
            err = ((local(g) - mine(i1[k])) - d_want).abs()
            row = [(err > PLAN_DELTA_ATOL).sum() / copies,
                   (d_want.abs() > PLAN_DELTA_ATOL).sum() / copies,
                   torch.tensor(err.numel() / copies, device=err.device),
                   err.max()]
            for mom in ("m", "v"):
                ref = o0[mom][k]
                row.append((local(o1[mom][k]) - mine(ref)).abs().max()
                           / ref.abs().max().clamp(min=1e-30))
            out[k] = torch.stack([r.double() for r in row[:4]]
                                 + [torch.maximum(*row[4:]).double()])
    table = torch.stack(list(out.values()))
    if sharded:
        table = torch.cat([psum(table[:, :3].contiguous(), None),
                           pmax(table[:, 3:].contiguous(), None)], 1)
    return {k: row for k, row in zip(out, table.tolist())}


def plan_step_check(say, label, cfg, batch, mesh, device):
    """One float32 train step of ``cfg`` (weights from seed 0, remat
    'none') sharded against unsharded, in every rank, the sharded step's
    experts the unsharded step's (:func:`pinned_experts`): the loss and
    gradient norm within phase 8's bounds; each parameter's change from
    the initial weights within ``PLAN_DELTA_ATOL`` of the unsharded step's
    but at ``PLAN_LEAF_OUTLIERS`` of a leaf's elements and
    ``PLAN_STEP_OUTLIERS`` of all (each off by at most twice the lr);
    most changes above that bound; the moments within ``PLAN_MOMENT_RTOL``
    of each leaf's largest. Printed beside it, as the floor of rounding:
    the unsharded step from the weights nudged by one float32 ulp each."""
    import copy
    import torch
    from repro_torch.models import init_lm
    from repro_torch.models.param import shard_lm
    from repro_torch.optim import init_opt_state
    from repro_torch.parallel.compat import set_mesh
    from repro_torch.parallel.sharding import Rules
    from repro_torch.training import Hyper, make_train_step
    rules = Rules()
    hyper = Hyper(**PLAN_STEP_HYPER)
    lm = init_lm(cfg, seed=0, device=device)
    init = {k: v.detach().clone() for k, v in lm.named_parameters()}
    experts = []

    def step(l, sharded=False):
        opt = init_opt_state(l)
        with set_mesh(mesh) if sharded else contextlib.nullcontext(), \
                pinned_experts(experts, replay=bool(experts)):
            l, opt, m = make_train_step(cfg, rules, hyper)(l, opt, batch, 1)
        return (dict(l.named_parameters()), opt), \
            {k: plan_scalar(v) for k, v in m.items()}
    want, m0 = step(copy.deepcopy(lm))
    nudged = copy.deepcopy(lm)
    gen = torch.Generator(device=device).manual_seed(9)
    with torch.no_grad():
        for p in nudged.parameters():
            p.mul_(1 + (torch.randint(0, 2, p.shape, generator=gen,
                                      device=device) * 2 - 1) * 2.0 ** -23)
    start = {k: v.detach().clone() for k, v in nudged.named_parameters()}
    floor = plan_step_diff((init, start), want, step(nudged)[0])
    del nudged, start
    got, m1 = step(shard_lm(copy.deepcopy(lm), rules, mesh,
                            src_data_rank=None), sharded=True)
    diff = plan_step_diff(init, want, got)
    lr = m0["lr"]
    rel = (abs(m1["loss"] - m0["loss"]) / abs(m0["loss"]),
           abs(m1["grad_norm"] - m0["grad_norm"]) / abs(m0["grad_norm"]))

    def total(table):
        rows = list(table.values())
        return ([round(sum(r[i] for r in rows)) for i in range(3)]
                + [max(r[i] for r in rows) for i in (3, 4)])
    (off, moved, size, worst, mom), floor_t = total(diff), total(floor)
    leaf_ok = all(r[0] <= max(PLAN_LEAF_OUTLIERS[0],
                              PLAN_LEAF_OUTLIERS[1] * r[2])
                  for r in diff.values())
    share = max(r[0] / r[2] for r in diff.values())
    say(f"{label}, float32, one step of {tuple(batch['tokens'].shape)} "
        f"sharded against unsharded: loss {m1['loss']} / {m0['loss']}, "
        f"grad_norm {m1['grad_norm']} / {m0['grad_norm']}; relative "
        f"differences {rel[0]:.3g} (bound {TRAIN_LOSS_RTOL}), {rel[1]:.3g} "
        f"({TRAIN_GNORM_RTOL}); parameter changes (lr {lr}) off by more "
        f"than {PLAN_DELTA_ATOL} at {off} of {size} elements (bound "
        f"{PLAN_STEP_OUTLIERS:g} of them), at most {worst:.3g}, a leaf's "
        f"share at most {share:.3g} (bound {PLAN_LEAF_OUTLIERS}); {moved} "
        f"changes above {PLAN_DELTA_ATOL}; moments within {mom:.3g} of "
        f"each leaf's largest ({PLAN_MOMENT_RTOL}); the unsharded step "
        f"from weights nudged by one ulp: {floor_t[0]} off, moments within "
        f"{floor_t[4]:.3g}")
    if not (rel[0] <= TRAIN_LOSS_RTOL and rel[1] <= TRAIN_GNORM_RTOL
            and leaf_ok and off <= PLAN_STEP_OUTLIERS * size
            and worst <= 2 * lr * 1.01 and moved > size / 2
            and mom <= PLAN_MOMENT_RTOL and m1["lr"] == lr
            and PLAN_DELTA_ATOL < lr / 10):
        raise AssertionError(f"plan: the sharded step of {label} differs")


@contextlib.contextmanager
def pinned_experts(experts: list, replay: bool):
    """``models.moe._top_k`` patched: each call's experts appended to
    ``experts``, or, with ``replay``, taken from it in call order, with
    their probabilities. A routing change is a jump that this model's width
    makes likely somewhere (PERF.md), and it moves a few tokens' gradients
    to other experts; with the experts pinned the two steps differ by
    rounding alone, and the routing is held by :func:`plan_block_check`.
    Every call of the forward is one call here (remat 'none')."""
    from repro_torch.models import moe
    real, replayed = moe._top_k, iter(experts)

    def top_k(probs, k):
        if replay:
            idx = next(replayed)
            return probs.gather(-1, idx), idx
        vals, idx = real(probs, k)
        experts.append(idx)
        return vals, idx
    moe._top_k = top_k
    try:
        yield
    finally:
        moe._top_k = real
    if replay and next(replayed, None) is not None:
        raise AssertionError("plan: the replayed step made fewer routings")


def plan_steps(mesh, device, out):
    """:func:`plan_step_check` at Granite's smoke config and at its
    published width cut to ``PLAN_F32_STEP_LAYERS`` layers, the batch
    phase 8's."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(PLAN_ARCH).replace(remat="none")
    plan_step_check(out["say"], f"{PLAN_ARCH} smoke", cfg,
                    train_batch(cfg, *PLAN_SMOKE_SHAPE, device), mesh, device)
    cfg = plan_config(PLAN_F32_STEP_LAYERS).replace(remat="none")
    plan_step_check(out["say"], f"{PLAN_ARCH} at full width, "
                    f"{PLAN_F32_STEP_LAYERS} layers", cfg,
                    train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, device), mesh,
                    device)


def plan_smoke_families(mesh, device, out):
    """The other families at their smoke configs in float32 (GQA, MLA, the
    Mamba2 hybrid): a prefill and two decode steps sharded against
    unsharded, in every rank, within the CPU tests' bound."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode_step, forward, init_cache, init_lm
    from repro_torch.models.param import distribute_tree, shard_lm
    from repro_torch.parallel.compat import set_mesh
    from repro_torch.parallel.sharding import Rules
    rules = Rules()
    for arch in PLAN_SMOKE_ARCHS:
        cfg = get_smoke_config(arch)
        lm = init_lm(cfg, seed=0, device=device)
        lm_s = shard_lm(copy.deepcopy(lm), rules, mesh, src_data_rank=None)
        tokens = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (SERVE_BATCH, 32))).to(device)
        errs = []
        with torch.no_grad():
            want = forward(cfg, lm, {"tokens": tokens}, rules)[0]
            with set_mesh(mesh):
                got = forward(cfg, lm_s, {"tokens": tokens}, rules)[0]
            errs.append(float((got.full_tensor() - want).abs().max()))
            cache, axes = init_cache(cfg, SERVE_BATCH, 8, device=device)
            cache_s = distribute_tree(
                init_cache(cfg, SERVE_BATCH, 8, device=device)[0], axes,
                rules, mesh, src_data_rank=None)
            for i in range(2):
                t = tokens[:, i:i + 1]
                want = decode_step(cfg, lm, cache, t, i, rules)[0]
                with set_mesh(mesh):
                    got = decode_step(cfg, lm_s, cache_s, t, i, rules)[0]
                errs.append(float((got.full_tensor() - want).abs().max()))
        out["say"](f"{arch} smoke, float32, sharded against unsharded: "
                   f"prefill and 2 decode steps, logits max abs differences "
                   f"{errs} (tolerance {PLAN_SMOKE_ATOL})")
        if not max(errs) <= PLAN_SMOKE_ATOL:
            raise AssertionError(f"plan: {arch}'s sharded run differs")


def plan_collectives(rank, world, device, out):
    """The ring, the pipeline, the compressed sum and expert parallelism
    on CUDA tensors over the ``world`` ranks, each held to its
    single-process counterpart computed here from every rank's inputs
    (each rank draws them all from one seed)."""
    import dataclasses
    import types
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe
    from repro_torch.models.moe_ep import ep_moe
    from repro_torch.parallel.compat import make_mesh
    from repro_torch.parallel.compression import compressed_psum
    from repro_torch.parallel.pipeline import pipeline_forward
    from repro_torch.parallel.ring import ring_all_gather, ring_all_reduce
    from repro_torch.parallel.sharding import Rules
    say = out["say"]
    mesh = make_mesh((world,), ("ep",), "cuda")
    group = mesh.get_group("ep")
    gen = torch.Generator(device=device).manual_seed(5)
    y = torch.randn(world, 8192, generator=gen, device=device)
    ms = []
    got = timed(ring_all_reduce, ms)(y[rank], group)
    err = float((got - y.sum(0)).abs().max())
    gathered = ring_all_gather(y[rank], group)
    say(f"ring_all_reduce of 8,192 float32 a rank: {ms[0]:.2f} ms, max abs "
        f"difference from the sum {err}; ring_all_gather equal: "
        f"{torch.equal(gathered, y)}")
    if not (err <= 1e-4 and torch.equal(gathered, y)):
        raise AssertionError("plan: the ring collectives differ")
    ws = torch.randn(world, 256, 256, generator=gen, device=device) * 0.06
    mbs = torch.randn(6, 16, 256, generator=gen, device=device)
    pf = pipeline_forward(lambda w, x: torch.tanh(x @ w), ws[rank], mbs,
                          group)
    if rank == world - 1:
        want = mbs
        for w in ws:
            want = torch.tanh(want @ w)
        err = float((pf - want).abs().max())
        say(f"pipeline_forward, {world} stages, 6 microbatches: last stage "
            f"max abs difference from the sequential composition {err}")
        if not err <= 1e-5:
            raise AssertionError("plan: the pipeline differs")
    mean, res = compressed_psum(y[rank], group, torch.zeros_like(y[rank]))
    scale = torch.clamp(y.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    want_mean = q.to(torch.int32).sum(0).float() * scale / world
    want_res = (y[rank].double() - q[rank].double() * scale.double()).float()
    bits = torch.equal(mean, want_mean) and torch.equal(res, want_res)
    say(f"compressed_psum: mean and residual bit-equal to the one-process "
        f"computation: {bits}; max abs difference from the true mean "
        f"{float((mean - y.mean(0)).abs().max())}")
    if not bits:
        raise AssertionError("plan: compressed_psum differs")
    cfg = get_config(PLAN_ARCH)
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=PLAN_EP_CAPACITY))
    m, dm, bf = cfg.moe, cfg.d_model, torch.bfloat16
    x = torch.randn(world * PLAN_EP_TOKENS, dm, generator=gen,
                    device=device).to(bf)
    p = types.SimpleNamespace(
        router=(torch.randn(dm, m.n_experts, generator=gen, device=device)
                * dm ** -0.5).to(bf),
        w_in=(torch.randn(m.n_experts, dm, 2 * m.d_expert, generator=gen,
                          device=device) * dm ** -0.5).to(bf),
        w_out=(torch.randn(m.n_experts, m.d_expert, dm, generator=gen,
                           device=device) * m.d_expert ** -0.5).to(bf))
    ms = []
    for _ in range(2):
        y_ep, aux = timed(ep_moe, ms)(cfg, mesh, "ep", x, p.router, p.w_in,
                                      p.w_out)
    y_ep = y_ep.full_tensor()
    if rank == 0:
        with torch.inference_mode():
            y_ref, aux_ref = moe(cfg, p, x[None], Rules())
        err = float((y_ep.float() - y_ref[0].float()).abs().max())
        say(f"ep_moe at {PLAN_ARCH}'s width ({m.n_experts} experts, "
            f"{m.n_experts // world} a rank, top-{m.top_k}, {PLAN_EP_TOKENS} "
            f"tokens a rank, capacity factor {PLAN_EP_CAPACITY}): "
            f"{ms[-1]:.2f} ms (second call); max abs difference from moe in "
            f"one rank {err} (tolerance {DISPATCH_LOGIT_ATOL}); aux "
            f"{float(aux)} (summed over the ranks) / {float(aux_ref)}")
        if not err <= DISPATCH_LOGIT_ATOL:
            raise AssertionError("plan: ep_moe differs from moe")


def plan_rank(rank: int, world: int, workdir: str) -> int:
    """One rank of phase 9: joins a gloo group of ``world`` processes on
    ``cuda:0`` (DTensor's collectives on CUDA operands, which gloo stages
    through the host itself), runs :func:`plan_granite`,
    :func:`plan_granite_f32`, :func:`plan_steps`,
    :func:`plan_smoke_families` and :func:`plan_collectives`, and prints
    its lines and one ``PLAN_RESULT`` JSON line."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.compat import make_mesh
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300))
    t0 = time.perf_counter()

    def say(text):
        print(f"[plan] rank {rank}: {text}", flush=True)
    out = {"rank": rank, "say": say}
    try:
        mesh = make_mesh(*PLAN_MESH, "cuda")
        plan_granite(rank, mesh, device, out)
        plan_granite_f32(mesh, device, out)
        plan_steps(mesh, device, out)
        plan_smoke_families(mesh, device, out)
        plan_collectives(rank, world, device, out)
    finally:
        dist.destroy_process_group()
    del out["say"]
    out["peak"] = max(out["peak_before_step"],
                      torch.cuda.max_memory_allocated(device))
    out["seconds"] = time.perf_counter() - t0
    print("PLAN_RESULT " + json.dumps(out), flush=True)
    return 0


def phase_plan(report, device):
    """The parallel plan (``phase_plan``): ``PLAN_RANKS`` gloo ranks of
    :func:`plan_rank` on this card; rank 0's lines printed, every rank's
    B1, B2 and B4 launches required and added to the kernels' rows."""
    import tempfile
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        outs = run_mesh_ranks(PLAN_RANKS, tmp, timeout=PLAN_TIMEOUT,
                              flag="--plan-rank")
    results = []
    for r, text in enumerate(outs):
        for line in text.splitlines():
            if line.startswith("[plan]") and (
                    r == 0 or any(k in line for k in (
                        "B of the", "through the host", "pipeline_forward"))):
                print(line)
            elif line.startswith("PLAN_RESULT "):
                results.append(json.loads(line.split(" ", 1)[1]))
    if len(results) != PLAN_RANKS:
        raise AssertionError("plan: a rank printed no result")
    for res in results:
        for kname in PLAN_PATH:
            if res["launches"].get(kname, 0) == 0:
                raise AssertionError(f"plan: rank {res['rank']} never "
                                     f"launched {kname}")
        for kname, c in res["launches"].items():
            report.rows[kname]["launches"] += c
        print(f"[plan] rank {res['rank']}: {res['seconds']:.1f} s, peak "
              f"{res['peak']} B (train step {res['train_peak']} B), "
              f"launches {used(res['launches'])}")
    print(f"[plan] phase took {time.perf_counter() - t_phase:.1f} s with the "
          f"processes' start")


# --- phase 10 ---------------------------------------------------------------

def launch_hw(device):
    """The card's own properties (``launch.hw.device_properties``) beside
    ``nvidia-smi``'s name and power limit; fails unless it is an H100 whose
    memory is within ``HW_MEMORY_RTOL`` of the data sheet's ``HBM_BYTES``."""
    from repro_torch.launch import hw
    props = hw.device_properties(device)
    smi = nvidia_smi()
    rel = abs(props["total_memory"] - hw.HBM_BYTES) / hw.HBM_BYTES
    print(f"[launch] hw: {props} beside nvidia-smi '{smi}'; total_memory "
          f"{rel:.4f} from the data sheet's {hw.HBM_BYTES:.0f} B (bound "
          f"{HW_MEMORY_RTOL}); peak bf16 {hw.PEAK_FLOPS_BF16:.3g} FLOP/s, HBM "
          f"{hw.HBM_BW:.3g} B/s, NVLink {hw.NVLINK_BW:.3g} B/s (data sheet)")
    if "H100" not in props["name"] or rel > HW_MEMORY_RTOL:
        raise AssertionError(f"launch: the card {props} is not the H100 of "
                             "launch.hw")


def launch_conformance():
    """The conformance matrix in every mode of this host, its kernels'
    launch counters set to 0 before and read after: every cell of
    ``cuda-kernel`` and every supported cell of ``cuda-graph`` must
    conform, and B1-B6 must each have run."""
    from repro_torch.testing import (CONTRACTS, assert_conforms,
                                     available_modes, iter_matrix, run_case)
    modes = available_modes()
    tally = {m.name: Counter() for m in modes}
    reasons, failed = Counter(), []
    t0 = time.perf_counter()

    def run_all():
        for op, engine, mode, gen, dtype in iter_matrix(modes):
            contract = CONTRACTS[op]
            reason = contract.supports(engine, mode, gen)
            if reason:
                tally[mode.name]["skipped"] += 1
                reasons[(mode.name, op, engine, reason)] += 1
                continue
            case = contract.build(gen, dtype)
            try:
                run = run_case(contract, case, engine, mode)
                assert_conforms(contract, run.case, run.outputs)
                tally[mode.name]["passed"] += 1
            except Exception as e:          # noqa: BLE001 - reported below
                tally[mode.name]["failed"] += 1
                failed.append(f"{op}-{engine}-{mode.name}-{gen}-{dtype}: "
                              f"{type(e).__name__}: {str(e)[:300]}")
    _, launches = launch_counts(run_all)
    for name, t in tally.items():
        print(f"[launch] conformance {name}: {t['passed']} passed, "
              f"{t['skipped']} skipped with a reason, {t['failed']} failed")
    for (mode, op, engine, reason), n in sorted(reasons.items()):
        print(f"[launch]   skipped {n} cells of {op}/{engine} in {mode}: "
              f"{reason}")
    print(f"[launch] conformance took {time.perf_counter() - t0:.1f} s; "
          f"launches {used(launches)}")
    for line in failed[:20]:
        print(f"[launch]   FAILED {line}")
    if failed:
        raise AssertionError(f"launch: {len(failed)} conformance cells "
                             "failed")
    missing = [k for k in CONFORMANCE_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"launch: the matrix never launched {missing}")


def launch_dryrun(report):
    """``launch.dryrun.run_cell`` of Granite at full width on fake (1, 1)
    and (2, 2) meshes, at phase 8's train cell and phase 6's prefill cell:
    FLOPs, bytes, collectives and memory a rank; the (2, 2) parameter
    bytes held to phase 9's measurement, the predicted train peak printed
    beside phase 8's measured one."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun
    cells = (ShapeCell("phase8_train", "train", TRAIN_SEQ, TRAIN_BATCH),
             ShapeCell("phase6_prefill", "prefill", DISPATCH_SEQ,
                       SERVE_BATCH))
    for shape in DRYRUN_MESHES:
        for cell in cells:
            rec = dryrun.run_cell(DRYRUN_ARCH, cell, False, accum=1,
                                  mesh_shape=shape)
            mem = rec["memory"]
            print(f"[launch] dry run {DRYRUN_ARCH} {cell.kind} "
                  f"{cell.global_batch} x {cell.seq_len} on a fake "
                  f"{rec['mesh']} group (meta local shards, "
                  f"'{rec['sort_impl']}' dispatch): {rec['trace_s']} s; "
                  f"FLOPs a rank {rec['flops_per_device']:.6g} (global "
                  f"{rec['flops_global']:.6g}, redundant "
                  f"{rec['flops_redundant']:.6g}); HBM bytes a rank "
                  f"{rec['hbm_bytes_per_device']:.6g}; collectives "
                  f"{rec['collectives']}; parameters {mem['params_bytes']} B"
                  f", optimizer {mem['opt_state_bytes']} B, peak "
                  f"{mem['peak_bytes']} B a rank; roofline "
                  f"{rec['roofline']}")
            want = DRYRUN_PARAM_BYTES.get(shape)
            if want is not None and mem["params_bytes"] != want:
                raise AssertionError(f"launch: {mem['params_bytes']} B of "
                                     f"parameters a rank on {shape}, phase 9"
                                     f" measured {want}")
            if cell.kind == "train" and shape == (1, 1):
                measured = report.train_peak
                ratio = (f"{mem['peak_bytes'] / measured:.3f}" if measured
                         else "not measured")
                print(f"[launch] predicted train peak {mem['peak_bytes']} B "
                      f"beside phase 8's max_memory_allocated {measured} B "
                      f"(train_loop with its snapshots): ratio {ratio}")


def phase_launch(report, device):
    """The launch layer and the conformance kit on the card
    (``phase_launch``): :func:`launch_hw`, :func:`launch_conformance`,
    :func:`launch_dryrun`."""
    t_phase = time.perf_counter()
    launch_hw(device)
    launch_conformance()
    launch_dryrun(report)
    print(f"[launch] phase took {time.perf_counter() - t_phase:.1f} s")


# --- phase 11 ---------------------------------------------------------------

class Tee:
    """A stream that writes to every one of ``streams``."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)
        return len(text)

    def flush(self):
        for s in self.streams:
            s.flush()


def printed(run):
    """``run()`` with what it prints to ``sys.stdout`` shown and kept;
    returns ``(result, text)``. A spawned process's prints reach the
    terminal but are not kept."""
    import io
    buf = io.StringIO()
    sys.stdout.flush()
    with contextlib.redirect_stdout(Tee(sys.stdout, buf)):
        out = run()
    sys.stdout.flush()
    return out, buf.getvalue()


def run_example(report, name: str, argv, path, device):
    """``repro_torch.examples.<name>.main(argv)`` on ``device``, its launch
    counters read around it (an 8-rank example's summed over the launches
    each rank reports): it must print ``<name> complete`` and launch each
    kernel of ``path``."""
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    t0 = time.perf_counter()
    (out, text), runs = launch_counts(lambda: printed(
        lambda: mod.main([*argv, "--device", device.type])))
    seconds = time.perf_counter() - t0
    ranks = out if isinstance(out, list) else []
    total = Counter(runs)
    for _, launches in ranks:
        total.update(launches)
    for kname, c in total.items():
        report.rows[kname]["launches"] += c
    if f"{name} complete" not in text:
        raise AssertionError(f"examples: {name} printed no complete line")
    missing = [k for k in path if not total[k]]
    if missing:
        raise AssertionError(f"examples: {name} never launched {missing}")
    where = f" over {len(ranks)} ranks on {device.type}" if ranks else ""
    print(f"[examples] {' '.join((name, *argv))}: complete in {seconds:.2f} s"
          f"{where}; launches {used(dict(total))}")


def count_params(arch: str) -> int:
    """``arch``'s parameters at its published config, counted on meta."""
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import count_params as count
    return count(get_config(arch))[0]


def cli_serve(report, arch: str, device):
    """``launch.serve.main(["--arch", arch, "--sort-impl", "pallas"])`` at
    the published config: every one of its 24 requests answered with 8
    tokens; the scheduler's run, each prefill batch and decode step timed
    (the engine's class patched for the call), peak memory."""
    import torch
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import BucketedScheduler, Engine
    n_params = count_params(arch)
    times = {"run": [], "prefill": [], "decode": []}
    real = (BucketedScheduler.run, Engine._prefill, Engine._decode)
    BucketedScheduler.run = timed(real[0], times["run"])
    Engine._prefill = timed(real[1], times["prefill"])
    Engine._decode = timed(real[2], times["decode"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        results, runs = launch_counts(lambda: serve_mod.main(
            ["--arch", arch, "--sort-impl", "pallas",
             "--device", device.type]))
    finally:
        BucketedScheduler.run, Engine._prefill, Engine._decode = real
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for kname, c in runs.items():
        report.rows[kname]["launches"] += c
    if sorted(r.request_id for r in results) != list(range(CLI_REQUESTS)) \
            or any(len(r.tokens) != CLI_MAX_NEW for r in results):
        raise AssertionError(f"cli: {arch} did not answer every one of "
                             f"{CLI_REQUESTS} requests with {CLI_MAX_NEW} "
                             "tokens")
    if not runs["oets_rows_lex"]:
        raise AssertionError(f"cli: {arch}'s admission never launched B1")
    tokens = sum(len(r.tokens) for r in results)
    print(f"[cli] serve {arch}: {n_params} parameters (counted on meta, "
          f"{n_params * 2} B in bf16); {len(results)} requests, {tokens} "
          f"tokens in {times['run'][0]:.2f} ms of the scheduler's run "
          f"({tokens / (times['run'][0] / 1e3):.1f} tokens/s), "
          f"{len(times['prefill'])} prefill batches, median "
          f"{statistics.median(times['prefill']):.2f} ms a batch (all "
          f"{[round(t, 2) for t in times['prefill']]}); "
          f"{len(times['decode'])} decode steps, median "
          f"{statistics.median(times['decode']):.2f} ms a step; "
          f"max_memory_allocated {peak} B; main {wall:.2f} s with the "
          f"weights' draw; launches {used(runs)}")


def cli_train(report, arch: str, device):
    """``launch.train.main(["--arch", arch, "--steps", "4"])`` at the
    published config and the CLI's batch 4 x seq 32: 4 finite losses; each
    step timed; peak memory."""
    import math
    import torch
    from repro_torch.launch import train as train_mod
    n_params = count_params(arch)
    times, per_step = [], []
    undo = timed_steps(train_mod, times, per_step)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        (losses, events), runs = launch_counts(lambda: train_mod.main(
            ["--arch", arch, "--steps", str(CLI_TRAIN_STEPS),
             "--device", device.type]))
    finally:
        undo()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for kname, c in runs.items():
        report.rows[kname]["launches"] += c
    if len(losses) != CLI_TRAIN_STEPS or events \
            or not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"cli: {arch} trained losses {losses}, "
                             f"events {events}")
    print(f"[cli] train {arch}: {n_params} parameters (counted on meta); "
          f"{CLI_TRAIN_STEPS} steps of 4 x 32, losses "
          f"{[round(l, 5) for l in losses]}; median "
          f"{statistics.median(times):.2f} ms a step (all "
          f"{[round(t, 2) for t in times]}); max_memory_allocated {peak} B; "
          f"main {wall:.2f} s with the weights' draw; launches {used(runs)}")


def phase_examples(report, device):
    """The port's examples and the CLIs at published configs on the card
    (``phase_examples``): each of :data:`EXAMPLES` through its ``main``
    (the 8-rank ones through their own launch of 8 processes on
    ``cuda:0``), then :func:`cli_serve` of ``CLI_SERVE_ARCHS`` and
    :func:`cli_train` of ``CLI_TRAIN_ARCHS``."""
    import gc
    import torch
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, argv, path in EXAMPLES:
        run_example(report, name, argv, path, device)
    for arch in CLI_SERVE_ARCHS:
        cli_serve(report, arch, device)
        gc.collect()
        torch.cuda.empty_cache()
    for arch in CLI_TRAIN_ARCHS:
        cli_train(report, arch, device)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[examples] phase took {time.perf_counter() - t_phase:.1f} s; "
          f"{nvidia_smi()}")


def synthetic_soak_words():
    """The soak's 200 words: ``tests/test_chaos.py``'s generator."""
    import numpy as np
    rng = np.random.default_rng(0)
    alpha = list("abcdefgh")
    return ["".join(rng.choice(alpha, l)) for l in rng.integers(0, 9, 200)]


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if sys.argv[1:2] == ["--plan-rank"]:
        return plan_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import DS1, DS2
    from repro_torch.core import packing
    from repro_torch.data import synthetic_words
    from repro_torch.kernels import execution_provenance
    device = torch.device("cuda")
    t0 = time.perf_counter()
    print(f"[env] {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} {execution_provenance(device)}")
    phase_build()
    words = {name: synthetic_words(n, seed=0) for name, n in
             (("chunk-500", 500), ("chunk-3000", 3000),
              ("DS1", DS1.n_words), ("DS2", DS2.n_words))}
    report = Report()
    phase_kernels(report, device, packing.pack_words(words["DS2"]),
                  packing.pack_words(words["chunk-500"]),
                  packing.pack_words(words["chunk-3000"]))
    phase_run_merges(report, device, packing.pack_words(words["DS2"]))
    phase_main_path(report, device, list(words.items()))
    big_words = synthetic_words(1_048_576, seed=0)
    phase_run_tier(report, device, words["DS2"], big_words)
    phase_fault_tolerance(report, device, words["DS2"], big_words)
    phase_partition_and_repairs(report, device, words["DS2"], big_words)
    phase_mesh(report, device, words["DS2"], big_words)
    phase_serve(report, device)
    phase_families(report, device)
    phase_train(report, device)
    phase_plan(report, device)
    phase_launch(report, device)
    phase_examples(report, device)
    for name, row in report.rows.items():
        if row["launches"] == 0:
            raise AssertionError(f"{name} was never launched on its path")
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"kernels": list(report.rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
