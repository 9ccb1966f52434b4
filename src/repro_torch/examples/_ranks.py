"""The rank launcher of the 8-rank examples: ``world`` processes
(``torch.multiprocessing``, spawned) joined in one gloo group, where the
reference's examples ask XLA for 8 fake host devices.

Every rank runs on the same device — the CPU, or ``cuda:0`` of one card,
whose CUDA operands gloo stages through the host — and rendezvouses through
a ``FileStore`` in a temporary directory. Each rank's return value and its
kernel launches come back to the caller; a rank that raises, or dies, fails
the launch, and the others are ended.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile

import torch

from ..interop import resolve_device

__all__ = ["run_ranks", "WORLD"]

WORLD = 8
# a collective that waits longer than this fails its rank
TIMEOUT_S = 300


def _rank_main(rank, fn, world, workdir, device, args):
    import torch.distributed as dist
    from ..kernels import KERNELS
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "rendezvous"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        for k in KERNELS.values():
            k.launches = 0
        out = fn(dev, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        launches = {n: k.launches for n, k in KERNELS.items()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((out, launches), f)


def run_ranks(fn, device="cuda", args=()):
    """Run ``fn(device, *args)`` in ``WORLD`` spawned processes of one gloo
    group (``fn`` a module-level function; ``args`` pickled to every rank)
    and wait for all of them. Returns, rank by rank, ``(fn's return value,
    {kernel: launches in that rank})``. Raises without a card where
    ``device`` is the card, and when any rank fails."""
    import torch.multiprocessing as mp
    resolve_device(device)
    with tempfile.TemporaryDirectory() as workdir:
        mp.start_processes(_rank_main,
                           args=(fn, WORLD, workdir, str(device), tuple(args)),
                           nprocs=WORLD, join=True, start_method="spawn")
        out = []
        for r in range(WORLD):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
