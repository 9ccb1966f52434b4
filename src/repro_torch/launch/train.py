"""End-to-end training with fault tolerance — the counterpart of
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
        --smoke --steps 50 --device cpu

It trains the published configuration unless ``--smoke`` is given, on the
card unless ``--device cpu`` is given (without a card the default raises);
``--sort-impl pallas`` sends the MoE dispatch through the hand-written
kernels. Fault tolerance as in the reference: periodic asynchronous
snapshots (``CheckpointManager(keep=2)``), an ``ElasticSupervisor`` that
restarts the step loop from the latest snapshot (or from the initial
weights before the first), simulated failures (``--fail-at``) and a
straggler monitor on the step times.

A snapshot holds the reference's tree — ``{"params": ..., "opt": {"m",
"v", "count"}}`` in the reference's layout (``interop.lm_to_reference``) —
so a float32 snapshot restores in either package. Like the reference's
loop, every segment starts a new data stream, so a resumed run trains again
on batches 0, 1, … from the restored step: a run that failed is not the
run that did not, in either package.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import ShardedLoader, TokenStream
from ..interop import (lm_to_reference, named_from_reference,
                       opt_state_to_reference, resolve_device, to_device)
from ..models.model import init_lm
from ..optim import init_opt_state
from ..parallel.sharding import Rules
from ..runtime import ElasticSupervisor, FailureInjector, StragglerMonitor
from ..training import Hyper, make_train_step

__all__ = ["train_loop", "load_snapshot", "main"]


def _make_batch_iter(cfg, batch, seq, seed=0):
    if cfg.input_kind == "tokens":
        return iter(TokenStream(cfg.vocab_size, batch, seq, seed=seed))

    def frames():
        rng = np.random.default_rng(seed)
        while True:
            f = rng.normal(size=(batch, seq, cfg.d_model)).astype(np.float32)
            l = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)
            yield {"frames": f, "labels": l}

    return frames()


@torch.no_grad()
def load_snapshot(lm, opt, tree):
    """Write a snapshot's tree — the reference's layout, ``{"params": ...,
    "opt": {"m", "v", "count"}}`` with numpy or tensor leaves — into
    ``lm``'s parameters and the AdamW state ``opt`` in place, each tensor
    keeping its device and dtype. ``tree["opt"]`` may be ``None``: zero
    moments and count, a cold start."""
    params = named_from_reference(tree["params"])
    for name, p in lm.named_parameters():
        p.copy_(params[name])
    if tree["opt"] is None:
        for t in list(opt["m"].values()) + list(opt["v"].values()):
            t.zero_()
        opt["count"] = torch.zeros_like(opt["count"])
        return
    for k in ("m", "v"):
        moments = named_from_reference(tree["opt"][k])
        for name, t in opt[k].items():
            t.copy_(moments[name])
    opt["count"] = torch.as_tensor(tree["opt"]["count"]).to(
        opt["count"].device, torch.int32)


def train_loop(cfg, steps: int = 20, batch: int = 4, seq: int = 32,
               ckpt_dir: str | None = None, ckpt_every: int = 10,
               fail_at=(), hyper: Hyper | None = None, verbose: bool = True,
               device="cuda"):
    """Single-host training loop with checkpoint/restart and failure
    recovery, on ``device``, from weights drawn with seed 0.

    Returns ``(lm, losses, recovery_events)``."""
    dev = resolve_device(device)
    rules = Rules()
    hyper = hyper or Hyper(lr=1e-3, warmup=5, total_steps=steps)
    lm = init_lm(cfg, seed=0, device=dev)
    opt = init_opt_state(lm)
    step_fn = make_train_step(cfg, rules, hyper)

    ckpt = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
    injector = FailureInjector(fail_at)
    monitor = StragglerMonitor()
    losses = []

    def run_segment(state, start_step, devices):
        lm, opt = state
        data = ShardedLoader(_make_batch_iter(cfg, batch, seq), prefetch=2)
        try:
            for step in range(start_step, steps):
                t0 = time.time()
                injector.check(step)
                b = {k: to_device(v, dev) for k, v in next(data).items()}
                lm, opt, metrics = step_fn(lm, opt, b, step)
                loss = float(metrics["loss"])
                losses.append(loss)
                monitor.record(step, time.time() - t0)
                if ckpt and (step + 1) % ckpt_every == 0:
                    ckpt.save(step + 1, {"params": lm_to_reference(lm),
                                         "opt": opt_state_to_reference(opt)})
                if verbose and (step % max(1, steps // 10) == 0):
                    print(f"step {step:5d} loss {loss:.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f}")
        finally:
            data.close()
        return lm, opt

    if ckpt is None:
        out = run_segment((lm, opt), 0, 1)
        return out[0], losses, []

    # the initial weights on the host: the step updates the parameters in
    # place, so a cold restart must not read them
    init_host = lm_to_reference(lm)

    def remesh(devices):
        # single-host recovery: restore the latest snapshot into the live
        # tensors (the reference rebuilds its mesh here); no snapshot yet
        # means a cold restart from the initial weights
        target = {"params": init_host,
                  "opt": {"m": init_host, "v": init_host,
                          "count": np.int32(0)}}
        step, tree = ckpt.restore_latest(target, device="cpu")
        if step is None:
            step, tree = 0, {"params": init_host, "opt": None}
        load_snapshot(lm, opt, tree)
        return step, (lm, opt)

    # single-host: a "failed" device is the restarted process itself, so the
    # world size never shrinks (restartable recovery, not an elastic shrink)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    sup = ElasticSupervisor(ckpt, initial_devices=n_dev, restartable=True)
    out = sup.run(run_segment, remesh, (lm, opt), 0)
    ckpt.wait()             # the last snapshot has landed when this returns
    return out[0], losses, sup.events


def main(argv=None):
    """The command line's run; returns ``(losses, recovery events)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--sort-impl", default="xla",
                    choices=("xla", "oets", "bitonic", "pallas"))
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    hyper = Hyper(lr=1e-3, warmup=5, total_steps=args.steps,
                  sort_impl=args.sort_impl)
    _, losses, events = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, fail_at=tuple(args.fail_at), hyper=hyper,
        device=args.device)
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f}); "
          f"{len(events)} recoveries")
    return losses, events


if __name__ == "__main__":
    main()
