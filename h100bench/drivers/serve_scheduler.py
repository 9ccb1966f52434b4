"""Serving through the port's scheduler: closed waves of requests, each
wave one ``serve.scheduler.BucketedScheduler.run`` over an
``serve.engine.Engine`` of the configuration's model (weights drawn from
the seed, ``sort_impl`` as the configuration states).

The benchmark's wrappers on the engine and the scheduler record what the
timed path produced: each bucket's admission order, each batch's prompts,
the logits its served tokens were read from (the last real row of the
prefill, then every decode step), and, in a traced run, a host span of
each prefill and decode step ended by a synchronize. After the window the
model is freed and the plain float32 reference runs a sample of the
batches, drawn from the seed with the batch of the longest prompts in it,
on the same prompts and the served tokens (:mod:`h100bench.reference.
granite_moe`).

The check fails closed: a served request that no recorded batch or
admission holds, a sampled batch short of the cell's count, and a served
token whose logits row was not caught each count against a limit of 0, so
a path that stops going through the wrapped calls reads not correct.
:func:`control` puts the check's control in the engine's place.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from ..reference import granite_moe
from ..traffic import prompts, weights

# the wave index of set-up's warm wave, outside the window's 0, 1, 2, ...
WARM_WAVE = 1 << 20


def model_config(config: dict):
    from repro_torch.models.config import ModelConfig, MoECfg
    m = dict(config["model"])
    m["moe"] = MoECfg(**m["moe"])
    return ModelConfig(**m)


def build_lm(config: dict, seed: int, device):
    """The port's ``LM`` of the configuration with the benchmark's weights
    (built on ``meta``, then the drawn tensors assigned)."""
    from repro_torch.models.model import LM
    from repro_torch.models.param import Builder
    cfg = model_config(config)
    lm = LM(cfg, Builder(None, dtype=getattr(torch, cfg.param_dtype),
                         device="meta"))
    lm.load_state_dict(weights.draw(config, seed, device), strict=True,
                       assign=True)
    return cfg, lm


def request_flops(model: dict, prompt: int, processed_new: int) -> float:
    """Model FLOPs of a request's real tokens, the prompt and the generated
    tokens fed back (all but the last): for a token at context ``c``, 2 x
    the parameters it multiplies (the attention projections, the router,
    the top-k experts, the head) and 4 x c x head_dim x heads a layer for
    the attention's two products."""
    d, h, kh, hd = (model["d_model"], model["n_heads"], model["n_kv_heads"],
                    model["head_dim"])
    moe = model["moe"]
    w_in = (2 if model["mlp_gated"] else 1) * moe["d_expert"]
    layer = (d * h * hd + 2 * d * kh * hd + h * hd * d + d * moe["n_experts"]
             + moe["top_k"] * (d * w_in + moe["d_expert"] * d))
    params = model["n_layers"] * layer + d * model["vocab_size"]
    n = prompt + processed_new
    # contexts 1..n
    return 2.0 * params * n + 4.0 * hd * h * model["n_layers"] * n * (n + 1) / 2


@dataclasses.dataclass
class Batch:
    wave: int
    prompts: list
    logits: list        # the served tokens' logits rows, (B, V) each


class Recorder:
    """The wrappers on one engine and scheduler."""

    def __init__(self, engine, sched, spans, timed: bool):
        self.batches: list = []
        self.orders: list = []        # (bucket's arrival order, admitted)
        self.wave = -1
        self.prefills = self.decodes = 0
        prefill, decode, generate = engine._prefill, engine._decode, \
            engine.generate
        admit = type(sched)._order_by_length

        def sync():
            if timed:
                torch.cuda.synchronize()

        def timed_span(label, fn, *args):
            t0 = time.time_ns()
            try:
                out = fn(*args)
                sync()
                return out
            finally:
                spans.add(label, t0, time.time_ns())

        def on_prefill(tokens, seq_mask):
            self.prefills += 1
            logits, cache = timed_span("prefill", prefill, tokens, seq_mask)
            last = seq_mask.sum(1).long() - 1
            rows = torch.arange(logits.shape[0], device=logits.device)
            self.batches[-1].logits.append(logits[rows, last].clone())
            return logits, cache

        def on_decode(cache, tok, cur):
            self.decodes += 1
            logits, cache = timed_span("decode", decode, cache, tok, cur)
            self.batches[-1].logits.append(logits.clone())
            return logits, cache

        def on_generate(batch_prompts, **kw):
            self.batches.append(Batch(self.wave,
                                      [tuple(p) for p in batch_prompts], []))
            return timed_span("generate", lambda: generate(batch_prompts, **kw))

        def on_admit(rs, **kw):
            out = timed_span("admission", lambda: admit(rs, **kw))
            self.orders.append((list(rs), list(out)))
            return out

        engine._prefill, engine._decode = on_prefill, on_decode
        engine.generate = on_generate
        sched._order_by_length = on_admit


def setup(cell, seed: int, device):
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import BucketedScheduler, Request
    config, mix = cell.config, cell.traffic
    cfg, lm = build_lm(config, seed, device)
    engine = Engine(cfg, lm, max_seq=config["max_position_embeddings"],
                    sort_impl=config["sort_impl"])
    sched = BucketedScheduler(engine, batch_size=mix["batch_size"],
                              n_buckets=mix["n_buckets"])

    def wave(index):
        return [Request(rid, p, mix["max_new"])
                for rid, p in prompts.wave(mix, seed, index, cfg.vocab_size)]

    # one warm wave: every batch shape of the window (each wave holds the
    # same lengths, so the same buckets and batches)
    sched.run(wave(WARM_WAVE))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"cell": cell, "seed": seed, "device": device, "cfg": cfg,
            "lm": lm, "engine": engine, "sched": sched, "wave": wave}


def window(state, win, spans) -> dict:
    cell, device = state["cell"], state["device"]
    model = cell.config["model"]
    on_card = device.type == "cuda"
    rec = Recorder(state["engine"], state["sched"], spans,
                   timed=spans.enabled and on_card)
    waves, per_unit, tokens = [], [], 0
    attempted = failed = 0
    for i in win:
        t0 = time.time_ns()
        reqs = state["wave"](i)
        spans.add("making the wave's requests", t0, time.time_ns())
        rec.wave = i
        attempted += len(reqs)
        p0, d0 = rec.prefills, rec.decodes
        try:
            results = state["sched"].run(reqs)
            if on_card:
                torch.cuda.synchronize(device)
        except RuntimeError as e:
            print(f"wave {i} failed: {e}", file=sys.stderr)
            failed += len(reqs)
            continue
        served = {r.request_id: r.tokens for r in results}
        for r in reqs:
            out = served.get(r.request_id)
            if out is None or len(out) != r.max_new:
                failed += 1
                continue
            tokens += len(r.prompt) + len(out)
        waves.append((reqs, served))
        per_unit.append({"waves": 1, "prefills": rec.prefills - p0,
                         "decodes": rec.decodes - d0})
    state.update(recorder=rec, waves=waves)
    flops = sum(request_flops(model, len(r.prompt), len(served[r.request_id]) - 1)
                for reqs, served in waves for r in reqs
                if len(served.get(r.request_id, ())) == r.max_new)
    metrics = {"tokens_per_s": tokens / win.seconds} if tokens else {}
    return {"attempted": attempted, "failed": failed, "metrics": metrics,
            "calls": len(waves), "model_flops": flops,
            "per_unit": per_unit}


def _admission_off(orders, served_ids) -> int:
    """Requests that a bucket's admission put out of (prompt length, first
    two tokens, arrival) order, and served requests that no recorded
    admission held."""
    off, admitted_ids = 0, set()
    for arrived, admitted in orders:
        key = {r.request_id: (len(r.prompt),
                              *(r.prompt[k] if len(r.prompt) > k else -1
                                for k in range(2)), i)
               for i, r in enumerate(arrived)}
        want = sorted(arrived, key=lambda r: key[r.request_id])
        off += sum(a.request_id != b.request_id
                   for a, b in zip(want, admitted))
        off += abs(len(want) - len(admitted))
        admitted_ids.update(r.request_id for r in admitted)
    return off + len(set(served_ids) - admitted_ids)


def _sample(batches, seed: int, n: int):
    """``n`` batches drawn from the seed: one holding the longest prompt,
    the others at random from the rest."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 13])
    longest = max(max(len(p) for p in b.prompts) for b in batches)
    with_longest = [i for i, b in enumerate(batches)
                    if max(len(p) for p in b.prompts) == longest]
    first = with_longest[rng.integers(len(with_longest))]
    rest = [i for i in range(len(batches)) if i != first]
    more = rng.choice(rest, size=min(n - 1, len(rest)), replace=False) \
        if rest else []
    return [batches[first]] + [batches[int(i)] for i in more]


def reference_readings(config, seed, device, batches, served_by_prompt,
                       control: bool = False):
    """Over ``batches``: the widest gap by which a served token's
    reference logit lies below the reference's best, and the largest
    difference of the program's logits from the reference's, over the
    reference row's standard deviation. With ``control`` also the same two
    readings of the control (the reference in float8) in the program's
    place: the gap of the token it puts first, and its logits' difference."""
    model = config["model"]
    w = weights.draw(config, seed, device)
    ref = granite_moe.Plain(model, w)
    ctl = granite_moe.Plain(model, w, precision="fp8") if control else None
    out = {"token_gap": 0.0, "logit_err": 0.0, "tokens_compared": 0,
           "logits_missing": 0}
    if control:
        out.update(control_gap=0.0, control_logit_err=0.0)
    with granite_moe.exact_float32():
        for b in batches:
            lens = torch.tensor([len(p) for p in b.prompts], device=device)
            toks = torch.zeros((len(b.prompts), int(lens.max())),
                               dtype=torch.long, device=device)
            for r, p in enumerate(b.prompts):
                toks[r, :len(p)] = torch.tensor(p, device=device)
            served = torch.tensor([served_by_prompt[p] for p in b.prompts],
                                  device=device)
            steps = served.shape[1]
            ref_logits, ctl_logits = [], []
            r_logits, r_cache = ref.prefill(toks, lens)
            ref_logits.append(r_logits)
            if ctl:
                c_logits, c_cache = ctl.prefill(toks, lens)
                ctl_logits.append(c_logits)
            for s in range(1, steps):
                cur = lens + s - 1
                ref_logits.append(ref.decode(r_cache, served[:, s - 1], cur))
                if ctl:
                    ctl_logits.append(ctl.decode(c_cache, served[:, s - 1],
                                                 cur))
            del r_cache
            for s, rl in enumerate(ref_logits):
                best = rl.max(-1).values
                got = rl.gather(1, served[:, s:s + 1])[:, 0]
                out["token_gap"] = max(out["token_gap"],
                                       float((best - got).max()))
                std = rl.std(-1)
                if s < len(b.logits) and b.logits[s].shape == rl.shape:
                    diff = (b.logits[s].float() - rl).abs().max(-1).values
                    out["logit_err"] = max(out["logit_err"],
                                           float((diff / std).max()))
                    out["tokens_compared"] += rl.shape[0]
                else:
                    out["logits_missing"] += rl.shape[0]
                if ctl:
                    cl = ctl_logits[s]
                    pick = cl.argmax(-1, keepdim=True)
                    cgap = best - rl.gather(1, pick)[:, 0]
                    out["control_gap"] = max(out["control_gap"],
                                             float(cgap.max()))
                    cdiff = (cl - rl).abs().max(-1).values
                    out["control_logit_err"] = max(out["control_logit_err"],
                                                   float((cdiff / std).max()))
            # rows caught beyond the served tokens' (a step counted twice)
            out["logits_missing"] += served.shape[0] * abs(len(b.logits)
                                                           - steps)
    return out


class ControlEngine:
    """The check's control in the engine's place: the plain reference with
    float8 projections (:class:`granite_moe.Plain`, ``precision='fp8'``)
    serving each batch greedily, through a ``_prefill``, ``_decode`` and
    ``generate`` of the engine's signatures for the wrappers to catch."""

    def __init__(self, config: dict, seed: int, device):
        self.device = device
        self.ref = granite_moe.Plain(config["model"],
                                     weights.draw(config, seed, device),
                                     precision="fp8")

    def _prefill(self, tokens, seq_mask):
        last, cache = self.ref.prefill(tokens, seq_mask.sum(1).long())
        # only each prompt's last real row is read
        return last[:, None].expand(-1, tokens.shape[1], -1), cache

    def _decode(self, cache, tok, cur):
        return self.ref.decode(cache, tok[:, 0], cur.long()), cache

    def generate(self, prompts, max_new: int = 16, **_):
        dev = self.device
        lens = torch.tensor([len(p) for p in prompts], device=dev)
        toks = torch.zeros((len(prompts), int(lens.max())), dtype=torch.long,
                           device=dev)
        for r, p in enumerate(prompts):
            toks[r, :len(p)] = torch.tensor(p, device=dev)
        mask = (torch.arange(toks.shape[1], device=dev)[None]
                < lens[:, None]).int()
        rows = torch.arange(len(prompts), device=dev)
        out = []
        with granite_moe.exact_float32():
            logits, cache = self._prefill(toks, mask)
            cur = logits[rows, lens - 1]
            for step in range(max_new):
                nxt = cur.argmax(-1)
                out.append(nxt)
                if step < max_new - 1:
                    cur, cache = self._decode(cache, nxt[:, None], lens + step)
        return torch.stack(out, 1).tolist()


def control(state):
    """Put the control in the program's place after set-up: the port's
    model is freed and the scheduler serves through :class:`ControlEngine`
    (its admission stays the port's)."""
    state["sched"].engine = None
    state.pop("lm", None)
    state.pop("engine", None)
    gc.collect()
    if state["device"].type == "cuda":
        torch.cuda.empty_cache()
    state["engine"] = state["sched"].engine = ControlEngine(
        state["cell"].config, state["seed"], state["device"])


def release(state):
    """Free the program's model, engine and caches (the wrappers tie the
    engine into a reference cycle, hence the collection)."""
    for k in ("lm", "engine", "sched", "wave"):
        state.pop(k, None)
    gc.collect()
    if state["device"].type == "cuda":
        torch.cuda.synchronize(state["device"])
        torch.cuda.empty_cache()


def check(state, records, control: bool = False) -> list:
    spec = state["cell"].spec
    limits = spec["limits"]
    rec = state.pop("recorder")
    waves = state.pop("waves")
    release(state)
    served_by_prompt, served_ids = {}, []
    for reqs, served in waves:
        for r in reqs:
            if len(served.get(r.request_id, ())) == r.max_new:
                served_by_prompt[tuple(r.prompt)] = served[r.request_id]
                served_ids.append(r.request_id)
    caught = [b for b in rec.batches if b.wave >= 0]
    in_batches = {p for b in caught for p in b.prompts}
    batches = [b for b in caught
               if all(p in served_by_prompt for p in b.prompts)]
    numbers = [("admission_off", _admission_off(rec.orders, served_ids),
                limits["admission_off"]),
               ("requests_uncaught",
                sum(p not in in_batches for p in served_by_prompt), 0)]
    want = spec["sample_batches"]
    if not batches:
        return numbers + [("batches_short", want, 0)]
    sample = _sample(batches, state["seed"], want)
    r = reference_readings(state["cell"].config, state["seed"],
                           state["device"], sample, served_by_prompt,
                           control=control)
    numbers += [("batches_short", want - len(sample), 0),
                ("logits_missing", r.pop("logits_missing"), 0),
                ("tokens_compared", r.pop("tokens_compared"), None),
                ("token_gap", r.pop("token_gap"), limits["token_gap"]),
                # a reading beside the limits: it does not separate the
                # program's seeds from the control's by three times
                ("logit_err", r.pop("logit_err"), None)]
    numbers += [(k, v, None) for k, v in r.items()]
    return numbers
