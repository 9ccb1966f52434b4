"""Batched generation engine — the counterpart of ``repro.serve.engine``.

Requests are right-padded to the batch's longest prompt; every request
tracks its own ``cur`` position, so a batch decodes together with
heterogeneous prompt lengths (per-row cache writes and per-row attention
masks: ``models/attention.py`` ``_cache_write``/``_decode_mask``). The
padding positions run through the model like real ones — in an MoE layer
they route and use expert capacity, as in the reference. Mamba2 layers
read the prefill's ``seq_mask``, so each state stops at its prompt's end.

Eager PyTorch under ``torch.inference_mode``: prefill, the cache grown to
``max_seq``, then one decode step a token. Where the parameters are
``DTensor``s (a sharded LM, ``models.param.shard_lm``) it runs under
``torch.no_grad`` instead: torch 2.11's DTensor has no sharding strategy for
the ``aten.detach_`` that ``inference_mode`` adds, so every redistribution
would raise. The mode is chosen from the parameters before the first op;
the tokens are the same under either. Greedy decoding takes the
argmax, the first maximum on ties (``jnp.argmax``'s rule). Sampling draws
with ``torch.multinomial`` from a ``torch.Generator`` seeded with ``seed``:
deterministic for a seed, but not the same draws as the reference's
``jax.random.categorical``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.model import LM, decode_step, forward, init_cache
from ..parallel.compat import get_mesh, set_mesh
from ..parallel.sharding import Rules, whole
from ..runtime import trace

__all__ = ["Engine", "GenerationResult"]


@dataclasses.dataclass
class GenerationResult:
    request_id: object
    tokens: List[int]


def _pad_cache_to(cache, axes, target_seq: int):
    """Grow every 'cache_seq' axis of a prefill cache (the attention
    leaves' positions) to the decode capacity with zeros; leaves without
    one (the Mamba2 conv window and state) stay as they are. ``axes``:
    ``init_cache``'s logical axes, the layer axis included."""
    out = {}
    for name, leaves in cache.items():
        out[name] = {}
        for k, leaf in leaves.items():
            ax = axes[name][k]
            if "cache_seq" in ax:
                dim = ax.index("cache_seq")
                shape = list(leaf.shape)
                shape[dim] = target_seq
                grown = leaf.new_zeros(shape)
                grown.narrow(dim, 0, leaf.shape[dim]).copy_(leaf)
                leaf = grown
            out[name][k] = leaf
    return out


class Engine:
    """Prefill + synchronised continuous decode for one model, on the
    device that holds ``params`` (an ``models.LM``; ``models.init_lm``
    puts it on the card by default). ``sort_impl`` is the MoE dispatch's
    sort ('xla', the reference's engine's, 'oets', 'bitonic', or 'pallas',
    the hand-written kernels)."""

    def __init__(self, cfg: ModelConfig, params: LM,
                 rules: Optional[Rules] = None, max_seq: int = 256,
                 eos_id: Optional[int] = None, sort_impl: str = "xla"):
        self.cfg = cfg
        self.params = params
        self.rules = rules or Rules()
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.sort_impl = sort_impl
        self._step = None       # the decode step under way, for its span

    @property
    def device(self) -> torch.device:
        return self.params.device

    def _prefill(self, tokens, seq_mask):
        with trace.span("engine.prefill"):
            logits, _, cache = forward(
                self.cfg, self.params,
                {"tokens": tokens, "seq_mask": seq_mask}, self.rules,
                sort_impl=self.sort_impl, return_cache=True)
            return whole(logits), cache

    def _decode(self, cache, tok, cur):
        with trace.span("engine.decode", step=self._step):
            logits, cache = decode_step(self.cfg, self.params, cache, tok,
                                        cur, self.rules,
                                        sort_impl=self.sort_impl)
            return whole(logits)[:, 0], cache

    @property
    def mesh(self):
        """The ``DeviceMesh`` of the parameters where they are
        ``DTensor``s (a sharded LM), else ``None``."""
        from torch.distributed.tensor import DTensor
        for p in self.params.parameters():
            if isinstance(p, DTensor):
                return p.device_mesh
        return None

    def generate(self, prompts: List[List[int]], max_new: int = 16,
                 greedy: bool = True, seed: int = 0) -> List[List[int]]:
        """Generate for a batch of variable-length prompts (one bucket). A
        sharded LM runs under its parameters' mesh where no mesh is active,
        and under ``torch.no_grad`` (the module's docstring); the logits
        are taken whole, so the tokens are read as from an unsharded LM."""
        mesh = self.mesh
        if mesh is None:
            with torch.inference_mode():
                return self._generate(prompts, max_new, greedy, seed)
        with torch.no_grad(), (set_mesh(mesh) if get_mesh() is None
                               else contextlib.nullcontext()):
            return self._generate(prompts, max_new, greedy, seed)

    def _generate(self, prompts, max_new, greedy, seed):
        dev = self.device
        bsz = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int64)
        bound = int(lens.max())
        toks = np.zeros((bsz, bound), np.int64)
        mask = np.zeros((bsz, bound), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
            mask[i, :len(p)] = 1

        with trace.sync("engine.upload"):
            toks_d = torch.from_numpy(toks).to(dev)
        with trace.sync("engine.upload"):
            mask_d = torch.from_numpy(mask).to(dev)
        logits, cache = self._prefill(toks_d, mask_d)
        axes = init_cache(self.cfg, bsz, bound, abstract=True)[1]
        with trace.span("engine.cache_grow"):
            cache = _pad_cache_to(cache, axes, self.max_seq)

        # the next token comes from each prompt's *last real* logits row
        with trace.sync("engine.upload"):
            last = torch.from_numpy(lens - 1).to(dev)
        cur_logits = logits[torch.arange(bsz, device=dev), last]

        out = [[] for _ in range(bsz)]
        with trace.sync("engine.upload"):
            cur = torch.from_numpy(lens.astype(np.int32)).to(dev)
        gen = None if greedy else torch.Generator(device=dev).manual_seed(seed)
        done = np.zeros((bsz,), bool)
        for step in range(max_new):
            if greedy:
                nxt = torch.argmax(cur_logits, dim=-1)
            else:
                probs = torch.softmax(cur_logits.float(), dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            with trace.sync("engine.readback"):
                nxt_np = nxt.cpu().numpy()
            for i in range(bsz):
                if not done[i]:
                    out[i].append(int(nxt_np[i]))
                    if self.eos_id is not None and nxt_np[i] == self.eos_id:
                        done[i] = True
            if done.all() or step == max_new - 1:
                break
            self._step = step + 1
            cur_logits, cache = self._decode(cache, nxt[:, None], cur)
            cur = cur + 1
        self._step = None
        return out
