"""Batched generation engine — the counterpart of ``repro.serve.engine``.

Requests are right-padded to the batch's longest prompt; every request
tracks its own ``cur`` position, so a batch decodes together with
heterogeneous prompt lengths (per-row cache writes and per-row attention
masks: ``models/attention.py`` ``_cache_write``/``_decode_mask``). The
padding positions run through the model like real ones — in an MoE layer
they route and use expert capacity, as in the reference.

Eager PyTorch under ``torch.inference_mode``: prefill, the cache grown to
``max_seq``, then one decode step a token. Greedy decoding takes the
argmax, the first maximum on ties (``jnp.argmax``'s rule). Sampling draws
with ``torch.multinomial`` from a ``torch.Generator`` seeded with ``seed``:
deterministic for a seed, but not the same draws as the reference's
``jax.random.categorical``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.model import LM, decode_step, forward
from ..parallel.sharding import Rules

__all__ = ["Engine", "GenerationResult"]


@dataclasses.dataclass
class GenerationResult:
    request_id: object
    tokens: List[int]


def _pad_cache_to(cache, target_seq: int):
    """Grow the sequence axis (axis 2 of every ``(layers, B, S, ...)``
    leaf) of a prefill cache to the decode capacity with zeros."""
    out = {}
    for name, leaves in cache.items():
        out[name] = {}
        for k, leaf in leaves.items():
            grown = leaf.new_zeros(leaf.shape[:2] + (target_seq,)
                                   + leaf.shape[3:])
            grown[:, :, :leaf.shape[2]] = leaf
            out[name][k] = grown
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

    @property
    def device(self) -> torch.device:
        return self.params.device

    def _prefill(self, tokens, seq_mask):
        logits, _, cache = forward(
            self.cfg, self.params, {"tokens": tokens, "seq_mask": seq_mask},
            self.rules, sort_impl=self.sort_impl, return_cache=True)
        return logits, cache

    def _decode(self, cache, tok, cur):
        logits, cache = decode_step(self.cfg, self.params, cache, tok, cur,
                                    self.rules, sort_impl=self.sort_impl)
        return logits[:, 0], cache

    @torch.inference_mode()
    def generate(self, prompts: List[List[int]], max_new: int = 16,
                 greedy: bool = True, seed: int = 0) -> List[List[int]]:
        """Generate for a batch of variable-length prompts (one bucket)."""
        dev = self.device
        bsz = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int64)
        bound = int(lens.max())
        toks = np.zeros((bsz, bound), np.int64)
        mask = np.zeros((bsz, bound), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
            mask[i, :len(p)] = 1

        logits, cache = self._prefill(torch.from_numpy(toks).to(dev),
                                      torch.from_numpy(mask).to(dev))
        cache = _pad_cache_to(cache, self.max_seq)

        # the next token comes from each prompt's *last real* logits row
        last = torch.from_numpy(lens - 1).to(dev)
        cur_logits = logits[torch.arange(bsz, device=dev), last]

        out = [[] for _ in range(bsz)]
        cur = torch.from_numpy(lens.astype(np.int32)).to(dev)
        gen = None if greedy else torch.Generator(device=dev).manual_seed(seed)
        done = np.zeros((bsz,), bool)
        for step in range(max_new):
            if greedy:
                nxt = torch.argmax(cur_logits, dim=-1)
            else:
                probs = torch.softmax(cur_logits.float(), dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            nxt_np = nxt.cpu().numpy()
            for i in range(bsz):
                if not done[i]:
                    out[i].append(int(nxt_np[i]))
                    if self.eos_id is not None and nxt_np[i] == self.eos_id:
                        done[i] = True
            if done.all() or step == max_new - 1:
                break
            cur_logits, cache = self._decode(cache, nxt[:, None], cur)
            cur = cur + 1
        return out
