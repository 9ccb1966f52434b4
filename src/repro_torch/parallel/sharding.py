"""Logical-axis sharding rules — the table of ``repro.parallel.sharding``.

Every parameter and activation dimension of the model stack has a
*logical* axis name; a :class:`Rules` table maps logical names to mesh
axes, so a parallelism plan (pure DP, FSDP x TP, EP, a sequence-sharded KV
cache) is a table edit, not a model edit.

The port runs its model stack on one device, where no dimension is sharded:
:func:`constrain` is the identity there, as the reference's is when no mesh
is active (``repro/parallel/sharding.py:152-153``). The table is kept so
the model code reads as the reference's and the multi-device plan has its
names. The ``PartitionSpec`` helpers (``spec``, ``mesh_spec``,
``shape_spec``, ``spec_for``) and the FSDP and TP rendering come with the
parallel item of ROADMAP A13.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

__all__ = ["Rules", "DEFAULT_RULES", "constrain"]


# FSDP (params sharded over `data`) x TP (`model`) x DP over pods — the
# reference's baseline plan
DEFAULT_RULES: Mapping[str, object] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "res_seq": None,          # residual-region sequence axis: "model" for
                              # Megatron-style sequence parallelism
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
    "act_expert": "model",
    "act_vocab": "model",
    # parameters
    "layers": None,
    "embed": "data",          # FSDP: gather per layer
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",        # expert parallelism
    "expert_mlp": None,
    "q_lora": None,
    "kv_lora": None,
    "state": None,
    "conv": None,
    # kv / ssm caches
    "cache_batch": ("data",),
    "cache_seq": None,
    "cache_kv_heads": "model",
}


@dataclasses.dataclass(frozen=True)
class Rules:
    """Immutable logical -> mesh axis mapping."""

    table: Mapping[str, object] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def override(self, **kw) -> "Rules":
        t = dict(self.table)
        t.update(kw)
        return Rules(t)


def constrain(x, rules: Rules, *axes):
    """Constrain ``x``'s dimensions to the mesh axes that ``rules`` maps
    ``axes`` to. On one device — the only layout the port runs — no axis is
    sharded, so this is the identity and returns ``x`` itself."""
    return x
