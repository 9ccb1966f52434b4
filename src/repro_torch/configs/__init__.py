"""Configurations of the port: the paper's two datasets (``paper_sort``)
and the architecture registry — ``--arch <id>`` resolves here.

Each architecture module is a copy of the reference's
(``repro.configs.<id>``): the exact published dimensions, data only.
``get_config(id)`` takes the dashed public ids; ``SHAPES`` holds the
per-arch input-shape cells (train / prefill / decode / long), and
``cells_for(cfg)`` applies the long_500k rule: only the sub-quadratic
families (SSM, hybrid) take it.
"""

from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ModelConfig, smoke_variant
from .paper_sort import CONFIG, DS1, DS2, SortConfig

__all__ = ["SortConfig", "DS1", "DS2", "CONFIG", "ARCH_IDS", "get_config",
           "get_smoke_config", "SHAPES", "cells_for", "ShapeCell"]

ARCH_IDS = [
    "granite-moe-1b-a400m",
    "deepseek-v2-236b",
    "nemotron-4-340b",
    "minicpm3-4b",
    "glm4-9b",
    "llama3-405b",
    "mamba2-370m",
    "qwen2-vl-2b",
    "musicgen-large",
    "zamba2-1.2b",
]

_MODULES = {i: i.replace("-", "_").replace(".", "_") for i in ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return smoke_variant(get_config(arch_id))


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def cells_for(cfg: ModelConfig):
    """Shape cells applicable to an arch: long_500k only for sub-quadratic
    (SSM/hybrid) families."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        cells.append("long_500k")
    return [SHAPES[c] for c in cells]
