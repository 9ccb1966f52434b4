"""Peaks of one NVIDIA H100 SXM, frozen from NVIDIA's data sheet (dense
rates, no sparsity, at the full 700 W power limit): the yardstick of every
roofline and MFU share of this benchmark. The same numbers as the port's
``launch/hw.py``, copied so that a program change cannot move them. A card
set below 700 W runs slower under load; :func:`power_limit` reads the
card's limit, which the harness prints beside every run."""

from __future__ import annotations

import shutil
import subprocess

BF16_FLOPS = 989e12          # FLOP/s, bf16 and fp16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12    # B/s


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, or why not."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
