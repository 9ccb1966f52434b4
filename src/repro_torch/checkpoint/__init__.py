"""Fault-tolerant checkpointing — the counterpart of ``repro.checkpoint``:
atomic manifest+npy snapshots in the reference's format, keep-N GC, an
async save thread, restore onto a device, and manifest metadata readable
without loading arrays (sorted-run resume discovery)."""

from .manager import (CheckpointManager, CorruptSnapshotError, latest_step,
                      list_steps, read_manifest, restore, save, sweep_tmp)

__all__ = ["CheckpointManager", "CorruptSnapshotError", "save", "restore",
           "latest_step", "list_steps", "read_manifest", "sweep_tmp"]
