"""Dependency-free checkpointing built for crash safety — the counterpart of
``repro.checkpoint.manager``, on the same files.

Layout:   <dir>/step_<N>/manifest.json + <leaf>.npy
Atomicity: writes land in <dir>/.tmp_<N>, then one os.replace renames the
           complete snapshot into place — a crash mid-save can never corrupt
           the latest checkpoint.
Async:     save() optionally returns immediately; the writer thread is
           joined before the next save (single in-flight snapshot).
Devices:   restore() puts every leaf on ``device``, or with ``shardings``
           (a tree of ``parallel.sharding.NamedSharding``) places each leaf
           on its mesh as a ``DTensor`` — the reference's re-sharding on
           restore, onto any mesh shape.
Meshes:    a tree of ``DTensor``s is saved as its global arrays, the bytes
           of an unsharded save: every rank calls save() (the shards are
           gathered), rank 0 writes, and every rank returns once the
           snapshot is in place (the manager's ranks meet at its next
           wait(), after rank 0's writer); a sharded restore_latest takes
           rank 0's latest step in every rank.

The format is the reference's, byte for byte in the manifest: a tree is a
nest of dicts, lists and tuples (``None`` holds no leaf) flattened in the
reference's leaf order (dict keys sorted), each leaf named by the
reference's key path (``['a']['b']`` is ``a.b``, ``[0]`` is ``0``) and
written as ``<name>.npy`` with its numpy dtype string; torch tensors are
written with their bits unchanged (``interop.to_numpy``). A snapshot either
package writes restores in the other.

bfloat16 is written as the reference writes it: the same ``.npy`` bytes
(2-byte records, ``'<V2'`` in the header) and ``"bfloat16"`` in the
manifest; it is restored by the manifest's dtype, bits unchanged. The
reference itself cannot restore such a leaf (``np.load`` gives ``|V2``
records that it hands to ``jnp.asarray``); the port can.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..interop import BF16_RECORD, is_bf16, resolve_device, to_device, \
    to_numpy

__all__ = ["CheckpointManager", "CorruptSnapshotError", "save", "restore",
           "latest_step", "read_manifest", "list_steps", "sweep_tmp"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_RE = re.compile(r"^\.tmp_(\d+)$")
_LEAF_TYPES = (torch.Tensor, np.ndarray, np.generic, bool, int, float)


class CorruptSnapshotError(RuntimeError):
    """A snapshot file is unreadable — truncated, zero-length, or otherwise
    torn (a kill mid-write *after* the atomic rename can't produce this, but
    filesystem-level damage or external tampering can). Carries the path so
    a resuming job can log exactly which artifact to drop and recompute."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupt snapshot file {path}: {reason}")
        self.path = path
        self.reason = reason


def sweep_tmp(directory: str) -> list:
    """Remove leftover ``.tmp_<N>`` droppings (a job killed mid-save before
    its atomic rename). Returns the swept step numbers. Stores call this on
    open so half-written snapshots never accumulate and can never be
    mistaken for landed data."""
    if not os.path.isdir(directory):
        return []
    swept = []
    for d in os.listdir(directory):
        if (m := _TMP_RE.match(d)):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
            swept.append(int(m.group(1)))
    return sorted(swept)


def _load_npy(path: str) -> np.ndarray:
    """``np.load`` with torn-write detection: truncated or zero-length
    files raise :class:`CorruptSnapshotError` naming the path instead of a
    bare numpy/EOF exception."""
    try:
        if os.path.getsize(path) == 0:
            raise CorruptSnapshotError(path, "zero-length file")
        return np.load(path)
    except CorruptSnapshotError:
        raise
    except Exception as e:  # ValueError from a torn header, EOFError, OSError
        raise CorruptSnapshotError(path, f"unreadable npy ({e})") from e


def _flatten(tree, path=""):
    """``[(key path, leaf)]`` in the reference's leaf order: dict keys
    sorted, sequences by index, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree)
                for item in _flatten(sub, f"{path}[{i}]")]
    if not isinstance(tree, _LEAF_TYPES):
        raise TypeError(f"checkpoint leaf {path or '<root>'} is a "
                        f"{type(tree).__name__}: leaves must be tensors, "
                        "numpy arrays or numbers in dicts, lists and tuples")
    return [(path, tree)]


def _unflatten(target, leaves):
    """``target``'s structure with its leaves replaced, in order, from the
    iterator ``leaves``."""
    if target is None:
        return None
    if isinstance(target, dict):
        out = {k: _unflatten(target[k], leaves) for k in sorted(target)}
        return {k: out[k] for k in target}
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten(sub, leaves) for sub in target)
    return next(leaves)


def _leaf_names(tree):
    names, leaves = [], []
    for path, leaf in _flatten(tree):
        names.append(path.replace("/", "_").replace("'", "").strip("[]")
                     .replace("][", "."))
        leaves.append(leaf)
    if len(set(names)) != len(names):
        raise ValueError("non-unique leaf names in pytree")
    return names, leaves


def _host(leaf) -> np.ndarray:
    return to_numpy(leaf) if isinstance(leaf, torch.Tensor) \
        else np.asarray(leaf)


def _sharded(tree) -> bool:
    """Whether ``tree`` holds a ``DTensor``: its global arrays are written
    by rank 0 alone, and every rank must take part."""
    from torch.distributed.tensor import DTensor
    return any(isinstance(leaf, DTensor) for _, leaf in _flatten(tree))


def _save_npy(path: str, arr: np.ndarray) -> str:
    """``arr`` written as ``np.save`` writes it; returns its manifest dtype.
    A bfloat16 leaf gets the header the reference's ``ml_dtypes`` array
    gets (``'<V2'``), so the file's bytes are the reference's."""
    if not is_bf16(arr):
        np.save(path, arr)
        return str(arr.dtype)
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.view(np.int16).data)
    return "bfloat16"


def save(directory: str, step: int, tree: Any, extra: Any = None) -> str:
    """Atomic synchronous snapshot. Returns the final path.

    ``extra``: optional JSON-serialisable metadata stored under the
    manifest's ``"extra"`` key — e.g. the sort pipeline's per-run invariants
    (``pipeline.manifest.RunManifest``), readable without loading any array
    via :func:`read_manifest`. A tree of ``DTensor``s is written by rank 0
    as its global arrays; every rank must call it, and each returns once
    the snapshot is in place."""
    names, leaves = _leaf_names(tree)
    final = os.path.join(directory, f"step_{step}")
    sharded = _sharded(tree)
    if sharded and torch.distributed.get_rank() != 0:
        for leaf in leaves:
            _host(leaf)             # this rank's part of the gathers
        torch.distributed.barrier()     # rank 0 has written
        return final
    tmp = os.path.join(directory, f".tmp_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    if extra is not None:
        manifest["extra"] = extra
    for name, leaf in zip(names, leaves):
        arr = _host(leaf)
        fname = f"{name}.npy"
        dtype = _save_npy(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"name": name, "file": fname, "shape": list(arr.shape),
             "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    if sharded:
        torch.distributed.barrier()
    return final


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def list_steps(directory: str) -> list:
    """All completed snapshot steps, ascending (resume discovery for stores
    that keep many live steps, e.g. one per sorted run)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(directory)
                  if (m := _STEP_RE.match(d)))


def read_manifest(directory: str, step: int) -> dict:
    """The snapshot's manifest (leaf specs + any ``extra`` metadata) without
    touching the arrays — how a resuming sort job decides which runs are
    already complete before loading anything."""
    path = os.path.join(directory, f"step_{step}", "manifest.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CorruptSnapshotError(path, f"unreadable manifest ({e})") from e


def _sharding_leaves(target, shardings) -> list:
    """The leaves of ``shardings`` (``target``'s structure, a
    ``NamedSharding`` where ``target`` has a leaf) in ``target``'s leaf
    order."""
    if target is None:
        return []
    if isinstance(target, dict):
        return [s for k in sorted(target)
                for s in _sharding_leaves(target[k], shardings[k])]
    if isinstance(target, (list, tuple)):
        return [s for t, sh in zip(target, shardings)
                for s in _sharding_leaves(t, sh)]
    return [shardings]


def _placed(t: torch.Tensor, sharding) -> torch.Tensor:
    """Global tensor ``t``, which every rank read from the same file, as a
    ``DTensor`` on ``sharding``'s mesh: each rank keeps its own shard and
    nothing crosses between them."""
    from torch.distributed.tensor import distribute_tensor
    mesh = sharding.mesh
    return distribute_tensor(t.to(mesh.device_type), mesh,
                             sharding.placements, src_data_rank=None)


def restore(directory: str, step: int, target: Any, device="cuda",
            shardings: Any = None) -> Any:
    """Load a snapshot into the structure of ``target`` (a tree of tensors,
    numpy arrays or numbers giving each leaf's shape), every leaf a tensor
    on ``device`` with the dtype and bits it was saved with (the
    manifest's: a ``"bfloat16"`` leaf's 2-byte records become a bf16
    tensor). ``shardings`` (``target``'s structure, each leaf a
    ``parallel.sharding.NamedSharding``) places every leaf on its mesh
    instead, whatever mesh — or none — saved it; every rank calls it."""
    dev = torch.device("cpu") if shardings is not None \
        else resolve_device(device)
    path = os.path.join(directory, f"step_{step}")
    manifest = read_manifest(directory, step)
    by_name = {e["name"]: e for e in manifest["leaves"]}
    names, leaves = _leaf_names(target)
    out = []
    for name, leaf in zip(names, leaves):
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        leaf_path = os.path.join(path, by_name[name]["file"])
        arr = _load_npy(leaf_path)
        if tuple(arr.shape) != tuple(by_name[name]["shape"]):
            # loadable but short/oversized vs what save() recorded: a torn
            # or externally damaged file, not a caller shape mistake
            raise CorruptSnapshotError(
                leaf_path, f"shape {tuple(arr.shape)} != manifest "
                f"{tuple(by_name[name]['shape'])}")
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"{name}: checkpoint shape {arr.shape} != "
                             f"target {tuple(np.shape(leaf))}")
        if by_name[name]["dtype"] == "bfloat16":
            if arr.dtype.itemsize != 2:
                raise CorruptSnapshotError(
                    leaf_path, f"{arr.dtype} records for a bfloat16 leaf")
            arr = arr.view(BF16_RECORD)
        out.append(to_device(arr, dev))
    if shardings is not None:
        out = [_placed(t, s) for t, s in
               zip(out, _sharding_leaves(target, shardings))]
    return _unflatten(target, iter(out))


class CheckpointManager:
    """keep-N rotation + optional async writes + resume discovery."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._meet = False          # a sharded save not yet met on
        os.makedirs(directory, exist_ok=True)

    def wait(self):
        """Join the writer; after a sharded save, every rank returns once
        rank 0's writer is done."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._meet:
            self._meet = False
            torch.distributed.barrier()

    def _gc(self):
        for s in list_steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def save(self, step: int, tree: Any, extra: Any = None):
        self.wait()
        # copy to the host *before* returning, so the caller may overwrite
        # its tensors while the writer thread runs (a CPU tensor's numpy
        # view would share its memory)
        _, leaves = _leaf_names(tree)
        host_tree = _unflatten(tree, iter([np.array(_host(l))
                                           for l in leaves]))
        if _sharded(tree):
            self._meet = True
            if torch.distributed.get_rank() != 0:   # rank 0 writes it
                return

        def work():
            save(self.directory, step, host_tree, extra=extra)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def restore_latest(self, target: Any, device="cuda",
                       shardings: Any = None):
        self.wait()
        step = latest_step(self.directory)
        if shardings is not None:       # every rank restores rank 0's step
            box = [step]
            torch.distributed.broadcast_object_list(box, src=0)
            step = box[0]
        if step is None:
            return None, None
        return step, restore(self.directory, step, target, device,
                             shardings)
