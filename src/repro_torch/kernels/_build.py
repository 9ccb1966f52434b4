"""Lazy build and binding of the port's hand-written CUDA kernels.

On the first launch of any kernel, every source in ``csrc/*.cu`` is compiled
with ``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface, all sources at once (one ``nvcc`` process each), into
``build/kernels/`` at the root of the checkout. Each library is loaded with
``ctypes``: pointers and the stream pass as ``c_void_p``. A library's name
carries a hash of its sources and flags, so an edited source is rebuilt and
a finished build is reused. Nothing is built when the package is imported,
and nothing here runs for a tensor on the CPU.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:class:`Kernel` raises on a non-zero code. It also counts its successful
launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import torch

from .lex import MAX_ARRAYS, codes_mask

__all__ = ["Kernel", "KERNELS", "build_all", "ptxas_report", "BUILD_DIR",
           "CSRC", "SMEM_LIMIT", "check_stacked"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("oets.cu", "bitonic.cu", "merge.cu", "distribute.cu",
           "runmerge.cu", "kway.cu", "partition.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the dynamic shared memory a Hopper block may opt in to (227 KB)
SMEM_LIMIT = 232_448

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# every kernel of the package by name; each Kernel enters itself
KERNELS: dict[str, "Kernel"] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return nvcc


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for f in (source, "common.cuh"):
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel, and
    return ``{source: library path}``. ``nvcc``'s report (registers, shared
    memory and spills per kernel, from ``-Xptxas -v``) is kept beside each
    library as ``<library>.ptxas.txt``. Raises if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: _lib_path(s) for s in SOURCES}
    procs = {}
    for source, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        procs[source] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, path)
    failed = []
    for source, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        path.with_name(path.name + ".ptxas.txt").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{source}:\n{out}")
            continue
        os.replace(tmp, path)     # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def ptxas_report() -> dict[str, str]:
    """``nvcc -Xptxas -v``'s lines for every source, from the last build."""
    return {s: p.with_name(p.name + ".ptxas.txt").read_text()
            for s, p in build_all().items()}


def _library(source: str) -> ctypes.CDLL:
    with _lock:
        if source not in _libs:
            _libs[source] = ctypes.CDLL(str(build_all()[source]))
        return _libs[source]


class Kernel:
    """One hand-written CUDA kernel behind a C entry point.

    ``name``: the kernel's name in reports; ``source``: its file under
    ``csrc/``; ``symbol``/``argtypes``: the C entry point, which takes the
    stream last and returns a CUDA error code; ``replaces``: ``file:line``
    of the Pallas TPU kernel it ports. ``launches`` counts the calls whose
    launches succeeded; a caller may set it to 0."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def _load(self):
        lib = _library(self.source)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.kernel_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err
        return fn

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raise if the launch fails.
        The host's time per call is most of a small kernel's, so the device
        is switched only when it is not the current one, and the stream is
        read as a raw handle rather than through a ``torch.cuda.Stream``
        object."""
        fn = self._fn or self._load()
        index = device.index
        current = torch.cuda.current_device()
        if index is None or index == current:
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(current))
        else:
            with torch.cuda.device(index):
                rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed: "
                               f"{self._err(rc).decode()} (error {rc})")
        self.launches += 1


def check_stacked(x: torch.Tensor, codes: Sequence[int], what: str):
    """Validate a stacked ``(A, R, C)`` int32 lane tensor and its codes;
    returns the kernels' packed codes argument."""
    if x.dtype != torch.int32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous (arrays, rows, cols) "
                         f"int32 tensor, got {tuple(x.shape)} {x.dtype}")
    if not 1 <= x.shape[0] <= MAX_ARRAYS or len(codes) != x.shape[0]:
        raise ValueError(f"{what}: need 1 to {MAX_ARRAYS} arrays and one code "
                         f"each, got {x.shape[0]} arrays, {len(codes)} codes")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {x.device}")
    return codes_mask(codes)
