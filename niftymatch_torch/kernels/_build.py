"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library under
``build/niftymatch_torch/`` at the repository root, named by a hash of the
source, the ``csrc/`` headers it includes and the flags, so an edited
source or header is rebuilt on its next use.  The libraries are loaded
with ``ctypes``; every C entry point returns ``cudaGetLastError()`` after
its launch and ``check`` raises on anything but 0.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.  ``build_all`` starts one ``nvcc`` per source
at once and waits for all of them.

``LAUNCHES`` counts the launches of the system's kernels (K1-K3, the
two-view polish and the small-matrix solvers) by kernel name,
``K4_LAUNCHES`` those of K4's fold variants, which run only in their
microbenchmark.  A wrapper adds one right after it launches its kernel,
and nowhere else, so a run that resets the counts and reads them
afterwards sees which kernels it went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "niftymatch_torch"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v"]
# windows.cu (K2) keeps every multiply and add separately rounded (no FMA
# contraction): it floors quotients into bins, so it reproduces its plain
# PyTorch version's fp32 arithmetic op for op.  descriptors.cu (K3),
# match.cu (K1), fold_micro.cu (K4), refine.cu (the two-view polish) and
# linalg.cu (the small-matrix solvers) compute continuous functions and let
# nvcc contract.  See the note at the top of each source.
EXTRA_FLAGS = {"windows": ["-fmad=false"], "descriptors": [], "match": [],
               "fold_micro": [], "refine": [], "linalg": []}
SOURCES = tuple(EXTRA_FLAGS)
_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.M)

LAUNCHES = {"k1_match_top2": 0, "k1_match_top2_bf16": 0,
            "k2_orientation_hist": 0, "k3_descriptor": 0, "refine_gn": 0,
            "svd3x3": 0, "smallest_eigvec": 0}
# K4's fold variants, in the order of csrc/fold_micro.cu's enum.
K4_FOLDS = ("gemm", "rowsum", "min1", "current", "pipe", "top2noi", "top2idx",
            "slotpack", "bf16")
K4_LAUNCHES = {f"k4_fold_{f}": 0 for f in K4_FOLDS}

_LIBS: dict = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, K4_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _source(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def _flags(name: str):
    return ARCH_FLAGS + COMMON_FLAGS + EXTRA_FLAGS[name]


def _lib_path(name: str) -> Path:
    text = _source(name).read_bytes()
    h = hashlib.sha256(text)
    for header in sorted(set(_INCLUDE.findall(text))):
        h.update((CSRC_DIR / header.decode()).read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one source; returns (process, target, tmp)."""
    target = _lib_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    log = open(target.with_suffix(".log"), "w")
    cmd = [_nvcc()] + _flags(name) + ["-o", str(tmp), str(_source(name))]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc, target, tmp


def _finish_build(name: str, proc, target: Path, tmp: Path) -> None:
    rc = proc.wait()
    if rc != 0:
        log = target.with_suffix(".log").read_text()
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {rc}):\n{log}")
    os.replace(tmp, target)


def build_all(names=SOURCES) -> float:
    """Build every library not yet built, all ``nvcc`` runs at once;
    returns the seconds spent."""
    t0 = time.perf_counter()
    jobs = [(n,) + _start_build(n) for n in names if not _lib_path(n).exists()]
    for job in jobs:
        _finish_build(*job)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)."""
    return _lib_path(name).with_suffix(".log").read_text()


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed.  ``signatures``
    maps each C function to its argtypes; every function returns int."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _lib_path(name).exists():
            build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, t: torch.Tensor, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype/shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
