"""The two-view geometry's small-matrix solvers, one launch a call
(``csrc/linalg.cu``).

``svd3x3`` runs all of ``geometry.linalg.svd3x3_plain`` (the Jacobi
eigendecomposition of ``E^T E``, the sort and the rebuild of U) and
``smallest_eigvec`` all of ``geometry.linalg.smallest_eigvec_plain`` (the
jittered Cholesky factor and the inverse iteration) for a batch of
matrices, one thread a matrix.  The wrappers take any leading batch axes,
allocate the outputs, launch on the current stream and neither read the
device nor synchronise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.precision import device_constant
from . import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "nm_svd3x3": [_P, _P, _P, _P, _I, _I, _P],
    "nm_smallest_eigvec": [_P, _P, _P, _I, _I, _I, _P],
}
MAX_N = 9                      # the largest n the eigenvector kernel is built for

_STARTS: dict = {}             # (device, n) -> the inverse iteration's start vector


def start_vector(n: int) -> np.ndarray:
    """The inverse iteration's fixed generic start vector, the plain
    version's: ``default_rng(12345)``'s normal draw of n, normalised."""
    seed = np.random.default_rng(12345).normal(size=n).astype(np.float32)
    return seed / np.linalg.norm(seed)


def _start_on(device: torch.device, n: int) -> torch.Tensor:
    """The start vector on ``device``, uploaded once per device and n
    (queued, so the host does not wait for the device)."""
    key = (device, n)
    x = _STARTS.get(key)
    if x is None:
        x = _STARTS[key] = device_constant(start_vector(n), device)
    return x


def _matrices(name: str, A: torch.Tensor, n: int) -> torch.Tensor:
    """``A`` as a contiguous (B, n, n) float32 CUDA tensor, or raise."""
    if A.dim() < 2 or A.shape[-2:] != (n, n):
        raise ValueError(f"{name}: expected (..., {n}, {n}), got {tuple(A.shape)}")
    if A.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {A.device}")
    return A.to(torch.float32).contiguous().reshape(-1, n, n)


def svd3x3(E: torch.Tensor, sweeps: int = 12):
    """``(U, S, Vt)`` of (..., 3, 3) CUDA matrices, S descending."""
    if sweeps < 0:
        raise ValueError(f"svd3x3: sweeps must be >= 0, got {sweeps}")
    flat = _matrices("svd3x3", E, 3)
    b = flat.shape[0]
    U, Vt = torch.empty_like(flat), torch.empty_like(flat)
    S = torch.empty((b, 3), dtype=torch.float32, device=flat.device)
    if b:
        lib = _build.load("linalg", _SIGNATURES)
        rc = lib.nm_svd3x3(flat.data_ptr(), U.data_ptr(), S.data_ptr(), Vt.data_ptr(),
                           b, sweeps, _build.stream_ptr(flat))
        _build.check(rc, "svd3x3")
        _build.LAUNCHES["svd3x3"] += 1
    lead = E.shape[:-2]
    return U.reshape(lead + (3, 3)), S.reshape(lead + (3,)), Vt.reshape(lead + (3, 3))


def smallest_eigvec(A: torch.Tensor, iterations: int = 8) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric PSD
    (..., n, n) CUDA matrices, n <= 9."""
    n = A.shape[-1] if A.dim() >= 2 else 0
    if not 1 <= n <= MAX_N:
        raise ValueError(f"smallest_eigvec: the kernel takes n <= {MAX_N}, got "
                         f"{tuple(A.shape)}")
    if iterations < 0:
        raise ValueError(f"smallest_eigvec: iterations must be >= 0, got {iterations}")
    flat = _matrices("smallest_eigvec", A, n)
    b = flat.shape[0]
    x = torch.empty((b, n), dtype=torch.float32, device=flat.device)
    if b:
        lib = _build.load("linalg", _SIGNATURES)
        rc = lib.nm_smallest_eigvec(flat.data_ptr(), _start_on(flat.device, n).data_ptr(),
                                    x.data_ptr(), b, n, iterations, _build.stream_ptr(flat))
        _build.check(rc, "smallest_eigvec")
        _build.LAUNCHES["smallest_eigvec"] += 1
    return x.reshape(A.shape[:-1])
