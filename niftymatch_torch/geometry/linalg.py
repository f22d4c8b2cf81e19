"""Batched small-matrix linear algebra for robust geometry
(``geometry/linalg.py`` of the JAX package).

The same algorithms as the JAX file, with the same arithmetic choices: a
cyclic Jacobi eigendecomposition (12 sweeps, rotations in the same (p, q)
order), the 3-element compare-swap sort, inverse iteration on a jittered
Cholesky factor for the smallest eigenvector (jitter ``1e-6 tr/n + 1e-30``,
the same start vector, 8 iterations), and adjugate 3x3 solves.  JAX
writes them as chains of scalar operations that XLA fuses into one
program; run eagerly, each operation is a kernel launch, so here they work
on whole ``(..., n, n)`` tensors a rotation, a column or a solve at a
time.  Every function takes any leading batch axes.

``svd3x3`` and ``smallest_eigvec`` are one CUDA launch a call on CUDA
tensors (``kernels/linalg.py``, ``csrc/linalg.cu``): their plain versions,
``svd3x3_plain`` and ``smallest_eigvec_plain``, which CPU tensors take,
are ~512 and ~130 launches a call, and the SLAM frame calls them ~20 times.
"""

from __future__ import annotations

import torch

from ..kernels import linalg as _kernel
from ..ops.gradients import div_const
from ..utils.precision import device_constant, f32
from ..utils.profiling import count


def _jacobi_rotation(app, aqq, apq):
    """(c, s) of the rotation that annihilates A[p, q]; apq = 0 gives the
    identity."""
    theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
    return torch.cos(theta), torch.sin(theta)


@f32
def jacobi_eigh(A: torch.Tensor, sweeps: int = 12):
    """Eigendecomposition of small symmetric (..., n, n) matrices by cyclic
    Jacobi: ``(w (..., n), V (..., n, n))`` with ``A V = V diag(w)``,
    eigenvalues unsorted.

    Each rotation J(p, q) is applied as ``A <- J^T (A J)``, ``V <- V J``
    with J the identity but for its 2x2 (p, q) block, which changes columns
    and then rows p and q exactly as the JAX file's updates do.  The 3x3
    path of the JAX file symmetrises its input first; so does this one."""
    n = A.shape[-1]
    A = A.to(torch.float32)
    if n == 3:
        A = 0.5 * (A + A.transpose(-1, -2))
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    V = eye.expand(A.shape).clone()
    pairs = [(p, q) for p in range(n - 1) for q in range(p + 1, n)]
    block = device_constant([[p, p, q, q, p, q, p, q] for p, q in pairs], A.device,
                            torch.long)
    for _ in range(sweeps):
        for i, (p, q) in enumerate(pairs):
            c, s = _jacobi_rotation(A[..., p, p], A[..., q, q], A[..., p, q])
            G = eye.expand(A.shape).clone()
            G[..., block[i, :4], block[i, 4:]] = torch.stack([c, s, -s, c], dim=-1)
            A = G.transpose(-1, -2) @ (A @ G)
            V = V @ G
    return torch.diagonal(A, dim1=-2, dim2=-1), V


def _sort3(w: torch.Tensor, V: torch.Tensor, descending: bool):
    """Branchless 3-element sort of eigenpairs by the JAX file's
    compare-swap network (which, with its strict comparisons, keeps its
    own order among ties)."""
    def cswap(wa, va, wb, vb):
        swap = wb > wa if descending else wb < wa
        sv = swap[..., None]
        return (torch.where(swap, wb, wa), torch.where(sv, vb, va),
                torch.where(swap, wa, wb), torch.where(sv, va, vb))

    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    v0, v1, v2 = V[..., :, 0], V[..., :, 1], V[..., :, 2]
    w0, v0, w1, v1 = cswap(w0, v0, w1, v1)
    w0, v0, w2, v2 = cswap(w0, v0, w2, v2)
    w1, v1, w2, v2 = cswap(w1, v1, w2, v2)
    return torch.stack([w0, w1, w2], dim=-1), torch.stack([v0, v1, v2], dim=-1)


@f32
def sorted_eigh(A: torch.Tensor, sweeps: int = 12):
    """``jacobi_eigh`` with eigenvalues ascending (a stable sort, as
    ``jnp.argsort``) and their eigenvector columns."""
    w, V = jacobi_eigh(A, sweeps)
    if A.shape[-1] == 3:
        return _sort3(w, V, descending=False)
    w_sorted, order = torch.sort(w, dim=-1, stable=True)
    return w_sorted, torch.gather(V, -1, order[..., None, :].expand(V.shape))


def _cholesky_lower(A: torch.Tensor, floor: float) -> torch.Tensor:
    """Lower Cholesky factor, a column per step, no pivoting; a pivot
    below ``floor`` is clamped to it, so the factor stays finite."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        s = A[..., j:, j] - (L[..., j:, :j] * L[..., j:j + 1, :j]).sum(-1)
        d = torch.sqrt(torch.clamp(s[..., 0], min=floor))
        L[..., j, j] = d
        L[..., j + 1:, j] = s[..., 1:] / d[..., None]
    return L


def _cholesky_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(L L^T)^-1 b`` for b of shape (..., n)."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]


@f32
def smallest_eigvec(A: torch.Tensor, iterations: int = 8) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric PSD
    (..., n, n) matrices: inverse iteration on the Cholesky factor of
    ``A + (1e-6 tr(A)/n + 1e-30) I`` from a fixed generic start vector
    (the DLT solvers' null-space extractor).  CUDA tensors take the kernel,
    for n <= 9 only (a larger n raises ``ValueError``)."""
    count("linalg.calls")
    if A.device.type == "cuda":
        count("linalg.fused")
        return _kernel.smallest_eigvec(A, iterations)
    return smallest_eigvec_plain(A, iterations)


@f32
def smallest_eigvec_plain(A: torch.Tensor, iterations: int = 8) -> torch.Tensor:
    """:func:`smallest_eigvec` in plain PyTorch on any device: the kernel's
    counterpart, which CPU tensors take."""
    n = A.shape[-1]
    A = A.to(torch.float32)
    tr = div_const(torch.diagonal(A, dim1=-2, dim2=-1).sum(-1), float(n))
    eps = 1e-6 * tr + 1e-30
    A = A.clone()
    torch.diagonal(A, dim1=-2, dim2=-1).add_(eps[..., None])
    L = _cholesky_lower(A, 1e-30)

    x = device_constant(_kernel.start_vector(n), A.device).expand(A.shape[:-1])
    for _ in range(iterations):
        x = _cholesky_solve(L, x)
        norm = torch.sqrt((x * x).sum(-1, keepdim=True))
        x = x * (1.0 / torch.clamp(norm, min=1e-30))
    return x


@f32
def svd3x3(E: torch.Tensor, sweeps: int = 12):
    """SVD of (..., 3, 3) matrices from the Jacobi eigh of ``E^T E``:
    ``(U, S, Vt)`` with S descending; the last column of U is rebuilt as
    the signed cross product of the first two (it is all noise once s3 is
    small, as for an essential matrix).  CUDA tensors take the kernel."""
    count("linalg.calls")
    if E.device.type == "cuda":
        count("linalg.fused")
        return _kernel.svd3x3(E, sweeps)
    return svd3x3_plain(E, sweeps)


@f32
def svd3x3_plain(E: torch.Tensor, sweeps: int = 12):
    """:func:`svd3x3` in plain PyTorch on any device: the kernel's
    counterpart, which CPU tensors take."""
    E = E.to(torch.float32)
    w, V = jacobi_eigh(E.transpose(-1, -2) @ E, sweeps)
    w, V = _sort3(w, V, descending=True)
    S = torch.sqrt(torch.clamp(w, min=0.0))
    U = (E @ V) / torch.clamp(S[..., None, :], min=1e-12)

    def unit(v):
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                               min=1e-20)

    u1 = unit(U[..., :, 0])
    u2 = U[..., :, 1]
    u2 = unit(u2 - (u1 * u2).sum(-1, keepdim=True) * u1)
    u3 = torch.linalg.cross(u1, u2, dim=-1)
    flip = (u3 * U[..., :, 2]).sum(-1, keepdim=True) < 0.0
    u3 = torch.where(flip, -u3, u3)
    return torch.stack([u1, u2, u3], dim=-1), S, V.transpose(-1, -2)


def _solve3x3_cols(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A^-1 B`` for (..., 3, 3) A and (..., 3, k) B by the adjugate and
    the determinant, divided after the product; zeros where |det| <= 1e-20."""
    a = [[A[..., i, j] for j in range(3)] for i in range(3)]
    c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2]
    c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02
    c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2]
    c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0]
    c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1]
    c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2]
    c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    adj_t = torch.stack([
        torch.stack([c00, c10, c20], dim=-1),
        torch.stack([c01, c11, c21], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2)
    ok = (torch.abs(det) > 1e-20)[..., None, None]
    safe = torch.where(ok, det[..., None, None], torch.ones_like(det)[..., None, None])
    x = (adj_t @ B) / safe
    return torch.where(ok, x, torch.zeros_like(x))


@f32
def solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 solve ``A x = b`` for (..., 3) b by the adjugate;
    zeros for a singular A."""
    return _solve3x3_cols(A, b[..., None])[..., 0]


@f32
def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Adjugate 3x3 inverse (``resample.cu:119-143``); zeros when singular."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    return _solve3x3_cols(A, eye.expand(A.shape))


@f32
def cholesky_solve_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve small SPD systems (n <= 8) by an unpivoted Cholesky factor; a
    non-positive pivot is clamped to 1e-20, giving a finite step."""
    n = A.shape[-1]
    if n != b.shape[-1] or n > 8:
        raise ValueError(f"expected (..., n, n) and (..., n) with n <= 8, got "
                         f"{tuple(A.shape)} and {tuple(b.shape)}")
    return _cholesky_solve(_cholesky_lower(A.to(torch.float32), 1e-20),
                           b.to(torch.float32))
