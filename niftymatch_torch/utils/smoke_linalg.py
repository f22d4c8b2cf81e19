"""The small-matrix solvers' kernels (``kernels/linalg.py``,
``csrc/linalg.cu``) on the card at the SLAM frame's shapes: their inputs
and their comparison with the plain versions.  ``chip_smoke.py``'s linalg
section and the card tests use it; ``python -m
niftymatch_torch.utils.smoke_linalg`` runs the comparison alone.

The inputs, made on the card from a seed:

* ``svd_inputs``: 512 3 x 3 matrices (RANSAC's hypotheses), a third
  generic, a third rank-2 essential matrices ``U diag(s, s, 0) V^T``, a
  third with two singular values within 1e-6 to 1e-3 of each other;
* ``eig9_inputs``: 512 normal matrices of the 8-point system, built by
  ``geometry.transforms`` from a two-view scene with a third outliers and
  half a pixel of noise: half from RANSAC's minimal samples
  (``_sample_weights`` of a Gumbel draw, rank 8), half from refits over a
  winner's inliers;
* ``eig4_inputs``: 8 x 1,024 normal matrices of ``triangulate_dlt``'s
  4 x 4 system, the homography branch's cheirality vote: eight candidate
  poses against 1,024 noisy correspondences.

Tolerances, kernel against the plain version on the same card:
* S within 1e-5 of s1 where S >= 1e-2 s1, and S^2 within 1e-5 of s1^2
  everywhere: both versions take S from the eigenvalues of E^T E, which
  fp32 holds to ~1e-7 s1^2, so a singular value near 0 (an essential
  matrix's s3) is known only to ~sqrt(1e-7) s1 by either;
* U and V column by column up to sign within 1e-4, and for two singular
  values closer than 1e-2 s1 the projector onto their pair of columns
  (the vectors of a repeated value are any basis of its plane);
* ``U diag(S) Vt`` within 2e-3 of E, relative to E's largest entry
  (``tests/test_torch_geometry.py``'s 2e-3 on matrices of unit entries);
* eigenvectors with the same sign (the same start vector), within 1e-4
  where the matrix is well conditioned for the smallest eigenvector, eps
  kappa <= 1e-3 (eps = 2^-23, kappa = lambda_max / lambda_2 in float64),
  and within 1e-4 + 0.1 eps kappa elsewhere.  Any fp32 factorisation of A
  is that of A + dA with |dA| ~ eps |A|, which moves the eigenvector by
  ~eps kappa: two fp32 versions land up to a few hundredths of eps kappa
  apart, and both as far from the float64 answer.  Minimal 8-point samples
  of nearly collinear points reach eps kappa ~ 0.2.
"""

from __future__ import annotations

import numpy as np
import torch

SVD_BATCH = 512
EIG9_BATCH = 512
EIG4_SHAPE = (8, 1024)
SVD_ATOL = 1e-4
S_RTOL = 1e-5
RECON_ATOL = 2e-3
EIG_ATOL = 1e-4
CLUSTER = 1e-2          # singular values closer than this times s1 share a plane
EPS = float(np.finfo(np.float32).eps)
CONDITIONED = 1e-3      # eps kappa at or below which an eigenvector is held to EIG_ATOL
KAPPA_SHARE = 0.1       # the bound elsewhere: EIG_ATOL + KAPPA_SHARE eps kappa


def _rotations(rng, n, angle=np.pi):
    """n rotation matrices about random axes by up to ``angle``."""
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = rng.uniform(-angle, angle, n)[:, None, None]
    k = np.zeros((n, 3, 3))
    k[:, 0, 1], k[:, 0, 2], k[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
    k -= k.transpose(0, 2, 1)
    return np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * (k @ k)


def svd_inputs(dev, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    third = SVD_BATCH // 3
    generic = rng.standard_normal((third, 3, 3))
    scale = 10.0 ** rng.uniform(-1, 1, (SVD_BATCH - third, 1))
    essential = scale[: third, :, None] * (
        _rotations(rng, third) @ np.diag([1.0, 1.0, 0.0]) @ _rotations(rng, third))
    rest = SVD_BATCH - 2 * third
    s = np.sort(rng.uniform(0.1, 1.0, (rest, 3)), axis=1)[:, ::-1].copy()
    gap = 10.0 ** rng.uniform(-6, -3, rest)
    pair = rng.integers(0, 2, rest)                  # s1 ~ s2 or s2 ~ s3
    s[pair == 0, 1] = s[pair == 0, 0] * (1 - gap[pair == 0])
    s[pair == 1, 2] = s[pair == 1, 1] * (1 - gap[pair == 1])
    near = (_rotations(rng, rest) * s[:, None, :]) @ _rotations(rng, rest)
    near *= scale[third:, :, None]
    E = np.concatenate([generic, essential, near]).astype(np.float32)
    return torch.from_numpy(E).to(dev)


def _two_view_points(rng, n, outliers, noise=1e-3):
    """Normalised coordinates of n points seen from two poses with
    Gaussian noise of ``noise`` (half a pixel at a focal length of 500),
    the first ``outliers`` of B replaced by uniform noise (float32, on the
    host)."""
    R = _rotations(rng, 1, 0.3)[0]
    t = rng.standard_normal(3)
    t /= np.linalg.norm(t)
    p = rng.uniform(-1, 1, (n, 3))
    p[:, 2] += 4.0
    q = p @ R.T + t
    xa = p[:, :2] / p[:, 2:] + rng.normal(0, noise, (n, 2))
    xb = q[:, :2] / q[:, 2:] + rng.normal(0, noise, (n, 2))
    xb[:outliers] = rng.uniform(-0.5, 0.5, (outliers, 2))
    return xa.astype(np.float32), xb.astype(np.float32)


def eig9_inputs(dev, seed: int = 0) -> torch.Tensor:
    from ..geometry.ransac import _sample_weights
    from ..geometry.transforms import _normal_matrix, hartley_normalization

    rng = np.random.default_rng(seed)
    n = 1024
    xa, xb = _two_view_points(rng, n, n // 3)
    src, dst = torch.from_numpy(xa).to(dev), torch.from_numpy(xb).to(dev)
    half = EIG9_BATCH // 2
    scores = torch.from_numpy(rng.gumbel(size=(half, n)).astype(np.float32)).to(dev)
    minimal = _sample_weights(scores, torch.ones(n, dtype=torch.bool, device=dev), 8)
    # A refit's weights are a winner's inliers: the true ones, less a
    # random share of them that a hypothesis missed.
    kept = rng.uniform(0, 1, (half, n)) > rng.uniform(0, 0.5, (half, 1))
    kept[:, : n // 3] = False
    refit = torch.from_numpy(kept.astype(np.float32)).to(dev)
    weights = torch.cat([minimal, refit])
    ns, _ = hartley_normalization(src, weights)
    nd, _ = hartley_normalization(dst, weights)
    x, y, u, v = ns[..., 0], ns[..., 1], nd[..., 0], nd[..., 1]
    r = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, torch.ones_like(x)], dim=-1)
    return _normal_matrix(r, weights).contiguous()


def eig4_inputs(dev, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    k, n = EIG4_SHAPE
    xa, xb = _two_view_points(rng, n, 0)
    t = rng.standard_normal((k, 3))
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    T_b = np.concatenate([_rotations(rng, k, 0.3), t[:, :, None]], axis=2)
    T_a = np.broadcast_to(np.eye(3, 4), (k, 3, 4))
    rows = []
    for T, pts in ((T_a, xa), (T_b, xb)):
        for c in range(2):
            rows.append(pts[None, :, c, None] * T[:, None, 2, :] - T[:, None, c, :])
    A = np.stack(rows, axis=-2).astype(np.float32)           # (K, N, 4, 4)
    A = torch.from_numpy(A).to(dev)
    return (A.transpose(-1, -2) @ A).contiguous()


def _svd_errors(E, got, want):
    """The largest errors of ``got`` = (U, S, Vt) against ``want``: S and
    S^2 over s1 and s1^2, the columns' (or their planes') projectors, and
    ``U diag(S) Vt - E`` over E's largest entry."""
    E = E.double().cpu().numpy()
    (U, S, Vt), (Up, Sp, Vtp) = ([t.double().cpu().numpy() for t in r] for r in (got, want))
    s1 = np.maximum(Sp[:, :1], 1e-30)
    big = Sp >= 1e-2 * s1
    s_err = float((np.abs(S - Sp) / s1)[big].max())
    s2_err = float((np.abs(S * S - Sp * Sp) / (s1 * s1)).max())
    recon = float((np.abs((U * S[:, None, :]) @ Vt - E).max(axis=(1, 2))
                   / np.maximum(np.abs(E).max(axis=(1, 2)), 1e-30)).max())
    vec_err = 0.0
    for i in range(E.shape[0]):
        for M, Mp in ((U[i], Up[i]), (Vt[i].T, Vtp[i].T)):
            cols, k = [], 0
            while k < 3:                      # clusters of near-equal values
                j = k + 1
                while j < 3 and Sp[i, j - 1] - Sp[i, j] < CLUSTER * s1[i, 0]:
                    j += 1
                cols.append(slice(k, j))
                k = j
            for c in cols:
                P, Pp = M[:, c] @ M[:, c].T, Mp[:, c] @ Mp[:, c].T
                vec_err = max(vec_err, float(np.abs(P - Pp).max()))
    return {"S": s_err, "S_squared": s2_err, "vectors": vec_err, "reconstruction": recon}


def _eig_errors(A, x, xp):
    """Kernel ``x`` against plain ``xp`` for the matrices ``A``: the
    largest distance, that over the well-conditioned matrices, the
    largest distance over its bound, the share well conditioned, and
    whether every sign agrees."""
    n = A.shape[-1]
    w = np.linalg.eigvalsh(A.double().cpu().numpy().reshape(-1, n, n))
    eps_kappa = EPS * w[:, -1] / np.maximum(w[:, 1], 1e-300)
    x, xp = (t.double().cpu().numpy().reshape(-1, n) for t in (x, xp))
    d = np.abs(x - xp).max(axis=-1)
    good = eps_kappa <= CONDITIONED
    return {"max_abs_err": float(d.max()),
            "max_abs_err_conditioned": float(d[good].max()) if good.any() else 0.0,
            "conditioned_share": float(good.mean()),
            "max_over_bound": float((d / (EIG_ATOL + KAPPA_SHARE * eps_kappa)).max()),
            "same_sign": bool(((x * xp).sum(-1) > 0).all())}


def compare(dev, seed: int = 0):
    """Each kernel against its plain version on the card at the SLAM
    frame's shapes: the errors, a second run's bits, and the launches."""
    from ..geometry import linalg as gl
    from ..kernels import _build
    from ..kernels import linalg as kl

    out = {}
    E = svd_inputs(dev, seed)
    _build.reset_launches()
    got = kl.svd3x3(E)
    again = kl.svd3x3(E)
    want = gl.svd3x3_plain(E)
    torch.cuda.synchronize(dev)
    out["svd3x3"] = {**_svd_errors(E, got, want), "batch": E.shape[0],
                     "rerun_equal": all(torch.equal(a, b) for a, b in zip(got, again))}
    for name, A in (("eig9", eig9_inputs(dev, seed)), ("eig4", eig4_inputs(dev, seed))):
        x, x2, xp = kl.smallest_eigvec(A), kl.smallest_eigvec(A), gl.smallest_eigvec_plain(A)
        torch.cuda.synchronize(dev)
        out[name] = {**_eig_errors(A, x, xp), "shape": list(A.shape[:-1]),
                     "rerun_equal": torch.equal(x, x2), "finite": bool(torch.isfinite(x).all())}
    out["launches"] = {k: _build.LAUNCHES[k] for k in ("svd3x3", "smallest_eigvec")}
    return out


def check(result) -> None:
    """Raise unless ``compare``'s result is within the tolerances."""
    svd = result["svd3x3"]
    assert svd["rerun_equal"], "svd3x3 differs between two runs"
    assert svd["S"] <= S_RTOL and svd["S_squared"] <= S_RTOL, f"svd3x3 S: {svd}"
    assert svd["vectors"] <= SVD_ATOL, f"svd3x3 U/V: {svd}"
    assert svd["reconstruction"] <= RECON_ATOL, f"svd3x3 U S Vt: {svd}"
    for name in ("eig9", "eig4"):
        r = result[name]
        assert r["rerun_equal"] and r["finite"] and r["same_sign"], \
            f"smallest_eigvec {name}: {r}"
        assert r["max_abs_err_conditioned"] <= EIG_ATOL and r["max_over_bound"] <= 1.0, \
            f"smallest_eigvec {name}: {r}"
    assert result["launches"] == {"svd3x3": 2, "smallest_eigvec": 4}, result["launches"]


if __name__ == "__main__":
    import json

    dev = torch.device("cuda")
    res = compare(dev)
    print(json.dumps(res))
    check(res)
