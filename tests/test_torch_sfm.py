"""The port's SE(3)/Sim(3) groups, triangulation, essential and homography
pose recovery and two-view refinement (``niftymatch_torch/sfm/``) against
the JAX package, on the CPU, on the same numpy inputs.

Tolerances: group operations 1e-5; edge Jacobians (forward mode on both
sides) 1e-4, at the identity, below the theta = 0.1 branch and near pi;
triangulation and pose recovery 1e-4, up to sign where an eigenvector is
returned; ``refine_relative_pose`` R and t within 1e-4 and its cost within
1e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from niftymatch_torch.kernels import _build
from niftymatch_torch.sfm import homography as th
from niftymatch_torch.sfm import posegraph as tp
from niftymatch_torch.sfm import se3 as ts
from niftymatch_torch.sfm import sim3 as tsim
from niftymatch_torch.sfm import triangulation as ttri
from niftymatch_torch.sfm import two_view_refine as tref
from niftymatch_tpu.sfm import homography as jh
from niftymatch_tpu.sfm import posegraph as jp
from niftymatch_tpu.sfm import se3 as js
from niftymatch_tpu.sfm import sim3 as jsim
from niftymatch_tpu.sfm import triangulation as jtri
from niftymatch_torch.utils import profiling
from niftymatch_tpu.sfm import two_view_refine as jref
from torch_parity import assert_close_up_to_sign, np_


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=atol, rtol=rtol)


def _axis_angles(rng, n, lo, hi):
    ax = rng.normal(size=(n, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    return (ax * rng.uniform(lo, hi, size=(n, 1))).astype(np.float32)


def _phis(rng):
    """Rotation vectors at theta = 0, below 0.1, at moderate angles and
    near pi (cos theta < -0.9999 takes the axis-from-diagonal branch)."""
    return np.concatenate([
        np.zeros((2, 3), np.float32),
        _axis_angles(rng, 6, 1e-4, 0.099),
        _axis_angles(rng, 8, 0.2, 2.8),
        _axis_angles(rng, 4, np.pi - 0.01, np.pi - 0.002),
    ])


def _xis(rng):
    phi = _phis(rng)
    rho = rng.normal(size=(phi.shape[0], 3)).astype(np.float32)
    return np.concatenate([rho, phi], axis=1)


# ---------------------------------------------------------------------------
# SE(3) / Sim(3)
# ---------------------------------------------------------------------------


def test_so3_exp_log_hat_match_jax(rng):
    phi = _phis(rng)
    _close(ts.hat(_t(phi)), js.hat(_j(phi)), 0)
    R = ts.so3_exp(_t(phi))
    _close(R, js.so3_exp(_j(phi)), 1e-5)
    # so3_log on the same rotations (JAX's exp output, fed to both).
    Rj = np.asarray(js.so3_exp(_j(phi)))
    _close(ts.so3_log(_t(Rj)), js.so3_log(_j(Rj)), 1e-5)


def test_se3_maps_match_jax(rng):
    xi = _xis(rng)
    T = np.asarray(js.se3_exp(_j(xi)))
    _close(ts.se3_exp(_t(xi)), T, 1e-5)
    _close(ts.se3_log(_t(T)), js.se3_log(_j(T)), 1e-5)
    T2 = np.asarray(js.se3_exp(_j(_xis(rng))))
    _close(ts.se3_compose(_t(T), _t(T2)), js.se3_compose(_j(T), _j(T2)), 1e-5)
    _close(ts.se3_inverse(_t(T)), js.se3_inverse(_j(T)), 1e-5)
    _close(ts.se3_relative(_t(T), _t(T2)), js.se3_relative(_j(T), _j(T2)), 1e-5)
    _close(ts.camera_center(_t(T)), js.camera_center(_j(T)), 1e-5)
    pts = rng.normal(size=(T.shape[0], 7, 3)).astype(np.float32)
    _close(ts.se3_apply(_t(T), _t(pts)), js.se3_apply(_j(T), _j(pts)), 1e-5)
    one = pts[:, 0]
    _close(ts.se3_apply(_t(T), _t(one)), js.se3_apply(_j(T), _j(one)), 1e-5)
    _close(ts.se3_identity((4,)), js.se3_identity((4,)), 0)


def test_sim3_maps_match_jax(rng):
    n = 20
    s1 = rng.uniform(0.5, 2.0, n).astype(np.float32)
    s2 = rng.uniform(0.5, 2.0, n).astype(np.float32)
    T1 = np.asarray(js.se3_exp(_j(_xis(rng))))
    T2 = np.asarray(js.se3_exp(_j(_xis(rng))))
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    xi = np.concatenate([_xis(rng), rng.normal(0, 0.2, (n, 1))], 1).astype(np.float32)
    a = tuple(_t(v) for v in (s1, T1, s2, T2))
    b = tuple(_j(v) for v in (s1, T1, s2, T2))
    for got, want in zip(vmap(tsim.sim3_compose)(*a), jax.vmap(jsim.sim3_compose)(*b)):
        _close(got, want, 1e-5)
    for got, want in zip(vmap(tsim.sim3_inverse)(a[0], a[1]),
                         jax.vmap(jsim.sim3_inverse)(b[0], b[1])):
        _close(got, want, 1e-5)
    _close(vmap(tsim.sim3_apply)(a[0], a[1], _t(pts)),
           jax.vmap(jsim.sim3_apply)(b[0], b[1], _j(pts)), 1e-5)
    for got, want in zip(vmap(tsim.sim3_retract)(_t(xi), a[0], a[1]),
                         jax.vmap(jsim.sim3_retract)(_j(xi), b[0], b[1])):
        _close(got, want, 1e-5)
    _close(vmap(tsim.sim3_error)(a[0], a[1]), jax.vmap(jsim.sim3_error)(b[0], b[1]), 1e-5)


def _edges_around(rng, phis):
    """(Ti, Tj, Z) per edge with residual rotation log(Z^-1 Ti Tj^-1) = phi."""
    n = phis.shape[0]
    Ti = np.asarray(js.se3_exp(_j(rng.normal(0, 0.5, (n, 6)).astype(np.float32))))
    Tj = np.asarray(js.se3_exp(_j(rng.normal(0, 0.5, (n, 6)).astype(np.float32))))
    rel = js.se3_compose(_j(Ti), js.se3_inverse(_j(Tj)))
    rho = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    E = js.se3_exp(_j(np.concatenate([rho, phis], 1)))
    Z = np.array(js.se3_compose(rel, js.se3_inverse(E)))        # Z^-1 rel = E
    return Ti, Tj, Z


def test_edge_residual_jacobians_match_jax(rng):
    """Forward-mode Jacobians of the SE(3) edge residual at theta = 0 (the
    identity edge), below the 0.1 branch and near pi."""
    phis = _phis(rng)
    Ti, Tj, Z = _edges_around(rng, phis)
    Z[0] = np.asarray(js.se3_compose(_j(Ti[0]), js.se3_inverse(_j(Tj[0]))))  # exact identity
    zero_t = torch.zeros(6)
    got_i, got_j = vmap(lambda a, b, c: jacfwd(tp._se3_r_of, argnums=(0, 1))(
        zero_t, zero_t, a, b, c))(_t(Ti), _t(Tj), _t(Z))
    zero_j = jnp.zeros(6)

    def r_of(xi_i, xi_j, a, b, c):
        return jp.edge_residual(js.se3_compose(js.se3_exp(xi_i), a),
                                js.se3_compose(js.se3_exp(xi_j), b), c)

    want_i, want_j = jax.jit(jax.vmap(lambda a, b, c: jax.jacfwd(r_of, argnums=(0, 1))(
        zero_j, zero_j, a, b, c)))(_j(Ti), _j(Tj), _j(Z))
    assert got_i.dtype == got_j.dtype == torch.float32
    assert np.isfinite(np_(got_i)).all() and np.isfinite(np_(got_j)).all()
    _close(got_i, want_i, 1e-4)
    _close(got_j, want_j, 1e-4)
    _close(tp.edge_residual(_t(Ti), _t(Tj), _t(Z)),
           jp.edge_residual(_j(Ti), _j(Tj), _j(Z)), 1e-5)


def test_sim3_edge_residual_jacobians_match_jax(rng):
    phis = _phis(rng)
    Ti, Tj, Z = _edges_around(rng, phis)
    n = phis.shape[0]
    si = rng.uniform(0.7, 1.4, n).astype(np.float32)
    sj = rng.uniform(0.7, 1.4, n).astype(np.float32)
    zs = (si / sj).astype(np.float32)
    zs[0] = 1.0
    si[0] = sj[0] = 1.0
    Z[0] = np.asarray(js.se3_compose(_j(Ti[0]), js.se3_inverse(_j(Tj[0]))))
    args = (si, Ti, sj, Tj, zs, Z)
    zero_t = torch.zeros(7)
    got_i, got_j = vmap(lambda *a: jacfwd(tp._sim3_r_of, argnums=(0, 1))(
        zero_t, zero_t, *a))(*[_t(a) for a in args])
    zero_j = jnp.zeros(7)

    def r_of(xi_i, xi_j, si, Ti, sj, Tj, zs, zT):
        return jp.sim3_edge_residual(*jsim.sim3_retract(xi_i, si, Ti),
                                     *jsim.sim3_retract(xi_j, sj, Tj), zs, zT)

    ja = [_j(a) for a in args]
    want_i, want_j = jax.jit(jax.vmap(lambda *a: jax.jacfwd(r_of, argnums=(0, 1))(
        zero_j, zero_j, *a)))(*ja)
    assert got_i.dtype == got_j.dtype == torch.float32
    assert np.isfinite(np_(got_i)).all() and np.isfinite(np_(got_j)).all()
    _close(got_i, want_i, 1e-4)
    _close(got_j, want_j, 1e-4)
    _close(vmap(tp.sim3_edge_residual)(*[_t(a) for a in args]),
           jax.vmap(jp.sim3_edge_residual)(*ja), 1e-5)


# ---------------------------------------------------------------------------
# Triangulation, essential and homography pose recovery
# ---------------------------------------------------------------------------


def _two_view_scene(rng, n=64, noise=1e-4, planar=False):
    """World points in front of camera A (the world frame) and camera B =
    (R, t) with unit t; normalised observations with noise."""
    R = np.asarray(js.so3_exp(_j(np.array([0.05, -0.12, 0.03], np.float32))))
    t = np.array([0.8, 0.1, -0.2])
    t = (t / np.linalg.norm(t)).astype(np.float32)
    X = rng.uniform(-1.5, 1.5, size=(n, 3))
    X[:, 2] = 5.0 + (0.0 if planar else rng.uniform(-1.0, 2.0, n))
    if planar:
        X[:, 2] += 0.1 * X[:, 0]
    X = X.astype(np.float32)
    xa = X[:, :2] / X[:, 2:]
    Xb = X @ R.T + t
    xb = Xb[:, :2] / Xb[:, 2:]
    xa = (xa + rng.normal(0, noise, xa.shape)).astype(np.float32)
    xb = (xb + rng.normal(0, noise, xb.shape)).astype(np.float32)
    Tb = np.concatenate([R, t[:, None]], 1).astype(np.float32)
    return X, R, t, Tb, xa, xb


def test_triangulation_matches_jax(rng):
    X, R, t, Tb, xa, xb = _two_view_scene(rng)
    Ta = np.eye(3, 4, dtype=np.float32)
    for tf, jf in ((ttri.triangulate_midpoint, jtri.triangulate_midpoint),
                   (ttri.triangulate_dlt, jtri.triangulate_dlt)):
        got = tf(_t(Ta), _t(Tb), _t(xa), _t(xb))
        want = jf(_j(Ta), _j(Tb), _j(xa), _j(xb))
        _close(got, want, 1e-4)
        _close(got, X, 3e-2)
    _close(ttri.reprojection_error(_t(Tb), _t(X), _t(xb)),
           jtri.reprojection_error(_j(Tb), _j(X), _j(xb)), 1e-6)
    _close(ttri.depths(_t(Tb), _t(X)), jtri.depths(_j(Tb), _j(X)), 1e-5)


def _essential(R, t):
    return np.asarray(js.hat(_j(t)) @ _j(R))


def test_decompose_essential_and_recover_pose_match_jax(rng):
    X, R, t, Tb, xa, xb = _two_view_scene(rng)
    E = _essential(R, t)
    # An exact E has two equal singular values, so its first two singular
    # vectors are any basis of a plane, which rounding picks: the two
    # packages may swap R1 and R2 and flip t.  The four hypotheses agree.
    R1, R2, tt = ttri.decompose_essential(_t(E))
    W1, W2, wt = jtri.decompose_essential(_j(E))
    got_rs, want_rs = np.stack([np_(R1), np_(R2)]), np.stack([np.asarray(W1), np.asarray(W2)])
    if np.abs(got_rs - want_rs).max() > np.abs(got_rs[::-1] - want_rs).max():
        got_rs = got_rs[::-1]
    _close(got_rs, want_rs, 1e-4)
    assert_close_up_to_sign(tt, wt, 1e-4)
    mask = np.ones(len(xa), bool)
    mask[::7] = False
    got = ttri.recover_pose(_t(E), _t(xa), _t(xb), _t(mask))
    want = jtri.recover_pose(_j(E), _j(xa), _j(xb), _j(mask))
    _close(got.R, want.R, 1e-4)
    _close(got.t, want.t, 1e-4)
    _close(got.R, R, 1e-3)
    _close(got.points, want.points, 1e-4)
    assert got.cheirality.dtype == torch.bool
    np.testing.assert_array_equal(np_(got.cheirality), np.asarray(want.cheirality))
    assert int(got.num_good) == int(want.num_good) == mask.sum()


def _plane_homography(R, t, n, d):
    return (R + np.outer(t, n) / d).astype(np.float32)


def test_decompose_homography_and_recover_pose_match_jax(rng):
    X, R, t, Tb, xa, xb = _two_view_scene(rng, planar=True)
    n = np.array([-0.1, 0.0, 1.0]) / np.linalg.norm([-0.1, 0.0, 1.0])
    d = float(n @ X[0])
    H = _plane_homography(R, t, n, d)
    got = th.decompose_homography(_t(H))
    want = jh.decompose_homography(_j(H))
    for g, w in zip(got, want):
        _close(g, w, 1e-4)
    mask = np.ones(len(xa), bool)
    gp = th.recover_pose_homography(_t(H), _t(xa), _t(xb), _t(mask))
    wp = jh.recover_pose_homography(_j(H), _j(xa), _j(xb), _j(mask))
    _close(gp.R, wp.R, 1e-4)
    _close(gp.t, wp.t, 1e-4)
    _close(gp.points, wp.points, 1e-3)
    np.testing.assert_array_equal(np_(gp.cheirality), np.asarray(wp.cheirality))
    assert int(gp.num_good) == int(wp.num_good)
    # Batched: the candidate axis sits before the matrix axes.
    Hb = np.stack([H, H * 1.7])
    for g, w in zip(th.decompose_homography(_t(Hb)), jh.decompose_homography(_j(Hb))):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("weights", ["binary", "soft"])
def test_refine_relative_pose_matches_jax(rng, weights):
    X, R, t, Tb, xa, xb = _two_view_scene(rng, n=96, noise=5e-4)
    R0 = np.asarray(js.so3_exp(_j(np.array([0.01, -0.02, 0.015], np.float32))) @ _j(R))
    t0 = t + np.array([0.03, -0.02, 0.05], np.float32)
    t0 = (t0 / np.linalg.norm(t0)).astype(np.float32)
    if weights == "binary":
        w = (rng.uniform(size=len(xa)) > 0.2).astype(np.float32)
    else:
        w = rng.uniform(0.2, 1.0, len(xa)).astype(np.float32)
    Rg, tg, cg = tref.refine_relative_pose(_t(R0), _t(t0), _t(xa), _t(xb), _t(w))
    Rw, tw, cw = jref.refine_relative_pose(_j(R0), _j(t0), _j(xa), _j(xb), _j(w))
    _close(Rg, Rw, 1e-4)
    _close(tg, tw, 1e-4)
    _close(cg, cw, 0, rtol=1e-3)
    _close(Rg, R, 1e-2)


@pytest.mark.parametrize("weights", ["binary", "soft"])
def test_smoke_float64_polish_takes_the_plain_steps(rng, weights):
    """``chip_smoke.refine_float64``, the exact polish that the card's smoke
    holds the kernel to, takes the plain version's steps: on the JAX test's
    scene, where fp32 rounding moves nothing, the two agree to 1e-5."""
    import chip_smoke

    X, R, t, Tb, xa, xb = _two_view_scene(rng, n=96, noise=5e-4)
    R0 = np.asarray(ts.so3_exp(_t(np.array([0.01, -0.02, 0.015], np.float32)))) @ R
    t0 = t + np.array([0.03, -0.02, 0.05], np.float32)
    t0 = (t0 / np.linalg.norm(t0)).astype(np.float32)
    if weights == "binary":
        w = (rng.uniform(size=len(xa)) > 0.2).astype(np.float32)
    else:
        w = rng.uniform(0.2, 1.0, len(xa)).astype(np.float32)
    args = [_t(a.astype(np.float32)) for a in (R0, t0, xa, xb, w)]
    Rg, tg, cg = tref.refine_relative_pose_plain(*args)
    Rx, tx, cx = chip_smoke.refine_float64(*args, iterations=10)
    assert Rx.dtype == tx.dtype == cx.dtype == torch.float64
    _close(Rg.double(), Rx, 1e-5)
    _close(tg.double(), tx, 1e-5)
    _close(cg.double(), cx, 0, rtol=1e-4)
    _close(Rx, torch.from_numpy(R).double(), 1e-2)


def test_refine_on_cpu_takes_the_plain_path_and_counts(rng, monkeypatch, tmp_path):
    """CPU tensors run the plain ``jacfwd`` polish: no CUDA library is built
    or loaded and no kernel launch is counted; under a profiler each call
    adds one to ``refine.calls`` and nothing to ``refine.fused``."""
    def no_build(*args, **kwargs):
        raise AssertionError("the CPU path built or loaded a CUDA library")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    _build.reset_launches()
    _, R, t, _, xa, xb = _two_view_scene(rng, n=32)
    args = [_t(a) for a in (R, t, xa, xb, np.ones(32, np.float32))]
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            Rg, tg, _ = tref.refine_relative_pose(*args, iterations=2)
        counted = profiling.counts()
    assert counted == {"refine.calls": 3}
    assert _build.LAUNCHES["refine_gn"] == 0
    assert Rg.device.type == tg.device.type == "cpu"
