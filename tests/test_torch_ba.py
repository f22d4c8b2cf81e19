"""The port's bundle adjustment (``niftymatch_torch/sfm/ba.py``, dense
Schur LM, and ``sfm/ba_cg.py``, matrix-free Schur PCG) against the JAX
package, on the CPU, on the same numpy problems.

Tolerances: projection, residuals and cost 1e-5 relative; one damped
solve's dxi and dX within 1e-4 of their largest entry (dxi 1e-3 where a
small damping leaves S's condition number near 3e6); LM cost traces
within 1e-3 relative (1e-4 absolute once the cost sits at the fp32 floor
of a noise-free problem) and final poses within 1e-4; the observation
layout's tables exactly; segment sums 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niftymatch_torch.config import BAConfig as TBAConfig
from niftymatch_torch.convert import ba_problem_from_numpy
from niftymatch_torch.sfm import ba as tba
from niftymatch_torch.sfm import ba_cg as tcg
from niftymatch_tpu.config import BAConfig as JBAConfig
from niftymatch_tpu.data.synthetic import make_observation_table, make_scene
from niftymatch_tpu.sfm import ba as jba
from niftymatch_tpu.sfm import ba_cg as jcg
from niftymatch_tpu.sfm.se3 import se3_compose, se3_exp
from test_ba import _perturbed_problem
from torch_parity import np_


def _port(problem):
    return ba_problem_from_numpy({k: np.asarray(v) for k, v in problem._asdict().items()})


def _problem(C, L, seed, noise_px=0.5, outlier_frac=0.0, pose_noise=0.02, lm_noise=0.05):
    """A perturbed JAX ``BAProblem`` on ``make_scene``, built as
    ``tests/test_ba.py`` builds its own, with its port copy."""
    scene = make_scene(num_cams=C, num_landmarks=L, seed=seed)
    obs_uv, obs_cam, obs_lm, valid = make_observation_table(
        scene, seed=seed, noise_px=noise_px, outlier_frac=outlier_frac)
    rng = np.random.default_rng(seed + 7)
    xi = rng.normal(0, pose_noise, size=(C, 6)).astype(np.float32)
    xi[:2] = 0
    poses = np.asarray(se3_compose(se3_exp(jnp.asarray(xi)), jnp.asarray(scene.poses)))
    lms = scene.landmarks + rng.normal(0, lm_noise, scene.landmarks.shape).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[:2] = True
    problem = jba.BAProblem(*[jnp.asarray(a) for a in (
        poses, lms, scene.intrinsics, obs_uv, obs_cam, obs_lm, valid, fixed)])
    return scene, problem, _port(problem)


def _cfg(**kw):
    return JBAConfig(**kw), TBAConfig(**kw)


def _rel(got, want, rtol):
    got, want = np_(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


@pytest.fixture(scope="module")
def outlier_problem():
    """6 x 128 with 0.5-px noise and 10 % outliers, half an observation
    invalid in every 5: the Huber branch and the masks are exercised."""
    _, jp, _ = _problem(6, 128, seed=2, outlier_frac=0.1)
    valid = np.asarray(jp.obs_valid).copy()
    valid[::5] = False
    jp = jp._replace(obs_valid=jnp.asarray(valid))
    return jp, _port(jp)


def test_project_residuals_cost_match_jax(outlier_problem):
    jp, tp = outlier_problem
    uv_t, p_t = tba.project(tp.poses, tp.landmarks, tp.intrinsics, tp.obs_cam, tp.obs_lm)
    uv_j, p_j = jba.project(jp.poses, jp.landmarks, jp.intrinsics, jp.obs_cam, jp.obs_lm)
    _rel(uv_t, uv_j, 1e-5)
    _rel(p_t, p_j, 1e-5)
    for delta in (2.0, 1.0):
        got = tba.residuals_and_weights(tp, delta)
        want = jba.residuals_and_weights(jp, delta)
        for g, w in zip(got, want):
            if g.dtype == torch.bool:
                np.testing.assert_array_equal(np_(g), np.asarray(w))
            else:
                _rel(g, w, 1e-5)
        np.testing.assert_allclose(float(tba.ba_cost(tp, delta)),
                                   float(jba.ba_cost(jp, delta)), rtol=1e-5)


def test_solve_step_matches_jax(outlier_problem):
    """dxi and dX within 1e-4 of their largest entry where the damping
    conditions S; at lam = 1e-3 S's condition number is ~3e6 (its entries
    reach 2.6e6), the two packages' fp32 S agree within 4e-7 relative, and
    that alone moves dxi by up to ~3e-4 (solving either S in float64 gives
    the same spread), so dxi is held to 1e-3 there."""
    jp, tp = outlier_problem
    jc, tc = _cfg(huber_delta=1.0)
    for lam, tol_dxi in ((1e3, 1e-4), (1e4, 1e-4), (1e-3, 1e-3)):
        dxi_t, dX_t = tba._solve_step(tp, torch.tensor(lam), tc)
        dxi_j, dX_j = jba._solve_step(jp, jnp.float32(lam), jc)
        _rel(dxi_t, dxi_j, tol_dxi)
        _rel(dX_t, dX_j, 1e-4)
        assert (np_(dxi_t)[:2] == 0).all()


@pytest.mark.parametrize("case", ["noise_free", "outliers"])
def test_bundle_adjust_matches_jax(case, outlier_problem):
    """``tests/test_ba.py``'s 6 x 128 problem (noise-free, 15 iterations)
    and the outlier problem (Huber 1.0, 20 iterations)."""
    if case == "noise_free":
        scene, jp = _perturbed_problem(seed=0)
        tp = _port(jp)
        jc, tc = _cfg(max_iterations=15, damping=1e-3)
    else:
        jp, tp = outlier_problem
        jc, tc = _cfg(max_iterations=20, damping=1e-3, huber_delta=1.0)
    solved_j, stats_j = jax.jit(lambda p: jba.bundle_adjust(p, jc))(jp)
    solved_t, stats_t = tba.bundle_adjust(tp, tc, device="cpu")
    np.testing.assert_allclose(float(stats_t.initial_cost), float(stats_j.initial_cost),
                               rtol=1e-5)
    np.testing.assert_allclose(np_(stats_t.costs), np.asarray(stats_j.costs),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np_(stats_t.lambdas), np.asarray(stats_j.lambdas), rtol=1e-5)
    np.testing.assert_allclose(np_(solved_t.poses), np.asarray(solved_j.poses), atol=1e-4)
    np.testing.assert_allclose(np_(solved_t.landmarks), np.asarray(solved_j.landmarks),
                               atol=1e-3)
    # The gauge poses stay put, bit for bit.
    np.testing.assert_array_equal(np_(solved_t.poses)[:2], np.asarray(jp.poses)[:2])
    if case == "noise_free":
        assert float(stats_t.final_cost) < 1e-3 * float(stats_t.initial_cost)
        np.testing.assert_allclose(np_(solved_t.poses), scene.poses, atol=2e-3)


# ---------------------------------------------------------------------------
# Matrix-free Schur PCG
# ---------------------------------------------------------------------------


def test_obs_layout_tables_equal_jax(rng):
    C, L, O = 7, 50, 600
    cam = rng.integers(0, C, O).astype(np.int32)
    lm = rng.integers(0, L - 3, O).astype(np.int32)    # the last landmarks unseen
    lay_t = tcg.build_obs_layout(torch.from_numpy(cam), torch.from_numpy(lm), C, L)
    lay_j = jcg.build_obs_layout(jnp.asarray(cam), jnp.asarray(lm), C, L)
    for name in jcg.ObsLayout._fields:
        np.testing.assert_array_equal(np_(getattr(lay_t, name)),
                                      np.asarray(getattr(lay_j, name)), err_msg=name)


def test_segment_sums_match_jax(rng):
    C, L, O = 5, 40, 500
    cam = rng.integers(0, C, O).astype(np.int32)
    lm = rng.integers(0, L - 2, O).astype(np.int32)
    lay_t = tcg.build_obs_layout(torch.from_numpy(cam), torch.from_numpy(lm), C, L)
    lay_j = jcg.build_obs_layout(jnp.asarray(cam), jnp.asarray(lm), C, L)
    vals = rng.normal(size=(O, 2, 3)).astype(np.float32)
    vt, vj = torch.from_numpy(vals), jnp.asarray(vals)
    _rel(tcg.seg_reduce_lm(vt, lay_t), jcg.seg_reduce_lm(vj, lay_j), 1e-5)
    _rel(tcg.seg_reduce_cam(vt, lay_t), jcg.seg_reduce_cam(vj, lay_j), 1e-5)
    flat = vals.reshape(O, 6)
    _rel(tcg.seg_sum_lm_exact(torch.from_numpy(flat), lay_t),
         jcg.seg_sum_lm_exact(jnp.asarray(flat), lay_j, L), 1e-5)
    _rel(tcg.seg_sum_cam_exact(torch.from_numpy(flat), lay_t),
         jcg.seg_sum_cam_exact(jnp.asarray(flat), lay_j, C), 1e-5)


def test_block_sums_exact_vs_prefix_diff(rng):
    """A tiny late segment after a huge prefix: the prefix difference
    loses ~eps * prefix absolute accuracy; the exact per-segment sum the
    block terms use does not (``tests/test_ba_cg.py:97-127``)."""
    O = 1 << 17
    vals = rng.uniform(1e3, 1e5, size=(O, 1)).astype(np.float32)
    vals[-16:] = rng.uniform(0.5, 2.0, size=(16, 1)).astype(np.float32)
    lm = np.zeros(O, np.int64)
    lm[-16:] = 1
    lay = tcg.build_obs_layout(torch.zeros(O, dtype=torch.int64), torch.from_numpy(lm), 1, 2)
    ref = vals[-16:].astype(np.float64).sum()
    exact = float(tcg.seg_sum_lm_exact(torch.from_numpy(vals), lay)[1, 0])
    plain = float(tcg.seg_reduce_lm(torch.from_numpy(vals), lay)[1, 0])
    assert abs(exact - ref) / ref < 1e-5, (exact, ref)
    assert abs(exact - ref) <= abs(plain - ref)


@pytest.fixture(scope="module")
def window_8x256():
    return _problem(8, 256, seed=3)


def test_bundle_adjust_cg_matches_jax_and_dense(window_8x256):
    scene, jp, tp = window_8x256
    jc, tc = _cfg(max_iterations=8, damping=1e-3, cg_iterations=40)
    solved_j, stats_j = jax.jit(lambda p: jcg.bundle_adjust_cg(p, jc))(jp)
    solved_t, stats_t = tcg.bundle_adjust_cg(tp, tc, device="cpu")
    np.testing.assert_allclose(float(stats_t.initial_cost), float(stats_j.initial_cost),
                               rtol=1e-5)
    np.testing.assert_allclose(np_(stats_t.costs), np.asarray(stats_j.costs), rtol=1e-3)
    np.testing.assert_allclose(np_(solved_t.poses), np.asarray(solved_j.poses), atol=1e-4)
    np.testing.assert_array_equal(np_(solved_t.poses)[:2], np.asarray(jp.poses)[:2])
    # Against the port's dense solver (``tests/test_ba_cg.py:15-24``'s bar).
    _, stats_d = tba.bundle_adjust(tp, tc, device="cpu")
    cc, cd = float(stats_t.final_cost), float(stats_d.final_cost)
    assert cc < float(stats_t.initial_cost)
    assert cc <= 1.3 * cd + 1e-3, (cc, cd)


def test_schur_pcg_step_matches_jax(window_8x256):
    """One PCG solve on the sorted problem (the reduce_fn hook left at the
    identity), against the JAX step: within 1e-4 where the damping
    conditions S, 1e-3 at lam = 1e-3 (see ``test_solve_step_matches_jax``)."""
    _, jp, tp = window_8x256
    jc, tc = _cfg(damping=1e-3, cg_iterations=30)
    C, L = tp.poses.shape[0], tp.landmarks.shape[0]

    def sort(prob, lay):
        o = lay.order_lm
        return prob._replace(obs_uv=prob.obs_uv[o], obs_cam=lay.cam_sorted,
                             obs_lm=lay.lm_sorted, obs_valid=prob.obs_valid[o])

    lay_t = tcg.build_obs_layout(tp.obs_cam, tp.obs_lm, C, L)
    lay_j = jcg.build_obs_layout(jp.obs_cam, jp.obs_lm, C, L)
    for lam, tol in ((1e3, 1e-4), (1e-3, 1e-3)):
        dxi_t, dX_t = tcg._schur_pcg_step(sort(tp, lay_t), lay_t, torch.tensor(lam), tc)
        dxi_j, dX_j = jcg._schur_pcg_step(sort(jp, lay_j), lay_j, jnp.float32(lam), jc)
        _rel(dxi_t, dxi_j, tol)
        _rel(dX_t, dX_j, 1e-4)
