"""The port's pose-graph optimisers (``niftymatch_torch/sfm/posegraph.py``:
SE(3), Sim(3) dense with and without Huber, Sim(3)-CG) against the JAX
package, on the CPU, on the 12-node graphs of
``tests/test_posegraph_sim3.py`` and ``tests/test_posegraph_metrics.py``.

Tolerances: graph costs 1e-5 relative; LM cost traces 1e-3 relative (1e-6
absolute once a cost sits at the fp32 floor); poses and scales within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niftymatch_torch.convert import pose_graph_from_numpy, sim3_graph_from_numpy
from niftymatch_torch.sfm import posegraph as tp
from niftymatch_torch.sfm.se3 import camera_center
from niftymatch_torch.utils.metrics import ate_rmse
from niftymatch_tpu.sfm import posegraph as jp
from test_posegraph_metrics import _chain_graph, _integrate_odometry
from test_posegraph_sim3 import _drifted_loop, _graphs
from torch_parity import np_


def _np(graph):
    return {k: np.asarray(v) for k, v in graph._asdict().items()}


@pytest.fixture(scope="module")
def loop_graphs():
    gt, drifted, loop = _drifted_loop(n=12, gamma=1.06)
    sim3, se3 = _graphs(gt, drifted, loop)
    return gt, sim3, se3


@pytest.fixture(scope="module")
def chain_graph():
    rng = np.random.default_rng(42)
    poses_gt, graph = _chain_graph(rng, n=12, drift=0.08)
    graph = graph._replace(poses=jnp.asarray(_integrate_odometry(graph, 12)))
    return poses_gt, graph


def _check(stats_t, stats_j, out_t, out_j, fields):
    np.testing.assert_allclose(float(stats_t.initial_cost), float(stats_j.initial_cost),
                               rtol=1e-5)
    np.testing.assert_allclose(np_(stats_t.costs), np.asarray(stats_j.costs),
                               rtol=1e-3, atol=1e-6)
    for f in fields:
        np.testing.assert_allclose(np_(getattr(out_t, f)), np.asarray(getattr(out_j, f)),
                                   atol=1e-3, err_msg=f)


@pytest.mark.parametrize("graph", ["chain", "loop"])
def test_optimize_pose_graph_matches_jax(graph, chain_graph, loop_graphs):
    if graph == "chain":
        gt, g = chain_graph
        kw = dict(iterations=12, damping=1e-4)
    else:
        gt, _, g = loop_graphs
        kw = dict(iterations=20, damping=1e-4)
    gt_t = pose_graph_from_numpy(_np(g))
    np.testing.assert_allclose(float(tp.graph_cost(gt_t)), float(jp.graph_cost(g)), rtol=1e-5)
    out_j, st_j = jax.jit(lambda x: jp.optimize_pose_graph(x, **kw))(g)
    out_t, st_t = tp.optimize_pose_graph(gt_t, **kw, device="cpu")
    _check(st_t, st_j, out_t, out_j, ["poses"])
    np.testing.assert_array_equal(np_(out_t.poses)[0], np.asarray(g.poses)[0])
    if graph == "chain":
        assert float(st_t.final_cost) < 0.5 * float(st_t.initial_cost)
        centers = np_(camera_center(torch.from_numpy(np.asarray(gt))))
        before = ate_rmse(np_(camera_center(gt_t.poses)), centers, with_scale=False)
        after = ate_rmse(np_(camera_center(out_t.poses)), centers, with_scale=False)
        assert after < 0.8 * before


@pytest.mark.parametrize("huber", [None, 0.05])
def test_optimize_pose_graph_sim3_matches_jax(huber, loop_graphs):
    _, g, _ = loop_graphs
    gt_t = sim3_graph_from_numpy(_np(g))
    np.testing.assert_allclose(float(tp.sim3_graph_cost(gt_t, huber)),
                               float(jp.sim3_graph_cost(g, huber)), rtol=1e-5)
    kw = dict(iterations=20, damping=1e-4, huber_delta=huber)
    out_j, st_j = jp.optimize_pose_graph_sim3(g, **kw)
    out_t, st_t = tp.optimize_pose_graph_sim3(gt_t, **kw, device="cpu")
    _check(st_t, st_j, out_t, out_j, ["scale", "poses"])
    assert float(st_t.final_cost) < 0.05 * float(st_t.initial_cost)


def test_optimize_pose_graph_sim3_cg_matches_jax(loop_graphs):
    _, g, _ = loop_graphs
    gt_t = sim3_graph_from_numpy(_np(g))
    kw = dict(iterations=20, damping=1e-4, cg_iterations=96)
    out_j, st_j = jp.optimize_pose_graph_sim3_cg(g, **kw)
    out_t, st_t = tp.optimize_pose_graph_sim3_cg(gt_t, **kw, device="cpu")
    _check(st_t, st_j, out_t, out_j, ["scale", "poses"])
    # The dense solver reaches the same optimum (``test_posegraph_sim3.py``).
    out_d, st_d = tp.optimize_pose_graph_sim3(gt_t, iterations=20, damping=1e-4,
                                              device="cpu")
    assert float(st_t.final_cost) <= 1.5 * float(st_d.final_cost) + 1e-6
    np.testing.assert_allclose(np_(out_t.scale), np_(out_d.scale), rtol=0.02)
