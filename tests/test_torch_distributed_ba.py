"""The port's distributed bundle adjustment (``niftymatch_torch/parallel/
ba.py``) against the JAX package's on the conftest's 8-device CPU mesh.
The port runs on gloo process groups of 2 and 4 spawned CPU processes
(``parallel.spawn.run``).

Tolerances: ``partition_by_landmark``'s layout equal to JAX's bit for
bit; the dense and the PCG solver at n ranks against JAX's at n devices
on the same shards: cost traces within 1e-4 relative (on problems with
0.5-px noise, whose costs stay far above the fp32 floor), poses within
1e-4 (where ``tests/test_torch_ba.py`` holds one solve's steps) and the
gathered landmarks within 1e-3; every rank holds the same bits; the
gauge poses do not move.
"""

import jax
import numpy as np
import pytest
import torch

import torch_spawn_tasks as tasks
from niftymatch_torch.config import BAConfig as TBAConfig
from niftymatch_torch.parallel import partition_by_landmark, spawn
from niftymatch_tpu.config import BAConfig as JBAConfig
from niftymatch_tpu.parallel import (
    distributed_bundle_adjust,
    distributed_bundle_adjust_cg,
    make_keyframe_mesh,
)
from niftymatch_tpu.parallel import partition_by_landmark as jax_partition
from test_torch_ba import _problem

SETTINGS = dict(max_iterations=6, damping=1e-3, cg_iterations=40)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_partition_by_landmark_equals_jax(n_shards):
    """``tests/test_distributed_ba.py``'s 6 x 96 scene (noise 0.5 px) laid
    out in n shards: every array equal to JAX's, bit for bit."""
    _, jp, _ = _problem(6, 96, seed=1)
    got = partition_by_landmark(jp, n_shards)
    want = jax_partition(jp, n_shards)
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("world, size", [(2, (6, 96)), (4, (8, 256))])
def test_distributed_ba_matches_jax(world, size):
    """Dense and PCG distributed BA at ``world`` ranks against JAX's at
    ``world`` devices: the 6 x 96 window of ``tests/test_distributed_ba.py``
    and the 8 x 256 window of ``tests/test_ba_cg.py``, both with 0.5-px
    noise."""
    _, jp, _ = _problem(*size, seed=size[0] // 2)
    sharded = partition_by_landmark(jp, world)
    out = spawn.run(tasks.ba_task, world, sharded, TBAConfig(**SETTINGS), device="cpu")
    mesh = make_keyframe_mesh(world)
    jsharded = jax_partition(jp, world)
    for name, solve in (("dense", distributed_bundle_adjust),
                        ("cg", distributed_bundle_adjust_cg)):
        solved, stats = jax.device_get(solve(jsharded, mesh, JBAConfig(**SETTINGS)))
        poses, landmarks, st = out[0][name]
        for rank in out[1:]:
            assert all(torch.equal(a, b) for a, b in zip(rank[name][:2], (poses, landmarks)))
        np.testing.assert_allclose(float(st.initial_cost), float(stats.initial_cost),
                                   rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(st.costs.numpy(), np.asarray(stats.costs), rtol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(poses.numpy(), np.asarray(solved.poses), atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(landmarks.numpy(), np.asarray(solved.landmarks),
                                   atol=1e-3, err_msg=name)
        np.testing.assert_array_equal(poses.numpy()[:2], np.asarray(jp.poses)[:2])
        assert float(st.final_cost) < 0.5 * float(st.initial_cost)
