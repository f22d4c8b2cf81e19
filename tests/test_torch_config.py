"""The port's config tree and carry-across functions against the JAX
package's (``niftymatch_torch/config.py``, ``convert.py``)."""

import dataclasses

import numpy as np
import pytest

import niftymatch_torch.config as tc
import niftymatch_tpu.config as jc
from niftymatch_torch.convert import (
    ba_problem_from_numpy,
    features_from_numpy,
    mosaic_config_from_dict,
    pipeline_config_from_dict,
    pose_graph_from_numpy,
    sift_config_from_dict,
    sim3_graph_from_numpy,
)

_DERIVED = ("level_max", "level_min", "num_octaves", "num_gauss_levels",
            "num_dogs", "sigma_k", "sigma_0", "sigma_d0", "base_smooth",
            "sigmas")


def test_module_constants_equal():
    for name in ("SIFT_VECTOR_SIZE", "MAX_DESCRIPTORS", "MINIMUM_OCTAVE_SIZE",
                 "NUM_ORI_BINS", "NUM_DESC_ORI_BINS", "NUM_DESC_SPATIAL_BINS",
                 "DESC_MAGNIF", "MACHINE_EPS"):
        assert getattr(tc, name) == getattr(jc, name), name


@pytest.mark.parametrize("cls", ["CompatFlags", "MatchConfig", "RansacConfig",
                                 "BAConfig", "RuntimeConfig"])
def test_leaf_config_fields_and_defaults(cls):
    t, j = getattr(tc, cls)(), getattr(jc, cls)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(t)] == [
        f.name for f in dataclasses.fields(j)]


@pytest.mark.parametrize("w,h", [(640, 480), (128, 96), (64, 48)])
def test_sift_config_fields_and_derived(w, h):
    t, j = tc.SiftConfig(width=w, height=h), jc.SiftConfig(width=w, height=h)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for name in _DERIVED:
        assert getattr(t, name) == getattr(j, name), name
    for o in range(t.num_octaves + 1):
        assert t.octave_shape(o) == j.octave_shape(o)


def test_pipeline_config_round_trip():
    j = jc.PipelineConfig(
        sift=jc.SiftConfig(
            width=128, height=96, max_features=256, use_second_orientation=True,
            compat=jc.CompatFlags(flipped_gaussian_sign=True),
        ),
        match=jc.MatchConfig(ambiguity=0.7, precision="bf16"),
        runtime=jc.RuntimeConfig(use_pallas=False),
    )
    t = pipeline_config_from_dict(dataclasses.asdict(j))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert isinstance(t.sift.compat, tc.CompatFlags)
    assert t.sift.sigmas == j.sift.sigmas
    assert sift_config_from_dict(dataclasses.asdict(j.sift)) == t.sift
    assert tc.PipelineConfig.for_image(64, 48) == tc.PipelineConfig(
        sift=tc.SiftConfig(width=64, height=48))


def _sfm_state(kind):
    """A JAX ``BAProblem``, ``PoseGraph`` or ``Sim3Graph`` from the JAX
    tests build them, and its cost function."""
    import jax.numpy as jnp

    from niftymatch_tpu.sfm import ba as jba
    from niftymatch_tpu.sfm import posegraph as jp
    from test_ba import _perturbed_problem
    from test_posegraph_sim3 import _drifted_loop, _graphs

    if kind == "ba":
        _, problem = _perturbed_problem(seed=1, outlier_frac=0.05)
        valid = np.asarray(problem.obs_valid).copy()
        valid[::3] = False
        return problem._replace(obs_valid=jnp.asarray(valid)), lambda p: jba.ba_cost(p, 2.0)
    sim3, se3 = _graphs(*_drifted_loop(n=12, gamma=1.06))
    if kind == "pose_graph":
        return se3, jp.graph_cost
    return sim3._replace(scale=jnp.linspace(0.9, 1.2, 12)), jp.sim3_graph_cost


@pytest.mark.parametrize("kind", ["ba", "pose_graph", "sim3_graph"])
def test_sfm_state_round_trip(kind):
    """JAX state -> numpy -> port -> numpy is bit for bit the original,
    dtypes kept (int32 indices, bool masks); the costs agree at 1e-6."""
    from niftymatch_torch.sfm import ba as tba
    from niftymatch_torch.sfm import posegraph as tp

    state, cost = _sfm_state(kind)
    arrays = {k: np.asarray(v) for k, v in state._asdict().items()}
    convert, port_cost = {
        "ba": (ba_problem_from_numpy, lambda p: tba.ba_cost(p, 2.0)),
        "pose_graph": (pose_graph_from_numpy, tp.graph_cost),
        "sim3_graph": (sim3_graph_from_numpy, tp.sim3_graph_cost),
    }[kind]
    port = convert(arrays)
    assert list(port._fields) == list(state._fields)
    for name, a in arrays.items():
        back = getattr(port, name).numpy()
        assert back.dtype == a.dtype, name
        np.testing.assert_array_equal(back, a, err_msg=name)
    np.testing.assert_allclose(float(port_cost(port)), float(cost(state)), rtol=1e-6)


def test_mosaic_config_round_trip():
    from niftymatch_torch.mosaic import MosaicConfig
    from niftymatch_tpu.mosaic import MosaicConfig as JMosaicConfig

    j = JMosaicConfig(
        width=128, height=96, canvas_width=512, anchor_x=12.5,
        ransac=jc.RansacConfig(iterations=300, inlier_threshold=4.0, seed=3),
        ambiguity=0.75, camera_matrix=(100.0, 101.0, 63.5, 47.5),
        distortion=(-0.1, 0.01, 0.0), center_weighted=False,
    )
    t = mosaic_config_from_dict(dataclasses.asdict(j))
    assert isinstance(t, MosaicConfig) and isinstance(t.ransac, tc.RansacConfig)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert mosaic_config_from_dict(dataclasses.asdict(JMosaicConfig(64, 48))) == MosaicConfig(64, 48)


def test_features_round_trip(rng):
    k = 10
    arrays = dict(
        x=rng.uniform(0, 100, k).astype(np.float32),
        y=rng.uniform(0, 100, k).astype(np.float32),
        sigma=rng.uniform(1, 5, k).astype(np.float32),
        angle=rng.uniform(0, 6, k).astype(np.float32),
        response=rng.uniform(0, 1, k).astype(np.float32),
        octave=rng.integers(0, 4, k).astype(np.int32),
        level=rng.integers(0, 3, k).astype(np.int32),
        desc=rng.uniform(0, 0.2, (k, 128)).astype(np.float32),
        valid=rng.uniform(size=k) > 0.3,
    )
    f = features_from_numpy(arrays)
    assert f.capacity == k and int(f.count()) == int(arrays["valid"].sum())
    for name, a in arrays.items():
        back = getattr(f, name).numpy()
        np.testing.assert_array_equal(back, a, err_msg=name)
        assert back.dtype == a.dtype, name


def test_topk_features_matches_jax_with_ties(rng):
    """Global top-k keeps jax.lax.top_k's order: lower slot first among
    equal responses (invalid slots tie at -inf)."""
    import jax.numpy as jnp

    from niftymatch_torch.features import Features, concat_features, topk_features
    from niftymatch_tpu.features import Features as JFeatures
    from niftymatch_tpu.features import topk_features as j_topk

    k = 12
    arrays = dict(
        x=np.arange(k, dtype=np.float32), y=np.arange(k, dtype=np.float32) * 2,
        sigma=np.ones(k, np.float32), angle=np.zeros(k, np.float32),
        response=np.array([3, 1, 3, 2, 1, 3, 0, 2, 2, 1, 3, 5], np.float32),
        octave=np.zeros(k, np.int32), level=np.arange(k, dtype=np.int32) % 3,
        desc=rng.uniform(size=(k, 128)).astype(np.float32),
        valid=np.array([1, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1], bool),
    )
    jf = JFeatures(**{n: jnp.asarray(a) for n, a in arrays.items()})
    tf = features_from_numpy(arrays)
    for kk in (5, 8, 16):
        want = j_topk(jf, kk)
        got = topk_features(tf, kk)
        for name in Features._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)
    both = concat_features([tf, tf])
    assert both.capacity == 2 * k and int(both.count()) == 2 * int(tf.count())
