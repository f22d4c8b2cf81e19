"""The frozen references agree with the port's plain path on the CPU."""

import numpy as np
import pytest
import torch

import niftymatch_torch as nt
from niftymatch_torch.data import synthetic
from niftymatch_torch.ops.match import match_descriptors
from niftymatch_torch.parallel.matching import allpairs_match
from portbench.reference import match as ref_match
from portbench.reference import scenes
from portbench.reference.sift.config import SiftConfig
from portbench.reference.sift.pipeline import detect_describe

SMALL = dict(width=128, height=96, max_keypoints_per_level=64, max_features=256)


@pytest.fixture(scope="module")
def pairs():
    return scenes.shifted_pairs(96, 128, scenes.rng(11, 1), 2, 20, 5, "cpu")


@pytest.fixture(scope="module")
def both(pairs):
    ref = detect_describe(pairs, SiftConfig(**SMALL))
    prog = nt.detect_and_describe_batch(pairs, nt.SiftConfig(**SMALL), device="cpu")
    return ref, prog


def test_sift_equals_the_port_plain_path(both):
    ref, prog = both
    assert int(ref.valid.sum()) > 20
    for name in ref._fields:
        assert torch.equal(getattr(ref, name), getattr(prog, name)), name


@pytest.mark.parametrize("ambiguity", [0.7, 0.8])
def test_pair_match_equals_the_port(both, ambiguity):
    ref, _ = both
    got = ref_match.pair_match(ref.desc[:2], ref.valid[:2], ref.desc[2:], ref.valid[2:],
                               ambiguity, "fp32")
    want = match_descriptors(ref.desc[:2], ref.desc[2:], ambiguity,
                             a_valid=ref.valid[:2], b_valid=ref.valid[2:]).indices
    assert torch.equal(got, want) and int((got >= 0).sum()) > 10


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_allpairs_equals_the_port_oracle(both, mode):
    ref, _ = both
    counts, idx = ref_match.allpairs(ref.desc, ref.valid, 0.8, True, mode)
    want = allpairs_match(ref.desc, ref.valid, 0.8, mutual=True, return_indices=True,
                          precision=mode)
    assert torch.equal(counts, want.counts) and torch.equal(idx, want.indices)


def test_scene_equals_the_port_generator():
    ours = scenes.make_scene(np.random.default_rng(4), 6, 200)
    theirs = synthetic.make_scene(num_cams=6, num_landmarks=200, seed=4)
    assert np.array_equal(ours.poses, theirs.poses)
    assert np.array_equal(ours.landmarks, theirs.landmarks)


def test_render_agrees_with_the_port_renderer():
    theirs_scene = synthetic.make_scene(num_cams=3, num_landmarks=150, seed=2, width=160,
                                        height=120)
    ours_scene = scenes.make_scene(np.random.default_rng(2), 3, 150, width=160, height=120)
    want = synthetic.render_frames(theirs_scene, seed=2)
    got = scenes.render_frames(ours_scene, np.random.default_rng(2 + 11), "cpu").numpy()
    assert np.abs(want - 128).max() > 50
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159265, 0.0])
    got = ref_match.round_tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0 and got[2] == 1.0 + 2 ** -9
    assert abs(float(got[3]) + 3.14159265) < 2 ** -9 and got[4] == 0.0
    assert torch.equal(ref_match.round_tf32(got), got)
