"""The roofline counts at the cells' shapes, and K3's count against the
arithmetic it was copied from (``chip_smoke.window_work``)."""

import math

import pytest
import torch

from portbench import counts
from portbench.reference import scenes
from portbench.reference.sift.config import SiftConfig
from portbench.reference.sift.pipeline import detect_describe


@pytest.mark.parametrize("shape, precision, ms, by", [
    ((96, 1024, 128), "bf16", 2.474e12 / 989e12 * 1e3, "operations"),   # sweep.slam640
    ((50, 2048, 128), "fp32", 3 * 2.684e12 / 495e12 * 1e3, "operations"),  # exhaustive
])
def test_sweep_bound(shape, precision, ms, by):
    s, what = counts.sweep_bound_s(*shape, precision)
    assert math.isclose(1e3 * s, ms, rel_tol=2e-3) and what == by


def test_k3_count_equals_chip_smoke():
    import chip_smoke

    cfg = SiftConfig(width=128, height=96, max_keypoints_per_level=64, max_features=256)
    imgs = scenes.shifted_pairs(96, 128, scenes.rng(3, 1), 1, 20, 5, "cpu")
    _, work = detect_describe(imgs, cfg, k3_work=True)
    ours = counts.window_work(work.planes, cfg, work.kp, work.image, work.valid, work.angle0)
    theirs = chip_smoke.window_work(work.planes, cfg, work.kp, work.image, work.valid,
                                    work.angle0)
    assert torch.equal(ours[0], theirs[0]) and torch.equal(ours[1], theirs[1])
    assert ours[2:] == theirs[2:] and ours[2] > 0
    s, _ = counts.k3_bound_s(work, cfg)
    assert s > 0
