"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a card.  Every test here needs CUDA (marker ``cuda``) and
skips without it.  This file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K2/K3 raw histograms within 1e-4 times each row's largest
bin (the kernels add with shared-memory atomics, in another order than the
plain version's matrix product); K1 fp32 min1/min2 within 2e-3 with exact
indices where the top-2 gap exceeds 1e-3; K1 bf16 index agreement above
0.999 where the gap exceeds 2% (``tests/test_pallas_match.py:107-129``).
"""

import numpy as np
import pytest
import torch

import niftymatch_torch as nt
from niftymatch_torch.kernels import _build
from niftymatch_torch.kernels import match as tk
from niftymatch_torch.kernels import windows as tw
from niftymatch_torch.sift import keypoints_and_planes
from torch_parity import (
    assert_hist_close,
    cuda_device,
    np_,
    sorted_valid,
    structured_image,
)

H, W = 96, 128
CFG = nt.SiftConfig(width=W, height=H, max_keypoints_per_level=64, max_features=256)
KP = ("x", "y", "sigma", "octave", "level")

pytestmark = pytest.mark.cuda


def _front(dev):
    imgs = np.stack([structured_image(H, W, seed=s) for s in (2, 4, 6)])
    mk, planes = keypoints_and_planes(torch.from_numpy(imgs).to(dev), CFG)
    fl = {k: v.reshape(-1) for k, v in mk.items()}
    image = torch.arange(3, dtype=torch.int32, device=dev).repeat_interleave(
        CFG.max_features)
    return fl, planes, image


def test_k2_k3_match_plain():
    dev = cuda_device()
    fl, planes, image = _front(dev)
    assert int(fl["valid"].sum()) > 30
    kp = [fl[k] for k in KP]
    _build.reset_launches()
    hk = tw.orientation_hists(planes, *kp, fl["valid"], CFG, image=image)
    angle0 = torch.linspace(0.0, 6.2, hk.shape[0], device=dev)
    dk = tw.descriptors(planes, *kp, angle0, fl["valid"], CFG, image=image)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["k2_orientation_hist"] == 1
    assert _build.LAUNCHES["k3_descriptor"] == 1
    hp = tw.orientation_hists_plain(planes, *kp, fl["valid"], CFG, image)
    dp = tw.descriptors_plain(planes, *kp, angle0, fl["valid"], CFG, image)
    assert_hist_close(hk, hp, err_msg="K2")
    assert_hist_close(dk, dp, err_msg="K3")
    assert (np_(hk)[~np_(fl["valid"])] == 0).all()


def _descs(rng, pairs, m, n, d=128):
    a = rng.normal(size=(pairs, m, d)).astype(np.float32)
    b = rng.normal(size=(pairs, n, d)).astype(np.float32)
    k = min(m, n) // 2
    b[:, :k] = a[:, :k] + 0.01 * rng.normal(size=(pairs, k, d)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("m,n", [(1000, 1500), (33, 7), (64, 1)])
@pytest.mark.parametrize("bf16", [False, True])
def test_k1_matches_plain(m, n, bf16):
    dev = cuda_device()
    rng = np.random.default_rng(42)
    a, b = (torch.from_numpy(x).to(dev) for x in _descs(rng, 2, m, n))
    bv = torch.from_numpy(rng.uniform(size=(2, n)) > 0.1).to(dev)
    bv[:, 0] = True
    a_mat, a_norm = tk.prepare_descriptors(a, bf16)
    b_mat, b_norm = tk.prepare_descriptors(b, bf16)
    b_norm = torch.where(bv, b_norm, torch.full_like(b_norm, tk.MASKVAL))
    _build.reset_launches()
    got = tk.fused_match_topk_prepared(a_mat, b_mat, a_norm, b_norm)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["k1_match_top2"] == 1
    want = tk.fused_match_topk_plain(a_mat, b_mat, a_norm, b_norm)
    g1, gi, g2 = (np_(t) for t in got)
    w1, wi, w2 = (np_(t) for t in want)
    assert ((gi >= 0) & (gi < n)).all()
    if not bf16:
        np.testing.assert_allclose(g1, w1, atol=2e-3, rtol=1e-5)
        if n > 1:
            np.testing.assert_allclose(g2, w2, atol=2e-3, rtol=1e-5)
        unique = (w2 - w1) > 1e-3
        np.testing.assert_array_equal(gi[unique], wi[unique])
    else:
        clear = (w2 - w1) > 2e-2 * np.maximum(np.abs(w1), np.abs(w2))
        if n > 1:
            assert np.mean(gi[clear] == wi[clear]) > 0.999


def test_wrappers_reject_bad_inputs():
    dev = cuda_device()
    a = torch.zeros((4, 128), device=dev)
    with pytest.raises(ValueError):
        tk.fused_match_topk_prepared(a.to(torch.float64), a.to(torch.float64),
                                     a[:, 0], a[:, 0])
    with pytest.raises(ValueError):
        tk.fused_match_topk_prepared(a[:, :64], a[:, :64], a[:, 0], a[:, 0])
    fl, planes, image = _front(dev)
    with pytest.raises(ValueError):
        tw.orientation_hists(planes, *[fl[k] for k in KP], fl["valid"], CFG,
                             image=image.to(torch.int64))


def test_slice_on_card_matches_cpu():
    """detect + describe + match on the card (kernels) against the CPU
    (plain versions): the tolerances of tests/test_pallas_windows.py."""
    dev = cuda_device()
    img_a = structured_image(H, W, seed=2)
    img_b = np.roll(img_a, (3, 4), axis=(0, 1))
    pcfg = nt.PipelineConfig(sift=CFG)
    _build.reset_launches()
    ga, gb, gm = nt.make_pair_pipeline(pcfg, device=dev)(img_a, img_b)
    torch.cuda.synchronize()
    assert all(v == 1 for v in _build.LAUNCHES.values()), _build.LAUNCHES
    ca, cb, cm = nt.make_pair_pipeline(pcfg, device="cpu")(img_a, img_b)
    for g, c in ((ga, ca), (gb, cb)):
        vg, og = sorted_valid(g.valid, g.x, g.y)
        vc, oc = sorted_valid(c.valid, c.x, c.y)
        assert vg.sum() == vc.sum() > 10
        for field in ("x", "y", "sigma", "angle", "response"):
            np.testing.assert_allclose(np_(getattr(g, field))[vg][og],
                                       np_(getattr(c, field))[vc][oc], atol=1e-4)
        np.testing.assert_allclose(np_(g.desc)[vg][og], np_(c.desc)[vc][oc], atol=2e-3)
    assert (np_(gm.indices) >= 0).sum() == (np_(cm.indices) >= 0).sum()
