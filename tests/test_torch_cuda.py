"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a card.  Every test here needs CUDA (marker ``cuda``) and
skips without it.  This file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K2/K3 raw histograms within 1e-4 times each row's largest
bin (K2 adds each lane's pixels into that lane's own column of a 36 x 32
histogram in shared memory and sums each bin over the columns in a fixed
order, with the per-pixel arithmetic of the plain version and no FMA
contraction; K3 adds into fixed-point bins with integer atomics,
FMA-contracted; both add in another order than the plain version's matrix
product); K1 fp32 min1/min2 within 2e-3 with exact indices where the top-2
gap exceeds 1e-3; K1 bf16 index agreement above 0.999 where the gap
exceeds 2% (``tests/test_pallas_match.py:107-129``).  K1, K2 and K3 give
the same bits on every run, and K2 the same bits for a keypoint in a batch
as for the keypoint's image alone.  The SfM back-end on the card agrees
with its CPU run (cost traces within 1e-3, poses within 1e-3) and passes
``chip_smoke.py``'s phase 7 at small sizes; dense BA and the pose graphs
give the same bits on every run.  ``slam_step`` on the card agrees with
its CPU run (matches, inliers and success equal, pose and world points
within 1e-3) and the SLAM system passes phase 8a.  The fused two-view
polish agrees with the plain ``jacfwd`` polish on the CPU (R and t within
1e-4, cost within 1e-3 relative; analytic against forward-mode
derivatives, sums in another order), is one launch with no host wait and
gives the same bits on every run.  The small-matrix solvers' kernels
(``svd3x3``, ``smallest_eigvec``) agree with their plain versions on the
card at the SLAM frame's shapes under ``utils/smoke_linalg.py``'s
tolerances, are one launch a call with no host wait, and leave RANSAC's
inlier masks and ``two_view_from_matches``' pose as the plain versions
give them.  K4's nine fold
variants agree with their plain versions under ``kernels.fold.agreement``
and give the same bits on every run, also split across CTAs, with ties
across splits and in graph replays; the all-pairs sweep in bf16 lies
within 2 % + 2 of the fp32 oracle's counts (ratio tests that flip within
bf16 noise), in fp32 within 2 (a tie broken in another order); loop
closure passes phase 9a.  The ring's block match through K1 fp32 lies
within 2 of its plain version's counts (indices equal in 99.5 % of the
matched slots); the ring at world 1 on NCCL equals the fused sweep bit for
bit and lies within 2 of the oracle; distributed dense and PCG BA at
world 1 give the single-device solvers' bits.
"""

import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import niftymatch_torch as nt
from niftymatch_torch.kernels import _build
from niftymatch_torch.kernels import fold as tf
from niftymatch_torch.kernels import match as tk
from niftymatch_torch.kernels import windows as tw
from niftymatch_torch.sift import keypoints_and_planes
from torch_parity import (
    PLANAR_TRUTH,
    assert_hist_close,
    cuda_device,
    dense_blob_scene,
    np_,
    planar_correspondences,
    sorted_valid,
    structured_image,
    two_view,
)

H, W = 96, 128
CFG = nt.SiftConfig(width=W, height=H, max_keypoints_per_level=64, max_features=256)
KP = ("x", "y", "sigma", "octave", "level")

pytestmark = pytest.mark.cuda
LINALG = ("svd3x3", "smallest_eigvec")
# The small-matrix solvers' launches in one ransac(): fits in the batch and the refit.
RANSAC_LINALG = {"translation": (0, 0), "similarity": (0, 0), "homography": (0, 2),
                 "fundamental": (2, 2), "essential": (4, 2), "essential5": (2, 1)}


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
    assert _build.LAUNCHES["k1_match_top2_bf16" if bf16 else "k1_match_top2"] == 1
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
    expected = {k: int(k not in ("k1_match_top2_bf16", "refine_gn", *LINALG))
                for k in _build.LAUNCHES}
    assert _build.LAUNCHES == expected, _build.LAUNCHES
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


# --- K3 at the edges of its inputs -----------------------------------------


def _k3_slots(planes, sigmas, angle0s, edges):
    """Keypoint slots on image 1 of the stack: one per (sigma, angle0) at
    the centre of octave 0, level 1, and ``edges`` keypoints on the last
    row, the last column and the corner of every octave's image."""
    rows = [(W / 2 + 0.3, H / 2 - 0.2, s, 0, 1, a) for s in sigmas for a in angle0s]
    for o in range(planes.num_octaves):
        ho, wo = H >> o, W >> o
        for xo, yo in ((wo - 1, ho / 2), (wo / 2, ho - 1), (wo - 1, ho - 1))[:edges]:
            for lvl in range(planes.num_levels):
                rows.append((xo * 2**o + 0.2, yo * 2**o - 0.1,
                             1.6 * 2 ** (o + lvl / 3), o, lvl, 2.0))
    dev = planes.mag.device
    cols = list(zip(*rows))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    kp = [f32(cols[0]), f32(cols[1]), f32(cols[2]), i32(cols[3]), i32(cols[4])]
    n = len(rows)
    return kp, f32(cols[5]), torch.ones(n, dtype=torch.int32, device=dev)


TWO_PI_BELOW = float(np.nextafter(np.float32(2 * np.pi), np.float32(0)))


@pytest.mark.parametrize("case", ["angles", "sweep", "edges", "sigmas", "flipped"])
def test_k3_edge_cases_match_plain(case):
    """angle0 at 0, pi/4, just under 2pi and a sweep over [0, 2pi);
    keypoints on the last row and column of every octave; the smallest
    and largest window scales (the largest clipped to the padding, its
    window staged in several parts); and the flipped Gaussian sign, whose
    window weights grow to 4.77 and coarsen the fixed-point scale."""
    dev = cuda_device()
    _, planes, _ = _front(dev)
    cfg = CFG
    sigmas, angles, edges = [2.4], [0.0, np.pi / 4, TWO_PI_BELOW], 0
    if case == "sweep":
        angles = np.linspace(0.0, TWO_PI_BELOW, 97).tolist()
    elif case == "edges":
        angles, edges = [1.0], 3
    elif case == "sigmas":
        sigmas, angles = [0.8, 1.0, 3.2, 3.6, 8.0], [0.0, 2.5]
    elif case == "flipped":
        sigmas, angles, edges = [0.8, 3.2, 8.0], [0.0, 2.5, TWO_PI_BELOW], 3
        cfg = dataclasses.replace(
            CFG, compat=nt.CompatFlags(flipped_gaussian_sign=True))
    kp, angle0, image = _k3_slots(planes, sigmas, angles, edges)
    valid = torch.ones_like(angle0, dtype=torch.bool)
    got = tw.descriptors(planes, *kp, angle0, valid, cfg, image=image)
    want = tw.descriptors_plain(planes, *kp, angle0, valid, cfg, image)
    assert (np_(want).max(axis=-1) > 0).mean() > 0.5
    assert_hist_close(got, want, err_msg=f"K3 {case}")


def test_k3_all_invalid_gives_zeros():
    dev = cuda_device()
    fl, planes, image = _front(dev)
    kp = [fl[k] for k in KP]
    angle0 = torch.linspace(0.0, 6.2, image.shape[0], device=dev)
    valid = torch.zeros_like(fl["valid"])
    got = tw.descriptors(planes, *kp, angle0, valid, CFG, image=image)
    torch.cuda.synchronize()
    assert got.shape == (image.shape[0], 128) and not got.any()


# --- K2 at the edges of its inputs -----------------------------------------


def _k2_bin_boundary_planes(dev, radius=12):
    """One slab of unit magnitudes whose angles cycle through the bin edges
    float32(k 2pi / 36), their float32 neighbours on both sides and the
    float just below 2pi, so that one ulp in the bin's quotient would move
    a pixel."""
    edges = (np.arange(36) * (2 * np.pi / 36)).astype(np.float32)
    vals = np.concatenate([edges, np.nextafter(edges, np.float32(-1.0)),
                           np.nextafter(edges, np.float32(7.0)),
                           np.float32([TWO_PI_BELOW])]).astype(np.float32)
    hp, wp = H + 2 * radius, W + 2 * radius
    yy, xx = np.mgrid[0:H, 0:W]
    ang = np.zeros((1, hp, wp), np.float32)
    mag = np.zeros((1, hp, wp), np.float32)
    ang[0, radius:radius + H, radius:radius + W] = vals[(7 * yy + xx) % vals.size]
    mag[0, radius:radius + H, radius:radius + W] = 1.0
    t = lambda a: torch.from_numpy(a).to(dev)
    return tw.GradPlanes(t(mag), t(ang), radius, 1, 1, 1)


def _k2_bin_boundary_slots(dev, sigmas, n=48):
    """``n`` keypoints at seeded sub-pixel positions over the whole image,
    borders included, the sigmas taken in turn (octave 0, level 0)."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0.0, W - 1.0, n).astype(np.float32)
    y = rng.uniform(0.0, H - 1.0, n).astype(np.float32)
    x[:4], y[:4] = [0.0, W - 1.0, 0.3, W - 1.2], [0.0, H - 1.0, H - 1.4, 0.2]
    sigma = np.resize(np.float32(sigmas), n)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    return [f32(x), f32(y), f32(sigma), zeros, zeros], zeros


# sigma at octave 0: w_r = 1, 4, exactly 10 (floor(10.35)), clipped to 10.
K2_SIGMAS = [0.2, 1.0, 2.3, 8.0]


@pytest.mark.parametrize("case", ["edges", "sigmas", "flipped", "bin_boundaries"])
def test_k2_edge_cases_match_plain(case):
    """Keypoints on the last row, the last column and the corner of every
    octave; windows of radius 1, 4, exactly 10 and clipped to 10; the
    flipped Gaussian sign, whose weights grow outwards; and hand-made planes
    whose angles sit on and beside every bin edge, which hold the per-pixel
    arithmetic bit for bit and not only the sums."""
    dev = cuda_device()
    cfg = CFG
    if case == "bin_boundaries":
        planes = _k2_bin_boundary_planes(dev)
        kp, image = _k2_bin_boundary_slots(dev, K2_SIGMAS)
    else:
        _, planes, _ = _front(dev)
        sigmas, edges = K2_SIGMAS, 3
        if case == "edges":
            sigmas = [2.0]
        elif case == "sigmas":
            edges = 0
        else:
            cfg = dataclasses.replace(
                CFG, compat=nt.CompatFlags(flipped_gaussian_sign=True))
        kp, _, image = _k3_slots(planes, sigmas, [0.0], edges)
    valid = torch.ones_like(kp[0], dtype=torch.bool)
    _build.reset_launches()
    got = tw.orientation_hists(planes, *kp, valid, cfg, image=image)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["k2_orientation_hist"] == 1
    want = tw.orientation_hists_plain(planes, *kp, valid, cfg, image)
    assert (np_(want).max(axis=-1) > 0).mean() > 0.5
    assert_hist_close(got, want, err_msg=f"K2 {case}")


def test_k2_division_matches_ieee():
    """K2's branch-free division equals CUDA's ``/`` bit for bit: every
    float dividend in [2^-60, 2^60] of either sign over 2 pi (the bin's
    divisor) and over 2 sigma_w^2 for sigma_w = 3.45 (a weight's), and
    2^28 random pairs."""
    dev = cuda_device()
    lib = _build.load("windows", tw._K2_SIGNATURES)
    lo = int(np.float32(2.0 ** -60).view(np.uint32))
    hi = int(np.float32(2.0 ** 60).view(np.uint32))
    for d, first, count, mode in ((float(np.float32(2 * np.pi)), lo, hi - lo + 1, 0),
                                  (float(np.float32(23.805)), lo, hi - lo + 1, 0),
                                  (1.0, 7, 1 << 28, 1)):
        out = torch.zeros(2, dtype=torch.int64, device=dev)
        rc = lib.nm_quotient_check(d, first, count, mode, out.data_ptr(),
                                   out[1:].data_ptr(), _build.stream_ptr(out))
        _build.check(rc, "division check")
        bad, checked = out.tolist()
        assert checked >= min(count, 1 << 28) and bad == 0, (d, bad, checked)


def test_k2_all_invalid_gives_zeros():
    dev = cuda_device()
    fl, planes, image = _front(dev)
    kp = [fl[k] for k in KP]
    got = tw.orientation_hists(planes, *kp, torch.zeros_like(fl["valid"]), CFG,
                               image=image)
    torch.cuda.synchronize()
    assert got.shape == (image.shape[0], 36) and not got.any()


def test_k2_batch_equals_single_images():
    """Each image's keypoints against its own slabs alone give the same
    bits as in the 3-image launch."""
    dev = cuda_device()
    fl, planes, image = _front(dev)
    batch = tw.orientation_hists(planes, *[fl[k] for k in KP], fl["valid"], CFG,
                                 image=image)
    per = planes.num_octaves * planes.num_levels
    m = CFG.max_features
    for i in range(3):
        one = planes._replace(mag=planes.mag[i * per:(i + 1) * per].contiguous(),
                              ang=planes.ang[i * per:(i + 1) * per].contiguous(),
                              num_images=1)
        sl = slice(i * m, (i + 1) * m)
        alone = tw.orientation_hists(one, *[fl[k][sl].contiguous() for k in KP],
                                     fl["valid"][sl].contiguous(), CFG)
        assert torch.equal(batch[sl], alone), f"image {i}"


# --- K1 at the main path's shape, on ties and on rows with no valid B ------


def _k1_operands(a, b, bv, bf16):
    a_mat, a_norm = tk.prepare_descriptors(a, bf16)
    b_mat, b_norm = tk.prepare_descriptors(b, bf16)
    b_norm = torch.where(bv, b_norm, torch.full_like(b_norm, tk.MASKVAL))
    return a_mat, b_mat, a_norm, b_norm


def _k1_check(got, want, bf16):
    g1, gi, g2 = (np_(t) for t in got)
    w1, wi, w2 = (np_(t) for t in want)
    if not bf16:
        np.testing.assert_allclose(g1, w1, atol=2e-3, rtol=1e-5)
        np.testing.assert_allclose(g2, w2, atol=2e-3, rtol=1e-5)
        unique = (w2 - w1) > 1e-3
        np.testing.assert_array_equal(gi[unique], wi[unique])
    else:
        clear = (w2 - w1) > 2e-2 * np.maximum(np.abs(w1), np.abs(w2))
        assert np.mean(gi[clear] == wi[clear]) > 0.999


@pytest.mark.parametrize("pairs,m,n", [(8, 2048, 2048), (8, 2047, 1999), (3, 129, 255)])
@pytest.mark.parametrize("bf16", [False, True])
def test_k1_batched_matches_plain(pairs, m, n, bf16):
    """The main path's 8 x 2048 x 2048 and ragged M/N, unit-norm rows."""
    dev = cuda_device()
    rng = np.random.default_rng(7)
    a, b = (torch.from_numpy(x).to(dev) for x in _descs(rng, pairs, m, n))
    a, b = (x / x.norm(dim=-1, keepdim=True) for x in (a, b))
    bv = torch.from_numpy(rng.uniform(size=(pairs, n)) > 0.05).to(dev)
    ops = _k1_operands(a, b, bv, bf16)
    got = tk.fused_match_topk_prepared(*ops)
    _k1_check(got, tk.fused_match_topk_plain(*ops), bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_k1_duplicates_take_lowest_column_and_empty_rows(bf16):
    """Exact-duplicate B rows: the lowest column wins and min2 equals
    min1.  A pair whose B rows are all invalid reports min1 >= 1e29."""
    dev = cuda_device()
    rng = np.random.default_rng(3)
    a, b = _descs(rng, 2, 300, 700)
    dup = [(160, 9, 200), (170, 131, 640), (250, 601, 699)]   # a row, columns
    for r, *cols in dup:
        for c in cols:
            b[0, c] = a[0, r] + 0.001
    a, b = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    bv = torch.ones((2, 700), dtype=torch.bool, device=dev)
    bv[1] = False
    ops = _k1_operands(a, b, bv, bf16)
    g1, gi, g2 = (np_(t) for t in tk.fused_match_topk_prepared(*ops))
    for r, *cols in dup:
        assert gi[0, r] == cols[0] and g2[0, r] == g1[0, r]
    assert (g1[1] >= tk.NOVALID).all()
    _k1_check([t[:1] for t in tk.fused_match_topk_prepared(*ops)],
              [t[:1] for t in tk.fused_match_topk_plain(*ops)], bf16)


def test_k1_k2_k3_rerun_bit_identical():
    dev = cuda_device()
    fl, planes, image = _front(dev)
    kp = [fl[k] for k in KP]
    h1 = tw.orientation_hists(planes, *kp, fl["valid"], CFG, image=image)
    h2 = tw.orientation_hists(planes, *kp, fl["valid"], CFG, image=image)
    assert torch.equal(h1, h2)
    angle0 = torch.linspace(0.0, 6.2, image.shape[0], device=dev)
    d1 = tw.descriptors(planes, *kp, angle0, fl["valid"], CFG, image=image)
    d2 = tw.descriptors(planes, *kp, angle0, fl["valid"], CFG, image=image)
    assert torch.equal(d1, d2)
    rng = np.random.default_rng(11)
    a, b = (torch.from_numpy(x).to(dev) for x in _descs(rng, 8, 2048, 2048))
    bv = torch.ones((8, 2048), dtype=torch.bool, device=dev)
    for bf16 in (False, True):
        ops = _k1_operands(a, b, bv, bf16)
        first = tk.fused_match_topk_prepared(*ops)
        second = tk.fused_match_topk_prepared(*ops)
        assert all(torch.equal(u, v) for u, v in zip(first, second))


# --- geometry, warp and mosaic on the card ---------------------------------


@pytest.mark.parametrize("model", ["translation", "similarity", "homography",
                                   "fundamental", "essential", "essential5"])
def test_ransac_on_card_matches_cpu(model):
    """One injected draw on the card and on the CPU: the small-matrix
    solvers launched once a fit on the card, the same transform
    (corners within 1e-3 px for the 2-D models, entries within 1e-3 up to
    sign for the epipolar ones), and inlier flags that differ only at
    points whose error lies within 1e-4 tau of tau (CUDA divides by a
    Python number through its rounded reciprocal)."""
    from niftymatch_torch.geometry.ransac import _error_fn

    dev = cuda_device()
    rng = np.random.default_rng(8)
    n, iters = 512, 512
    if model in PLANAR_TRUTH:
        src, dst = planar_correspondences(rng, model, n, n // 3)
        tau = 4.0
    else:
        src, dst, _ = two_view(rng, n, outliers=n // 3)
        tau = 1e-5
    mask = np.ones(n, bool)
    scores = rng.gumbel(size=(iters, n)).astype(np.float32)
    cfg = nt.RansacConfig(iterations=iters, inlier_threshold=tau)
    _build.reset_launches()
    rg = nt.ransac(src, dst, mask, cfg, model=model, scores=scores, device=dev)
    rc = nt.ransac(src, dst, mask, cfg, model=model, scores=scores, device="cpu")
    assert bool(rg.success) and bool(rc.success)
    assert _build.LAUNCHES == {**{k: 0 for k in _build.LAUNCHES},
                               **dict(zip(LINALG, RANSAC_LINALG[model]))}
    tg, tc = np_(rg.transform), np_(rc.transform)
    if model in PLANAR_TRUTH:
        corners = np.array([[0, 0, 1], [300, 0, 1], [0, 300, 1], [300, 300, 1]], float).T
        pg, pc = tg @ corners, tc @ corners
        assert np.abs(pg[:2] / pg[2] - pc[:2] / pc[2]).max() <= 1e-3
        err = np_(_error_fn(model)(rc.transform, torch.from_numpy(src),
                                   torch.from_numpy(dst)))
        differ = np_(rg.inliers) != np_(rc.inliers)
        assert (np.abs(err[differ] - tau) <= 1e-4 * tau).all()
        return
    # Epipolar winners are chosen by inlier count, and many hypotheses tie:
    # rounding may pick another one on the card, so hold each side to the
    # truth instead.
    truth = np.ones(n, bool)
    truth[: n // 3] = False
    for r in (rg, rc):
        err = np_(_error_fn(model)(r.transform.cpu(), torch.from_numpy(src),
                                   torch.from_numpy(dst)))
        assert (err[truth] < tau).all() and np_(r.inliers)[truth].all()
        assert abs(int(r.num_inliers) - truth.sum()) <= 0.02 * n


def test_warp_and_blend_on_card_match_cpu():
    from niftymatch_torch.ops import warp as tw_

    dev = cuda_device()
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.uniform(0, 255, (48, 64)).astype(np.float32))
    hom = torch.tensor([[0.98, 0.05, 3.5], [-0.04, 1.02, -2.25], [1e-4, -2e-4, 1.0]])
    for inverse in (False, True):
        g = tw_.warp_perspective(img.to(dev), hom.to(dev), (40, 56), inverse)
        c = tw_.warp_perspective(img, hom, (40, 56), inverse)
        np.testing.assert_allclose(np_(g), np_(c), atol=1e-3)
    cam, dist = torch.tensor([60.0, 58.0, 31.5, 23.5]), torch.tensor([-0.2, 0.05, 0.0])
    g = tw_.remap(img.to(dev), *tw_.undistort_map(cam.to(dev), dist.to(dev), 48, 64))
    c = tw_.remap(img, *tw_.undistort_map(cam, dist, 48, 64))
    np.testing.assert_allclose(np_(g), np_(c), atol=1e-3)
    fw = torch.ones((48, 64))
    canvas, weights = torch.zeros((80, 100)), torch.zeros((80, 100))
    shift = torch.tensor([[1.0, 0, -10], [0, 1, -12], [0, 0, 1]])
    gc, gw = tw_.blend_into_mosaic(canvas.to(dev), weights.to(dev), img.to(dev),
                                   fw.to(dev), shift.to(dev))
    cc, cw = tw_.blend_into_mosaic(canvas, weights, img, fw, shift)
    np.testing.assert_allclose(np_(gc), np_(cc), atol=1e-3)
    np.testing.assert_array_equal(np_(gw), np_(cw))


def test_mosaic_add_frame_launches_and_registers():
    """Each add_frame after the first launches K1 twice (both match
    directions), K2 and K3 once, and ``smallest_eigvec`` twice (the
    homography fits of RANSAC's batch and refit); shifted crops register."""
    from niftymatch_torch.mosaic import MosaicBuilder, MosaicConfig

    dev = cuda_device()
    scene = dense_blob_scene(H + 40, W + 60)
    mb = MosaicBuilder(MosaicConfig(width=W, height=H, canvas_width=320, canvas_height=240,
                                    detector_features=256), device=dev)
    assert mb.add_frame(scene[:H, :W])["registered"]
    for k in (1, 2):
        _build.reset_launches()
        info = mb.add_frame(scene[10 * k:10 * k + H, 14 * k:14 * k + W])
        torch.cuda.synchronize()
        assert info["registered"], info
        assert _build.LAUNCHES == {"k1_match_top2": 2, "k1_match_top2_bf16": 0,
                                   "k2_orientation_hist": 1, "k3_descriptor": 1,
                                   "refine_gn": 0, "svd3x3": 0, "smallest_eigvec": 2}
    h = mb.frame_to_canvas()
    np.testing.assert_allclose(h[:2, 2] - np.array([(320 - W) / 2, (240 - H) / 2]),
                               [28, 20], atol=1.0)


def test_per_octave_on_card_matches_merged():
    """The plain per-octave oracle against the merged path through K2/K3,
    both on the card (``tests/test_sift_e2e.py:74-103``'s tolerances)."""
    dev = cuda_device()
    img = structured_image(H, W, seed=7)
    fo = nt.sift.detect_and_describe_per_octave(img, CFG, device=dev)
    fm = nt.detect_and_describe(img, CFG, device=dev)
    vo, vm = np_(fo.valid), np_(fm.valid)
    assert vo.sum() == vm.sum() > 10
    oo = np.lexsort([np_(getattr(fo, k))[vo] for k in ("angle", "y", "x")])
    om = np.lexsort([np_(getattr(fm, k))[vm] for k in ("angle", "y", "x")])
    for field in ("x", "y", "sigma", "angle", "response", "desc"):
        np.testing.assert_allclose(np_(getattr(fo, field))[vo][oo],
                                   np_(getattr(fm, field))[vm][om], atol=1e-4,
                                   err_msg=field)


# --- the SfM back-end on the card -------------------------------------------


def test_two_view_on_card_matches_cpu():
    """``estimate_two_view`` on synthetic features with one injected draw
    for each model: the card launches K1 twice and gives the CPU's
    matches, and R, t within 1e-3 of the CPU's and of the truth."""
    from niftymatch_torch.data import make_feature_sequence, make_scene
    from niftymatch_torch.utils.smoke_sfm import _rel_pose

    dev = cuda_device()
    scene = make_scene(num_cams=3, num_landmarks=600, seed=2)
    feats = make_feature_sequence(scene, capacity=512, seed=2)
    intr = tuple(float(v) for v in scene.intrinsics)
    cfg = nt.RansacConfig(iterations=512, inlier_threshold=4.0)
    rng = np.random.default_rng(3)
    se, sh = (rng.gumbel(size=(512, 512)).astype(np.float32) for _ in range(2))
    _build.reset_launches()
    got = nt.estimate_two_view(*feats[:2], intr, cfg, scores_e=se, scores_h=sh, device=dev)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["k1_match_top2"] == 2
    want = nt.estimate_two_view(*feats[:2], intr, cfg, scores_e=se, scores_h=sh, device="cpu")
    np.testing.assert_array_equal(np_(got.matches.indices), np_(want.matches.indices))
    assert bool(got.success) and bool(want.success)
    R_true, _ = _rel_pose(scene.poses[0], scene.poses[1])
    for r in (got, want):
        assert np.abs(np_(r.R) - R_true).max() < 0.02
    np.testing.assert_allclose(np_(got.R), np_(want.R), atol=1e-3)
    np.testing.assert_allclose(np_(got.t), np_(want.t), atol=1e-3)


# --- the small-matrix solvers (csrc/linalg.cu) --------------------------------


@contextlib.contextmanager
def _plain_solvers():
    """Every caller of ``svd3x3`` and ``smallest_eigvec`` given the plain
    versions, which also run on CUDA tensors."""
    from niftymatch_torch.geometry import linalg as gl
    from niftymatch_torch.geometry import transforms
    from niftymatch_torch.sfm import homography, triangulation

    with contextlib.ExitStack() as stack:
        for mod in (gl, transforms, triangulation, homography):
            for name in LINALG:
                if hasattr(mod, name):
                    stack.enter_context(
                        mock.patch.object(mod, name, getattr(gl, name + "_plain")))
        yield


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_linalg_kernels_match_plain(seed):
    """``svd3x3`` over 512 3 x 3 matrices (generic, rank-2 essential, two
    singular values within 1e-6 to 1e-3), ``smallest_eigvec`` over 512 9 x 9
    DLT normal matrices and 8 x 1,024 4 x 4 ``triangulate_dlt`` systems,
    against the plain versions on the card: ``utils/smoke_linalg.py``'s
    tolerances, and the same bits on a rerun."""
    from niftymatch_torch.utils import smoke_linalg

    dev = cuda_device()
    result = smoke_linalg.compare(dev, seed)
    smoke_linalg.check(result)
    assert result["eig9"]["conditioned_share"] > 0.5
    assert result["eig4"]["conditioned_share"] > 0.9


@pytest.mark.parametrize("solver", LINALG)
def test_linalg_one_kernel_a_call_no_sync(solver):
    """On a CUDA tensor the router launches exactly one kernel, the
    solver's, counts it once, and waits for nothing on the host (sync
    debug mode "error"); a CUDA ``smallest_eigvec`` past n = 9 raises."""
    from torch.profiler import ProfilerActivity, profile

    from niftymatch_torch.geometry import linalg as gl
    from niftymatch_torch.utils import smoke_linalg

    dev = cuda_device()
    A = smoke_linalg.svd_inputs(dev) if solver == "svd3x3" else smoke_linalg.eig9_inputs(dev)
    call = getattr(gl, solver)
    call(A)                            # builds, loads, uploads the start vector
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call(A)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call(A)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and f"{solver}_kernel" in kernels[0], kernels
    assert _build.LAUNCHES == {**{k: 0 for k in _build.LAUNCHES}, solver: 2}
    with pytest.raises(ValueError, match="n <= 9"):
        gl.smallest_eigvec(torch.eye(10, device=dev))


@pytest.mark.parametrize("model", ["essential", "homography"])
def test_ransac_kernel_path_matches_plain_path(model):
    """``ransac`` on the card with one injected draw, through the kernels
    and through the plain solvers: the same success, inlier mask and
    ``num_inliers`` (``test_ransac_on_card_matches_cpu``'s data)."""
    dev = cuda_device()
    rng = np.random.default_rng(8)
    n, iters = 512, 512
    if model in PLANAR_TRUTH:
        src, dst = planar_correspondences(rng, model, n, n // 3)
        tau = 4.0
    else:
        src, dst, _ = two_view(rng, n, outliers=n // 3)
        tau = 1e-5
    scores = rng.gumbel(size=(iters, n)).astype(np.float32)
    cfg = nt.RansacConfig(iterations=iters, inlier_threshold=tau)
    mask = np.ones(n, bool)
    _build.reset_launches()
    got = nt.ransac(src, dst, mask, cfg, model=model, scores=scores, device=dev)
    with _plain_solvers():
        want = nt.ransac(src, dst, mask, cfg, model=model, scores=scores, device=dev)
    torch.cuda.synchronize()
    assert tuple(_build.LAUNCHES[k] for k in LINALG) == RANSAC_LINALG[model]
    assert bool(got.success) and bool(want.success)
    np.testing.assert_array_equal(np_(got.inliers), np_(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers)


def test_two_view_kernel_path_matches_plain_path():
    """``two_view_from_matches`` on a rendered 640x480 pair (views 0 and 1
    of ``chip_smoke.py`` 7a's scene, 1,024 features, mutual matches) with
    one injected draw for each model, through the kernels and through the
    plain solvers: the same success and inliers, R within 1e-4."""
    from niftymatch_torch.data import make_scene, render_frames
    from niftymatch_torch.ops.match import mutual_matches
    from niftymatch_torch.slam.frontend import two_view_from_matches

    dev = cuda_device()
    scene = make_scene(num_cams=8, num_landmarks=1200, seed=0, radius=6.0,
                       width=640, height=480)
    frames = torch.from_numpy(render_frames(scene, seed=0)[:2]).to(dev)
    feats = nt.detect_and_describe_batch(frames, nt.SiftConfig(640, 480, max_features=1024),
                                         device=dev)
    fa, fb = (nt.Features(*[t[i] for t in feats]) for i in range(2))
    m = nt.match_pair(fa, fb, ambiguity=0.7, device=dev)
    m = m._replace(indices=mutual_matches(m, nt.match_pair(fb, fa, ambiguity=0.7, device=dev)))
    intr = tuple(float(v) for v in scene.intrinsics)
    cfg = nt.RansacConfig(iterations=512, inlier_threshold=4.0)
    rng = np.random.default_rng(3)
    se, sh = (rng.gumbel(size=(512, 1024)).astype(np.float32) for _ in range(2))
    got = two_view_from_matches(fa, fb, m, intr, cfg, scores_e=se, scores_h=sh, device=dev)
    with _plain_solvers():
        want = two_view_from_matches(fa, fb, m, intr, cfg, scores_e=se, scores_h=sh,
                                     device=dev)
    assert bool(got.success) and bool(want.success)
    assert int(got.num_inliers) == int(want.num_inliers) >= 20
    np.testing.assert_allclose(np_(got.R), np_(want.R), atol=1e-4)


def _refine_scene(rng, n, t_dir=(0.8, 0.1, -0.2), noise=5e-4):
    """``tests/test_torch_sfm.py``'s two-view scene (camera B = (R, t), unit
    t, normalised observations with noise) with R from the port's
    ``so3_exp``: the world points and the truth (R, t)."""
    from niftymatch_torch.sfm.se3 import so3_exp

    R = so3_exp(torch.tensor([0.05, -0.12, 0.03])).numpy()
    t = np.asarray(t_dir, np.float64)
    t = (t / np.linalg.norm(t)).astype(np.float32)
    X = rng.uniform(-1.5, 1.5, size=(n, 3))
    X[:, 2] = 5.0 + rng.uniform(-1.0, 2.0, n)
    X = X.astype(np.float32)
    Xb = X @ R.T + t
    xa = (X[:, :2] / X[:, 2:] + rng.normal(0, noise, (n, 2))).astype(np.float32)
    xb = (Xb[:, :2] / Xb[:, 2:] + rng.normal(0, noise, (n, 2))).astype(np.float32)
    return R, t, xa, xb


def _refine_start(R, t, dr=(0.01, -0.02, 0.015), dt=(0.03, -0.02, 0.05)):
    from niftymatch_torch.sfm.se3 import so3_exp

    R0 = so3_exp(torch.tensor(dr, dtype=torch.float32)).numpy() @ R
    t0 = t + np.asarray(dt, np.float32)
    return R0.astype(np.float32), (t0 / np.linalg.norm(t0)).astype(np.float32)


def _refine_case(case):
    """(R0, t0, pts_a, pts_b, weights) of one card case."""
    from niftymatch_torch.sfm.two_view_refine import refine_relative_pose

    rng = np.random.default_rng(7)
    if case in ("n96_binary", "n96_soft", "at_optimum", "far_start"):
        R, t, xa, xb = _refine_scene(rng, 96)     # |t_x| = 0.96: basis on e_y
        R0, t0 = _refine_start(R, t)
        if case == "n96_binary":
            w = (rng.uniform(size=96) > 0.2).astype(np.float32)
        elif case == "n96_soft":
            w = rng.uniform(0.2, 1.0, 96).astype(np.float32)
        else:
            w = np.ones(96, np.float32)
        if case == "at_optimum":   # steps of ~1e-7: so3_exp's Taylor branch
            R0, t0, _ = refine_relative_pose(*(torch.from_numpy(a) for a in (R0, t0, xa, xb, w)))
            R0, t0 = R0.numpy(), t0.numpy()
        if case == "far_start":    # a first step past theta = 0.1: sin and cos
            R0, t0 = _refine_start(R, t, dr=(0.15, -0.2, 0.1))
        return R0, t0, xa, xb, w
    n = {"n1024_zeros": 1024, "all_zero": 1024, "tx_branch": 300, "n3000": 3000}[case]
    t_dir = (-0.95, 0.2, 0.1) if case == "tx_branch" else (0.3, -0.2, 0.93)
    R, t, xa, xb = _refine_scene(rng, n, t_dir)
    R0, t0 = _refine_start(R, t)
    w = {"n1024_zeros": (rng.uniform(size=n) > 0.4).astype(np.float32),
         "all_zero": np.zeros(n, np.float32)}.get(case, np.ones(n, np.float32))
    return R0, t0, xa, xb, w


@pytest.mark.parametrize("case", ["n96_binary", "n96_soft", "n1024_zeros", "all_zero",
                                  "tx_branch", "at_optimum", "far_start", "n3000"])
def test_refine_kernel_matches_plain(case):
    """The fused polish on the card against the plain ``jacfwd`` polish on
    the CPU: R and t within 1e-4, the cost within 1e-3 relative.  The
    cases: ``tests/test_torch_sfm.py``'s scene at n = 96 with binary and
    soft weights, N = 1,024 with ~40 % zero weights, all weights zero, both
    branches of ``_tangent_basis`` (|t_x| below and above 0.9), a start at
    the optimum (Taylor branch of ``so3_exp``), a start ~0.27 rad off
    (its generic branch), and N = 3,000, past the shared-memory stage."""
    from niftymatch_torch.sfm.two_view_refine import refine_relative_pose

    dev = cuda_device()
    arrays = _refine_case(case)
    want = refine_relative_pose(*(torch.from_numpy(a) for a in arrays))
    _build.reset_launches()
    got = refine_relative_pose(*(torch.from_numpy(a).to(dev) for a in arrays))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["refine_gn"] == 1
    np.testing.assert_allclose(np_(got[0]), np_(want[0]), atol=1e-4)
    np.testing.assert_allclose(np_(got[1]), np_(want[1]), atol=1e-4)
    np.testing.assert_allclose(np_(got[2]), np_(want[2]), rtol=1e-3, atol=0)


def test_refine_kernel_one_launch_no_sync_same_bits():
    """One polish is exactly one ``refine_gn`` launch and nothing else
    counted, waits for nothing on the host (sync debug mode "error"), and
    gives the same bits on a rerun."""
    from niftymatch_torch.sfm.two_view_refine import refine_relative_pose

    dev = cuda_device()
    args = [torch.from_numpy(a).to(dev) for a in _refine_case("n1024_zeros")]
    refine_relative_pose(*args)        # builds and loads the library
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = refine_relative_pose(*args)
        second = refine_relative_pose(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {**{k: 0 for k in _build.LAUNCHES}, "refine_gn": 2}
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bundle_adjust_on_card_matches_cpu():
    """Dense window BA (6 x 128) and PCG BA (32 x 1,024) on the card and on
    the CPU: cost traces within 1e-3 (the fp32 floor, 1e-7 of the start,
    counting as equal), poses within 1e-3."""
    from niftymatch_torch.utils.smoke_sfm import perturbed_problem

    dev = cuda_device()
    cases = [(nt.bundle_adjust, perturbed_problem(6, 128)[1],
              nt.BAConfig(max_iterations=15, damping=1e-3)),
             (nt.bundle_adjust_cg, perturbed_problem(32, 1024, noise_px=0.5, radius=8.0)[1],
              nt.BAConfig(max_iterations=8, damping=1e-3, cg_iterations=40))]
    for solve, problem, cfg in cases:
        sg, stg = solve(problem, cfg, device=dev)
        sc, stc = solve(problem, cfg, device="cpu")
        a, b = np_(stg.costs), np_(stc.costs)
        floor = 1e-4 * float(stc.initial_cost)
        assert (np.abs(a - b) / np.maximum(np.maximum(a, b), floor)).max() <= 1e-3
        assert float(stg.final_cost) < float(stg.initial_cost)
        np.testing.assert_allclose(np_(sg.poses), np_(sc.poses), atol=1e-3)
        np.testing.assert_array_equal(np_(sg.poses)[:2], np_(problem.poses)[:2])


def test_pose_graphs_on_card_match_cpu():
    """SE(3), Sim(3) with Huber and Sim(3)-CG on small graphs: the card's
    costs within 1e-3 of the CPU's, poses within 1e-3."""
    from niftymatch_torch.sfm import (
        optimize_pose_graph,
        optimize_pose_graph_sim3,
        optimize_pose_graph_sim3_cg,
    )
    from niftymatch_torch.utils.smoke_sfm import se3_chain_graph, sim3_loop_graph

    dev = cuda_device()
    _, chain = se3_chain_graph(24)
    _, loop = sim3_loop_graph(24, 1.03, anchors=[23])
    runs = [(optimize_pose_graph, chain, dict(iterations=12, damping=1e-4)),
            (optimize_pose_graph_sim3, loop, dict(iterations=20, damping=1e-4, huber_delta=1.0)),
            (optimize_pose_graph_sim3_cg, loop, dict(iterations=20, damping=1e-4,
                                                     cg_iterations=96))]
    for opt, graph, kw in runs:
        og, sg = opt(graph, **kw, device=dev)
        oc, sc = opt(graph, **kw, device="cpu")
        assert float(sg.final_cost) < 0.5 * float(sg.initial_cost)
        np.testing.assert_allclose(np_(sg.costs), np_(sc.costs), rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(np_(og.poses), np_(oc.poses), atol=1e-3)


def test_sfm_phase_on_card():
    """``chip_smoke.py``'s phase 7 at small sizes (its 7a at 640x480, the
    size its bars are for): every check of each part holds."""
    from niftymatch_torch.utils import smoke_sfm

    dev = cuda_device()
    smoke_sfm.two_view_phase(dev)
    smoke_sfm.window_ba_phase(dev, sizes=((5, 1024),), reps=2)
    smoke_sfm.global_ba_phase(dev, cams=64, landmarks=8192, obs_per_cam=1024,
                              check_jax_costs=False)
    smoke_sfm.pose_graph_phase(dev, dense_nodes=48, cg_nodes=240, reps=1)


def test_ba_and_pose_graphs_rerun_bit_identical():
    """Dense ``bundle_adjust``, ``bundle_adjust_cg`` (at 65,536 observations,
    beyond one tile of CUDA's one-row scan) and the SE(3), Sim(3) and
    Sim(3)-CG pose graphs, each run twice on the card: the same bits (their
    sums are sorted segment sums and prefix sums in a fixed order, no float
    atomics)."""
    from niftymatch_torch.sfm import (
        optimize_pose_graph,
        optimize_pose_graph_sim3,
        optimize_pose_graph_sim3_cg,
    )
    from niftymatch_torch.utils.smoke_sfm import (
        global_problem,
        perturbed_problem,
        se3_chain_graph,
        sim3_loop_graph,
    )

    dev = cuda_device()
    problem = perturbed_problem(16, 4096, noise_px=0.5)[1]
    cfg = nt.BAConfig(max_iterations=6, damping=1e-3, huber_delta=1.0)
    runs = [nt.bundle_adjust(problem, cfg, device=dev) for _ in range(2)]
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(a, b)
    problem = global_problem(64, 16384, 1024)[1]
    cfg = nt.BAConfig(max_iterations=6, damping=1e-3, cg_iterations=24)
    runs = [nt.bundle_adjust_cg(problem, cfg, device=dev) for _ in range(2)]
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(a, b), "bundle_adjust_cg"
    _, chain = se3_chain_graph(64)
    _, loop = sim3_loop_graph(64, 1.03, anchors=[63])
    for opt, graph, kw in [(optimize_pose_graph, chain, dict(iterations=8)),
                           (optimize_pose_graph_sim3, loop, dict(iterations=8, huber_delta=1.0)),
                           (optimize_pose_graph_sim3_cg, loop, dict(iterations=8))]:
        (ga, sa), (gb, sb) = (opt(graph, **kw, device=dev) for _ in range(2))
        for a, b in zip(ga + sa, gb + sb):
            assert torch.equal(a, b), opt.__name__


def test_slam_step_on_card_matches_cpu():
    """``slam_step`` with one injected draw: the card launches K1 twice and
    gives the CPU's matches, inliers and success, and its pose and world
    points within 1e-3."""
    from niftymatch_torch.data import make_feature_sequence, make_scene
    from niftymatch_torch.slam import slam_step

    dev = cuda_device()
    scene = make_scene(num_cams=3, num_landmarks=400, seed=0, radius=6.0)
    feats = make_feature_sequence(scene, capacity=384, noise_px=0.5, seed=0)
    intr = tuple(float(v) for v in scene.intrinsics)
    cfg = nt.RansacConfig(iterations=512, inlier_threshold=4.0)
    draw = np.random.default_rng(5).gumbel(size=(512, 384)).astype(np.float32)
    pose = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    world, has = np.zeros((384, 3), np.float32), np.zeros(384, bool)
    _build.reset_launches()
    got = slam_step(feats[0], feats[1], pose, world, has, intr, cfg, scores=(draw, draw),
                    device=dev)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["k1_match_top2"] == 2
    want = slam_step(feats[0], feats[1], pose, world, has, intr, cfg, scores=(draw, draw),
                     device="cpu")
    for name in ("indices", "inliers", "success", "num_inliers", "points_valid"):
        np.testing.assert_array_equal(np_(getattr(got, name)), np_(getattr(want, name)))
    assert bool(got.success) and int(got.num_inliers) > 300
    np.testing.assert_allclose(np_(got.pose), np_(want.pose), atol=1e-3)
    v = np_(want.points_valid)
    np.testing.assert_allclose(np_(got.points_w)[v], np_(want.points_w)[v], atol=1e-3)


def test_slam_parity_phase_on_card():
    """``chip_smoke.py``'s phase 8a: ``SlamSystem`` per frame and chunked on
    the card against the CPU and against a second card run."""
    from niftymatch_torch.utils import smoke_slam

    smoke_slam.parity_phase(cuda_device())


# --- K4, the all-pairs sweep and loop closure on the card ------------------


@pytest.mark.parametrize("k,nb,n", [(1024, 16, None), (4096, 1, None), (2048, 2, None),
                                    (1000, 3, None), (1000, 2, 1)])
@pytest.mark.parametrize("fold", tf.FOLDS)
def test_k4_matches_plain(fold, k, nb, n):
    """Each fold variant against its plain version (``kernels.fold.
    agreement``'s tolerances) and against a second run, bit for bit, at
    the fold microbenchmark's two shapes, one between them (split in 4 as
    (4,096, 1) is), 1,000 rows against 1,000 (no multiple of any tile; 4
    splits of 8 tiles) and against one B row (n = 1: no second value, 1
    split).  One launch a call: the splits' merge runs in the kernel's last
    CTA of each row block."""
    from niftymatch_torch.utils import smoke_fold

    dev = cuda_device()
    a_mat, _, b_mat, b_norm = smoke_fold.operands(k, nb, dev, n=n)
    _build.reset_launches()
    got = tf.fold_variant(a_mat, b_mat, b_norm, fold)
    again = tf.fold_variant(a_mat, b_mat, b_norm, fold)
    torch.cuda.synchronize()
    assert _build.K4_LAUNCHES[tf.launch_name(fold)] == 2
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    want = tf.fold_variant_plain(a_mat, b_mat, b_norm, fold)
    res = tf.agreement(fold, got, want, tf.distances(a_mat, b_mat, b_norm))
    assert res["ok"], res


def _k4_splits(k, nb):
    dev = cuda_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return tf.column_splits(nb, k, k, sms)


@pytest.mark.parametrize("fold", tf.FOLDS)
def test_k4_cross_split_tie(fold):
    """Rows with an exact tie of their two minima at columns in the first
    and the last column split (``smoke_fold.plant_ties``) at (4,096, 1):
    the lower column keeps idx1, and min2 equals min1."""
    from niftymatch_torch.utils import smoke_fold

    dev = cuda_device()
    splits = _k4_splits(4096, 1)
    assert splits == 4           # the grid fills the card: 4 x 32 CTAs
    bounds = tf.split_bounds(4096, splits)
    rows = list(range(0, 4096, 331))
    ties = [(0, i, bounds[0][0] + j, bounds[-1][0] + j) for j, i in enumerate(rows)]
    a_mat, _, b_mat, b_norm = smoke_fold.plant_ties(smoke_fold.operands(4096, 1, dev), ties)
    got = tf.fold_variant(a_mat, b_mat, b_norm, fold)
    want = tf.fold_variant_plain(a_mat, b_mat, b_norm, fold)
    res = tf.agreement(fold, got, want, tf.distances(a_mat, b_mat, b_norm))
    assert res["ok"], res
    g1, gi, g2 = (t[0].cpu() for t in got)
    if fold not in ("gemm", "rowsum", "min1"):
        assert torch.equal(g1[rows], g2[rows])
    if fold in ("current", "pipe", "top2idx", "bf16", "slotpack"):
        assert gi[rows].tolist() == [c for _, _, c, _ in ties]


def test_k4_graph_replays_merge_splits():
    """A CUDA graph of one split launch, replayed: every replay gives the
    direct call's bits (the row blocks' counters are left at zero)."""
    from niftymatch_torch.utils import smoke_fold

    dev = cuda_device()
    assert _k4_splits(4096, 1) > 1
    a_mat, _, b_mat, b_norm = smoke_fold.operands(4096, 1, dev)
    direct = tf.fold_variant(a_mat, b_mat, b_norm, "top2idx")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tf.fold_variant(a_mat, b_mat, b_norm, "top2idx")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tf.fold_variant(a_mat, b_mat, b_norm, "top2idx")
    for _ in range(3):
        for t in out:
            t.fill_(7)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(out, direct))


@pytest.mark.parametrize("k,nb", [(1024, 16), (4096, 1)])
@pytest.mark.parametrize("fold", ["gemm", "rowsum"])
def test_k4_consume_only_sums(fold, k, nb):
    """``gemm`` and ``rowsum`` with their sums added to 0, not 3.4e38 (which
    hides every sum), against the plain sums within 1e-4 relative; at
    (4,096, 1) the sums of 4 column splits, ``base`` added once."""
    from niftymatch_torch.utils import smoke_fold

    dev = cuda_device()
    a_mat, _, b_mat, b_norm = smoke_fold.operands(k, nb, dev)
    got = tf.fold_variant(a_mat, b_mat, b_norm, fold, base=0.0)
    want = tf.fold_variant_plain(a_mat, b_mat, b_norm, fold, base=0.0)
    assert bool((got[0] < -1.0).all())   # -2 a.b summed: a, b in [0, 1)
    res = tf.agreement(fold, got, want, tf.distances(a_mat, b_mat, b_norm), base=0.0)
    assert res["ok"], res


def test_allpairs_fused_bf16_on_card_matches_cpu_oracle():
    """The closure sweep's bf16 K1 launches (one per keyframe) against the
    fp32 oracle on the CPU: every count within 2 % + 2; in fp32 the fused
    sweep gives the oracle's counts."""
    from niftymatch_torch.parallel import allpairs_match, allpairs_match_fused

    dev = cuda_device()
    rng = np.random.default_rng(5)
    pool = rng.random((1500, 128)).astype(np.float32)
    desc = np.stack([pool[rng.choice(1500, 1024, replace=False)]
                     + rng.normal(0, 0.03, (1024, 128)).astype(np.float32)
                     for _ in range(10)])
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    valid = rng.random((10, 1024)) > 0.1
    d, v = torch.from_numpy(desc), torch.from_numpy(valid)
    want = allpairs_match(d, v, ambiguity=0.7, mutual=True).counts.numpy()
    _build.reset_launches()
    got = np_(allpairs_match_fused(d.to(dev), v.to(dev), ambiguity=0.7, mutual=True,
                                   precision="bf16").counts)
    assert _build.LAUNCHES["k1_match_top2_bf16"] == 10
    assert (np.abs(got - want) <= 0.02 * want + 2).all()
    fp32 = np_(allpairs_match_fused(d.to(dev), v.to(dev), ambiguity=0.7, mutual=True).counts)
    assert np.abs(fp32 - want).max() <= 2


def test_closure_parity_phase_on_card():
    """``chip_smoke.py``'s phase 9a: the 12-keyframe loop's closure on the
    card against the CPU, and the test's bars."""
    from niftymatch_torch.utils import smoke_closure

    smoke_closure.parity_phase(cuda_device())


@pytest.fixture()
def nccl_world1(tmp_path):
    """A process group of this process alone on NCCL (file:// rendezvous)."""
    import torch.distributed as dist

    from niftymatch_torch.parallel import initialize_distributed

    dev = cuda_device()
    torch.cuda.set_device(dev.index or 0)
    initialize_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0, "nccl")
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def _keyframes(K, N, seed=5):
    rng = np.random.default_rng(seed)
    pool = rng.random((N + N // 2, 128)).astype(np.float32)
    desc = np.stack([pool[rng.choice(len(pool), N, replace=False)]
                     + rng.normal(0, 0.03, (N, 128)).astype(np.float32) for _ in range(K)])
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return torch.from_numpy(desc), torch.from_numpy(rng.random((K, N)) > 0.1)


@pytest.mark.parametrize("mutual", [False, True])
def test_ring_block_match_k1_matches_plain(mutual):
    """The ring's block match through K1 fp32 (one launch per visiting
    frame, a second with ``mutual``) against its plain version, the fp32
    oracle on the CPU: counts within 2, indices equal in 99.5 % of the
    matched slots."""
    from niftymatch_torch.parallel.matching import _pack, _ring_block_match, _unpack

    dev = cuda_device()
    desc, valid = _keyframes(5, 1024)
    packed = _pack(desc, valid)
    res, vis = packed[:3], packed[3:]
    want_c, want_i = _ring_block_match(_unpack(res), _unpack(vis), 0.8, mutual)
    _build.reset_launches()
    got_c, got_i = _ring_block_match(_unpack(res.to(dev)), _unpack(vis.to(dev)), 0.8, mutual)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["k1_match_top2"] == 2 * (1 + mutual)
    assert np.abs(np_(got_c).astype(int) - np_(want_c)).max() <= 2
    hit = (np_(want_i) >= 0) | (np_(got_i) >= 0)
    assert (np_(got_i) == np_(want_i))[hit].mean() >= 0.995


def test_ring_world1_nccl_matches_oracle_and_fused(nccl_world1):
    """The ring at world 1 on NCCL: counts within 2 of the fp32 oracle on
    the card, and counts and indices equal to ``allpairs_match_fused``
    (the same K1 rows) bit for bit."""
    from niftymatch_torch.parallel import (
        allpairs_match,
        allpairs_match_fused,
        make_keyframe_mesh,
        ring_allpairs_match,
    )

    dev = nccl_world1
    desc, valid = (t.to(dev) for t in _keyframes(6, 1024))
    mesh = make_keyframe_mesh()
    _build.reset_launches()
    ring = ring_allpairs_match(desc, valid, mesh, ambiguity=0.7, mutual=True,
                               return_indices=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["k1_match_top2"] == 12
    fused = allpairs_match_fused(desc, valid, ambiguity=0.7, mutual=True, return_indices=True)
    assert torch.equal(ring.counts, fused.counts) and torch.equal(ring.indices, fused.indices)
    oracle = allpairs_match(desc, valid, ambiguity=0.7, mutual=True).counts
    assert int((ring.counts - oracle).abs().max()) <= 2


@pytest.mark.parametrize("cg", [False, True])
def test_distributed_ba_world1_bit_identical(nccl_world1, cg):
    """Distributed BA at world 1 on NCCL gives the single-device solver's
    bits on the same (partition-ordered) problem, and a rerun the same."""
    import niftymatch_torch as nt
    from niftymatch_torch.parallel import (
        distributed_bundle_adjust,
        distributed_bundle_adjust_cg,
        make_keyframe_mesh,
        partition_by_landmark,
    )
    from niftymatch_torch.utils.smoke_sfm import perturbed_problem

    dev = nccl_world1
    _, problem = perturbed_problem(8, 512, noise_px=0.5)
    sharded = partition_by_landmark(problem, 1)
    cfg = nt.BAConfig(max_iterations=5, damping=1e-3, cg_iterations=24)
    solve = distributed_bundle_adjust_cg if cg else distributed_bundle_adjust
    ref = nt.bundle_adjust_cg if cg else nt.bundle_adjust
    want, want_st = ref(nt.BAProblem(*sharded), cfg, device=dev)
    for _ in range(2):
        got, st = solve(sharded, make_keyframe_mesh(), cfg)
        assert torch.equal(st.costs, want_st.costs)
        assert torch.equal(got.poses, want.poses)
        assert torch.equal(got.landmarks, want.landmarks)
