"""Kernels K2 (orientation histograms) and K3 (descriptors) of the port
(``niftymatch_torch/kernels/windows.py``) against the JAX package.

Their plain PyTorch versions are held against the Pallas kernels run in
interpret mode (``orientation_hists_pallas`` / ``descriptors_pallas``) and
against the JAX merged jnp path, on the same gradients and keypoints.
Raw histograms and descriptors agree within 1e-4 times each row's largest
bin: only the order of the sums differs.  Normalised descriptors agree
within 2e-3.  The kernels themselves are held against the plain versions
on a card by ``tests/test_torch_cuda.py``.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from niftymatch_torch.kernels import windows as tw
from niftymatch_torch.ops import descriptor as t_desc
from niftymatch_torch.ops import orientation as t_ori
from niftymatch_torch.ops.patches import gather_windows, patch_offsets
from niftymatch_torch.ops.pyramid import OctaveData
from niftymatch_tpu.config import SiftConfig
from niftymatch_tpu.ops import descriptor as j_desc
from niftymatch_tpu.ops import orientation as j_ori
from niftymatch_tpu.ops.keypoints import detect_keypoints
from niftymatch_tpu.ops.pyramid import build_pyramid, stack_gradients
from niftymatch_tpu.pallas import windows as jw
from niftymatch_tpu.sift import _merge_keypoints
from torch_parity import (
    assert_hist_close,
    np_,
    port_config,
    structured_image,
)

H, W = 96, 128
KP_FIELDS = ("x", "y", "sigma", "octave", "level")


@functools.lru_cache(maxsize=None)
def _front(seed: int, max_features: int):
    """JAX front end (jitted): merged keypoints, octave gradients, the
    Pallas planes and the jnp gradient stack, all as numpy."""
    cfg = SiftConfig(width=W, height=H, max_keypoints_per_level=64,
                     max_features=max_features)

    @jax.jit
    def front(img):
        octaves = build_pyramid(img, cfg)
        kps = [detect_keypoints(d.dog, o, cfg) for o, d in enumerate(octaves)]
        planes = jw.build_grad_planes(octaves, cfg)
        return (_merge_keypoints(kps, cfg), [d.grad for d in octaves],
                planes.mag, planes.ang, stack_gradients(octaves))

    mk, grads, pmag, pang, gstack = jax.device_get(
        front(jnp.asarray(structured_image(H, W, seed=seed))))
    return cfg, mk, grads, (pmag, pang), gstack


def _with_border_keypoints(mk):
    """Put keypoints on the last column of octave 0 and octave 1 into the
    two last slots, so a difference in how the two sides clip shows."""
    mk = {k: np.array(v) for k, v in mk.items()}
    border = [(W - 1 + 0.3, 40.2, 2.4, 0, 1), (2 * (W // 2 - 1) + 0.4, 61.0, 5.1, 1, 0)]
    for slot, (x, y, s, o, l) in zip((-1, -2), border):
        mk["x"][slot], mk["y"][slot], mk["sigma"][slot] = x, y, s
        mk["octave"][slot], mk["level"][slot], mk["valid"][slot] = o, l, True
    return mk


def _port_planes(grads, cfg):
    octaves = [OctaveData(None, None, torch.from_numpy(np.array(g))) for g in grads]
    return tw.build_grad_planes(octaves, port_config(cfg))


def _t(mk):
    return {k: torch.from_numpy(np.array(v)) for k, v in mk.items()}


def _pallas_planes(cfg, pmag, pang):
    r = j_desc.static_radius_for_level(cfg.num_dog_levels - 1, cfg)
    return jw.GradPlanes(jnp.asarray(pmag), jnp.asarray(pang), r,
                         H + 2 * r + 16, cfg.num_dog_levels)


def _kp_args(mk, lib):
    return [lib(mk[k]) for k in KP_FIELDS]


def test_plain_k2_matches_pallas_interpret():
    cfg, mk, grads, (pmag, pang), _ = _front(seed=2, max_features=16)
    mk = _with_border_keypoints(mk)
    assert mk["valid"].sum() >= 10
    want = jw.orientation_hists_pallas(
        _pallas_planes(cfg, pmag, pang), *_kp_args(mk, jnp.asarray),
        jnp.asarray(mk["valid"]), cfg, interpret=True)
    tmk = _t(mk)
    got = tw.orientation_hists(_port_planes(grads, cfg), *_kp_args(tmk, lambda a: a),
                               tmk["valid"], port_config(cfg))
    assert np.abs(np.asarray(want)[mk["valid"]]).max(axis=-1).min() > 0
    assert_hist_close(got, want, err_msg="K2 raw histograms")
    np.testing.assert_array_equal(np_(got)[~mk["valid"]], 0.0)


def test_plain_k3_matches_pallas_interpret():
    cfg, mk, grads, (pmag, pang), _ = _front(seed=2, max_features=16)
    mk = _with_border_keypoints(mk)
    angle0 = np.random.default_rng(7).uniform(0, 2 * np.pi, mk["x"].shape)
    angle0 = angle0.astype(np.float32)
    want = jw.descriptors_pallas(
        _pallas_planes(cfg, pmag, pang), *_kp_args(mk, jnp.asarray),
        jnp.asarray(angle0), jnp.asarray(mk["valid"]), cfg, interpret=True)
    tmk = _t(mk)
    tcfg = port_config(cfg)
    got = tw.descriptors(_port_planes(grads, cfg), *_kp_args(tmk, lambda a: a),
                         torch.from_numpy(angle0), tmk["valid"], tcfg)
    assert_hist_close(got, want, err_msg="K3 raw descriptors")
    np.testing.assert_allclose(
        np_(t_desc.normalize_descriptors(got))[mk["valid"]],
        np.asarray(j_desc.normalize_descriptors(want))[mk["valid"]], atol=2e-3)


def test_merged_paths_match_jax_jnp_merged():
    """At max_features=256 the port's kernel path (plain on the CPU), the
    port's stack path and the JAX jnp merged path give the same
    orientations and descriptors."""
    cfg, mk, grads, _, gstack = _front(seed=4, max_features=256)
    tcfg = port_config(cfg)
    valid = mk["valid"]
    assert valid.sum() > 20
    ja, jv = j_ori.compute_orientations_merged(
        jnp.asarray(gstack), *_kp_args(mk, jnp.asarray), jnp.asarray(valid), cfg)
    tmk = _t(mk)
    planes = _port_planes(grads, cfg)
    ta, tv = tw.compute_orientations_merged_kernel(
        planes, *_kp_args(tmk, lambda a: a), tmk["valid"], tcfg)
    sa, sv = t_ori.compute_orientations_merged(
        torch.from_numpy(np.array(gstack)), *_kp_args(tmk, lambda a: a), tmk["valid"], tcfg)
    for a, v in ((ta, tv), (sa, sv)):
        np.testing.assert_array_equal(np_(v), np.asarray(jv))
        np.testing.assert_allclose(np_(a), np.asarray(ja), atol=1e-4)

    bvalid = valid & np.asarray(jv)[:, 0]
    angle0 = np.asarray(ja)[:, 0]
    jd, _ = j_desc.compute_descriptors_merged(
        jnp.asarray(gstack), *_kp_args(mk, jnp.asarray), jnp.asarray(angle0),
        jnp.asarray(bvalid), cfg)
    td, _ = tw.compute_descriptors_merged_kernel(
        planes, *_kp_args(tmk, lambda a: a), torch.from_numpy(angle0),
        torch.from_numpy(bvalid), tcfg)
    sd, _ = t_desc.compute_descriptors_merged(
        torch.from_numpy(np.array(gstack)), *_kp_args(tmk, lambda a: a),
        torch.from_numpy(angle0), torch.from_numpy(bvalid), tcfg)
    for d in (td, sd):
        np.testing.assert_allclose(np_(d), np.asarray(jd), atol=2e-3)


def test_bound_counts_the_pixels_that_add():
    """``chip_smoke.window_work``, which sets K2's and K3's bounds, marks
    enough pixels: zeroing every other pixel of the planes leaves the plain
    K2/K3 unchanged.  And no more than K3 needs: its count of adding pixels
    is the count of window pixels with nonzero magnitude and a nonzero
    4x4 spatial tent product."""
    cfg, mk, grads, _, _ = _front(seed=4, max_features=256)
    tcfg = port_config(cfg)
    tmk = _t(mk)
    planes = _port_planes(grads, cfg)
    kp = _kp_args(tmk, lambda a: a)
    image = torch.zeros_like(tmk["octave"])
    angles, avalid = tw.compute_orientations_merged_kernel(planes, *kp, tmk["valid"], tcfg)
    angle0 = angles[:, 0].contiguous()
    dvalid = tmk["valid"] & avalid[:, 0]
    for valid, a0, run in (
        (tmk["valid"], None, lambda p: tw.orientation_hists(p, *kp, tmk["valid"], tcfg)),
        (dvalid, angle0, lambda p: tw.descriptors(p, *kp, angle0, dvalid, tcfg)),
    ):
        need_mag, need_ang, ops, pixels = chip_smoke.window_work(
            planes, tcfg, kp, image, valid, a0, step=50)
        assert 0 < need_ang.sum() <= need_mag.sum() and ops > pixels > 0
        masked = planes._replace(mag=planes.mag * need_mag, ang=planes.ang * need_ang)
        np.testing.assert_array_equal(np_(run(masked)), np_(run(planes)))

    sel = dvalid.nonzero().squeeze(1)
    xo, yo, so, xi, yi, slab = tw._window_params(planes, *[t[sel] for t in kp], image[sel])
    r = planes.radius
    mag = gather_windows(planes.mag, slab, yi, xi, 2 * r + 1)
    fy, fx = patch_offsets(r)
    sbp = (3.0 * so + 1e-7)[:, None, None]
    w = torch.floor(math.sqrt(2.0) * sbp * 5 / 2 + 0.5)
    dx = fx + (xi.float() - xo)[:, None, None]
    dy = fy + (yi.float() - yo)[:, None, None]
    st, ct = torch.sin(angle0[sel])[:, None, None], torch.cos(angle0[sel])[:, None, None]
    wxy = (t_desc._spatial_tents((-st * dx + ct * dy) / sbp)[..., :, None]
           * t_desc._spatial_tents((ct * dx + st * dy) / sbp)[..., None, :])
    adds = ((fx.abs() <= w) & (fy.abs() <= w) & (mag != 0)
            & (wxy.flatten(-2) > 0).any(-1))
    assert pixels == int(adds.sum())


def test_batched_planes_equal_single_image():
    """Two images' planes in one stack, keypoints naming their image, give
    each image's own histograms and descriptors."""
    fronts = [_front(seed=s, max_features=16) for s in (2, 4)]
    cfg = fronts[0][0]
    tcfg = port_config(cfg)
    grads = [np.stack([f[2][o] for f in fronts]) for o in range(cfg.num_octaves)]
    batch = _port_planes(grads, cfg)
    mks = [_t(f[1]) for f in fronts]
    cat = {k: torch.cat([m[k] for m in mks]) for k in mks[0]}
    image = torch.repeat_interleave(torch.arange(2, dtype=torch.int32), 16)
    angle0 = torch.linspace(0.0, 6.0, 32)
    hb = tw.orientation_hists(batch, *_kp_args(cat, lambda a: a), cat["valid"],
                              tcfg, image=image)
    db = tw.descriptors(batch, *_kp_args(cat, lambda a: a), angle0,
                        cat["valid"], tcfg, image=image)
    for b, (f, m) in enumerate(zip(fronts, mks)):
        single = _port_planes(f[2], cfg)
        sl = slice(16 * b, 16 * (b + 1))
        hs = tw.orientation_hists(single, *_kp_args(m, lambda a: a), m["valid"], tcfg)
        ds = tw.descriptors(single, *_kp_args(m, lambda a: a), angle0[sl],
                            m["valid"], tcfg)
        np.testing.assert_array_equal(np_(hb[sl]), np_(hs))
        np.testing.assert_array_equal(np_(db[sl]), np_(ds))
