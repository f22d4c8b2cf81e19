"""Per-keypoint window kernels K2 (orientation histograms) and K3
(descriptors), the counterparts of ``niftymatch_tpu/pallas/windows.py``.

The gradient planes are a zero-padded ``(S, H0 + 2R, W0 + 2R)`` stack per
channel, one slab per (image, octave, level), ``R`` the descriptor
window's static radius; octave ``o`` fills the top-left ``(H0 >> o,
W0 >> o)`` of its slab.  A keypoint names its slab by an image index, which
takes the place of the Pallas wrappers' ``slab_base`` row offsets: the
batched pipeline puts all B images' planes and keypoints into one launch of
each kernel.

Each wrapper takes CPU tensors to its plain PyTorch version and CUDA
tensors to its CUDA kernel (K2 ``csrc/windows.cu``, K3
``csrc/descriptors.cu``); there is no fallback from one to the other.  As
in the Pallas wrappers, the integer window centre is clipped before the
sub-pixel offsets are taken from it; the clip is to the slab's data area
(the octave-0 size), which the JAX merged path also uses and which keeps
every window read inside its slab.  The Pallas wrappers clip a few pixels
looser; the two differ only for a keypoint that lies outside its octave's
image, which detection never produces.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..config import NUM_ORI_BINS, SIFT_VECTOR_SIZE, SiftConfig
from ..ops.descriptor import (
    _descriptor_core,
    finish_descriptors,
    static_radius_for_level,
)
from ..ops.orientation import _histograms_core, finish_orientations, octave_coords
from ..ops.patches import gather_windows
from . import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_K2_SIGNATURES = {
    "nm_orientation_hists": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                             _P, _P, _P, _I, _I, ctypes.c_float, _P, _P],
    # K2's branch-free division against CUDA's `/` (a card test runs it).
    "nm_quotient_check": [ctypes.c_float, ctypes.c_uint, ctypes.c_uint, _I,
                          _P, _P, _P],
}
_K3_SIGNATURES = {
    "nm_descriptors": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                       _P, _P, _P, _I, ctypes.c_float, _P, _P],
}

# Keypoints per step of the plain versions, which materialise per-pixel
# intermediates: this bounds their memory at a full batch on the card.
_PLAIN_CHUNK = {"k2": 4096, "k3": 512}


class GradPlanes(NamedTuple):
    mag: torch.Tensor    # (S, Hp, Wp) float32, S = images * octaves * levels
    ang: torch.Tensor
    radius: int          # zero padding R on every side of each slab
    num_images: int
    num_octaves: int
    num_levels: int


def build_grad_planes(octaves, config: SiftConfig) -> GradPlanes:
    """Pack every octave's (..., L, Ho, Wo, 2) gradients into the planes;
    the leading axes, if any, are the images."""
    radius = static_radius_for_level(config.num_dog_levels - 1, config)
    g0 = octaves[0].grad
    lead = g0.shape[:-4]
    n_img = math.prod(lead)
    n_lvl, h0, w0 = g0.shape[-4], g0.shape[-3], g0.shape[-2]
    shape = (n_img, len(octaves), n_lvl, h0 + 2 * radius, w0 + 2 * radius)
    mag = torch.zeros(shape, dtype=torch.float32, device=g0.device)
    ang = torch.zeros(shape, dtype=torch.float32, device=g0.device)
    for o, data in enumerate(octaves):
        ho, wo = data.grad.shape[-3], data.grad.shape[-2]
        g = data.grad.reshape(n_img, n_lvl, ho, wo, 2)
        mag[:, o, :, radius:radius + ho, radius:radius + wo] = g[..., 0]
        ang[:, o, :, radius:radius + ho, radius:radius + wo] = g[..., 1]
    flat = (-1,) + shape[-2:]
    return GradPlanes(mag.view(flat), ang.view(flat), radius, n_img,
                      len(octaves), n_lvl)


def _window_params(planes: GradPlanes, x, y, sigma, octave, level, image):
    """Octave coords, the clipped integer centre and the slab index."""
    xo, yo, so, xi, yi = octave_coords(x, y, sigma, octave)
    h0 = planes.mag.shape[1] - 2 * planes.radius
    w0 = planes.mag.shape[2] - 2 * planes.radius
    xi = torch.clamp(xi, 0, w0 - 1)
    yi = torch.clamp(yi, 0, h0 - 1)
    slab = (
        torch.clamp(image, 0, planes.num_images - 1) * planes.num_octaves
        + torch.clamp(octave, 0, planes.num_octaves - 1)
    ) * planes.num_levels + torch.clamp(level, 0, planes.num_levels - 1)
    return xo, yo, so, xi, yi, slab


def _sign(config: SiftConfig) -> float:
    return 1.0 if config.compat.flipped_gaussian_sign else -1.0


def _image_index(image, x):
    if image is None:
        return torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    return image


def _check_inputs(planes: GradPlanes, vectors: dict) -> int:
    m = vectors["x"].shape[0]
    for name in ("mag", "ang"):
        t = getattr(planes, name)
        _build.require_cuda(f"planes.{name}", t, torch.float32)
        if t.dim() != 3 or t.shape != planes.mag.shape:
            raise ValueError(f"planes.{name}: expected the (S, Hp, Wp) stack")
    dtypes = dict(x=torch.float32, y=torch.float32, sigma=torch.float32,
                  angle0=torch.float32, octave=torch.int32,
                  level=torch.int32, image=torch.int32, valid=torch.bool)
    for name, t in vectors.items():
        _build.require_cuda(name, t, dtypes[name], (m,))
        if t.device != planes.mag.device:
            raise ValueError(f"{name}: on {t.device}, planes on {planes.mag.device}")
    return m


def _geometry_args(planes: GradPlanes):
    _, hp, wp = planes.mag.shape
    return [planes.mag.data_ptr(), planes.ang.data_ptr(), planes.num_images,
            planes.num_octaves, planes.num_levels, hp, wp, planes.radius]


def _chunked(fn, m: int, step: int, device, width: int):
    if m == 0:
        return torch.zeros((0, width), dtype=torch.float32, device=device)
    return torch.cat([fn(slice(s, s + step)) for s in range(0, m, step)])


# ---------------------------------------------------------------------------
# K2: orientation histograms
# ---------------------------------------------------------------------------


def orientation_hists_plain(planes: GradPlanes, x, y, sigma, octave, level,
                            valid, config: SiftConfig, image=None):
    """Plain PyTorch K2: gather each 21x21 window, masked one-hot histogram."""
    image = _image_index(image, x)
    r_o = config.max_orientation_radius
    xo, yo, so, xi, yi, slab = _window_params(planes, x, y, sigma, octave,
                                              level, image)
    off = planes.radius - r_o

    def part(sl):
        r0, c0 = yi[sl] + off, xi[sl] + off
        mag = gather_windows(planes.mag, slab[sl], r0, c0, 2 * r_o + 1)
        ang = gather_windows(planes.ang, slab[sl], r0, c0, 2 * r_o + 1)
        return _histograms_core(mag, ang, xo[sl], yo[sl], xi[sl], yi[sl],
                                so[sl], valid[sl], r_o, config)

    return _chunked(part, x.shape[0], _PLAIN_CHUNK["k2"], x.device, NUM_ORI_BINS)


def orientation_hists(planes: GradPlanes, x, y, sigma, octave, level, valid,
                      config: SiftConfig, image=None):
    """Raw (M, 36) orientation histograms; invalid slots are zero.

    ``image`` (int32 (M,), optional) names each keypoint's image in a
    batched plane stack."""
    image = _image_index(image, x)
    if planes.mag.device.type == "cpu":
        return orientation_hists_plain(planes, x, y, sigma, octave, level,
                                       valid, config, image)
    m = _check_inputs(planes, dict(x=x, y=y, sigma=sigma, octave=octave,
                                   level=level, image=image, valid=valid))
    if config.max_orientation_radius > planes.radius:
        raise ValueError("orientation radius exceeds the planes' padding")
    out = torch.empty((m, NUM_ORI_BINS), dtype=torch.float32, device=x.device)
    lib = _build.load("windows", _K2_SIGNATURES)
    rc = lib.nm_orientation_hists(
        *_geometry_args(planes), x.data_ptr(), y.data_ptr(), sigma.data_ptr(),
        octave.data_ptr(), level.data_ptr(), image.data_ptr(),
        valid.data_ptr(), m, config.max_orientation_radius, _sign(config),
        out.data_ptr(), _build.stream_ptr(x),
    )
    _build.check(rc, "K2 orientation histograms")
    _build.LAUNCHES["k2_orientation_hist"] += 1
    return out


def compute_orientations_merged_kernel(planes: GradPlanes, x, y, sigma,
                                       octave, level, valid,
                                       config: SiftConfig, image=None):
    """``angles`` (M, 2) with -1 sentinels and ``valid`` (M, 2)."""
    hists = orientation_hists(planes, x, y, sigma, octave, level, valid,
                              config, image)
    return finish_orientations(hists, valid)


# ---------------------------------------------------------------------------
# K3: descriptors
# ---------------------------------------------------------------------------


def descriptors_plain(planes: GradPlanes, x, y, sigma, octave, level, angle0,
                      valid, config: SiftConfig, image=None):
    """Plain PyTorch K3: gather each (2R+1)^2 window, tents, one batched
    product per chunk of keypoints."""
    image = _image_index(image, x)
    radius = planes.radius
    xo, yo, so, xi, yi, slab = _window_params(planes, x, y, sigma, octave,
                                              level, image)

    def part(sl):
        mag = gather_windows(planes.mag, slab[sl], yi[sl], xi[sl], 2 * radius + 1)
        ang = gather_windows(planes.ang, slab[sl], yi[sl], xi[sl], 2 * radius + 1)
        return _descriptor_core(mag, ang, xo[sl], yo[sl], xi[sl], yi[sl],
                                so[sl], angle0[sl], valid[sl], radius, config)

    return _chunked(part, x.shape[0], _PLAIN_CHUNK["k3"], x.device,
                    SIFT_VECTOR_SIZE)


def descriptors(planes: GradPlanes, x, y, sigma, octave, level, angle0, valid,
                config: SiftConfig, image=None):
    """Raw (unnormalised) (M, 128) descriptors; invalid slots are zero."""
    image = _image_index(image, x)
    if planes.mag.device.type == "cpu":
        return descriptors_plain(planes, x, y, sigma, octave, level, angle0,
                                 valid, config, image)
    m = _check_inputs(planes, dict(x=x, y=y, sigma=sigma, octave=octave,
                                   level=level, image=image, angle0=angle0,
                                   valid=valid))
    out = torch.empty((m, SIFT_VECTOR_SIZE), dtype=torch.float32, device=x.device)
    lib = _build.load("descriptors", _K3_SIGNATURES)
    rc = lib.nm_descriptors(
        *_geometry_args(planes), x.data_ptr(), y.data_ptr(), sigma.data_ptr(),
        octave.data_ptr(), level.data_ptr(), image.data_ptr(),
        angle0.data_ptr(), valid.data_ptr(), m, _sign(config),
        out.data_ptr(), _build.stream_ptr(x),
    )
    _build.check(rc, "K3 descriptors")
    _build.LAUNCHES["k3_descriptor"] += 1
    return out


def compute_descriptors_merged_kernel(planes: GradPlanes, x, y, sigma, octave,
                                      level, angle0, valid,
                                      config: SiftConfig, image=None):
    """Normalised (M, 128) descriptors (zeros on invalid slots) and validity."""
    desc = descriptors(planes, x, y, sigma, octave, level, angle0, valid,
                       config, image)
    return finish_descriptors(desc, valid, config), valid
