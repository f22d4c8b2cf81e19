"""The plain SIFT pipeline of the port, as its merged batch path computes it.

Built from frozen copies of ``niftymatch_torch/sift.py`` (``_merge_keypoints``,
``keypoints_and_planes``, ``describe_keypoints``) and the plain halves of
``niftymatch_torch/kernels/windows.py`` (``build_grad_planes``,
``_window_params``, ``orientation_hists_plain``, ``descriptors_plain``) at
commit def8df72c5c264abd9e3aa10eba50d4d66e57296.  What changed from them:
the hand-written kernels are gone (the plain versions run on every device),
and ``lower`` computes the pyramid in the precision below the
configuration's float32 (every blurred level rounded to bfloat16), which is
the control of the benchmark's comparison.

    detect_describe(images, config, lower=False) -> Features (B, max_features)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .config import NUM_ORI_BINS, SIFT_VECTOR_SIZE, SiftConfig
from .features import Features, concat_features, take_slots, topk_desc_stable, topk_features
from .ops.descriptor import _descriptor_core, finish_descriptors, static_radius_for_level
from .ops.filters import convolve_separable, downsample_by_2
from .ops.gradients import dog_stack
from .ops.keypoints import detect_keypoints
from .ops.orientation import _histograms_core, finish_orientations, octave_coords
from .ops.patches import gather_windows
from .ops.pyramid import OctaveData, build_pyramid, gaussian_kernels, gradients_for_octave

_PLAIN_CHUNK = {"k2": 4096, "k3": 512}


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def build_pyramid_bf16(image: torch.Tensor, config: SiftConfig):
    """``ops.pyramid.build_pyramid`` with the input and every blurred level
    rounded to bfloat16: the control's front end."""
    base_kernel, level_kernels = gaussian_kernels(config)
    octaves = []
    current = round_bf16(image.to(torch.float32))
    for o in range(config.num_octaves):
        if o == 0:
            current = round_bf16(convolve_separable(current, base_kernel))
        levels = [current]
        for l in range(config.num_gauss_levels - 1):
            current = round_bf16(convolve_separable(current, level_kernels[l]))
            levels.append(current)
        gauss = torch.stack(levels, dim=-3)
        octaves.append(OctaveData(gauss=gauss, dog=dog_stack(gauss),
                                  grad=gradients_for_octave(gauss, config)))
        current = downsample_by_2(gauss[..., config.num_dog_levels, :, :])
    return octaves


class GradPlanes(NamedTuple):
    mag: torch.Tensor
    ang: torch.Tensor
    radius: int
    num_images: int
    num_octaves: int
    num_levels: int


def build_grad_planes(octaves, config: SiftConfig) -> GradPlanes:
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


def window_params(planes: GradPlanes, x, y, sigma, octave, level, image):
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


def _chunked(fn, m: int, step: int, device, width: int):
    if m == 0:
        return torch.zeros((0, width), dtype=torch.float32, device=device)
    return torch.cat([fn(slice(s, s + step)) for s in range(0, m, step)])


def orientation_hists(planes: GradPlanes, x, y, sigma, octave, level, valid,
                      config: SiftConfig, image):
    r_o = config.max_orientation_radius
    xo, yo, so, xi, yi, slab = window_params(planes, x, y, sigma, octave, level, image)
    off = planes.radius - r_o

    def part(sl):
        r0, c0 = yi[sl] + off, xi[sl] + off
        mag = gather_windows(planes.mag, slab[sl], r0, c0, 2 * r_o + 1)
        ang = gather_windows(planes.ang, slab[sl], r0, c0, 2 * r_o + 1)
        return _histograms_core(mag, ang, xo[sl], yo[sl], xi[sl], yi[sl],
                                so[sl], valid[sl], r_o, config)

    return _chunked(part, x.shape[0], _PLAIN_CHUNK["k2"], x.device, NUM_ORI_BINS)


def descriptors(planes: GradPlanes, x, y, sigma, octave, level, angle0, valid,
                config: SiftConfig, image):
    radius = planes.radius
    xo, yo, so, xi, yi, slab = window_params(planes, x, y, sigma, octave, level, image)

    def part(sl):
        mag = gather_windows(planes.mag, slab[sl], yi[sl], xi[sl], 2 * radius + 1)
        ang = gather_windows(planes.ang, slab[sl], yi[sl], xi[sl], 2 * radius + 1)
        return _descriptor_core(mag, ang, xo[sl], yo[sl], xi[sl], yi[sl],
                                so[sl], angle0[sl], valid[sl], radius, config)

    return _chunked(part, x.shape[0], _PLAIN_CHUNK["k3"], x.device, SIFT_VECTOR_SIZE)


def merge_keypoints(kp_list, config: SiftConfig):
    lead = kp_list[0].x.shape[:-2]

    def cat(get):
        return torch.cat([get(kp, o).reshape(lead + (-1,))
                          for o, kp in enumerate(kp_list)], dim=-1)

    x = cat(lambda kp, o: kp.x)
    y = cat(lambda kp, o: kp.y)
    sigma = cat(lambda kp, o: kp.sigma)
    resp = cat(lambda kp, o: kp.response)
    valid = cat(lambda kp, o: kp.valid)
    level = cat(lambda kp, o: kp.level)
    octave = cat(lambda kp, o: torch.full(kp.x.shape, o, dtype=torch.int32,
                                          device=kp.x.device))
    m = config.max_features
    scores = torch.where(valid, resp, torch.full_like(resp, float("-inf")))
    if scores.shape[-1] < m:
        pad = m - scores.shape[-1]
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
        x, y, sigma, resp, level, octave = (
            torch.nn.functional.pad(a, (0, pad))
            for a in (x, y, sigma, resp, level, octave)
        )
    top_scores, idx = topk_desc_stable(scores, m)
    sel_valid = torch.isfinite(top_scores)
    return dict(
        x=take_slots(x, idx), y=take_slots(y, idx), sigma=take_slots(sigma, idx),
        response=torch.where(sel_valid, top_scores, torch.zeros_like(top_scores)),
        level=take_slots(level, idx), octave=take_slots(octave, idx), valid=sel_valid,
    )


class K3Work(NamedTuple):
    """What K3 is handed for one batch: the planes and each slot's inputs."""

    planes: GradPlanes
    kp: tuple          # (x, y, sigma, octave, level), each (B * M,)
    image: torch.Tensor
    angle0: torch.Tensor
    valid: torch.Tensor


def detect_describe(images: torch.Tensor, config: SiftConfig, lower: bool = False,
                    k3_work: bool = False):
    """(B, H, W) float32 images -> Features (B, max_features); with
    ``k3_work`` also the ``K3Work`` of the first orientation."""
    images = images.to(torch.float32)
    octaves = build_pyramid_bf16(images, config) if lower else build_pyramid(images, config)
    kp_list = [detect_keypoints(data.dog, o, config) for o, data in enumerate(octaves)]
    mk = merge_keypoints(kp_list, config)
    planes = build_grad_planes(octaves, config)
    del octaves, kp_list
    b, m = mk["x"].shape
    fl = {k: v.reshape(b * m) for k, v in mk.items()}
    image = torch.arange(b, dtype=torch.int32, device=fl["x"].device).repeat_interleave(m)
    kp = (fl["x"], fl["y"], fl["sigma"], fl["octave"], fl["level"])
    hists = orientation_hists(planes, *kp, fl["valid"], config, image)
    angles, avalid = finish_orientations(hists, fl["valid"])

    def unb(a):
        return a.reshape((b, m) + a.shape[1:])

    def block(angle_index: int):
        angle0 = angles[:, angle_index].contiguous()
        bvalid = fl["valid"] & avalid[:, angle_index]
        raw = descriptors(planes, *kp, angle0, bvalid, config, image)
        desc = finish_descriptors(raw, bvalid, config)
        feats = Features(
            x=unb(fl["x"]), y=unb(fl["y"]), sigma=unb(fl["sigma"]),
            angle=unb(torch.where(bvalid, angle0, torch.zeros_like(angle0))),
            response=unb(fl["response"]), octave=unb(fl["octave"]),
            level=unb(fl["level"]), desc=unb(desc), valid=unb(bvalid),
        )
        return feats, K3Work(planes, kp, image, angle0, bvalid)

    out, work = block(0)
    if config.use_second_orientation:
        out = concat_features([out, block(1)[0]])
    out = topk_features(out, config.max_features)
    return (out, work) if k3_work else out
