"""End-to-end SIFT pipeline (``sift.py`` of the JAX package).

    detect_and_describe(image, config) -> Features
    detect_and_describe_batch(images, config) -> Features with a batch axis
    detect_and_describe_per_octave(image, config) -> Features (the oracle)
    match_pair(feats_a, feats_b) -> MatchResult

One code path serves one image and a batch: a batch of B images is one
(B, H, W) tensor through the pyramid and detection, and one launch each of
the orientation kernel K2 and the descriptor kernel K3 for all B * M
keypoint slots, as the JAX package's batched TPU path does
(``sift.py:241-286``).  A single image is a batch of one.  Matching goes
through the fused kernel K1, one launch for a whole batch of pairs.

Every entry point takes ``device`` and runs on CUDA when it is not given;
without CUDA it raises.  On ``device="cpu"`` the kernels' plain PyTorch
versions run instead, which is what the tests compare with the JAX package.
"""

from __future__ import annotations

import torch

from .config import PipelineConfig, SiftConfig
from .features import Features, concat_features, take_slots, topk_desc_stable, topk_features
from .kernels.match import match_descriptors_fused
from .kernels.windows import (
    build_grad_planes,
    compute_descriptors_merged_kernel,
    compute_orientations_merged_kernel,
)
from .ops.descriptor import compute_descriptors
from .ops.keypoints import detect_keypoints
from .ops.match import MatchResult
from .ops.orientation import compute_orientations
from .ops.pyramid import build_pyramid
from .utils.precision import resolve_device


def _merge_keypoints(kp_list, config: SiftConfig):
    """Global top-``max_features`` keypoints over all octaves by |response|,
    lower slot first among ties.  Each octave's (..., L, K) keypoints are
    flattened into one pool; returns a dict of (..., M) tensors."""
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
        x=take_slots(x, idx),
        y=take_slots(y, idx),
        sigma=take_slots(sigma, idx),
        response=torch.where(sel_valid, top_scores, torch.zeros_like(top_scores)),
        level=take_slots(level, idx),
        octave=take_slots(octave, idx),
        valid=sel_valid,
    )


def keypoints_and_planes(images: torch.Tensor, config: SiftConfig,
                         masks: torch.Tensor | None = None):
    """Front end of a (B, H, W) batch: pyramid, detection and the global
    merge.  Returns the merged keypoints (a dict of (B, M) tensors) and the
    gradient planes that K2 and K3 read."""
    octaves = build_pyramid(images, config)
    kp_list = [detect_keypoints(data.dog, o, config, mask_image=masks)
               for o, data in enumerate(octaves)]
    return _merge_keypoints(kp_list, config), build_grad_planes(octaves, config)


def describe_keypoints(mk: dict, planes, config: SiftConfig) -> Features:
    """Orientations (K2) and descriptors (K3) of every image's merged
    keypoints, one launch each for the whole batch, then the global top-k:
    Features of shape (B, max_features)."""
    b, m = mk["x"].shape
    fl = {k: v.reshape(b * m) for k, v in mk.items()}
    image = torch.arange(b, dtype=torch.int32, device=fl["x"].device)
    image = image.repeat_interleave(m)
    kp = (fl["x"], fl["y"], fl["sigma"], fl["octave"], fl["level"])
    angles, avalid = compute_orientations_merged_kernel(
        planes, *kp, fl["valid"], config, image=image)

    def unb(a):
        return a.reshape((b, m) + a.shape[1:])

    def block(angle_index: int) -> Features:
        angle0 = angles[:, angle_index].contiguous()
        bvalid = fl["valid"] & avalid[:, angle_index]
        desc, dvalid = compute_descriptors_merged_kernel(
            planes, *kp, angle0, bvalid, config, image=image)
        return Features(
            x=unb(fl["x"]), y=unb(fl["y"]), sigma=unb(fl["sigma"]),
            angle=unb(torch.where(bvalid, angle0, torch.zeros_like(angle0))),
            response=unb(fl["response"]), octave=unb(fl["octave"]),
            level=unb(fl["level"]), desc=unb(desc), valid=unb(dvalid),
        )

    out = block(0)
    if config.use_second_orientation:
        out = concat_features([out, block(1)])
    return topk_features(out, config.max_features)


def _detect_describe(images: torch.Tensor, config: SiftConfig,
                     masks: torch.Tensor | None = None) -> Features:
    """(B, H, W) images -> Features of shape (B, max_features)."""
    mk, planes = keypoints_and_planes(images, config, masks)
    return describe_keypoints(mk, planes, config)


def _as_images(images, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(images, dtype=torch.float32, device=device)


def detect_and_describe(image, config: SiftConfig, mask=None,
                        device=None) -> Features:
    """Full SIFT on a grayscale (H, W) image.  ``mask`` (H, W) keeps
    keypoints whose input-image position has mask >= 1
    (``siftfunctions.cu:65-98``)."""
    dev = resolve_device(device)
    masks = None if mask is None else _as_images(mask, dev)[None]
    f = _detect_describe(_as_images(image, dev)[None], config, masks)
    return Features(*[a[0] for a in f])


def detect_and_describe_batch(images, config: SiftConfig,
                              device=None) -> Features:
    """(B, H, W) -> Features with a leading batch axis on every field."""
    dev = resolve_device(device)
    return _detect_describe(_as_images(images, dev), config)


def _octave_features(octave_idx: int, octave_data, config: SiftConfig,
                     mask_image=None) -> Features:
    """Every capacity slot of one octave through detection, orientations and
    descriptors: Features of shape (L * K,), or (2 L K,) with the second
    orientation."""
    kpts = detect_keypoints(octave_data.dog, octave_idx, config, mask_image=mask_image)
    angles, avalid = compute_orientations(kpts, octave_data.grad, octave_idx, config)
    n = kpts.x.numel()

    def block(angle_index: int) -> Features:
        desc, dvalid = compute_descriptors(kpts, angles, avalid, octave_data.grad,
                                           octave_idx, config, angle_index)
        angle = torch.where(avalid[..., angle_index], angles[..., angle_index],
                            torch.zeros_like(angles[..., angle_index]))
        return Features(
            x=kpts.x.reshape(n), y=kpts.y.reshape(n), sigma=kpts.sigma.reshape(n),
            angle=angle.reshape(n), response=kpts.response.reshape(n),
            octave=torch.full((n,), octave_idx, dtype=torch.int32, device=kpts.x.device),
            level=kpts.level.reshape(n), desc=desc.reshape(n, -1),
            valid=dvalid.reshape(n),
        )

    out = block(0)
    if config.use_second_orientation:
        out = concat_features([out, block(1)])
    return out


def detect_and_describe_per_octave(image, config: SiftConfig, mask=None,
                                   device=None) -> Features:
    """The reference-shaped per-octave pipeline, the oracle of the merged
    path: orientations and descriptors for every capacity slot of every
    octave in plain PyTorch, then one global top-k.  It differs from
    ``detect_and_describe`` only where a selected keypoint has no
    orientation peak (the merged path then leaves its slot empty)."""
    dev = resolve_device(device)
    masks = None if mask is None else _as_images(mask, dev)
    octaves = build_pyramid(_as_images(image, dev), config)
    parts = [_octave_features(o, data, config, masks)
             for o, data in enumerate(octaves)]
    return topk_features(concat_features(parts), config.max_features)


def match_pair(feats_a: Features, feats_b: Features, ambiguity: float = 0.8,
               precision: str = "fp32", device=None) -> MatchResult:
    """Ratio-test matches of A's features against B's
    (``compute_sift_matches``); a leading batch axis matches many pairs in
    one launch."""
    dev = resolve_device(device)
    return match_descriptors_fused(
        feats_a.desc.to(dev), feats_b.desc.to(dev), ambiguity=ambiguity,
        a_valid=feats_a.valid.to(dev), b_valid=feats_b.valid.to(dev),
        precision=precision,
    )


def make_detector(config: SiftConfig, masked: bool = False, device=None):
    """``image -> Features`` for a fixed image size, or
    ``(image, mask) -> Features`` with ``masked=True``."""
    dev = resolve_device(device)
    if masked:
        return lambda image, mask: detect_and_describe(image, config, mask, dev)
    return lambda image: detect_and_describe(image, config, device=dev)


def make_batch_detector(config: SiftConfig, device=None):
    """``(B, H, W) -> Features`` with a leading batch axis."""
    dev = resolve_device(device)
    return lambda images: detect_and_describe_batch(images, config, dev)


def make_pair_pipeline(config: PipelineConfig, device=None):
    """``(img_a, img_b) -> (Features, Features, MatchResult)``: the flagship
    detect + match step.  Both images go through detection as one batch
    of two."""
    dev = resolve_device(device)

    def run(img_a, img_b):
        imgs = torch.stack([_as_images(img_a, dev), _as_images(img_b, dev)])
        f = _detect_describe(imgs, config.sift)
        fa = Features(*[t[0] for t in f])
        fb = Features(*[t[1] for t in f])
        m = match_pair(fa, fb, config.match.ambiguity, config.match.precision,
                       dev)
        return fa, fb, m

    return run
