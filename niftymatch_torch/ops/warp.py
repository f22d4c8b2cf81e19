"""Undistortion, warping and mosaic blending (``ops/warp.py`` of the JAX
package; ``undistort.cu`` and ``resample.cu`` of the reference).

Sampling follows the reference's CUDA texture reads: bilinear, zero
outside the image, and pixel-centre coordinates (x = 0 is the centre of
pixel 0, so ``bilinear_sample(img, x, y) == tex2D(img, x + 0.5, y + 0.5)``).
Images are (H, W) or (H, W, C); each function computes on its inputs'
device.
"""

from __future__ import annotations

import torch

from ..geometry.linalg import inv3x3


def undistort_map(camera_matrix: torch.Tensor, distortion: torch.Tensor,
                  height: int, width: int):
    """Radial correction maps (u, v), each (H, W) float32
    (``undistort.cu:6-47``): pixel coordinates normalised by (fx, fy, cx,
    cy), scaled by ``1 + k1 r^2 + k2 r^4 + k3 r^6`` and projected back.
    ``camera_matrix`` packs (fx, fy, cx, cy), ``distortion`` (k1, k2, k3)."""
    fx, fy, cx, cy = (camera_matrix[i] for i in range(4))
    k1, k2, k3 = (distortion[i] for i in range(3))
    kw = dict(dtype=torch.float32, device=camera_matrix.device)
    y = torch.arange(height, **kw)[:, None]
    x = torch.arange(width, **kw)[None, :]
    u = ((x - cx) / fx).expand(height, width)
    v = ((y - cy) / fy).expand(height, width)
    r2 = u * u + v * v
    kr = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    return u * kr * fx + cx, v * kr * fy + cy


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear gather at pixel-centre coordinates, zero outside the image
    (``cudatex2D.cu:15-19``); x and y share the output's shape."""
    h, w = img.shape[0], img.shape[1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    # A corner index at -2 or beyond the far edge is outside either way.
    x0i = torch.clamp(x0, -2, w).long()
    y0i = torch.clamp(y0, -2, h).long()

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        val = img[torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1)]
        if img.dim() == 3:
            inside = inside[..., None]
        return torch.where(inside, val, torch.zeros_like(val))

    v00, v01 = tap(y0i, x0i), tap(y0i, x0i + 1)
    v10, v11 = tap(y0i + 1, x0i), tap(y0i + 1, x0i + 1)
    if img.dim() == 3:
        fx, fy = fx[..., None], fy[..., None]
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy


def remap(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """``img`` sampled at per-pixel coordinates (``resample.cu:83-112``)."""
    return bilinear_sample(img, map_x, map_y)


def perspective_coords(H: torch.Tensor, height: int, width: int,
                       inverse: bool = False):
    """Source coordinates of each output pixel under a 3x3 transform
    (``resample.cu:115-191``); ``inverse=True`` applies H's inverse (use
    when H maps source -> output)."""
    Hm = inv3x3(H) if inverse else H
    kw = dict(dtype=torch.float32, device=H.device)
    y = torch.arange(height, **kw)[:, None]
    x = torch.arange(width, **kw)[None, :]
    xp = Hm[0, 0] * x + Hm[0, 1] * y + Hm[0, 2]
    yp = Hm[1, 0] * x + Hm[1, 1] * y + Hm[1, 2]
    wp = Hm[2, 0] * x + Hm[2, 1] * y + Hm[2, 2]
    wp = torch.where(torch.abs(wp) > 1e-12, wp, torch.full_like(wp, 1e-12))
    return xp / wp, yp / wp


def warp_perspective(img: torch.Tensor, H: torch.Tensor,
                     out_shape: tuple[int, int] | None = None,
                     inverse: bool = False) -> torch.Tensor:
    """``img`` warped by a homography into ``out_shape`` (height, width),
    the input's shape by default (``resample.cu:193-208``)."""
    oh, ow = out_shape if out_shape is not None else img.shape[:2]
    mx, my = perspective_coords(H, oh, ow, inverse=inverse)
    return bilinear_sample(img, mx, my)


def warp_mask(mask: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor,
              lower_limit: float = 0.5) -> torch.Tensor:
    """A {0, 1} float mask resampled and binarised at ``lower_limit``
    (``resample.cu:68-81``)."""
    res = bilinear_sample(mask, map_x, map_y)
    return (res > lower_limit).to(torch.float32)


def blend_into_mosaic(canvas: torch.Tensor, canvas_weights: torch.Tensor,
                      frame: torch.Tensor, frame_weights: torch.Tensor,
                      H: torch.Tensor, frame_mask: torch.Tensor | None = None):
    """``frame`` warped into ``canvas`` as a per-pixel weighted running
    average (``resample.cu:7-66``).  H maps canvas pixels to frame
    coordinates; canvas pixels whose sampled ``frame_mask`` is <= 0.5 are
    left alone.  Returns the new canvas and weights."""
    hc, wc = canvas.shape[0], canvas.shape[1]
    mx, my = perspective_coords(H, hc, wc)
    hf, wf = frame.shape[0], frame.shape[1]
    in_bounds = (mx > -1.0) & (mx < wf) & (my > -1.0) & (my < hf)

    sampled = bilinear_sample(frame, mx, my)
    new_w = bilinear_sample(frame_weights, mx, my)
    if frame_mask is not None:
        in_bounds = in_bounds & (bilinear_sample(frame_mask, mx, my) > 0.5)
    valid = in_bounds & (new_w > 0.0)

    w_old = canvas_weights
    w_new = torch.where(valid, new_w, torch.zeros_like(new_w))
    total = w_old + w_new
    safe_total = torch.clamp(total, min=1e-12)
    keep = total > 0.0
    if canvas.dim() == 3:
        w_old, w_new = w_old[..., None], w_new[..., None]
        safe_total, keep = safe_total[..., None], keep[..., None]
    blend = (canvas * w_old + sampled * w_new) / safe_total
    return torch.where(keep, blend, canvas), total
