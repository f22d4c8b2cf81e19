"""Every input of the benchmark, made from a seed.

* ``blob_scene`` is ``bench.py::make_scene`` as ``chip_smoke.py`` renders it
  on the card (frozen at commit def8df72c5c264abd9e3aa10eba50d4d66e57296):
  120 Gaussian blobs drawn with numpy, summed on the device.
* ``make_scene`` is a frozen copy of ``niftymatch_torch/data/synthetic.py``'s
  ``make_scene`` (same commit): landmarks in a box, cameras on an orbit.
* ``render_frames`` renders what that file's ``render_frames`` renders (the
  same numpy draws in the same order: constellations of Gaussian sub-blobs
  on a flat 128 backdrop), but on the device and in one product per frame
  batch: a sub-blob's window is separable, ``exp(-(dx^2 + dy^2) / 2s^2) =
  gx(x) gy(y)`` on its clipped square, so a frame is ``Gy^T diag(a) Gx``
  over its sub-blobs.  It agrees with the numpy loop to float32 rounding
  and takes milliseconds where the loop takes seconds a frame.

Seeds are any whole numbers; numpy streams are keyed by the seed and a
fixed tag, so two inputs of one run never share a stream.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def rng(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator for ``seed`` (any integer) and a stream tag."""
    return np.random.default_rng([int(seed) & _MASK64, *tags])


def blob_scene(h: int, w: int, gen: np.random.Generator, n_blobs: int, device) -> torch.Tensor:
    """(h + 16, w + 16) float32 blob scene on ``device``."""
    params = []
    for _ in range(n_blobs):
        by, bx = gen.uniform(10, h), gen.uniform(10, w)
        bs = gen.uniform(2, 7)
        amp = gen.uniform(60, 255) * gen.choice([-1.0, 1.0])
        params.append((by, bx, bs, amp))
    p = torch.tensor(params, dtype=torch.float32).to(device)
    yy = torch.arange(h + 16, dtype=torch.float32, device=device).view(1, -1, 1)
    xx = torch.arange(w + 16, dtype=torch.float32, device=device).view(1, 1, -1)
    by, bx, bs, amp = (p[:, i].view(-1, 1, 1) for i in range(4))
    blobs = amp * torch.exp(-((yy - by) ** 2 + (xx - bx) ** 2) / (2 * bs**2))
    return blobs.sum(0) + 128.0


def shifted_pairs(h: int, w: int, gen: np.random.Generator, pairs: int, n_blobs: int,
                  shift: int, device) -> torch.Tensor:
    """(2 * pairs, h, w): ``pairs`` scenes, then the same scenes shifted by
    ``shift`` px down and right."""
    scenes = [blob_scene(h, w, gen, n_blobs, device) for _ in range(pairs)]
    a = torch.stack([s[:h, :w] for s in scenes])
    b = torch.stack([s[shift:h + shift, shift:w + shift] for s in scenes])
    return torch.cat([a, b]).contiguous()


class SyntheticScene(NamedTuple):
    poses: np.ndarray        # (C, 3, 4) world->cam ground truth
    landmarks: np.ndarray    # (L, 3)
    intrinsics: np.ndarray   # (4,) fx, fy, cx, cy
    width: int
    height: int


def _look_at(eye: np.ndarray, target: np.ndarray, up=np.array([0.0, -1.0, 0.0])):
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0)
    t = -R @ eye
    return np.concatenate([R, t[:, None]], axis=1).astype(np.float32)


def make_scene(gen: np.random.Generator, num_cams: int, num_landmarks: int,
               radius: float = 6.0, width: int = 640, height: int = 480,
               arc: tuple = (-0.5, 0.5), helix: float = 0.05) -> SyntheticScene:
    landmarks = gen.uniform(-2.0, 2.0, size=(num_landmarks, 3)).astype(np.float32)
    angles = np.linspace(arc[0], arc[1], num_cams)
    poses = []
    for i, a in enumerate(angles):
        eye = np.array([radius * np.sin(a), 0.4 * np.sin(2.2 * a + 0.3) + helix * i,
                        -radius * np.cos(a)])
        jitter = gen.normal(0, 0.02, 3)
        poses.append(_look_at(eye + jitter, np.zeros(3)))
    fx = fy = 525.0
    return SyntheticScene(poses=np.stack(poses), landmarks=landmarks,
                          intrinsics=np.array([fx, fy, width / 2.0, height / 2.0], np.float32),
                          width=width, height=height)


def closed_loop_arc(n_frames: int) -> tuple:
    """The golden closed loop's orbit: one turn, last camera beside the first."""
    return (0.0, 2.0 * np.pi * (n_frames - 1) / n_frames)


def render_frames(scene: SyntheticScene, gen: np.random.Generator, device,
                  size_range: tuple = (0.015, 0.2), batch: int = 16) -> torch.Tensor:
    """(C, H, W) float32 frames on ``device``."""
    C, L = scene.poses.shape[0], scene.landmarks.shape[0]
    fx, fy, cx, cy = (float(v) for v in scene.intrinsics)
    h, w = scene.height, scene.width
    n_sub = 5
    sizes = np.exp(gen.uniform(np.log(size_range[0]), np.log(size_range[1]), L))
    offsets = gen.normal(0, 1.0, (L, n_sub, 3)) * (2.0 * sizes[:, None, None])
    offsets[:, 0] = 0.0
    amps = gen.uniform(40, 120, (L, n_sub)) * gen.choice([-1.0, 1.0], (L, n_sub))
    amps[:, 0] = gen.uniform(150, 255, L) * gen.choice([-1.0, 1.0], L)
    rel_size = gen.uniform(0.4, 0.8, (L, n_sub))
    rel_size[:, 0] = 1.0

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    pts = dev(scene.landmarks[:, None, :] + offsets).reshape(1, L * n_sub, 3)
    amp = dev(amps).reshape(1, -1)
    world_size = dev(sizes[:, None] * rel_size).reshape(1, -1)
    poses = dev(scene.poses)
    ys = torch.arange(h, dtype=torch.float32, device=device).view(1, 1, -1)
    xs = torch.arange(w, dtype=torch.float32, device=device).view(1, 1, -1)
    out = []
    for c0 in range(0, C, batch):
        T = poses[c0:c0 + batch]
        p = pts @ T[:, :, :3].transpose(1, 2) + T[:, None, :, 3]
        z = p[..., 2]
        zc = torch.clamp(z, min=1e-9)
        u = fx * (p[..., 0] / zc) + cx
        v = fy * (p[..., 1] / zc) + cy
        vis = (z > 0.5) & (u > -20) & (u < w + 20) & (v > -20) & (v < h + 20)
        sig = torch.clamp(fx * world_size / zc, min=0.8)
        r = torch.floor(torch.clamp(4.0 * sig, max=40.0))

        def profile(coord, grid, n):
            lo = torch.floor(torch.clamp(coord - r, min=0.0))
            hi = torch.trunc(torch.clamp(coord + r + 1.0, max=float(n)))
            d = grid - coord[..., None]
            inside = (grid >= lo[..., None]) & (grid < hi[..., None]) & vis[..., None]
            g = torch.exp(-(d * d) / (2.0 * sig[..., None] ** 2))
            return torch.where(inside, g, torch.zeros_like(g))

        gy = profile(v, ys, h) * amp[..., None]          # (b, S, h)
        gx = profile(u, xs, w)                           # (b, S, w)
        out.append(128.0 + gy.transpose(1, 2) @ gx)
    return torch.cat(out)
