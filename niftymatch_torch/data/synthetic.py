"""Synthetic multi-view scenes with exact ground truth.

Ground-truth generator for BA / pose-graph / SLAM tests and benchmarks:
random landmarks in a box, a smooth camera orbit, pinhole projection with
optional noise and outliers, packed into the fixed-capacity observation
tables ``sfm.ba.BAProblem`` consumes.

A numpy copy of the JAX package's ``data/synthetic.py``: the same
``default_rng`` streams drawn in the same order, so the same seeds give
bit-identical arrays.  Only ``make_feature_sequence`` differs: it returns
the port's ``Features`` on a ``device``."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SyntheticScene(NamedTuple):
    poses: np.ndarray        # (C, 3, 4) world->cam ground truth
    landmarks: np.ndarray    # (L, 3)
    intrinsics: np.ndarray   # (4,) fx, fy, cx, cy
    width: int
    height: int


def _look_at(eye: np.ndarray, target: np.ndarray, up=np.array([0.0, -1.0, 0.0])):
    """World->camera Rt looking from eye toward target (z forward)."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0)
    t = -R @ eye
    return np.concatenate([R, t[:, None]], axis=1).astype(np.float32)


def make_scene(
    num_cams: int = 8,
    num_landmarks: int = 256,
    seed: int = 0,
    radius: float = 6.0,
    width: int = 640,
    height: int = 480,
    arc: tuple = (-0.5, 0.5),
    helix: float = 0.05,
) -> SyntheticScene:
    """Cameras on an orbit segment around a landmark cloud at the origin.

    ``arc=(0, 2*pi*(K-1)/K)`` with ``helix=0`` gives a closed loop
    (first/last cameras adjacent) for loop-closure tests; the default
    ``helix`` adds a per-frame vertical rise so short arcs are not
    coplanar."""
    rng = np.random.default_rng(seed)
    landmarks = rng.uniform(-2.0, 2.0, size=(num_landmarks, 3)).astype(np.float32)
    angles = np.linspace(arc[0], arc[1], num_cams)
    poses = []
    for i, a in enumerate(angles):
        eye = np.array(
            [
                radius * np.sin(a),
                0.4 * np.sin(2.2 * a + 0.3) + helix * i,
                -radius * np.cos(a),
            ]
        )
        jitter = rng.normal(0, 0.02, 3)
        poses.append(_look_at(eye + jitter, np.zeros(3)))
    fx = fy = 525.0
    cx, cy = width / 2.0, height / 2.0
    return SyntheticScene(
        poses=np.stack(poses),
        landmarks=landmarks,
        intrinsics=np.array([fx, fy, cx, cy], np.float32),
        width=width,
        height=height,
    )


def make_observation_table(
    scene: SyntheticScene,
    seed: int = 0,
    noise_px: float = 0.5,
    outlier_frac: float = 0.0,
    max_obs: int | None = None,
    max_obs_per_cam: int | None = None,
):
    """Project all landmarks into all cameras; keep in-frame observations.

    ``max_obs_per_cam`` subsamples each camera's visible set (deterministic
    per seed) — the knob that shapes config-5-scale problems (millions of
    observations) without the full C x L cross product.

    Returns (obs_uv (O, 2) f32, obs_cam (O,) i32, obs_lm (O,) i32,
    obs_valid (O,) bool) padded to ``max_obs`` (default: exact count)."""
    rng = np.random.default_rng(seed + 1)
    C = scene.poses.shape[0]
    fx, fy, cx, cy = scene.intrinsics
    us, vs, cs, ls = [], [], [], []
    for c in range(C):
        T = scene.poses[c]
        p = scene.landmarks @ T[:, :3].T + T[:, 3]
        z = p[:, 2]
        u = fx * p[:, 0] / np.maximum(z, 1e-9) + cx
        v = fy * p[:, 1] / np.maximum(z, 1e-9) + cy
        ok = (z > 0.1) & (u >= 0) & (u < scene.width) & (v >= 0) & (v < scene.height)
        idx = np.nonzero(ok)[0]
        if max_obs_per_cam is not None and len(idx) > max_obs_per_cam:
            idx = np.sort(rng.choice(idx, max_obs_per_cam, replace=False))
        us.append(u[idx])
        vs.append(v[idx])
        cs.append(np.full(len(idx), c, np.int32))
        ls.append(idx.astype(np.int32))
    obs_uv = np.stack(
        [np.concatenate(us), np.concatenate(vs)], axis=-1
    ).astype(np.float32)
    obs_cam = np.concatenate(cs)
    obs_lm = np.concatenate(ls)
    O = obs_uv.shape[0]
    obs_uv = obs_uv + rng.normal(0, noise_px, size=obs_uv.shape).astype(np.float32)
    if outlier_frac > 0:
        n_out = int(O * outlier_frac)
        idx = rng.choice(O, n_out, replace=False)
        obs_uv[idx] = rng.uniform(
            [0, 0], [scene.width, scene.height], size=(n_out, 2)
        ).astype(np.float32)
    valid = np.ones(O, bool)
    if max_obs is not None:
        assert max_obs >= O, f"max_obs {max_obs} < O {O}"
        pad = max_obs - O
        obs_uv = np.pad(obs_uv, ((0, pad), (0, 0)))
        obs_cam = np.pad(obs_cam, (0, pad))
        obs_lm = np.pad(obs_lm, (0, pad))
        valid = np.pad(valid, (0, pad))
    return obs_uv, obs_cam, obs_lm, valid


def make_feature_sequence(
    scene: SyntheticScene,
    capacity: int = 512,
    noise_px: float = 0.5,
    desc_noise: float = 0.05,
    seed: int = 0,
    desc_dim: int = 128,
    device="cpu",
):
    """Per-camera synthetic ``Features`` with landmark-consistent descriptors.

    Each landmark gets a random unit descriptor; every observation sees it
    plus noise — so descriptor matching recovers ground-truth correspondence
    (with realistic ambiguity), while keypoint positions carry pixel noise.
    This isolates the full SLAM pipeline (matching, E/H-RANSAC, scale
    propagation, BA) from detector/renderer artifacts; the detector has its
    own oracle tests.  The features are the port's, on ``device``."""
    import torch

    from ..features import Features

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, device=device).to(dtype)

    rng = np.random.default_rng(seed + 23)
    L = scene.landmarks.shape[0]
    base_desc = rng.normal(size=(L, desc_dim)).astype(np.float32)
    base_desc /= np.linalg.norm(base_desc, axis=1, keepdims=True)
    fx, fy, cx, cy = scene.intrinsics
    out = []
    for c in range(scene.poses.shape[0]):
        T = scene.poses[c]
        p = scene.landmarks @ T[:, :3].T + T[:, 3]
        z = p[:, 2]
        u = fx * p[:, 0] / np.maximum(z, 1e-9) + cx
        v = fy * p[:, 1] / np.maximum(z, 1e-9) + cy
        ok = (
            (z > 0.3)
            & (u >= 0)
            & (u < scene.width)
            & (v >= 0)
            & (v < scene.height)
        )
        idx = np.nonzero(ok)[0][:capacity]
        n = len(idx)
        x = np.zeros(capacity, np.float32)
        y = np.zeros(capacity, np.float32)
        desc = np.zeros((capacity, desc_dim), np.float32)
        valid = np.zeros(capacity, bool)
        x[:n] = u[idx] + rng.normal(0, noise_px, n)
        y[:n] = v[idx] + rng.normal(0, noise_px, n)
        d = base_desc[idx] + desc_noise * rng.normal(size=(n, desc_dim)).astype(
            np.float32
        )
        desc[:n] = d / np.linalg.norm(d, axis=1, keepdims=True)
        valid[:n] = True
        out.append(
            Features(
                x=t(x),
                y=t(y),
                sigma=t(np.ones(capacity, np.float32)),
                angle=t(np.zeros(capacity, np.float32)),
                response=t(valid),
                octave=t(np.zeros(capacity, np.int32), torch.int32),
                level=t(np.zeros(capacity, np.int32), torch.int32),
                desc=t(desc),
                valid=t(valid, torch.bool),
            )
        )
    return out


def render_frames(
    scene: SyntheticScene,
    seed: int = 0,
    size_range: tuple = (0.015, 0.2),
    distortion: tuple | None = None,
    background: str = "flat",
    background_amp: float = 14.0,
) -> np.ndarray:
    """Render (C, H, W) float32 frames: each landmark is a small 3-D
    constellation of Gaussian sub-blobs (a central peak plus satellites with
    random world-space offsets/amplitudes).  The constellation is rigid in
    3-D, so its projection is view-consistent — SIFT descriptors are stable
    across views yet *distinctive between landmarks* (a single symmetric
    blob would make every descriptor identical and defeat the ratio test).

    ``background="sky"`` replaces the flat 128-gray backdrop with a
    VIEW-CONSISTENT distant texture: a 1/f^2 cloud panorama sampled by
    each pixel's ray direction (an environment map at infinity) — real
    scene texture that moves correctly with camera rotation, so features
    detected on it are legitimate points at infinity rather than the
    geometry-poisoning static pattern a sensor-fixed overlay would be
    (a real-texture substitute made without any external asset)."""
    rng = np.random.default_rng(seed + 11)
    C = scene.poses.shape[0]
    L = scene.landmarks.shape[0]
    fx, fy, cx, cy = scene.intrinsics
    h, w = scene.height, scene.width
    n_sub = 5
    # Log-uniform world radii over >10x: apparent blob scale is f*size/z, and
    # the detector only fires in a limited sigma band — a narrow size range
    # selects a narrow DEPTH SHELL of landmarks (quasi-planar inlier sets
    # that degenerate the essential matrix).  Wide sizes put detectable
    # texture at every depth.
    sizes = np.exp(rng.uniform(np.log(size_range[0]), np.log(size_range[1]), L))
    # Sub-blob world offsets / relative amps (index 0 = dominant center).
    offsets = rng.normal(0, 1.0, (L, n_sub, 3)) * (2.0 * sizes[:, None, None])
    offsets[:, 0] = 0.0
    amps = rng.uniform(40, 120, (L, n_sub)) * rng.choice([-1.0, 1.0], (L, n_sub))
    amps[:, 0] = rng.uniform(150, 255, L) * rng.choice([-1.0, 1.0], L)
    rel_size = rng.uniform(0.4, 0.8, (L, n_sub))
    rel_size[:, 0] = 1.0
    frames = np.full((C, h, w), 128.0, np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    if background == "sky":
        # Environment-map backdrop: pixel ray (world frame) -> equirect
        # (azimuth, elevation) -> bilinear sample of a cloud panorama.
        th, tw = 512, 2048
        pano = _cloud_texture(th, tw, np.random.default_rng(seed + 31))
        xn_g = (xx - cx) / fx
        yn_g = (yy - cy) / fy
        rays_cam = np.stack(
            [xn_g, yn_g, np.ones_like(xn_g)], axis=-1
        )  # (h, w, 3)
        for c in range(C):
            Rc = scene.poses[c][:, :3]
            rays = rays_cam @ Rc  # R^T applied row-wise: cam -> world
            az = np.arctan2(rays[..., 0], rays[..., 2])
            el = np.arctan2(
                rays[..., 1], np.linalg.norm(rays[..., (0, 2)], axis=-1)
            )
            u = (az / (2 * np.pi) + 0.5) * (tw - 1)
            v = (el / np.pi + 0.5) * (th - 1)
            u0 = np.floor(u).astype(np.int64)
            v0 = np.floor(v).astype(np.int64)
            fu, fv = (u - u0).astype(np.float32), (v - v0).astype(np.float32)
            u0 %= tw
            u1 = (u0 + 1) % tw
            v0 = np.clip(v0, 0, th - 1)
            v1 = np.clip(v0 + 1, 0, th - 1)
            s = (
                (1 - fu) * (1 - fv) * pano[v0, u0]
                + fu * (1 - fv) * pano[v0, u1]
                + (1 - fu) * fv * pano[v1, u0]
                + fu * fv * pano[v1, u1]
            )
            frames[c] += background_amp * s
    for c in range(C):
        T = scene.poses[c]
        pts = scene.landmarks[:, None, :] + offsets  # (L, n_sub, 3)
        p = pts @ T[:, :3].T + T[:, 3]
        z = p[..., 2]
        xn = p[..., 0] / np.maximum(z, 1e-9)
        yn = p[..., 1] / np.maximum(z, 1e-9)
        if distortion is not None:
            # Forward OpenCV-convention radial model (k1, k2, k3), the
            # inverse of what ops.warp.undistort_map corrects — so clips
            # rendered with it exercise the undistort + remap path.
            k1, k2, k3 = distortion
            r2 = xn * xn + yn * yn
            f = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            xn, yn = xn * f, yn * f
        u = fx * xn + cx
        v = fy * yn + cy
        vis = (z > 0.5) & (u > -20) & (u < w + 20) & (v > -20) & (v < h + 20)
        img = frames[c]
        for l, s in zip(*np.nonzero(vis)):
            sig = max(fx * sizes[l] * rel_size[l, s] / z[l, s], 0.8)
            r = int(min(4.0 * sig, 40))
            x0, x1 = int(max(u[l, s] - r, 0)), int(min(u[l, s] + r + 1, w))
            y0, y1 = int(max(v[l, s] - r, 0)), int(min(v[l, s] + r + 1, h))
            if x0 >= x1 or y0 >= y1:
                continue
            px = xx[y0:y1, x0:x1] - u[l, s]
            py = yy[y0:y1, x0:x1] - v[l, s]
            img[y0:y1, x0:x1] += amps[l, s] * np.exp(
                -(px * px + py * py) / (2.0 * sig * sig)
            )
    return frames


def _cloud_texture(h: int, w: int, rng, beta: float = 2.2) -> np.ndarray:
    """Unit-variance 1/f^beta ("cloud") texture via spectral shaping —
    the standard procedural stand-in for natural-image texture (natural
    images have ~1/f^2 power spectra)."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f2 = fx * fx + fy * fy
    spec = (
        rng.normal(size=(h, w // 2 + 1)) + 1j * rng.normal(size=(h, w // 2 + 1))
    ) / np.maximum(f2, 1e-6) ** (beta / 2.0)
    spec[0, 0] = 0.0
    tex = np.fft.irfft2(spec, s=(h, w)).astype(np.float32)
    return tex / max(float(tex.std()), 1e-9)


def apply_photometric(
    frames: np.ndarray,
    seed: int = 0,
    texture_amp: float = 2.0,
    vignette: float = 0.25,
    rolling_shutter_px: float = 3.0,
    shot_noise: float = 0.06,
    read_noise: float = 2.0,
) -> np.ndarray:
    """Sensor-realism post-pass over rendered (C, H, W) frames
    (photometric realism made without any external asset).  Models, in camera order:

    * **fixed-pattern noise**: a static low-amplitude 1/f^2 layer
      (sensor FPN / lens dirt at a post-calibration level — default 2
      gray levels).  Static features are geometrically inconsistent
      with egomotion, so the pipeline must reject them via RANSAC
      rather than track them.  SCENE texture belongs in the renderer
      (``render_frames(background="sky")``), not here: a strong static
      overlay poisons geometry in a way no real calibrated sensor does
      (measured: amp 6 doubled pipeline ATE; amp 2 is noise-class);
    * **rolling shutter**: per-row horizontal shear, magnitude
      ``rolling_shutter_px`` at the frame edges, direction varying
      smoothly over the clip (readout-time skew under panning);
    * **vignette**: radial gain falloff, ``1 - vignette`` at the corners;
    * **shot + read noise**: signal-proportional Gaussian shot noise and
      constant read noise per pixel per frame.

    Returns new float32 frames (input is not modified)."""
    frames = np.asarray(frames, np.float32)
    C, h, w = frames.shape
    rng = np.random.default_rng(seed + 77)
    out = frames.copy()

    tex = _cloud_texture(h, w, rng)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = ((xx - w / 2.0) / (w / 2.0)) ** 2 + ((yy - h / 2.0) / (h / 2.0)) ** 2
    gain = 1.0 - vignette * 0.5 * r2  # r2 = 2 at the corners
    row_phase = (np.arange(h, dtype=np.float32) / h) - 0.5
    ph = np.linspace(0.0, 2.0 * np.pi, C)
    cols = np.arange(w)
    for c in range(C):
        img = out[c] + texture_amp * tex
        # Rolling shutter: subpixel per-row shift via linear interpolation.
        shift = rolling_shutter_px * np.sin(ph[c] * 3.0 + 0.5) * row_phase
        i0 = np.floor(shift).astype(np.int64)[:, None]
        frac = (shift - np.floor(shift)).astype(np.float32)[:, None]
        idx0 = np.clip(cols[None, :] - i0, 0, w - 1)
        idx1 = np.clip(idx0 - 1, 0, w - 1)
        rows = np.arange(h)[:, None]
        img = (1.0 - frac) * img[rows, idx0] + frac * img[rows, idx1]
        img = img * gain
        img = img + rng.normal(0.0, 1.0, (h, w)).astype(np.float32) * np.sqrt(
            read_noise**2 + (shot_noise**2) * np.maximum(img, 0.0)
        )
        out[c] = img
    return out
