"""TUM RGB-D dataset IO: trajectory files, associations, image loading
(the port's copy of ``data/tum.py`` of the JAX package, numpy only).

Supports the standard TUM RGB-D layout (``rgb.txt``, ``depth.txt``,
``groundtruth.txt``, ``rgb/*.png``) used by BASELINE configs 2-3.  All
parsing is plain text; PNG decoding uses torch/PIL if available (gated —
this environment may have no image decoder and no dataset; synthetic scenes
cover the tests then)."""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np


class Trajectory(NamedTuple):
    timestamps: np.ndarray  # (N,)
    positions: np.ndarray   # (N, 3) tx ty tz
    quaternions: np.ndarray # (N, 4) qx qy qz qw


def read_trajectory(path: str) -> Trajectory:
    """Parse a TUM trajectory file: ``t tx ty tz qx qy qz qw`` per line."""
    ts, pos, quat = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = line.split()
            if len(vals) < 8:
                continue
            ts.append(float(vals[0]))
            pos.append([float(v) for v in vals[1:4]])
            quat.append([float(v) for v in vals[4:8]])
    return Trajectory(
        timestamps=np.asarray(ts),
        positions=np.asarray(pos),
        quaternions=np.asarray(quat),
    )


def write_trajectory(path: str, traj: Trajectory) -> None:
    """Write a TUM-format trajectory (evo-compatible)."""
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for t, p, q in zip(traj.timestamps, traj.positions, traj.quaternions):
            f.write(
                f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """(3, 3) -> (qx, qy, qz, qw), w >= 0."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        qx, qy, qz, qw = q
    q = np.array([qx, qy, qz, qw])
    if qw < 0:
        q = -q
    return q / np.linalg.norm(q)


def quaternion_to_rotation(q: np.ndarray) -> np.ndarray:
    """(qx, qy, qz, qw) -> (3, 3)."""
    x, y, z, w = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def poses_to_trajectory(
    poses: np.ndarray, timestamps: np.ndarray | None = None
) -> Trajectory:
    """(K, 3, 4) world->cam Rt -> camera-center trajectory with cam->world
    quaternions (the TUM convention stores camera pose in world frame)."""
    K = poses.shape[0]
    if timestamps is None:
        timestamps = np.arange(K, dtype=np.float64)
    # camera center: -R^T t
    centers = -np.einsum("kij,ki->kj", poses[:, :, :3], poses[:, :, 3])
    quats = np.stack(
        [rotation_to_quaternion(poses[k, :, :3].T) for k in range(K)]
    )
    return Trajectory(
        timestamps=np.asarray(timestamps), positions=centers, quaternions=quats
    )


def associate(
    times_a: np.ndarray, times_b: np.ndarray, max_dt: float = 0.02
):
    """Greedy nearest-timestamp association (TUM associate.py behavior).

    Returns (idx_a, idx_b) index arrays of matched rows."""
    ia, ib = [], []
    used = np.zeros(len(times_b), bool)
    for i, t in enumerate(times_a):
        j = int(np.argmin(np.abs(times_b - t)))
        if not used[j] and abs(times_b[j] - t) <= max_dt:
            ia.append(i)
            ib.append(j)
            used[j] = True
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)


def load_grayscale_png(path: str) -> np.ndarray:
    """Load a PNG as float32 grayscale (H, W) in [0, 255].

    Uses PIL if present, else torchvision; raises if neither is available.
    ``native_loader.read_gray`` decodes without either."""
    try:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("L"), np.float32)
        return img
    except ImportError:
        pass
    import torchvision.io as tvio  # may raise ImportError — caller gates

    data = tvio.read_image(path, tvio.ImageReadMode.GRAY)
    return data[0].numpy().astype(np.float32)


class TumSequence(NamedTuple):
    rgb_times: np.ndarray
    rgb_paths: list
    groundtruth: Trajectory


def load_sequence(root: str) -> TumSequence:
    """Load a TUM sequence directory (rgb.txt + groundtruth.txt)."""
    rgb_times, rgb_paths = [], []
    with open(os.path.join(root, "rgb.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, rel = line.split()[:2]
            rgb_times.append(float(t))
            rgb_paths.append(os.path.join(root, rel))
    gt = read_trajectory(os.path.join(root, "groundtruth.txt"))
    return TumSequence(
        rgb_times=np.asarray(rgb_times), rgb_paths=rgb_paths, groundtruth=gt
    )
