"""EuRoC MAV dataset IO (BASELINE config 4: keyframe SLAM on EuRoC MH_01),
the port's copy of ``data/euroc.py`` of the JAX package.

Standard ASL layout:

    <root>/mav0/cam0/data.csv            timestamp [ns], filename
    <root>/mav0/cam0/data/*.png          grayscale frames
    <root>/mav0/cam0/sensor.yaml         intrinsics (parsed line-wise; no
                                         yaml dependency)
    <root>/mav0/state_groundtruth_estimate0/data.csv
        timestamp, p_RS_R_{x,y,z}, q_RS_{w,x,y,z}, ...

Timestamps are converted to seconds.  Ground truth is returned as a
``tum.Trajectory`` so the same ATE tooling applies.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from .tum import Trajectory

# EuRoC cam0 factory calibration (MH/V sequences) — used when sensor.yaml
# is absent or unparsable.
DEFAULT_INTRINSICS = (458.654, 457.296, 367.215, 248.375)
DEFAULT_DISTORTION = (-0.28340811, 0.07395907, 0.00019359)


class EurocSequence(NamedTuple):
    cam_times: np.ndarray    # (N,) seconds
    cam_paths: list          # N png paths
    groundtruth: Trajectory  # positions in the RS (body) frame
    intrinsics: tuple        # (fx, fy, cx, cy)
    distortion: tuple        # (k1, k2, p1/k3...) radial-tangential leading 3


def _read_csv(path: str, min_cols: int):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = line.split(",")
            if len(vals) >= min_cols:
                rows.append(vals)
    return rows


def _parse_sensor_yaml(path: str):
    """Line-wise parse of cam0 sensor.yaml for ``intrinsics: [fx, fy, cx, cy]``
    and ``distortion_coefficients: [...]`` (no yaml dependency)."""
    intr, dist = None, None
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                for key in ("intrinsics:", "distortion_coefficients:"):
                    if line.startswith(key) and "[" in line:
                        vals = line.split("[", 1)[1].split("]", 1)[0]
                        nums = tuple(
                            float(v) for v in vals.split(",") if v.strip()
                        )
                        if key == "intrinsics:":
                            intr = nums[:4]
                        else:
                            dist = nums[:3]
    except OSError:
        pass
    return intr, dist


def load_sequence(root: str, cam: str = "cam0") -> EurocSequence:
    """Load an EuRoC sequence directory (``<root>/mav0/...``)."""
    mav = os.path.join(root, "mav0")
    cam_dir = os.path.join(mav, cam)
    rows = _read_csv(os.path.join(cam_dir, "data.csv"), 2)
    times = np.asarray([float(r[0]) * 1e-9 for r in rows])
    paths = [os.path.join(cam_dir, "data", r[1].strip()) for r in rows]

    gt_rows = _read_csv(
        os.path.join(mav, "state_groundtruth_estimate0", "data.csv"), 8
    )
    gt_t = np.asarray([float(r[0]) * 1e-9 for r in gt_rows])
    gt_p = np.asarray([[float(r[1]), float(r[2]), float(r[3])] for r in gt_rows])
    # EuRoC stores q as (w, x, y, z); Trajectory uses (x, y, z, w).
    gt_q = np.asarray(
        [[float(r[5]), float(r[6]), float(r[7]), float(r[4])] for r in gt_rows]
    )

    intr, dist = _parse_sensor_yaml(os.path.join(cam_dir, "sensor.yaml"))
    return EurocSequence(
        cam_times=times,
        cam_paths=paths,
        groundtruth=Trajectory(
            timestamps=gt_t, positions=gt_p, quaternions=gt_q
        ),
        intrinsics=intr or DEFAULT_INTRINSICS,
        distortion=dist or DEFAULT_DISTORTION,
    )
