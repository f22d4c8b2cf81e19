"""Checkpoint and resume of SLAM map state (``save_slam_state`` /
``load_slam_state`` of the JAX package's ``utils/checkpoint.py``).

The directory layout is the JAX package's, so a checkpoint written by
either package loads into the other: ``meta.json`` (keyframe count, next
track id, image size and intrinsics), ``tracks.npz`` (``positions``,
``alive``) and one ``kf_%05d.npz`` per keyframe (``pose``, ``track_ids``
and ``feat_<field>`` for every ``Features`` field).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..features import Features
from ..slam.keyframe import Keyframe
from .precision import device_constant, host_fetch, state_to


def save_slam_state(path: str, slam) -> None:
    """Checkpoint a ``SlamSystem``: keyframe poses, features and track ids
    and the global track store.  ``path`` is a directory."""
    slam.flush_ba()  # harvest any in-flight window-BA update
    os.makedirs(path, exist_ok=True)
    meta = {
        "num_keyframes": len(slam.keyframes),
        "next_track": slam._next_track,
        "config": {
            "width": slam.config.width,
            "height": slam.config.height,
            "intrinsics": list(slam.config.intrinsics),
        },
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    np.savez(os.path.join(path, "tracks.npz"), positions=slam.track_positions,
             alive=slam.track_alive)
    for kf in slam.keyframes:
        pose, *fields = host_fetch(kf.pose, *kf.feats)
        np.savez(os.path.join(path, f"kf_{kf.index:05d}.npz"), pose=pose,
                 track_ids=kf.track_ids,
                 **{f"feat_{name}": a for name, a in zip(Features._fields, fields)})


def load_slam_state(path: str, slam) -> None:
    """Restore a checkpoint written by :func:`save_slam_state` (of either
    package) into ``slam``, which must be built with a compatible config.
    The keyframes hold their features and, as in the JAX package, no
    store slot."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    tracks = np.load(os.path.join(path, "tracks.npz"))
    slam.track_positions = tracks["positions"]
    slam.track_alive = tracks["alive"]
    slam._next_track = int(meta["next_track"])
    slam.keyframes = []
    for i in range(meta["num_keyframes"]):
        data = np.load(os.path.join(path, f"kf_{i:05d}.npz"))
        feats = state_to(Features(*[data[f"feat_{name}"] for name in Features._fields]),
                         slam.device)
        slam.keyframes.append(Keyframe(
            index=i, feats=feats, pose=device_constant(data["pose"], slam.device, torch.float32),
            track_ids=data["track_ids"]))
