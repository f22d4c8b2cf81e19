"""The JAX package's result on the SLAM clip of ``bench.py::bench_slam_loop``
(113 rendered 640x480 uint8 frames, the same ``SlamConfig``), through one
``SlamSystem.process_frames`` call on whatever device JAX has; the port's
card check (``niftymatch_torch/utils/smoke_slam.py``, phase 8b) quotes
these numbers as its reference, since the card's machine has no JAX.

    JAX_PLATFORMS=cpu python tools/jax_slam_reference.py

Prints one JSON line: accept fraction, relocalisations, min and median
inliers of the tracked frames, keyframes, the Sim(3)-aligned ATE of the
keyframes' centres against the scene's and the trajectory's extent (the
mean distance of the true centres from their mean).
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from niftymatch_tpu.config import RansacConfig  # noqa: E402
from niftymatch_tpu.data import make_scene, render_frames  # noqa: E402
from niftymatch_tpu.slam import SlamConfig, SlamSystem  # noqa: E402
from niftymatch_tpu.utils import ate_rmse  # noqa: E402


def main():
    scene = make_scene(num_cams=113, num_landmarks=1200, seed=0, radius=6.0,
                       width=640, height=480)
    frames = np.clip(render_frames(scene, seed=0), 0, 255).astype(np.uint8)
    cfg = SlamConfig(width=640, height=480,
                     intrinsics=tuple(float(v) for v in scene.intrinsics),
                     ransac=RansacConfig(iterations=512, inlier_threshold=4.0),
                     detector_features=1024, min_inliers=12, chunk_size=16,
                     ba_every=4, ba_window=4, store_capacity=256)
    t0 = time.perf_counter()
    slam = SlamSystem(cfg)
    infos = slam.process_frames(frames)
    slam.flush_ba()
    seconds = time.perf_counter() - t0
    kept = [i for i, inf in enumerate(infos) if inf["keyframe"]]
    gt = -np.einsum("kji,kj->ki", scene.poses[:, :, :3], scene.poses[:, :, 3])
    inliers = [inf["num_inliers"] for inf in infos[1:] if inf["keyframe"]]
    print(json.dumps({
        "frames": len(infos), "accept_frac": len(kept) / len(infos),
        "relocs": sum(1 for inf in infos if inf.get("reloc")),
        "inliers_min": int(min(inliers)), "inliers_median": float(np.median(inliers)),
        "keyframes": len(slam.keyframes),
        "sim3_ate": ate_rmse(slam.trajectory(), gt[kept]),
        "extent": float(np.linalg.norm(gt - gt.mean(0), axis=1).mean()),
        "seconds": seconds}))


if __name__ == "__main__":
    main()
