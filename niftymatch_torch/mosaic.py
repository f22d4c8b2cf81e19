"""Sequential homography mosaicking (``mosaic.py`` of the JAX package):
undistort -> detect -> match both ways -> mutual check -> RANSAC
homography -> chain into the canvas -> warp and blend, the reference's
client loop (the GIFT-Surg use case).

The canvas, its weights and the frame-to-canvas chain stay on the device;
the Python layer only decides whether a frame registered, from one read of
the device per frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import RansacConfig, SiftConfig
from .geometry.linalg import inv3x3
from .geometry.ransac import align_points, ransac
from .ops.gradients import div_const
from .ops.match import mutual_matches
from .ops.warp import blend_into_mosaic, remap, undistort_map
from .sift import make_detector, match_pair
from .utils.precision import resolve_device


@dataclasses.dataclass
class MosaicConfig:
    width: int                      # frame width
    height: int                     # frame height
    canvas_width: int = 2048
    canvas_height: int = 1536
    # Where frame 0's origin lands on the canvas; centred by default.
    anchor_x: float | None = None
    anchor_y: float | None = None
    ransac: RansacConfig = dataclasses.field(
        default_factory=lambda: RansacConfig(iterations=1024, inlier_threshold=9.0)
    )
    ambiguity: float = 0.7
    min_inliers: int = 12
    detector_features: int = 1024
    # Optional undistortion: (fx, fy, cx, cy) and (k1, k2, k3).
    camera_matrix: tuple | None = None
    distortion: tuple | None = None
    # Centre-weighted blend weights for incoming frames (plain ones give a
    # straight running average).
    center_weighted: bool = True


class MosaicBuilder:
    """Registers each frame to the previous one by homography and blends it
    into a float canvas on the device (CUDA unless ``device`` says
    otherwise)."""

    def __init__(self, config: MosaicConfig, device=None):
        self.config = config
        self.device = dev = resolve_device(device)
        self._detect = make_detector(
            SiftConfig(width=config.width, height=config.height,
                       max_features=config.detector_features),
            device=dev,
        )
        h, w = config.height, config.width
        ch, cw = config.canvas_height, config.canvas_width
        kw = dict(dtype=torch.float32, device=dev)
        self.canvas = torch.zeros((ch, cw), **kw)
        self.weights = torch.zeros((ch, cw), **kw)
        ax = config.anchor_x if config.anchor_x is not None else (cw - w) / 2.0
        ay = config.anchor_y if config.anchor_y is not None else (ch - h) / 2.0
        # Current frame -> canvas; frame 0 is the anchor.
        self._H_canvas = torch.tensor([[1.0, 0.0, ax], [0.0, 1.0, ay],
                                       [0.0, 0.0, 1.0]], **kw)
        self._prev_feats = None
        self.num_registered = 0
        self.num_failed = 0

        self._undist = None
        if config.camera_matrix is not None:
            dist = config.distortion or (0.0, 0.0, 0.0)
            self._undist = undistort_map(torch.tensor(config.camera_matrix, **kw),
                                         torch.tensor(dist, **kw), h, w)

        if config.center_weighted:
            yy = torch.arange(h, **kw)[:, None]
            xx = torch.arange(w, **kw)[None, :]
            wy = 1.0 - torch.abs(div_const(2.0 * yy, float(h - 1)) - 1.0)
            wx = 1.0 - torch.abs(div_const(2.0 * xx, float(w - 1)) - 1.0)
            self._frame_weights = torch.clamp(wy * wx, min=1e-3)
        else:
            self._frame_weights = torch.ones((h, w), **kw)

    def _register(self, prev, cur):
        """Homography taking ``cur``'s coordinates to ``prev``'s, with its
        inlier count and success flag, all on the device."""
        cfg = self.config
        fwd = match_pair(prev, cur, ambiguity=cfg.ambiguity, device=self.device)
        bwd = match_pair(cur, prev, ambiguity=cfg.ambiguity, device=self.device)
        src, dst, mask = align_points(prev.x, prev.y, cur.x, cur.y,
                                      mutual_matches(fwd, bwd), prev.valid,
                                      device=self.device)
        # Fit cur -> prev directly: the chaining direction.
        res = ransac(dst, src, mask, cfg.ransac, model="homography",
                     device=self.device)
        return res.transform, res.num_inliers, res.success

    def _blend(self, frame, H_canvas_cur):
        # The blend samples the frame at canvas pixels: canvas -> frame.
        self.canvas, self.weights = blend_into_mosaic(
            self.canvas, self.weights, frame, self._frame_weights,
            inv3x3(H_canvas_cur))

    def add_frame(self, image) -> dict:
        """Register and blend one grayscale (H, W) frame; returns whether it
        registered and its inlier count."""
        frame = torch.as_tensor(image, device=self.device).to(torch.float32)
        if self._undist is not None:
            frame = remap(frame, *self._undist)
        feats = self._detect(frame)

        if self._prev_feats is None:
            self._blend(frame, self._H_canvas)
            self._prev_feats = feats
            self.num_registered += 1
            return {"registered": True, "num_inliers": 0}

        H_prev_cur, num_inl, success = self._register(self._prev_feats, feats)
        ok, num = torch.stack([success.to(torch.int64),
                               num_inl.to(torch.int64)]).tolist()  # the frame's one sync
        if not ok or num < self.config.min_inliers:
            self.num_failed += 1
            return {"registered": False, "num_inliers": num}

        self._H_canvas = self._H_canvas @ H_prev_cur
        self._blend(frame, self._H_canvas)
        self._prev_feats = feats
        self.num_registered += 1
        return {"registered": True, "num_inliers": num}

    def result(self) -> np.ndarray:
        """The mosaic canvas as a numpy array."""
        return self.canvas.cpu().numpy()

    def frame_to_canvas(self) -> np.ndarray:
        """The latest registered frame's homography into the canvas."""
        return self._H_canvas.cpu().numpy()
