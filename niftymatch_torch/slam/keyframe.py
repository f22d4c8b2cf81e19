"""Keyframe record for the SLAM system (``slam/keyframe.py`` of the JAX
package).

Fixed-capacity features living in the device-resident
:class:`~.store.FeatureStore`, plus host bookkeeping (track ids, coordinate
mirrors) and the pose, which is always a device (3, 4) tensor: the JAX
package keeps a host array for chunk-produced keyframes and a device array
otherwise; here one type, fetched for all keyframes at once by
``SlamSystem.poses``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..features import Features
from ..utils.precision import host_fetch


class Keyframe:
    """One SLAM keyframe.

    Features live in the system's :class:`~.store.FeatureStore` (one row per
    keyframe); ``feats`` reads the row on first access and caches it.
    Keyframes created on the per-frame path pass ``feats`` directly *and*
    a store slot.  A keyframe restored from a checkpoint has ``feats`` and
    no slot, as in the JAX package."""

    def __init__(
        self,
        index: int,
        feats: Features | None = None,
        pose: torch.Tensor | None = None,
        track_ids: np.ndarray | None = None,
        host_x: np.ndarray | None = None,
        host_y: np.ndarray | None = None,
        store=None,
        slot: int | None = None,
    ):
        if feats is None and (store is None or slot is None):
            raise ValueError("Keyframe needs feats or a (store, slot) reference")
        self.index = index
        self._feats = feats
        self._store = store
        self.slot = slot
        self.pose = pose
        self.track_ids = track_ids
        # Host mirrors of the (immutable) keypoint coordinates, filled from
        # a batched fetch or on first use, so window assembly never waits
        # on the device again.
        self.host_x = host_x
        self.host_y = host_y

    @property
    def feats(self) -> Features:
        if self._feats is None:
            self._feats = self._store.get(self.slot)
        return self._feats

    def ensure_host_coords(self) -> None:
        if self.host_x is None:
            (xy,) = host_fetch(torch.stack([self.feats.x, self.feats.y]))
            self.host_x, self.host_y = xy[0], xy[1]
