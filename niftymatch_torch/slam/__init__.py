"""Keyframe SLAM (``slam/`` of the JAX package): the front end (two-view
estimate, ``slam_step``, ``slam_chunk``), the keyframe store, the tracking
system with relocalisation and window BA, and global BA.  Loop closure is
still to port."""

from .frontend import (
    SlamStepResult,
    TwoViewResult,
    estimate_two_view,
    masked_median,
    normalize_points,
    slam_chunk,
    slam_step,
    triangulate_in_world,
    two_view_from_matches,
)
from .keyframe import Keyframe
from .reloc import Relocalizer
from .store import FeatureStore
from .system import SlamConfig, SlamSystem

__all__ = [
    "FeatureStore",
    "Keyframe",
    "Relocalizer",
    "SlamConfig",
    "SlamStepResult",
    "SlamSystem",
    "TwoViewResult",
    "estimate_two_view",
    "masked_median",
    "normalize_points",
    "slam_chunk",
    "slam_step",
    "triangulate_in_world",
    "two_view_from_matches",
]
