"""Keyframe SLAM (``slam/`` of the JAX package): so far the two-view front
end, relative pose between two keyframes."""

from .frontend import (
    TwoViewResult,
    estimate_two_view,
    normalize_points,
    two_view_from_matches,
)

__all__ = [
    "TwoViewResult",
    "estimate_two_view",
    "normalize_points",
    "two_view_from_matches",
]
