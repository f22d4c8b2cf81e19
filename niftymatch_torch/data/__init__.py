"""Datasets: synthetic multi-view scenes with exact ground truth
(``data/synthetic.py`` of the JAX package, bit-identical for the same
seeds), TUM RGB-D and EuRoC MAV sequence directories (``tum``,
``euroc``), a PNG writer (``png``) and the native PNG decoder and
prefetching loader (``native_loader``)."""

from .synthetic import (
    SyntheticScene,
    apply_photometric,
    make_feature_sequence,
    make_observation_table,
    make_scene,
    render_frames,
)

__all__ = [
    "SyntheticScene",
    "apply_photometric",
    "make_feature_sequence",
    "make_observation_table",
    "make_scene",
    "render_frames",
]
