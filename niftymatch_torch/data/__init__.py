"""Datasets: synthetic multi-view scenes with exact ground truth
(``data/synthetic.py`` of the JAX package, bit-identical for the same
seeds)."""

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
