"""NiftyMatch for PyTorch and CUDA: the port of ``niftymatch_tpu``.

SIFT detection, description and matching on NVIDIA Hopper, with the JAX
package's three TPU kernels rewritten as hand-written CUDA kernels
(``kernels/``, sources in ``csrc/``); RANSAC geometry (``geometry/``),
warping (``ops/warp.py``) and mosaicking (``mosaic.py``) in plain
PyTorch, as the JAX package writes them in plain ``jnp``.  The port imports
``torch`` and never ``jax`` or ``niftymatch_tpu``.  Entry points run on CUDA unless they are
given ``device="cpu"``.
"""

from .config import (
    BAConfig,
    CompatFlags,
    MatchConfig,
    PipelineConfig,
    RansacConfig,
    RuntimeConfig,
    SiftConfig,
)
from .features import Features, concat_features, topk_features
from .geometry import RansacResult, align_points, ransac
from .ops.match import MatchResult
from .sift import (
    detect_and_describe,
    detect_and_describe_batch,
    make_batch_detector,
    make_detector,
    make_pair_pipeline,
    match_pair,
)

__all__ = [
    "BAConfig",
    "CompatFlags",
    "Features",
    "MatchConfig",
    "MatchResult",
    "PipelineConfig",
    "RansacConfig",
    "RansacResult",
    "RuntimeConfig",
    "SiftConfig",
    "align_points",
    "concat_features",
    "detect_and_describe",
    "detect_and_describe_batch",
    "make_batch_detector",
    "make_detector",
    "make_pair_pipeline",
    "match_pair",
    "ransac",
    "topk_features",
]
