"""NiftyMatch for PyTorch and CUDA: the port of ``niftymatch_tpu``.

SIFT detection, description and matching on NVIDIA Hopper, with the repo's
four TPU kernels rewritten as hand-written CUDA kernels (``kernels/``,
sources in ``csrc/``: K1-K3 on the system's paths, K4 the fold
microbenchmark); RANSAC geometry (``geometry/``), warping
(``ops/warp.py``), mosaicking (``mosaic.py``), the SfM back-end (``sfm/``:
SE(3)/Sim(3), triangulation, dense and PCG bundle adjustment, pose
graphs), keyframe SLAM (``slam/``: the two-view front end, the keyframe
store, ``SlamSystem`` with relocalisation, window and global BA, loop
closure and ``finalize``; checkpoints in ``utils/checkpoint.py``), the
single-device all-pairs sweeps (``parallel/``) and synthetic scenes
(``data/``) in plain PyTorch, as the JAX package writes them in plain
``jnp``.  The port imports ``torch`` and never ``jax`` or
``niftymatch_tpu``.  Entry points run on CUDA unless they are given
``device="cpu"``.
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
from .sfm import (
    BAProblem,
    PoseGraph,
    Sim3Graph,
    bundle_adjust,
    bundle_adjust_cg,
    optimize_pose_graph,
    optimize_pose_graph_sim3,
)
from .sift import (
    detect_and_describe,
    detect_and_describe_batch,
    make_batch_detector,
    make_detector,
    make_pair_pipeline,
    match_pair,
)
from .slam import LoopCloser, SlamConfig, SlamSystem, estimate_two_view

__all__ = [
    "BAConfig",
    "BAProblem",
    "CompatFlags",
    "Features",
    "LoopCloser",
    "MatchConfig",
    "MatchResult",
    "PipelineConfig",
    "PoseGraph",
    "RansacConfig",
    "RansacResult",
    "RuntimeConfig",
    "SiftConfig",
    "Sim3Graph",
    "SlamConfig",
    "SlamSystem",
    "align_points",
    "bundle_adjust",
    "bundle_adjust_cg",
    "concat_features",
    "detect_and_describe",
    "detect_and_describe_batch",
    "estimate_two_view",
    "make_batch_detector",
    "make_detector",
    "make_pair_pipeline",
    "match_pair",
    "optimize_pose_graph",
    "optimize_pose_graph_sim3",
    "ransac",
    "topk_features",
]
