"""Structure-from-motion back-end (``sfm/`` of the JAX package): SE(3) and
Sim(3), triangulation, essential and homography pose recovery, two-view
refinement, dense and PCG bundle adjustment, SE(3)/Sim(3) pose graphs, in
plain PyTorch, as the JAX package writes them in plain ``jnp``."""

from .ba import BAProblem, BAStats, ba_cost, bundle_adjust, project
from .ba_cg import bundle_adjust_cg
from .homography import decompose_homography, recover_pose_homography
from .posegraph import (
    PGOStats,
    PoseGraph,
    Sim3Graph,
    edge_residual,
    graph_cost,
    optimize_pose_graph,
    optimize_pose_graph_sim3,
    optimize_pose_graph_sim3_cg,
    sim3_graph_cost,
)
from .se3 import (
    hat,
    se3_apply,
    se3_compose,
    se3_exp,
    se3_identity,
    se3_inverse,
    se3_log,
    se3_relative,
    so3_exp,
    so3_log,
)
from .sim3 import sim3_apply, sim3_compose, sim3_inverse, sim3_retract
from .triangulation import (
    PoseRecovery,
    decompose_essential,
    recover_pose,
    reprojection_error,
    triangulate_dlt,
    triangulate_midpoint,
)
from .two_view_refine import refine_relative_pose

__all__ = [
    "BAProblem",
    "BAStats",
    "PGOStats",
    "PoseGraph",
    "PoseRecovery",
    "Sim3Graph",
    "ba_cost",
    "bundle_adjust",
    "bundle_adjust_cg",
    "decompose_essential",
    "decompose_homography",
    "edge_residual",
    "graph_cost",
    "hat",
    "optimize_pose_graph",
    "optimize_pose_graph_sim3",
    "optimize_pose_graph_sim3_cg",
    "project",
    "recover_pose",
    "recover_pose_homography",
    "refine_relative_pose",
    "reprojection_error",
    "se3_apply",
    "se3_compose",
    "se3_exp",
    "se3_identity",
    "se3_inverse",
    "se3_log",
    "se3_relative",
    "sim3_apply",
    "sim3_compose",
    "sim3_graph_cost",
    "sim3_inverse",
    "sim3_retract",
    "so3_exp",
    "so3_log",
    "triangulate_dlt",
    "triangulate_midpoint",
]
