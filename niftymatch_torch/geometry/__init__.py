"""Robust two-view geometry: batched small linear algebra, transform
solvers and RANSAC (``geometry/`` of the JAX package), in plain PyTorch."""

from .fivepoint import essential_from_five, fit_essential5
from .linalg import (
    cholesky_solve_small,
    inv3x3,
    jacobi_eigh,
    smallest_eigvec,
    solve3x3,
    sorted_eigh,
    svd3x3,
)
from .ransac import MIN_SAMPLES, RansacResult, align_points, ransac
from .transforms import (
    apply_homography,
    fit_essential,
    fit_fundamental,
    fit_homography,
    fit_similarity,
    fit_translation,
    hartley_normalization,
    sampson_sq_error,
    transfer_sq_error,
)

__all__ = [
    "MIN_SAMPLES",
    "RansacResult",
    "align_points",
    "apply_homography",
    "cholesky_solve_small",
    "essential_from_five",
    "fit_essential",
    "fit_essential5",
    "fit_fundamental",
    "fit_homography",
    "fit_similarity",
    "fit_translation",
    "hartley_normalization",
    "inv3x3",
    "jacobi_eigh",
    "ransac",
    "sampson_sq_error",
    "smallest_eigvec",
    "solve3x3",
    "sorted_eigh",
    "svd3x3",
    "transfer_sq_error",
]
