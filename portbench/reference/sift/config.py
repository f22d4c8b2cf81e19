# Frozen copy of niftymatch_torch/config.py at commit def8df72c5c264abd9e3aa10eba50d4d66e57296, unchanged below this
# header: part of the benchmark's plain reference, imported by nothing of the program.
"""Typed configuration tree for the PyTorch/CUDA port.

A field-for-field copy of ``niftymatch_tpu/config.py`` (which imports only
``dataclasses`` and ``math``), kept separate so the port never imports the
JAX package.  Every default and derived property reproduces the reference's
``SiftParams`` rules (``siftparams.h:30-51``); ``tests/test_torch_config.py``
holds the two files equal over several image sizes.

Two fields exist only so that configs carry across unchanged
(``convert.py``): ``SiftConfig.use_pallas_windows`` and
``RuntimeConfig.use_pallas``.  In the port they select nothing: the device
of the input decides.  A CUDA tensor always goes through the hand-written
kernels (``kernels/``), never through a plain version, and a CPU tensor
through the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

SIFT_VECTOR_SIZE = 128          # siftdata.h:9
MAX_DESCRIPTORS = 2048          # siftdata.h:15
MINIMUM_OCTAVE_SIZE = 32        # siftparams.h:9
NUM_ORI_BINS = 36               # orientation.cu:8  (NBINS)
NUM_DESC_ORI_BINS = 8           # descriptor.cu:6   (NBO)
NUM_DESC_SPATIAL_BINS = 4       # descriptor.cu:7   (NBP)
DESC_MAGNIF = 3.0               # descriptor.cu:9   (MAG)
MACHINE_EPS = 1.0e-7            # descriptor.cu:12


@dataclasses.dataclass(frozen=True)
class CompatFlags:
    """Bug-for-bug compatibility switches vs. the reference CUDA kernels.

    All default to False => correct (VLFeat-convention) behaviour.
    """

    # exp(+r^2/...) windows of orientation.cu:56 / descriptor.cu:108.
    flipped_gaussian_sign: bool = False
    # Unnormalised descriptors (normalize_histogram is never called,
    # descriptor.cu:14-29).
    unnormalized_descriptors: bool = False
    # Accept non-positive 2x2 Hessian determinants in the edge test
    # (keypoint.cu:166-169).
    accept_negative_edge_score: bool = False


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """Scale-space + detector configuration (``siftparams.h:30-51``)."""

    width: int
    height: int
    num_dog_levels: int = 3
    sigma_n: float = 0.5
    peak_threshold: float = 0.0
    edge_threshold: float = 10.0
    max_keypoints_per_level: int = 512
    max_features: int = MAX_DESCRIPTORS
    max_orientation_radius: int = 10
    use_second_orientation: bool = False
    # Carried for config parity only; see the module docstring.
    use_pallas_windows: bool = True
    compat: CompatFlags = dataclasses.field(default_factory=CompatFlags)

    @property
    def level_max(self) -> int:
        return self.num_dog_levels + 1

    @property
    def level_min(self) -> int:
        return -1

    @property
    def num_octaves(self) -> int:
        n = int(
            math.floor(
                math.log(min(self.width, self.height) * 2.0 / MINIMUM_OCTAVE_SIZE)
                / math.log(2.0)
            )
        )
        return max(n, 1)

    @property
    def num_gauss_levels(self) -> int:
        return self.level_max - self.level_min + 1

    @property
    def num_dogs(self) -> int:
        return self.level_max - self.level_min

    @property
    def sigma_k(self) -> float:
        return 2.0 ** (1.0 / self.num_dog_levels)

    @property
    def sigma_0(self) -> float:
        return 1.6 * self.sigma_k

    @property
    def sigma_d0(self) -> float:
        k = self.sigma_k
        return self.sigma_0 * math.sqrt(1.0 - 1.0 / (k * k))

    @property
    def base_smooth(self) -> float:
        sa = self.sigma_0 * (self.sigma_k ** self.level_min)
        sb = self.sigma_n
        if sa > sb:
            return math.sqrt(sa * sa - sb * sb)
        return 0.0

    @property
    def sigmas(self) -> Tuple[float, ...]:
        """Incremental smoothing taking Gaussian level j to level j + 1."""
        return tuple(
            self.sigma_d0 * (self.sigma_k ** i)
            for i in range(self.level_min + 1, self.level_max + 1)
        )

    def octave_shape(self, octave: int) -> Tuple[int, int]:
        return self.height >> octave, self.width >> octave


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Lowe ratio test on squared L2 distances (``siftfunctions.h:20``)."""

    ambiguity: float = 0.8
    # Distance-GEMM operands: "fp32" (exact) or "bf16" (fp32 accumulation).
    precision: str = "fp32"


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    iterations: int = 2048
    inlier_threshold: float = 9.0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class BAConfig:
    max_iterations: int = 10
    damping: float = 1e-4
    huber_delta: float = 2.0
    cg_iterations: int = 50
    cg_tol: float = 1e-6
    obs_chunk: int = 131072


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    # Carried for config parity only; see the module docstring.
    use_pallas: bool = True
    profile: bool = False


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    sift: SiftConfig
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    ransac: RansacConfig = dataclasses.field(default_factory=RansacConfig)
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)

    @staticmethod
    def for_image(width: int, height: int, **kwargs) -> "PipelineConfig":
        return PipelineConfig(sift=SiftConfig(width=width, height=height), **kwargs)
