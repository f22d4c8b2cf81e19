"""Carry configs and feature sets across from the JAX package.

The system has no weights; what carries across is the config tree (SLAM's
included), the ``Features`` sets and the SfM state (bundle-adjustment
problems and pose graphs); SLAM map state carries across as a checkpoint
(``utils/checkpoint.py``).  These functions take plain Python and numpy data
(``dataclasses.asdict`` of a JAX-side config, ``numpy.asarray`` of each
field of a ``Features`` or of a JAX NamedTuple's ``_asdict()``), so the
port still imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from .config import (
    BAConfig,
    CompatFlags,
    MatchConfig,
    PipelineConfig,
    RansacConfig,
    RuntimeConfig,
    SiftConfig,
)
from .features import Features
from .mosaic import MosaicConfig
from .sfm.ba import BAProblem
from .sfm.posegraph import PoseGraph, Sim3Graph
from .slam.system import SlamConfig
from .utils.precision import state_to


def sift_config_from_dict(d: dict) -> SiftConfig:
    fields = dict(d)
    compat = fields.pop("compat", {})
    return SiftConfig(**fields, compat=CompatFlags(**compat))


def pipeline_config_from_dict(d: dict) -> PipelineConfig:
    return PipelineConfig(
        sift=sift_config_from_dict(d["sift"]),
        match=MatchConfig(**d.get("match", {})),
        ransac=RansacConfig(**d.get("ransac", {})),
        ba=BAConfig(**d.get("ba", {})),
        runtime=RuntimeConfig(**d.get("runtime", {})),
    )


def mosaic_config_from_dict(d: dict) -> MosaicConfig:
    fields = dict(d)
    ransac = fields.pop("ransac", {})
    return MosaicConfig(**fields, ransac=RansacConfig(**ransac))


def slam_config_from_dict(d: dict) -> SlamConfig:
    """A port ``SlamConfig`` from ``dataclasses.asdict`` of a JAX one."""
    fields = dict(d)
    fields["ransac"] = RansacConfig(**fields.get("ransac", {}))
    fields["ba"] = BAConfig(**fields.get("ba", {}))
    fields["intrinsics"] = tuple(fields.get("intrinsics", SlamConfig.intrinsics))
    if fields.get("distortion") is not None:
        fields["distortion"] = tuple(fields["distortion"])
    return SlamConfig(**fields)


def features_from_numpy(arrays: dict, device="cpu") -> Features:
    """A port ``Features`` from a dict of numpy arrays keyed by field name."""
    return state_to(Features(*[np.array(arrays[k]) for k in Features._fields]), device)


def ba_problem_from_numpy(arrays: dict, device="cpu") -> BAProblem:
    """A port ``BAProblem`` from a dict of numpy arrays keyed by field name
    (floats float32, ``obs_cam``/``obs_lm`` int32, masks bool)."""
    return state_to(BAProblem(*[np.array(arrays[k]) for k in BAProblem._fields]), device)


def pose_graph_from_numpy(arrays: dict, device="cpu") -> PoseGraph:
    """A port ``PoseGraph`` from a dict of numpy arrays keyed by field name."""
    return state_to(PoseGraph(*[np.array(arrays[k]) for k in PoseGraph._fields]), device)


def sim3_graph_from_numpy(arrays: dict, device="cpu") -> Sim3Graph:
    """A port ``Sim3Graph`` from a dict of numpy arrays keyed by field name."""
    return state_to(Sim3Graph(*[np.array(arrays[k]) for k in Sim3Graph._fields]), device)
