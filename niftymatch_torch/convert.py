"""Carry configs and feature sets across from the JAX package.

The system has no weights; what carries across is the config tree and the
``Features`` sets.  These functions take plain Python and numpy data
(``dataclasses.asdict`` of a JAX-side config, ``numpy.asarray`` of each
``Features`` field), so the port still imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

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


_DTYPES = dict(octave=torch.int32, level=torch.int32, valid=torch.bool)


def features_from_numpy(arrays: dict, device="cpu") -> Features:
    """A port ``Features`` from a dict of numpy arrays keyed by field name."""
    return Features(**{
        name: torch.as_tensor(np.asarray(arrays[name]),
                              dtype=_DTYPES.get(name, torch.float32),
                              device=device)
        for name in Features._fields
    })

