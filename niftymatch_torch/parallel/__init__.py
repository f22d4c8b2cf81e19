"""The multi-device layer (``parallel/`` of the JAX package):
keyframe meshes over ``torch.distributed`` process groups, the
ring-scheduled all-pairs sweep, sharded detection and distributed bundle
adjustment whose Schur reduction is all-reduced over the ranks.
``allpairs_match_fused`` stands for the JAX package's
``allpairs_match_pallas``."""

from .ba import (
    ShardedBAProblem,
    distributed_bundle_adjust,
    distributed_bundle_adjust_cg,
    partition_by_landmark,
)
from .matching import (
    AllPairsMatches,
    allpairs_match,
    allpairs_match_fused,
    gather_features,
    ring_allpairs_match,
    ring_allpairs_match_counts,
    ring_rows,
    shard_detect,
)
from .mesh import make_keyframe_mesh
from .multihost import initialize_distributed, local_batch_slice, make_hierarchical_mesh

__all__ = [
    "AllPairsMatches",
    "ShardedBAProblem",
    "allpairs_match",
    "allpairs_match_fused",
    "distributed_bundle_adjust",
    "distributed_bundle_adjust_cg",
    "gather_features",
    "initialize_distributed",
    "local_batch_slice",
    "make_hierarchical_mesh",
    "make_keyframe_mesh",
    "partition_by_landmark",
    "ring_allpairs_match",
    "ring_allpairs_match_counts",
    "ring_rows",
    "shard_detect",
]
