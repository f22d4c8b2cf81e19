"""The multi-device layer of the JAX package (``parallel/``), so far its
single-device all-pairs sweeps (``matching.py``).  The ring over a device
mesh, ``shard_detect``, distributed BA and the mesh helpers are still to
port."""

from .matching import AllPairsMatches, allpairs_match, allpairs_match_fused

__all__ = ["AllPairsMatches", "allpairs_match", "allpairs_match_fused"]
