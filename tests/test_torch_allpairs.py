"""The port's all-pairs keyframe sweeps (``niftymatch_torch/parallel/
matching.py``) against the JAX package's, on the CPU.

Six keyframes of 64 slots draw noisy copies of descriptors from one pool,
so frames share true matches; a tenth of the slots are invalid, and frame
0's slot 7 is an exact copy of its slot 3.  An exact duplicate's ratio test
is a coin flip (its two distances differ only by the GEMM's rounding), so
that slot and matches into it stay out of the index comparisons.
Tolerances: the fp32 oracle's counts and indices equal JAX's
``allpairs_match``; the fused sweep in fp32 gives the counts of JAX's
``allpairs_match_pallas(precision="fp32", interpret=True)``; in bf16 each
count lies within 2 % of the oracle's plus 2 (ratio tests that flip within
bf16 noise of the threshold) and equals the oracle's at bf16 operand
precision.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niftymatch_torch.parallel import allpairs_match, allpairs_match_fused
from niftymatch_tpu.parallel.matching import allpairs_match as jax_allpairs
from niftymatch_tpu.parallel.matching import allpairs_match_pallas as jax_allpairs_pallas

K, N, D = 6, 64, 128
DUP = (0, 3, 7)   # frame 0's slot 7 copies its slot 3


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(7)
    pool = rng.random((96, D)).astype(np.float32)
    desc = np.empty((K, N, D), np.float32)
    for k in range(K):
        pick = rng.choice(len(pool), N, replace=False)
        desc[k] = pool[pick] + rng.normal(0, 0.04, (N, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    f, a, b = DUP
    desc[f, b] = desc[f, a]
    valid = rng.random((K, N)) > 0.1
    valid[f, a] = valid[f, b] = True
    return desc, valid


def _clear(idx):
    """Index entries to compare exactly: not from the duplicated slots, not
    into them."""
    f, a, b = DUP
    keep = np.ones(idx.shape, bool)
    keep[f, :, [a, b]] = False
    keep[:, f][np.isin(idx[:, f], [a, b])] = False
    return keep


@pytest.mark.parametrize("mutual", [False, True])
def test_oracle_matches_jax(frames, mutual):
    desc, valid = frames
    want = jax_allpairs(jnp.asarray(desc), jnp.asarray(valid), ambiguity=0.8,
                        mutual=mutual, return_indices=True, jblock=4)
    got = allpairs_match(torch.from_numpy(desc), torch.from_numpy(valid), ambiguity=0.8,
                         mutual=mutual, return_indices=True, jblock=4)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    gi, wi = got.indices.numpy(), np.asarray(want.indices)
    keep = _clear(wi) & _clear(gi)
    np.testing.assert_array_equal(gi[keep], wi[keep])
    assert (got.counts.numpy()[~np.eye(K, dtype=bool)] > 0).all()
    counts_only = allpairs_match(torch.from_numpy(desc), torch.from_numpy(valid),
                                 ambiguity=0.8, mutual=mutual)
    assert counts_only.indices is None
    np.testing.assert_array_equal(counts_only.counts.numpy(), got.counts.numpy())


@pytest.mark.parametrize("mutual", [False, True])
def test_fused_fp32_matches_jax_pallas(frames, mutual):
    desc, valid = frames
    want = jax_allpairs_pallas(jnp.asarray(desc), jnp.asarray(valid), ambiguity=0.7,
                               mutual=mutual, return_indices=True, precision="fp32",
                               interpret=True)
    got = allpairs_match_fused(torch.from_numpy(desc), torch.from_numpy(valid),
                               ambiguity=0.7, mutual=mutual, return_indices=True)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    gi, wi = got.indices.numpy(), np.asarray(want.indices)
    keep = _clear(wi) & _clear(gi)
    np.testing.assert_array_equal(gi[keep], wi[keep])
    oracle = allpairs_match(torch.from_numpy(desc), torch.from_numpy(valid),
                            ambiguity=0.7, mutual=mutual)
    np.testing.assert_array_equal(got.counts.numpy(), oracle.counts.numpy())


def test_fused_bf16_within_flips(frames):
    desc, valid = frames
    got = allpairs_match_fused(torch.from_numpy(desc), torch.from_numpy(valid),
                               ambiguity=0.7, mutual=True, precision="bf16").counts.numpy()
    want = allpairs_match(torch.from_numpy(desc), torch.from_numpy(valid), ambiguity=0.7,
                          mutual=True).counts.numpy()
    assert (np.abs(got - want) <= 0.02 * want + 2).all(), (got, want)
    # The oracle at the same operand precision computes the same function.
    same = allpairs_match(torch.from_numpy(desc), torch.from_numpy(valid), ambiguity=0.7,
                          mutual=True, precision="bf16").counts.numpy()
    np.testing.assert_array_equal(got, same)
    with pytest.raises(ValueError):
        allpairs_match_fused(torch.from_numpy(desc), torch.from_numpy(valid),
                             precision="fp16")
