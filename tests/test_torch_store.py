"""The port's keyframe feature store (``niftymatch_torch/slam/store.py``)
against the JAX package's ``FeatureStore``, on the CPU.

The six cases of ``tests/test_feature_store.py``: both stores get the same
numpy rows and the same calls, and must return the same slots, counts,
capacities and rows bit for bit (a store only copies).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niftymatch_torch.features import Features as TFeatures
from niftymatch_torch.slam.store import FeatureStore as TStore
from niftymatch_tpu.features import Features as JFeatures
from niftymatch_tpu.slam.store import FeatureStore as JStore
from torch_parity import np_


def _rows(rng, n=32, d=8):
    return dict(
        x=rng.random(n, np.float32), y=rng.random(n, np.float32),
        sigma=np.ones(n, np.float32), angle=np.zeros(n, np.float32),
        response=rng.random(n, np.float32), octave=np.zeros(n, np.int32),
        level=np.zeros(n, np.int32), desc=rng.random((n, d), np.float32),
        valid=np.ones(n, bool))


def _batch_rows(rng, b=6, n=32, d=8):
    rows = [_rows(rng, n, d) for _ in range(b)]
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


class Pair:
    """One port store and one JAX store driven with the same calls."""

    def __init__(self, **kw):
        self.t, self.j = TStore(**kw), JStore(**kw)

    @staticmethod
    def feats(rows):
        return (TFeatures(*[torch.from_numpy(rows[k]) for k in TFeatures._fields]),
                JFeatures(*[jnp.asarray(rows[k]) for k in JFeatures._fields]))

    def both(self, method, rows=None, *args):
        if rows is None:
            got, want = getattr(self.t, method)(*args), getattr(self.j, method)(*args)
        else:
            tf, jf = self.feats(rows)
            got, want = getattr(self.t, method)(tf, *args), getattr(self.j, method)(jf, *args)
        self.check_state()
        return got, want

    def check_state(self):
        assert (self.t.count, self.t.capacity, self.t._staged) == \
            (self.j.count, self.j.capacity, self.j._staged)

    def same(self, got, want):
        assert isinstance(got, TFeatures)
        for name in TFeatures._fields:
            np.testing.assert_array_equal(np_(getattr(got, name)),
                                          np.asarray(getattr(want, name)), err_msg=name)


def test_stage_chunk_and_get(rng):
    s = Pair(init_capacity=4, chunk_pad=4)
    fb = _batch_rows(rng, b=6)
    slots = s.both("stage_chunk", fb, [1, 3, 4])
    assert slots[0] == slots[1] == [0, 1, 2]
    got = s.both("get", None, 1)
    s.same(*got)
    np.testing.assert_array_equal(np_(got[0].desc), fb["desc"][3])
    assert s.t.count == 3


def test_single_and_chunk_interleave(rng):
    s = Pair(init_capacity=4, chunk_pad=4)
    f0 = _rows(rng)
    s0 = s.both("stage_single", f0)
    slots = s.both("stage_chunk", _batch_rows(rng, b=5), [0, 2])
    s3 = s.both("stage_single", _rows(rng))
    assert (s0[0], slots[0], s3[0]) == (s0[1], slots[1], s3[1]) == (0, [1, 2], 3)
    s.both("flush")
    assert s.t.count == 4
    for slot in range(4):
        s.same(*s.both("get", None, slot))
    np.testing.assert_array_equal(np_(s.t.get(0).x), f0["x"])


def test_capacity_doubles_and_preserves(rng):
    s = Pair(init_capacity=2, chunk_pad=2)
    rows = []
    for _ in range(9):
        rows.append(_rows(rng))
        s.both("stage_single", rows[-1])
        s.both("flush")
    assert s.t.capacity >= 9 and s.t.count == 9
    for i, r in enumerate(rows):
        got = s.both("get", None, i)
        s.same(*got)
        np.testing.assert_array_equal(np_(got[0].desc), r["desc"])


def test_tail_and_gather(rng):
    s = Pair(init_capacity=4, chunk_pad=4)
    fb = _batch_rows(rng, b=8)
    s.both("stage_chunk", fb, list(range(8)))
    tail = s.both("tail", None, 3)
    s.same(*tail)
    np.testing.assert_array_equal(np_(tail[0].x), fb["x"][5:8])
    g = s.both("gather", None, [0, 7, 2])
    s.same(*g)
    np.testing.assert_array_equal(np_(g[0].y), fb["y"][[0, 7, 2]])


def test_view_masks_ghost_rows(rng):
    s = Pair(init_capacity=8, chunk_pad=4)
    s.both("stage_chunk", _batch_rows(rng, b=4), [0])  # pads row 0 into ghosts
    view = s.both("view")
    s.same(*view)                  # the ghost rows too
    assert view[0].x.shape[0] == s.t.capacity
    assert s.t.count == 1          # ghosts are beyond count
    # A later append overwrites the ghost region.
    f1 = _rows(rng)
    s.both("stage_single", f1)
    got = s.both("get", None, 1)
    s.same(*got)
    np.testing.assert_array_equal(np_(got[0].x), f1["x"])


def test_uncommitted_slot_raises():
    for store in (TStore(), JStore()):
        with pytest.raises(ValueError):
            store.get(-1)
