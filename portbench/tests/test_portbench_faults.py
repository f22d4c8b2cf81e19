"""The comparison fails a run whose timed path is broken underneath, once
for each fault a cell can have (no cell spans chips, so the exchange
between chips has no case), and passes the sound run."""

import numpy as np
import pytest
import torch

import niftymatch_torch as nt
from niftymatch_torch import sift as nt_sift
from niftymatch_torch.parallel import matching as nt_matching
from niftymatch_torch.slam import system as nt_system

from portbench.reference import scenes

from .small import run_small, small_cell


def test_sound_runs_are_correct():
    for cell in ("pairs.sift640", "sweep.slam640", "exhaustive.sift640"):
        out = run_small(cell)
        assert out["correct"], (cell, out["checks"])


def _altered_indices(monkeypatch):
    orig = nt_sift.match_pair

    def altered(*a, **k):
        m = orig(*a, **k)
        idx = torch.where(m.indices >= 0, (m.indices + 1) % m.indices.shape[-1], m.indices)
        return m._replace(indices=idx)

    monkeypatch.setattr(nt, "match_pair", altered)


def _half_batch(monkeypatch):
    orig = nt_sift.detect_and_describe_batch

    def half(images, config, device=None):
        h = images.shape[0] // 2
        f = orig(images[:h], config, device=device)
        return nt.Features(*[torch.cat([t, t]) for t in f])

    monkeypatch.setattr(nt, "detect_and_describe_batch", half)


def _stale_state(monkeypatch):
    """Each call hands back the state the previous call left."""
    orig = nt_sift.detect_and_describe_batch
    last = []

    def stale(images, config, device=None):
        fresh = orig(images, config, device=device)
        out = last[0] if last else fresh
        last[:] = [fresh]
        return out

    monkeypatch.setattr(nt, "detect_and_describe_batch", stale)


@pytest.mark.parametrize("fault", [_altered_indices, _half_batch, _stale_state],
                         ids=["answer_altered", "half_batch", "state_unchanged"])
def test_pairs_faults_fail(monkeypatch, fault):
    fault(monkeypatch)
    assert not run_small("pairs.sift640")["correct"]


def _sweep_altered(monkeypatch):
    orig = nt_matching.allpairs_match_fused

    def altered(*a, **k):
        r = orig(*a, **k)
        idx = torch.where(r.indices >= 0, (r.indices + 1) % r.indices.shape[-1], r.indices)
        return r._replace(indices=idx)

    monkeypatch.setattr(nt_matching, "allpairs_match_fused", altered)


def _sweep_half(monkeypatch):
    orig = nt_matching.allpairs_match_fused

    def half(desc, valid, **k):
        h = desc.shape[0] // 2
        keep = torch.zeros_like(valid)
        keep[:h] = valid[:h]
        return orig(desc, keep, **k)

    monkeypatch.setattr(nt_matching, "allpairs_match_fused", half)


@pytest.mark.parametrize("cell", ["sweep.slam640", "exhaustive.sift640"])
@pytest.mark.parametrize("fault", [_sweep_altered, _sweep_half],
                         ids=["answer_altered", "half_batch"])
def test_sweep_faults_fail(monkeypatch, cell, fault):
    fault(monkeypatch)
    assert not run_small(cell)["correct"]


@pytest.fixture
def small_track(monkeypatch):
    """The SLAM cell at 128 x 96 with the focal length scaled with the
    frame, so that a sound run tracks (13 frames, 600 landmarks)."""
    orig = scenes.make_scene

    def scaled(*a, **k):
        s = orig(*a, **k)
        f = 525.0 * s.width / 640.0
        return s._replace(intrinsics=np.array([f, f, s.width / 2.0, s.height / 2.0],
                                              np.float32))

    monkeypatch.setattr(scenes, "make_scene", scaled)
    cell = small_cell("track.slam640")
    cell.mix.update(frames=13, landmarks=600)
    return cell


def _track_unchanged(monkeypatch):
    """Every frame reported as a keyframe while the poses stay where the
    session started."""
    def unchanged(self, frames, chunk=None):
        new = len(frames)
        if not self.keyframes:
            feats = nt.detect_and_describe(self._images(frames[:1])[0], self._sift,
                                           device=self.device)
            self._first_keyframe(feats)
            new -= 1
        for _ in range(new):
            kf = self.keyframes[0]
            self.keyframes.append(type(kf)(index=len(self.keyframes), feats=kf.feats,
                                           pose=kf.pose, track_ids=kf.track_ids))
        return [{"keyframe": True}] * len(frames)

    monkeypatch.setattr(nt_system.SlamSystem, "process_frames", unchanged)


def _track_half(monkeypatch):
    """Half of each chunk's frames left out."""
    orig = nt_system.SlamSystem.process_frames

    def half(self, frames, chunk=None):
        return orig(self, frames[: (len(frames) + 1) // 2], chunk)

    monkeypatch.setattr(nt_system.SlamSystem, "process_frames", half)


def _track_altered(monkeypatch):
    """Each keyframe's pose moved where the system reports it."""
    orig = nt_system.SlamSystem.poses

    def altered(self):
        p = orig(self).copy()
        p[:, :, 3] += np.random.default_rng(0).normal(0.0, 1.0, p[:, :, 3].shape)
        return p

    monkeypatch.setattr(nt_system.SlamSystem, "poses", altered)


def test_track_sound_run_is_correct(small_track):
    out = run_small("track.slam640", cell=small_track, seconds=0.1)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_track_unchanged, _track_half, _track_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_track_faults_fail(monkeypatch, small_track, fault):
    fault(monkeypatch)
    assert not run_small("track.slam640", cell=small_track, seconds=0.1)["correct"]
