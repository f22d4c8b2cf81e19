"""The port's multi-device layer (``niftymatch_torch/parallel``: meshes,
the ring all-pairs sweep, ``shard_detect``, the closure's ring sweep and
``dryrun_multichip``) against the JAX package on the conftest's 8-device
CPU mesh.  The port runs on gloo process groups of 2-4 spawned CPU
processes (``parallel.spawn.run``, ``file://`` rendezvous in a temporary
directory); the tasks they run are in ``torch_spawn_tasks.py``.

Tolerances: ring counts and indices equal JAX's exactly at every world
size, with and without ``mutual`` (the inputs hold no exact duplicate
descriptors, whose ratio test is a coin flip); the closure's sweep
through the ring equal to the single-process sweep exactly; the sharded
detector's gathered features within ``test_torch_sift.py``'s bars (x, y,
sigma, angle, response 1e-4, descriptors 2e-3, valid counts equal,
compared sorted by (x, y)); the dry run's match total equal to JAX's and
its BA costs within 1e-4 relative.
"""

import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import niftymatch_torch as nt
import torch_spawn_tasks as tasks
from niftymatch_torch.dryrun import dryrun_multichip
from niftymatch_torch.parallel import (
    initialize_distributed,
    local_batch_slice,
    make_keyframe_mesh,
    spawn,
)
from niftymatch_torch.slam.closure import LoopCloser
from niftymatch_tpu import SiftConfig, make_detector
from niftymatch_tpu.parallel import make_keyframe_mesh as jax_mesh
from niftymatch_tpu.parallel import multihost as jax_multihost
from niftymatch_tpu.parallel import ring_allpairs_match, shard_detect
from test_parallel import _fake_descriptors
from test_torch_sift import _assert_features_close
from torch_parity import port_config, structured_image

RUNS = [dict(ambiguity=0.8, mutual=False, return_indices=True),
        dict(ambiguity=0.7, mutual=True, return_indices=True),
        dict(phase="compute", return_indices=True),
        dict(phase="comm")]


@pytest.fixture(scope="module")
def ring_inputs():
    """``tests/test_parallel.py``'s inputs: 16 frames of 24 x 32 (pairs
    sharing content) and the 13-frame case that pads at every world."""
    rng = np.random.default_rng(42)
    a = _fake_descriptors(rng, 16, 24)
    d, v = _fake_descriptors(rng, 14, 24)
    return [a, (d[:13], v[:13])]


@pytest.fixture(scope="module")
def jax_ring(ring_inputs):
    mesh = jax_mesh(8)
    return [[ring_allpairs_match(jnp.asarray(d), jnp.asarray(v), mesh, **kw)
             for kw in RUNS[:2]] for d, v in ring_inputs]


def test_mesh_helpers_single_process():
    initialize_distributed()             # a no-op for one process, as in JAX
    assert local_batch_slice(16) == jax_multihost.local_batch_slice(16) == slice(0, 16)
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_keyframe_mesh(device_type="cpu")


def test_mesh_helpers_world4(monkeypatch):
    """Mesh sizes and names, the over-request error, each rank's batch
    slice, the (hosts, ranks per host) mesh with LOCAL_WORLD_SIZE=2, and
    the ring shift, all-reduce and all-gather of ``parallel/comm.py``."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    out = spawn.run(tasks.mesh_task, 4, device="cpu")
    for r, o in enumerate(out):
        assert o["rank"] == r and o["world"] == 4
        assert o["kf_size"] == 4 and o["kf_names"] == ("kf",)
        assert o["over_request"] and "fake scaling" in o["over_request"]
        assert o["slice"] == slice(4 * r, 4 * r + 4)
        assert o["hier_shape"] == (2, 2) and o["hier_names"] == ("host", "kf")
        assert o["hier_kf_group"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert o["shifted"] == [float((r - 1) % 4)] * 3       # ppermute to (i + 1) % n
        assert o["summed"] == [4.0, 4.0] and o["gathered"] == [0, 1, 2, 3]


@pytest.mark.parametrize("world", [2, 3, 4])
def test_ring_matches_jax(world, ring_inputs, jax_ring):
    """Counts and indices of the ring at ``world`` ranks, each passing its
    own frames (K = 16 and the padded K = 13), against JAX's ring on 8
    devices, with and without ``mutual``; every rank returns the whole
    result; the "compute" and "comm" modes return the full shapes; the
    ranks' rows tile the batch in order, and a rank that passes the whole
    batch is refused."""
    out = spawn.run(tasks.ring_task, world, ring_inputs, RUNS, device="cpu")
    for a, (desc, _) in enumerate(ring_inputs):
        rows = [list(range(len(desc)))[o["rows"][a]] for o in out]
        assert sum(rows, []) == list(range(len(desc)))
        assert len(rows[0]) == -(-len(desc) // world)
    assert all(o["whole"] and "holds 13 frames" in o["whole"] for o in out)
    for a, (desc, _) in enumerate(ring_inputs):
        K, N = desc.shape[:2]
        for b in range(2):
            want = jax_ring[a][b]
            for rank in out:
                counts, idx = rank[a, b]
                np.testing.assert_array_equal(counts.numpy(), np.asarray(want.counts))
                np.testing.assert_array_equal(idx.numpy(), np.asarray(want.indices))
        counts, idx = out[0][a, 2]
        assert counts.shape == (K, K) and idx.shape == (K, K, N)
        counts, idx = out[0][a, 3]
        assert counts.shape == (K, K) and idx is None
        assert int(out[0][a, 0][0].diagonal().min()) > 0     # the trivial self-match


def test_shard_detect_world2_matches_jax():
    """4 frames of 96x128 through ``shard_detect`` at world 2 (each rank
    its 2 rows, gathered) against JAX's ``shard_detect`` on a 2-device
    mesh."""
    H, W = 96, 128
    jcfg = SiftConfig(width=W, height=H, max_keypoints_per_level=64, max_features=256)
    frames = np.stack([structured_image(H, W, seed=s) for s in range(4)])
    out = spawn.run(tasks.detect_task, 2, frames, port_config(jcfg), device="cpu")
    want = shard_detect(make_detector(jcfg), jnp.asarray(frames), jax_mesh(2))
    for r, (mine, gathered) in enumerate(out):
        for field in nt.Features._fields:
            assert torch.equal(getattr(mine, field), getattr(gathered, field)[2 * r:2 * r + 2])
        for k in range(4):
            _assert_features_close(nt.Features(*[t[k] for t in gathered]),
                                   type(want)(*[np.asarray(t[k]) for t in want]))


def test_closure_sweep_through_the_ring_world2():
    """``LoopCloser.sweep`` with a 2-rank process group (the ring) equals
    its sweep in one process (the oracle), on both ranks."""
    rng = np.random.default_rng(3)
    K, N = 7, 48
    desc = rng.normal(size=(K, N, 128)).astype(np.float32)
    for k in range(1, K):               # every frame shares half its slots with frame 0
        desc[k, : N // 2] = desc[0, : N // 2] + 0.05 * rng.normal(size=(N // 2, 128))
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    valid = np.ones((K, N), bool)
    valid[:, -4:] = False
    buf = SimpleNamespace(desc=torch.from_numpy(desc), valid=torch.from_numpy(valid))
    system = SimpleNamespace(keyframes=[None] * K, _store=SimpleNamespace(view=lambda: buf))
    want = LoopCloser(system).sweep().counts
    assert int(want[0, 1:].min()) > 0
    for counts in spawn.run(tasks.sweep_task, 2, desc, valid, device="cpu"):
        assert torch.equal(counts, want)


_LINE = re.compile(r"mesh=.*'kf': (\d+)\}\)?, counts \((\d+), (\d+)\), total=(\d+), "
                   r"ba cost ([\d.]+) -> ([\d.]+)")


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_matches_jax(n, capsys):
    """The dry run on n CPU ranks against ``__graft_entry__.dryrun_multichip``
    on the 8-device mesh: the same mesh, counts shape and match total, the
    BA costs within 1e-4 relative."""
    import __graft_entry__

    got = _LINE.search(dryrun_multichip(n, device="cpu")).groups()
    capsys.readouterr()
    __graft_entry__.dryrun_multichip(n)
    want = _LINE.search(capsys.readouterr().out).groups()
    assert got[:4] == want[:4] == (str(n), str(2 * n), str(2 * n), got[3])
    np.testing.assert_allclose([float(g) for g in got[4:]], [float(w) for w in want[4:]],
                               rtol=1e-4)
