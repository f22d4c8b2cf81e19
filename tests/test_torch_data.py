"""The port's dataset readers and writers (``niftymatch_torch/data/{png,
tum,euroc,native_loader}.py``) against the JAX package's on the same
files, written into ``tmp_path`` (no dataset is needed).

Tolerances: none.  The PNG writer's bytes, the parsed trajectories,
associations, sequences and quaternions equal the JAX package's
exactly; the native decoder's frames equal the JAX binding's and the
written uint8/uint16 arrays exactly (RGB to gray within 0.01 of the
reference's 0.21/0.72/0.07 weights).
"""

import numpy as np
import pytest

from niftymatch_torch.data import euroc, native_loader, png, tum
from niftymatch_tpu.data import euroc as jeuroc
from niftymatch_tpu.data import native_loader as jnative
from niftymatch_tpu.data import png as jpng
from niftymatch_tpu.data import tum as jtum
from test_euroc_io import _write_sequence


def _equal(a, b):
    """Two results (NamedTuples, tuples, lists or arrays) equal exactly."""
    if isinstance(a, tuple | list):
        assert type(a) is type(b) or (hasattr(a, "_fields") and a._fields == b._fields)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_png_bytes_equal_jax(tmp_path, rng, kind):
    shape, depth = {"gray8": ((24, 32), 8), "rgb8": ((6, 5, 3), 8),
                    "gray16": ((16, 20), 16)}[kind]
    arr = rng.uniform(0, 2**depth - 1, shape).astype(np.uint8 if depth == 8 else np.uint16)
    png.write_png(str(tmp_path / "t.png"), arr, bitdepth=depth)
    jpng.write_png(str(tmp_path / "j.png"), arr, bitdepth=depth)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def test_quaternions_and_poses_equal_jax(rng):
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = tum.quaternion_to_rotation(q)
        _equal(R, jtum.quaternion_to_rotation(q))
        _equal(tum.rotation_to_quaternion(R), jtum.rotation_to_quaternion(R))
    # A rotation with negative trace takes the other branch.
    R = np.diag([1.0, -1.0, -1.0])
    _equal(tum.rotation_to_quaternion(R), jtum.rotation_to_quaternion(R))
    poses = np.concatenate([np.stack([tum.quaternion_to_rotation(q) for q in
                                      rng.normal(size=(5, 4))]),
                            rng.normal(size=(5, 3, 1))], axis=-1)
    _equal(tum.poses_to_trajectory(poses), jtum.poses_to_trajectory(poses))


def test_trajectory_files_cross_read(tmp_path, rng):
    """A trajectory written by either package reads back the same in both."""
    n = 10
    traj = tum.Trajectory(timestamps=np.arange(n) * 0.1 + 1e9,
                          positions=rng.normal(size=(n, 3)),
                          quaternions=rng.normal(size=(n, 4)))
    tum.write_trajectory(str(tmp_path / "t.txt"), traj)
    jtum.write_trajectory(str(tmp_path / "j.txt"), jtum.Trajectory(*traj))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    _equal(tuple(tum.read_trajectory(str(tmp_path / "j.txt"))),
           tuple(jtum.read_trajectory(str(tmp_path / "t.txt"))))


def test_associate_equals_jax(rng):
    ta = np.sort(rng.uniform(0, 2, 60))
    tb = np.sort(rng.uniform(0, 2, 45))
    for max_dt in (0.005, 0.02, 0.1):
        _equal(tum.associate(ta, tb, max_dt), jtum.associate(ta, tb, max_dt))


def _tum_dir(root, rng, n=5):
    (root / "rgb").mkdir()
    frames = rng.uniform(0, 255, (n, 12, 16)).astype(np.uint8)
    with open(root / "rgb.txt", "w") as f:
        f.write("# timestamp filename\n")
        for i, img in enumerate(frames):
            png.write_png(str(root / "rgb" / f"{i}.png"), img)
            f.write(f"{1e9 + 0.05 * i:.6f} rgb/{i}.png\n")
    tum.write_trajectory(str(root / "groundtruth.txt"), tum.Trajectory(
        1e9 + 0.05 * np.arange(n), rng.normal(size=(n, 3)), np.tile([0, 0, 0, 1.0], (n, 1))))
    return frames


def test_tum_sequence_equals_jax(tmp_path, rng):
    frames = _tum_dir(tmp_path, rng)
    got, want = tum.load_sequence(str(tmp_path)), jtum.load_sequence(str(tmp_path))
    assert got.rgb_paths == want.rgb_paths
    _equal(got.rgb_times, want.rgb_times)
    _equal(tuple(got.groundtruth), tuple(want.groundtruth))
    with native_loader.PrefetchLoader(got.rgb_paths, threads=2) as loader:
        _equal(np.stack(list(loader)), frames.astype(np.float32))


@pytest.mark.parametrize("yaml", [True, False])
def test_euroc_sequence_equals_jax(tmp_path, yaml):
    _write_sequence(tmp_path)
    if not yaml:
        (tmp_path / "mav0" / "cam0" / "sensor.yaml").unlink()
    got, want = euroc.load_sequence(str(tmp_path)), jeuroc.load_sequence(str(tmp_path))
    assert got.cam_paths == want.cam_paths
    assert got.intrinsics == want.intrinsics and got.distortion == want.distortion
    _equal(got.cam_times, want.cam_times)
    _equal(tuple(got.groundtruth), tuple(want.groundtruth))


def test_native_loader_equals_jax(tmp_path, rng):
    """The port's own binding builds the library and decodes what the JAX
    binding decodes: gray, RGB, 16-bit depth, a bad file, and a prefetch
    over frames of two sizes."""
    assert native_loader.available()
    gray = rng.uniform(0, 255, (24, 32)).astype(np.uint8)
    rgb = np.stack([np.full((4, 4), v, np.uint8) for v in (100, 200, 50)], -1)
    depth = rng.uniform(0, 65535, (16, 20)).astype(np.uint16)
    small = rng.uniform(0, 255, (4, 4)).astype(np.uint8)
    paths = {k: str(tmp_path / f"{k}.png") for k in ("gray", "rgb", "depth", "small")}
    png.write_png(paths["gray"], gray)
    png.write_png(paths["rgb"], rgb)
    png.write_png(paths["depth"], depth, bitdepth=16)
    png.write_png(paths["small"], small)
    (tmp_path / "junk.png").write_bytes(b"not a png at all, definitely not")

    assert native_loader.png_info(paths["gray"]) == jnative.png_info(paths["gray"]) \
        == (32, 24, 1, 8)
    assert native_loader.png_info(str(tmp_path / "junk.png")) is None
    _equal(native_loader.read_gray(paths["gray"]), gray.astype(np.float32))
    _equal(native_loader.read_gray(paths["rgb"]), jnative.read_gray(paths["rgb"]))
    np.testing.assert_allclose(native_loader.read_gray(paths["rgb"]),
                               0.21 * 100 + 0.72 * 200 + 0.07 * 50, atol=0.01)
    _equal(native_loader.read_depth16(paths["depth"]), depth)
    with pytest.raises(ValueError):
        native_loader.read_depth16(paths["gray"])
    order = [paths["gray"], paths["small"], paths["gray"]]
    with native_loader.PrefetchLoader(order, threads=3) as loader:
        got = list(loader)
    jl = jnative.PrefetchLoader(order, threads=3)
    want = list(jl)
    jl.close()
    assert len(got) == 3 and got[1].shape == (4, 4)
    for g, w in zip(got, want):
        _equal(g, w)
