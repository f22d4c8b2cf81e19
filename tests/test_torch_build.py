"""How the port's kernels are built and how their bounds are counted, on
the CPU: a library's name follows its source and the headers it includes,
each source builds one library whose entry points are the ones the
wrappers load, the wrappers refuse what their kernels do not take before
anything is built, CPU tensors never reach a kernel, and
``chip_smoke.bound`` charges K1 at the tensor cores' rates."""

import ast
import importlib
import re
import shutil

import numpy as np
import pytest

import torch

import chip_smoke
from niftymatch_torch.config import RansacConfig
from niftymatch_torch.geometry import linalg as glinalg
from niftymatch_torch.geometry.ransac import ransac, ransac_plain
from niftymatch_torch.kernels import _build
from niftymatch_torch.kernels import linalg as klinalg
from niftymatch_torch.kernels import ransac as kransac
from niftymatch_torch.kernels import refine as krefine
from niftymatch_torch.utils import profiling


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, src)
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    return src


@pytest.mark.parametrize("name", _build.SOURCES)
def test_library_name_follows_source_and_headers(csrc_copy, name):
    """Editing a source or a header it includes renames the library, so
    the next use rebuilds it; editing another source, or a header it does
    not include, does not."""
    before = _build._lib_path(name)
    other = next(n for n in _build.SOURCES if n != name)
    (csrc_copy / f"{other}.cu").write_text("// another kernel\n")
    assert _build._lib_path(name) == before
    after_header = before
    for header in sorted(csrc_copy.glob("*.cuh")):
        includes = f'#include "{header.name}"' in (csrc_copy / f"{name}.cu").read_text()
        header.write_text(header.read_text() + "\n// edited\n")
        edited = _build._lib_path(name)
        assert (edited != after_header) == includes, header.name
        after_header = edited
    (csrc_copy / f"{name}.cu").write_text("// edited\n")
    assert _build._lib_path(name) not in (before, after_header)


def _loaded_entry_points():
    """Library name -> the C functions that ``kernels/`` loads from it: the
    keys of every ``_build.load("<name>", SIGNATURES)`` call's dict."""
    loaded = {}
    for path in sorted((_build.PKG_DIR / "kernels").glob("*.py")):
        module = importlib.import_module(f"niftymatch_torch.kernels.{path.stem}")
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "load"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "_build"):
                name, signatures = node.args
                key = name.value if isinstance(name, ast.Constant) else ast.unparse(name)
                loaded.setdefault(key, set()).update(getattr(module, signatures.id))
    return loaded


@pytest.mark.parametrize("name", _build.SOURCES)
def test_each_source_builds_one_library_with_the_entry_points_it_loads(name):
    """Each ``csrc/<name>.cu`` is built one way, with no macro of its own,
    and every C function it exports is one that ``kernels/`` loads from that
    library, and the other way round."""
    assert not any(f.startswith("-D") for f in _build._flags(name))
    exported = set(re.findall(r'extern "C"\s+\w+\s+(\w+)\s*\(',
                              _build._source(name).read_text()))
    assert exported and exported == _loaded_entry_points().get(name)


def test_solvers_device_code_is_shared_through_the_header():
    """``linalg.cu`` and ``ransac.cu`` both take the solvers' device code
    from ``linalg.cuh``, which exports and launches nothing itself;
    ``linalg.cu`` still exports its two entry points."""
    header = (_build.CSRC_DIR / "linalg.cuh").read_text()
    assert 'extern "C"' not in header and "__global__" not in header
    for body in ("void rotate(", "void cswap_desc(", "void svd3x3(",
                 "void smallest_eigvec("):
        assert body in header, body
    for name in ("linalg", "ransac"):
        text = _build._source(name).read_text()
        assert '#include "linalg.cuh"' in text
        assert "void rotate(" not in text and "void cswap_desc(" not in text
    assert _loaded_entry_points()["linalg"] == {"nm_svd3x3", "nm_smallest_eigvec"}


def test_every_kernel_has_a_counter_and_flags():
    assert set(_build.EXTRA_FLAGS) == set(_build.SOURCES)
    assert _build.EXTRA_FLAGS["windows"] == ["-fmad=false"]
    assert set(_build.LAUNCHES) == {"k1_match_top2", "k1_match_top2_bf16",
                                    "k2_orientation_hist", "k3_descriptor",
                                    "refine_gn", "svd3x3", "smallest_eigvec",
                                    "ransac_hypotheses", "ransac_refit"}
    assert "refine" in _build.SOURCES and _build.EXTRA_FLAGS["refine"] == []
    assert "linalg" in _build.SOURCES and _build.EXTRA_FLAGS["linalg"] == []
    assert "ransac" in _build.SOURCES and _build.EXTRA_FLAGS["ransac"] == []
    assert set(_build.K4_LAUNCHES) == {f"k4_fold_{f}" for f in _build.K4_FOLDS}
    _build.LAUNCHES["k3_descriptor"] = 3
    _build.K4_LAUNCHES["k4_fold_pipe"] = 2
    _build.reset_launches()
    assert not any(_build.LAUNCHES.values()) and not any(_build.K4_LAUNCHES.values())


def _no_build(*args, **kwargs):
    raise AssertionError("a CUDA library was built or loaded")


@pytest.mark.parametrize("bad", ["cpu", "shape", "iterations"])
def test_refine_wrapper_refuses_bad_inputs_before_building(monkeypatch, bad):
    """The polish kernel's wrapper takes CUDA tensors of the documented
    shapes only, and refuses anything else before it builds or launches."""
    monkeypatch.setattr(_build, "load", _no_build)
    monkeypatch.setattr(_build, "build_all", _no_build)
    args = [torch.eye(3), torch.tensor([1.0, 0.0, 0.0]), torch.zeros(8, 2),
            torch.zeros(8, 2), torch.ones(8)]
    kw = {}
    if bad == "shape":
        args[4] = torch.ones(7)
    if bad == "iterations":
        kw["iterations"] = -1
    with pytest.raises(ValueError):
        krefine.refine_relative_pose(*args, **kw)
    assert _build.LAUNCHES["refine_gn"] == 0


@pytest.mark.parametrize("bad", ["cpu", "shape", "n10", "sweeps", "iterations"])
def test_linalg_wrappers_refuse_bad_inputs_before_building(monkeypatch, bad):
    """The small-matrix kernels' wrappers take CUDA matrices of the sizes
    they are built for, and refuse anything else, with the reason, before
    they build or launch."""
    monkeypatch.setattr(_build, "load", _no_build)
    monkeypatch.setattr(_build, "build_all", _no_build)
    calls = {
        "cpu": (lambda: klinalg.svd3x3(torch.eye(3).expand(4, 3, 3)), "CUDA tensor"),
        "shape": (lambda: klinalg.svd3x3(torch.zeros(4, 3, 4)), "(..., 3, 3)"),
        "n10": (lambda: klinalg.smallest_eigvec(torch.zeros(4, 10, 10)), "n <= 9"),
        "sweeps": (lambda: klinalg.svd3x3(torch.eye(3), sweeps=-1), "sweeps must be >= 0"),
        "iterations": (lambda: klinalg.smallest_eigvec(torch.eye(4), -1),
                       "iterations must be >= 0"),
    }
    fn, reason = calls[bad]
    with pytest.raises(ValueError, match=re.escape(reason)):
        fn()
    assert _build.LAUNCHES["svd3x3"] == _build.LAUNCHES["smallest_eigvec"] == 0


@pytest.mark.parametrize("solver", ["svd3x3", "smallest_eigvec"])
def test_linalg_on_cpu_takes_the_plain_version(monkeypatch, tmp_path, solver):
    """CPU tensors never reach the kernels: the router gives the plain
    version's bits, counts every call in ``linalg.calls`` and none in
    ``linalg.fused``, and builds and launches nothing."""
    monkeypatch.setattr(_build, "load", _no_build)
    monkeypatch.setattr(_build, "build_all", _no_build)
    rng = torch.Generator().manual_seed(0)
    if solver == "svd3x3":
        args = (torch.randn(2, 5, 3, 3, generator=rng),)
    else:
        b = torch.randn(6, 8, 9, generator=rng)
        args = (b.transpose(-1, -2) @ b,)
    with profiling.trace(str(tmp_path)):
        got = getattr(glinalg, solver)(*args)
        getattr(glinalg, solver)(*args)
        counted = profiling.counts()
    want = getattr(glinalg, solver + "_plain")(*args)
    for g, w in zip(got if solver == "svd3x3" else (got,),
                    want if solver == "svd3x3" else (want,)):
        assert torch.equal(g, w)
    assert counted == {"linalg.calls": 2}
    assert not any(_build.LAUNCHES.values())


def _ransac_inputs(n=16, iters=6):
    rng = torch.Generator().manual_seed(0)
    src = torch.rand(n, 2, generator=rng) * 100
    dst = src + torch.tensor([3.0, -2.0])
    scores = -torch.log(torch.empty(iters, n).exponential_(generator=rng))
    return src, dst, torch.ones(n, dtype=torch.bool), scores


@pytest.mark.parametrize("bad", ["cpu", "dtype", "scores_shape", "model"])
def test_ransac_wrapper_refuses_bad_inputs_before_building(monkeypatch, bad):
    """The RANSAC kernels' wrapper takes CUDA tensors of the documented
    dtypes and shapes and the two models it fits, and refuses anything else,
    with the reason, before it builds or launches."""
    monkeypatch.setattr(_build, "load", _no_build)
    monkeypatch.setattr(_build, "build_all", _no_build)
    src, dst, mask, scores = _ransac_inputs()
    model = "homography"
    reason = "CUDA tensor"
    if bad == "dtype":   # the device is checked with the dtype: fake a CUDA tensor
        src = src.double()
        monkeypatch.setattr(_build, "require_cuda", _dtype_only)
        reason = "expected torch.float32"
    if bad == "scores_shape":
        monkeypatch.setattr(_build, "require_cuda", _dtype_only)
        scores = scores[:, :-1]
        reason = "scores: expected shape (6, 16)"
    if bad == "model":
        model, reason = "fundamental", "the RANSAC kernels fit ['essential', 'homography']"
    with pytest.raises(ValueError, match=re.escape(reason)):
        kransac.ransac(src, dst, mask, scores, 4.0, model)
    assert _build.LAUNCHES["ransac_hypotheses"] == _build.LAUNCHES["ransac_refit"] == 0


def _dtype_only(name, t, dtype, shape=None):
    """``_build.require_cuda`` without its device check, so a CPU tensor
    reaches the dtype and shape checks."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


@pytest.mark.parametrize("model", ["essential", "homography", "similarity"])
def test_ransac_on_cpu_takes_the_plain_version(monkeypatch, tmp_path, model):
    """CPU tensors never reach the RANSAC kernels: the router gives
    ``ransac_plain``'s bits, counts every call in ``ransac.calls`` and none
    in ``ransac.fused``, and builds and launches nothing."""
    monkeypatch.setattr(_build, "load", _no_build)
    monkeypatch.setattr(_build, "build_all", _no_build)
    src, dst, mask, scores = _ransac_inputs(n=40, iters=8)
    cfg = RansacConfig(iterations=8, inlier_threshold=1e-3 if model == "essential" else 4.0)
    with profiling.trace(str(tmp_path)):
        got = ransac(src, dst, mask, cfg, model=model, scores=scores, device="cpu")
        ransac(src, dst, mask, cfg, model=model, scores=scores, device="cpu")
        counted = profiling.counts()
    want = ransac_plain(src, dst, mask, cfg, model=model, scores=scores, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert counted.get("ransac.calls") == 2 and "ransac.fused" not in counted
    assert not any(_build.LAUNCHES.values())


def test_linalg_start_vector_is_the_plain_versions():
    """The kernel reads the plain version's fixed start vector: unit length,
    dense, the same for every call."""
    for n in (4, 9):
        v = klinalg.start_vector(n)
        assert v.dtype == np.float32 and v.shape == (n,)
        assert abs(float(np.linalg.norm(v)) - 1.0) < 1e-6 and (np.abs(v) > 1e-3).all()
        np.testing.assert_array_equal(v, klinalg.start_vector(n))


@pytest.mark.parametrize("products,rate,nbytes,want_ms", [
    (3, chip_smoke.PEAK_TF32_PER_S, 17104896, 0.0520602),   # K1 fp32, 3xTF32
    (1, chip_smoke.PEAK_BF16_PER_S, 8716288, 0.0086855),    # K1 bf16
])
def test_k1_bound_counts_tensor_core_work(products, rate, nbytes, want_ms):
    """The main path's K1 (8 pairs of 2048 x 2048 x 128) is bound by its
    products at the tensor cores' rate, not by its bytes."""
    ops = products * 2 * 8 * 2048 * 2048 * 128
    ms, by = chip_smoke.bound(nbytes, ops, rate)
    assert by == "operations"
    assert ms == pytest.approx(want_ms, rel=1e-5)
    assert nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3 < ms


def test_window_bounds_keep_the_fp32_rate():
    ms, by = chip_smoke.bound(48244812, 228283839)
    assert by == "bytes" and ms == pytest.approx(0.0144014, rel=1e-5)
    ms, by = chip_smoke.bound(1, 67e9)
    assert by == "operations" and ms == pytest.approx(1.0)
