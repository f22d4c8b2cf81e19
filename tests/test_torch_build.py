"""How the port's kernels are built and how their bounds are counted, on
the CPU: a library's name follows its source and the headers it includes,
the timing variants live only in their own libraries, and
``chip_smoke.bound`` charges K1 at the tensor cores' rates."""

import shutil

import pytest

import chip_smoke
from niftymatch_torch.kernels import _build


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


@pytest.mark.parametrize("name,entry", [("match", "nm_match_top2_variant"),
                                        ("descriptors", "nm_descriptors_variant"),
                                        ("windows", "nm_orientation_hists_variant"),
                                        ("fold_micro", "nm_fold_variant_noturns"),
                                        ("fold_micro", "nm_fold_variant_k1loop")])
def test_timing_variants_build_only_into_their_own_library(name, entry):
    """The timing variants' entry point is compiled only under
    NM_TIMING_VARIANTS, which only the ``<source>_timing`` library sets."""
    timing = name + _build.TIMING
    assert "-DNM_TIMING_VARIANTS" in _build._flags(timing)
    assert not any("TIMING" in f for n in _build.SOURCES for f in _build._flags(n))
    assert _build._source(timing) == _build._source(name)
    assert _build._lib_path(timing) != _build._lib_path(name)
    text = _build._source(name).read_text()
    assert text.index("#ifdef NM_TIMING_VARIANTS") < text.index(entry) \
        < text.index("#endif", text.index("#ifdef NM_TIMING_VARIANTS"))


def test_every_kernel_has_a_counter_and_flags():
    assert set(_build.EXTRA_FLAGS) == set(_build.SOURCES)
    assert _build.EXTRA_FLAGS["windows"] == ["-fmad=false"]
    assert set(_build.LAUNCHES) == {"k1_match_top2", "k1_match_top2_bf16",
                                    "k2_orientation_hist", "k3_descriptor"}
    assert set(_build.K4_LAUNCHES) == {f"k4_fold_{f}" for f in _build.K4_FOLDS}
    _build.LAUNCHES["k3_descriptor"] = 3
    _build.K4_LAUNCHES["k4_fold_pipe"] = 2
    _build.reset_launches()
    assert not any(_build.LAUNCHES.values()) and not any(_build.K4_LAUNCHES.values())


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
