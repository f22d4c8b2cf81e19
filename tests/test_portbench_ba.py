"""The ``solve.ba1dsfm`` cell of the port's benchmark on the CPU, at 8
cameras x 512 points x 384 observations a camera: ``bundle_adjust_cg``
against the plain float64 reference (``portbench/reference/ba.py``), the
control and a first LM cost off by TF32's margin failing the comparison,
the cell's five readers on a hand-built trace (and ``None`` from the four
that read the program's regions when it opens none), the roofline counts on hand-counted shapes, and the PCG
solver's ``nm.ba.*`` regions and ``ba_cg.*`` counters, which the dense
window solver (``sfm/ba.py``, shared with ``track.slam640``) must not
open or keep."""

import copy
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import niftymatch_torch as nt
from niftymatch_torch.sfm import ba as sfm_ba
from niftymatch_torch.utils import profiling
from portbench import harness
from portbench.counts import ba as counts_ba
from portbench.reference import ba as ref_ba
from portbench.trace import DeviceOp, Spans, Trace

CELL = "solve.ba1dsfm"
SMALL = {"cameras": 8, "points": 512, "max_obs_per_cam": 384}
# The harness's runs at fewer iterations: the comparison is the same.
FEW = {"max_iterations": 3, "cg_iterations": 8}
SEEDS = (2**31 + 11, 5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Thousands of small operations a solve: one thread each, so that
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_cell(**mix_keys) -> harness.Cell:
    """The cell at ``SMALL`` and ``FEW`` iterations, a pool of 2 problems
    by default."""
    c = harness.Cell(CELL)
    cfg, mix = copy.deepcopy(c.config), copy.deepcopy(c.mix)
    cfg["scene"].update(SMALL)
    cfg["ba"].update(FEW)
    mix.update({"pool": 2, **mix_keys})
    return harness.Cell(CELL, config=cfg, mix=mix)


# A traced slice of two steps makes the run take at least two, so both
# problems of the pool run however slow the machine is.
FORCED = {"trace": {"skip": 0, "steps": 2}}


@pytest.fixture(scope="module")
def cell():
    return _small_cell()


def _state(cell, seed):
    return cell.gen.setup(cell.config, cell.mix, seed, "cpu", Spans())


@pytest.mark.parametrize("seed", SEEDS)
def test_program_matches_the_float64_reference(cell, seed):
    """At the configuration's own iterations."""
    st = _state(cell, seed)
    ba = harness.Cell(CELL).config["ba"]
    assert st.pool[0].obs_uv.shape[0] == SMALL["cameras"] * SMALL["max_obs_per_cam"]
    prob = st.pool[seed % 2]
    _, stats = nt.bundle_adjust_cg(nt.BAProblem(*prob), nt.BAConfig(**ba), device="cpu")
    ref = ref_ba.solve(prob, ba)
    assert abs(float(stats.initial_cost) - ref.initial_cost) <= 1e-6 * ref.initial_cost
    np.testing.assert_allclose(stats.costs.double().numpy(), ref.costs, rtol=1e-4)
    assert ref.costs[-1] < 0.1 * ref.initial_cost


def test_control_breaks_a_limit_the_program_keeps(cell):
    st = _state(cell, SEEDS[0])
    for _ in range(len(st.pool)):
        cell.gen.step(st)
    cell.gen.release(st)
    limits = cell.mix["limits"]
    program, control = cell.gen.program_numbers(st), cell.gen.control(st)
    assert all(program[n] <= limits[n] for n in limits), program
    assert any(control[n] > limits[n] for n in limits), control


def test_sound_runs_are_correct():
    traced = harness.run(_small_cell(**FORCED), SEEDS[1], 0.0, True, "cpu", log=lambda m: None)
    assert traced["correct"], traced["checks"]
    assert traced["attempted"] >= 2 and traced["failed"] == 0
    assert set(traced["metrics"]) <= set(EXPECTED)
    one = harness.run(_small_cell(pool=1), SEEDS[1], 0.0, False, "cpu",
                      log=lambda m: None)
    assert one["correct"], one["checks"]
    assert set(one["metrics"]) == {"images_per_s", "setup_s"}


def test_stale_answers_fail(monkeypatch):
    """A solver that hands back the previous call's answer."""
    orig, last = nt.bundle_adjust_cg, []

    def stale(*a, **k):
        fresh = orig(*a, **k)
        out = last[0] if last else fresh
        last[:] = [fresh]
        return out

    monkeypatch.setattr(nt, "bundle_adjust_cg", stale)
    out = harness.run(_small_cell(**FORCED), SEEDS[1], 0.0, True, "cpu", log=lambda m: None)
    assert not out["correct"] and out["failed"] > 0


def test_a_first_step_off_by_tf32s_margin_fails(monkeypatch):
    """A solver whose first LM cost is 2e-5 off, as TF32 products leave it
    on the card, and whose other numbers stay within their limits: only
    ``cost1_gap`` tells it from the program."""
    orig = nt.bundle_adjust_cg

    def off(*a, **k):
        solved, stats = orig(*a, **k)
        costs = stats.costs.clone()
        costs[0] *= 1 + 2e-5
        return solved, stats._replace(costs=costs)

    monkeypatch.setattr(nt, "bundle_adjust_cg", off)
    out = harness.run(_small_cell(**FORCED), SEEDS[1], 0.0, True, "cpu", log=lambda m: None)
    broken = {n for n, c in out["checks"].items() if c["value"] > c["limit"]}
    assert not out["correct"] and broken == {"cost1_gap"} and out["failed"] > 0


MS = 1_000_000  # ns


def _trace(program_spans=True) -> Trace:
    spans = [("ba.solve", 0, 1000 * MS), ("ba.fetch", 1000 * MS, 1010 * MS)]
    if program_spans:
        spans += [("nm.ba.solve", 10 * MS, 990 * MS), ("nm.ba.layout", 20 * MS, 30 * MS),
                  ("nm.ba.linearize", 100 * MS, 200 * MS), ("nm.ba.pcg", 200 * MS, 800 * MS),
                  ("nm.ba.backsub", 800 * MS, 850 * MS)]

    def span(name):
        return name if program_spans else "ba.solve"

    ops = [DeviceOp("argsort", 25 * MS, MS, span("nm.ba.layout"), True),
           DeviceOp("jacobians", 150 * MS, 4 * MS, span("nm.ba.linearize"), True),
           DeviceOp("gemm", 300 * MS, 10 * MS, span("nm.ba.pcg"), True),
           DeviceOp("gemm", 400 * MS, 10 * MS, span("nm.ba.pcg"), True),
           DeviceOp("gather", 820 * MS, 2 * MS, span("nm.ba.backsub"), True),
           DeviceOp("cost", 900 * MS, 3 * MS, span("nm.ba.solve"), True),
           DeviceOp("Memset (Device)", 905 * MS, MS, span("nm.ba.solve"), False),
           DeviceOp("Memcpy DtoH (Device -> Pinned)", 1005 * MS, MS, "ba.fetch", False)]
    return Trace(ops, spans, (0, 1010 * MS), 32 * MS, [("ba.solve", 978 * MS)])


INFO = {"steps": 2}
COUNTERS = {"ba_cg.solves": 2, "ba_cg.lm_iterations": 12, "ba_cg.cg_iterations": 288,
            "ba_cg.observations": 2 * 4096, "ba_cg.cameras": 2 * 8, "ba_cg.landmarks": 2 * 1024}
EXPECTED = {
    "pcg_ms.solve": 20 / 2,
    "linearize_ms.solve": 4 / 2,
    "ba_launches.solve": 6 / 2,          # kernels under nm.ba.*, copies and sets not
    "solve_roofline.solve": 100.0 * 2 * counts_ba.solve_bound_s(4096, 8, 1024, 6, 24)[0] / 0.030,
    "idle_share.images": 100.0 * (1 - 32 / 1010),
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader(metric, monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTS", dict(COUNTERS))
    read = harness.reader(metric).read
    assert read(_trace(), INFO) == pytest.approx(EXPECTED[metric])
    without = read(_trace(program_spans=False), INFO)
    if metric.startswith("idle_share"):
        assert without == pytest.approx(EXPECTED[metric])   # the device's, spans or not
    else:
        assert without is None


def test_roofline_reads_nothing_without_the_counters(monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTS", {})
    assert harness.reader("solve_roofline.solve").read(_trace(), INFO) is None


def test_readers_are_declared_for_the_cell():
    bench = harness.benchmark()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in EXPECTED:
        m = declared[name]
        device = name.startswith("idle_share")
        assert m["workloads"] == (["pairs.sift640", CELL] if device else [CELL])
        assert m["moves"] == "images_per_s"
        assert m["layer"] == ("Device" if device else "Global BA")
    e2e, layer = harness.cell_metrics(bench, CELL)
    assert {m["name"] for m in e2e} == {"images_per_s", "setup_s"}
    assert {m["name"] for m in layer} == set(EXPECTED)
    entry = harness.cell_entry(bench, CELL)
    assert entry["chips"] == 1 and entry["config"] == "ba1dsfm"


@pytest.mark.parametrize("shape, nbytes, ops", [
    # One LM iteration of one CG iteration on 2 observations, 1 camera, 1 point:
    # bytes 16 x 2 + 2 x 4 x (12 + 3) per linearisation, 2 applies of 8 x 2 + 2 x 4 x 6;
    # operations 544 x 2 per linearisation, 2 applies of 68 x 2 + 15, 204 for the camera.
    ((2, 1, 1, 1, 1), 32 + 120 + 2 * (16 + 48), 1088 + 2 * 151 + 204),
    ((2_097_152, 512, 131_072, 6, 24),
     6 * (16 * 2_097_152 + 8 * (12 * 512 + 3 * 131_072)
          + 25 * (8 * 2_097_152 + 48 * 512)),
     6 * (544 * 2_097_152 + 25 * (68 * 2_097_152 + 15 * 131_072) + 24 * 204 * 512)),
])
def test_roofline_counts(shape, nbytes, ops):
    assert counts_ba.solve_bytes(*shape) == nbytes
    assert counts_ba.solve_ops(*shape) == ops
    s, by = counts_ba.solve_bound_s(*shape)
    assert math.isclose(s, max(nbytes / 3.35e12, ops / 67e12)) and by in ("bytes", "operations")


def test_roofline_from_counters_is_per_solve():
    one = counts_ba.solve_bound_s(4096, 8, 1024, 6, 24)[0]
    assert counts_ba.bound_from_counters(COUNTERS) == pytest.approx(2 * one)
    assert counts_ba.bound_from_counters({}) is None


def _tiny_problem():
    cfg = copy.deepcopy(harness.Cell(CELL).config)
    cfg["scene"].update(cameras=4, points=64, max_obs_per_cam=48)
    mix = {"pool": 1}
    st = harness.generator("ba").setup(cfg, mix, 3, "cpu", Spans())
    return nt.BAProblem(*st.pool[0])


def _spans(logdir):
    events = json.loads((Path(logdir) / "trace.json").read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"].startswith("nm.")),
                  key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_pcg_regions_nest_and_counters_count(tmp_path):
    prob = _tiny_problem()
    cfg = nt.BAConfig(max_iterations=3, damping=1e-3, cg_iterations=5)
    with profiling.trace(str(tmp_path)):
        nt.bundle_adjust_cg(prob, cfg, device="cpu")
        counted = profiling.counts()
    spans = _spans(tmp_path)
    solve = [s for s in spans if s[0] == "nm.ba.solve"]
    assert len(solve) == 1 and all(_inside(s, solve[0]) for s in spans)
    inner = [s[0] for s in spans if s is not solve[0]]
    assert inner == ["nm.ba.layout"] + ["nm.ba.linearize", "nm.ba.pcg", "nm.ba.backsub"] * 3
    O = prob.obs_uv.shape[0]
    assert counted == {"ba_cg.solves": 1, "ba_cg.lm_iterations": 3, "ba_cg.cg_iterations": 15,
                       "ba_cg.observations": O, "ba_cg.cameras": 4, "ba_cg.landmarks": 64}


def test_pcg_regions_cost_nothing_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    before = profiling.counts()
    nt.bundle_adjust_cg(_tiny_problem(), nt.BAConfig(max_iterations=1, cg_iterations=2),
                        device="cpu")
    assert profiling.counts() == before


def test_window_solver_opens_no_region_and_keeps_no_counter(tmp_path):
    """``sfm/ba.py`` is shared with the SLAM cell, whose window-BA metric
    reads the kernels whose innermost region is ``nm.slam.window_ba.solve``."""
    assert "profiling" not in Path(sfm_ba.__file__).read_text()
    with profiling.trace(str(tmp_path)):
        nt.bundle_adjust(_tiny_problem(), nt.BAConfig(max_iterations=2), device="cpu")
        counted = profiling.counts()
    assert _spans(tmp_path) == [] and counted == {}
