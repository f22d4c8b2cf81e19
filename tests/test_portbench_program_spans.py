"""The benchmark's readers of the program's own spans and counters
(``portbench/metrics/*.frames.py`` over ``portbench/program_spans.py``) on
a hand-built ``portbench.trace.Trace`` of two SLAM frames: each reader's
value, and ``None`` from the same trace without the program's ``nm.``
spans, as a program that opens none gives."""

import pytest

from niftymatch_torch.utils import profiling
from portbench import harness
from portbench.trace import DeviceOp, Trace

MS = 1_000_000  # ns


def _trace(program_spans=True) -> Trace:
    spans = [("slam.process_frames", 0, 1000 * MS)]
    if program_spans:
        spans += [("nm.slam.chunk", 100 * MS, 600 * MS),
                  ("nm.slam.frame", 100 * MS, 300 * MS),
                  ("nm.slam.frame.match", 110 * MS, 150 * MS),
                  ("nm.slam.frame.ransac_e", 150 * MS, 200 * MS),
                  ("nm.slam.frame.ransac_h", 200 * MS, 250 * MS),
                  ("nm.slam.frame", 300 * MS, 550 * MS),
                  ("nm.slam.frame.select", 400 * MS, 450 * MS),
                  ("nm.slam.fetch", 600 * MS, 650 * MS),
                  ("nm.slam.absorb", 650 * MS, 700 * MS),
                  ("nm.slam.window_ba.pack", 700 * MS, 720 * MS),
                  ("nm.slam.window_ba.solve", 720 * MS, 800 * MS),
                  ("nm.slam.ba_fetch", 900 * MS, 910 * MS)]

    def span(name):
        return name if program_spans or not name.startswith("nm.") else "slam.process_frames"

    ops = [DeviceOp("ransac_kernel", 160 * MS, MS, span("nm.slam.frame.ransac_e"), True),
           DeviceOp("ransac_kernel", 210 * MS, MS, span("nm.slam.frame.ransac_h"), True),
           DeviceOp("match_kernel", 120 * MS, MS, span("nm.slam.frame.match"), True),
           DeviceOp("copy_kernel", 310 * MS, MS, span("nm.slam.frame"), True),
           DeviceOp("lm_kernel", 730 * MS, 10 * MS, span("nm.slam.window_ba.solve"), True),
           DeviceOp("sift_kernel", 50 * MS, MS, "slam.process_frames", True),
           DeviceOp("Memcpy DtoH (Device -> Pageable)", 420 * MS, MS,
                    span("nm.slam.frame.select"), False),
           DeviceOp("Memcpy DtoH (Device -> Pinned)", 610 * MS, MS,
                    span("nm.slam.fetch"), False),
           DeviceOp("Memcpy DtoH (Device -> Pageable)", 20 * MS, MS,
                    "slam.process_frames", False)]
    gaps = [(span("nm.slam.frame.ransac_e"), 300 * MS),
            ("slam.process_frames", 100 * MS), ("outside any span", 100 * MS)]
    return Trace(ops, spans, (0, 1000 * MS), 500 * MS, gaps)


INFO = {"steps": 1, "frames": 2}
EXPECTED = {
    "tracking_host_ms.frames": (200 + 250) / 2,       # the two nm.slam.frame spans
    "tracking_launches.frames": 4 / 2,                # kernels under nm.slam.frame*
    "ransac_launches.frames": 2 / 2,
    "window_ba_host_ms.frames": (20 + 80) / 2,
    "ba_obs_updates_per_s.frames": 1000 / 0.010,      # the counter over 10 ms of solve kernels
    "host_wait_ms.frames": (50 + 10) / 2,
    "pageable_dtoh.frames": 1 / 2,                    # the one inside a program span
    "idle_covered_share.frames": 100.0 * 300 / 500,
    "refine_fused_share.frames": 100.0 * 3 / 4,       # refine.fused over refine.calls
    "linalg_fused_share.frames": 100.0 * 28 / 30,     # linalg.fused over linalg.calls
}
COUNTERS = {"ba.obs_updates": 1000, "ba.solves": 1, "refine.calls": 4, "refine.fused": 3,
            "linalg.calls": 30, "linalg.fused": 28}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_of_program_spans(metric, monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTS", dict(COUNTERS))
    read = harness.reader(metric).read
    assert read(_trace(), INFO) == pytest.approx(EXPECTED[metric])
    assert read(_trace(program_spans=False), INFO) is None


def test_every_reader_is_declared_for_the_track_cell():
    bench = harness.benchmark()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in EXPECTED:
        m = declared[name]
        assert m["workloads"] == ["track.slam640"] and m["moves"] == "frames_per_s"
        assert m["layer"] == "SLAM"
        counter = name.startswith(("ba_", "refine_", "linalg_"))
        assert m["source"] == ("program_counter" if counter else "program_span")


def test_refine_share_reads_nothing_without_its_counters(monkeypatch):
    """A program that opens the spans but keeps no polish counters (the
    SLAM loop before the fused polish) leaves the share unread."""
    monkeypatch.setattr(profiling, "_COUNTS", {"ba.obs_updates": 1000, "ba.solves": 1})
    assert harness.reader("refine_fused_share.frames").read(_trace(), INFO) is None


def test_linalg_share_reads_nothing_without_its_counters(monkeypatch):
    """A program that opens the spans but keeps no small-matrix solver
    counters (the SLAM loop before the fused solvers) leaves the share
    unread."""
    monkeypatch.setattr(profiling, "_COUNTS", {"ba.obs_updates": 1000, "ba.solves": 1,
                                               "refine.calls": 4, "refine.fused": 4})
    assert harness.reader("linalg_fused_share.frames").read(_trace(), INFO) is None
