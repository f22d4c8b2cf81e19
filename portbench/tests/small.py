"""A cell at a size the CPU runs in seconds: the program's plain path and
the reference at 128 x 96, through the harness as a run drives it."""

from __future__ import annotations

import copy

from portbench import harness

SMALL_SIFT = {"width": 128, "height": 96, "max_keypoints_per_level": 64, "max_features": 256}


def small_cell(name: str) -> harness.Cell:
    c = harness.Cell(name)
    cfg, mix = copy.deepcopy(c.config), copy.deepcopy(c.mix)
    cfg["sift"].update(SMALL_SIFT)
    if "slam" in cfg:
        cfg["slam"].update(width=128, height=96, detector_features=256, chunk_size=4)
        cfg["slam"]["ransac"]["iterations"] = 64
        mix.update(frames=9, landmarks=300, min_frames=5)
    if mix["kind"] == "chunks":
        mix.update(pairs=2, pool=2, check_chunks=1, blobs=20, trace={"skip": 2, "steps": 2})
    if mix["kind"] == "sweep":
        mix.update(frames=6, landmarks=300, describe_batch=3)
        if mix["precision"] == "fp32":
            # Enough near-threshold rows for TF32 to flip decided answers.
            cfg["sift"].update(width=160, height=120, max_keypoints_per_level=128,
                               max_features=512)
            mix.update(frames=8, landmarks=1200, describe_batch=8)
    return harness.Cell(name, config=cfg, mix=mix)


def run_small(name: str, seed: int = 2**31 + 5, seconds: float = 0.5, trace: bool = False,
              cell: harness.Cell | None = None) -> dict:
    return harness.run(cell or small_cell(name), seed, seconds, trace, "cpu", log=lambda m: None)
