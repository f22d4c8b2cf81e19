"""The command's behaviour on a machine without a card, the clean-process
check, and a cell added by new files alone."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness


def test_no_card_exits_nonzero_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "pairs.sift640",
                        "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("niftymatch_torch_extra", "jaxtyping", "flaxen", "niftymatch_tpux"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "niftymatch_tpu.sift", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["jax", "niftymatch_tpu"]


NEW_CELL = """
import json, sys
sys.path.insert(0, sys.argv[1])
from portbench import harness
out = harness.run(harness.Cell("pairs_small.sift128"), 7, 0.2, True, "cpu", log=lambda m: None)
print(json.dumps(out))
"""


def _digest(root):
    h = {}
    for p in sorted(root.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h[str(p.relative_to(root))] = hashlib.sha256(p.read_bytes()).hexdigest()
    return h


def test_a_cell_is_added_by_new_files(tmp_path):
    """A new configuration, traffic mix, per-layer metric and cell: files
    and BENCHMARK.json entries only; every file already there unchanged."""
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(harness.ROOT / "niftymatch_torch", tmp_path / "niftymatch_torch")
    before = _digest(tmp_path / "portbench")
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "sift640.json").read_text())
    cfg["sift"].update(width=128, height=96, max_keypoints_per_level=64, max_features=256)
    (pb / "configs" / "sift128.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "pairs.json").read_text())
    mix.update(pairs=1, pool=2, check_chunks=1, blobs=20, trace={"skip": 1, "steps": 2})
    (pb / "traffic" / "pairs_small.json").write_text(json.dumps(mix))
    (pb / "metrics" / "chunks_traced.images.py").write_text(
        "def read(trace, info):\n    return float(info['steps'])\n")
    bench["configs"].append({"name": "sift128", "source": "a test", "reduced": [],
                             "file": "portbench/configs/sift128.json", "why": "a test"})
    bench["workloads"].append({"name": "pairs_small.sift128", "config": "sift128",
                               "traffic": "pairs_small", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("pairs_small.sift128")
    bench["per_layer"].append({"name": "chunks_traced.images", "unit": "chunks",
                               "better": "higher", "source": "program_counter",
                               "layer": "Front end", "moves": "images_per_s",
                               "workloads": ["pairs_small.sift128"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    p = subprocess.run([sys.executable, "-c", NEW_CELL, str(tmp_path)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["metrics"]["chunks_traced.images"]["value"] == 2.0
    after = _digest(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
