"""BENCHMARK.json against the contract's shapes and the files it names."""

import json
import re

import pytest

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_names_existing_files(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1
    assert (harness.PKG / "configs" / f"{cell['config']}.json").exists()
    mix = json.loads((harness.PKG / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (harness.PKG / "generators" / f"{mix['kind']}.py").exists()
    e2e, layer = harness.cell_metrics(BENCH, cell["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for m in layer:
        assert (harness.PKG / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {x["name"] for x in e2e}
    assert len(cell["why"]) <= 200


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_names_and_units(metric):
    assert NAME.match(metric["name"])
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200


def test_names_unique_and_configs_used():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] == []
