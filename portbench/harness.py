"""The benchmark's harness: one cell, one seed, one window, one result line.

Everything particular to a cell is found by name: ``BENCHMARK.json`` at the
checkout's root names the cell's configuration and traffic mix and lists
the metrics; ``configs/<config>.json`` holds the configuration's sizes,
``traffic/<traffic>.json`` the mix's parameters and the ``kind`` of
generator that reads them (``generators/<kind>.py``), and each per-layer
metric is read by ``metrics/<metric>.py``.  A new cell, mix or metric is new
files and entries; nothing here names one.

A run: set-up (the program's kernels built or loaded from the checkout's
``build/``, the inputs made from the seed, the cell's shapes warmed up),
then a closed loop of the generator's steps for ``seconds``; each step ends
when its answer is on the host, and the window ends with the first step
that finishes after ``seconds``, followed by one device synchronisation.
With ``trace`` the profiler covers a bounded slice of the window
(``trace.steps`` steps after its first ``trace.skip``; the window runs its
full length all the same, and past the slice if the slice is longer), and
the run reports the per-layer metrics instead of the end-to-end ones.  Then the peak memory is read, the
program's state freed, and the sampled answers compared with the plain
reference (``reference/``).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

import torch

from . import trace as tracing

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "niftymatch_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str):
    """The cell's end-to-end metrics and per-layer metrics (entries of
    BENCHMARK.json): a metric with ``workloads`` applies to the cells it
    lists; a per-layer metric without it to every cell that reports the
    end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def generator(kind: str):
    return importlib.import_module(f"{__package__}.generators.{kind}")


def reader(metric: str):
    """``metrics/<metric>.py``, loaded by path (metric names hold dots)."""
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"{__package__}.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def p95(values) -> float:
    """The 95th percentile by Python's ``statistics.quantiles``."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


class Cell:
    """A cell resolved from BENCHMARK.json and its files."""

    def __init__(self, name: str, bench: dict | None = None, config: dict | None = None,
                 mix: dict | None = None):
        self.bench = benchmark() if bench is None else bench
        entry = cell_entry(self.bench, name)
        self.name = name
        self.chips = entry["chips"]
        self.config = config or load_json(PKG / "configs" / f"{entry['config']}.json")
        self.mix = mix or load_json(PKG / "traffic" / f"{entry['traffic']}.json")
        self.e2e, self.per_layer = cell_metrics(self.bench, name)
        self.gen = generator(self.mix["kind"])


def exact_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_kernels(device) -> None:
    """Build (first run in a checkout) or find the program's kernel
    libraries, all nvcc runs at once."""
    if device.type != "cuda":
        return
    from niftymatch_torch.kernels import _build

    _build.build_all(("windows", "descriptors", "match"))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, log=print) -> dict:
    """One run; returns the result line's object (without the clean-process
    check, which ``run.py`` makes last)."""
    device = torch.device(device)
    exact_fp32()
    gen = cell.gen
    spans = tracing.Spans()
    build_kernels(device)
    log(f"kernels ready at {process_age_s():.3f} s")
    state = gen.setup(cell.config, cell.mix, seed, device, spans)
    sync(device)
    log(f"inputs made at {process_age_s():.3f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    gen.warmup(state)
    sync(device)

    tr_cfg = cell.mix["trace"]
    traced = (tr_cfg["skip"], tr_cfg["skip"] + tr_cfg["steps"]) if trace else (-1, -1)
    steps, units, latencies = 0, 0, []
    prof = None
    t_window = time.perf_counter()
    setup_s = process_age_s()
    log(f"set-up {setup_s:.3f} s")
    while True:
        if steps == traced[0]:
            prof = _start_profile(device)
            win = torch.profiler.record_function(tracing.WINDOW)
            win.__enter__()
            spans.on = True
            hooks = getattr(gen, "trace_hooks", lambda _: contextlib.nullcontext())(state)
            hooks.__enter__()
        t0 = time.perf_counter()
        units += gen.step(state)
        latencies.append(time.perf_counter() - t0)
        steps += 1
        if steps == traced[1]:
            sync(device)
            hooks.__exit__(None, None, None)
            spans.on = False
            win.__exit__(None, None, None)
            prof.stop()
        if time.perf_counter() - t_window >= seconds and steps >= traced[1]:
            break
    sync(device)
    elapsed = time.perf_counter() - t_window
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    metrics = {}
    breakdown = None
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        t = tracing.read(prof)
        del prof
        info = gen.trace_info(state, tr_cfg)
        for m in cell.per_layer:
            value = reader(m["name"]).read(t, info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info["busy_s"] = t.busy_ns / 1e9
        dev_info["window_s"] = t.window_s
        breakdown = tracing.breakdown(t)
        log(f"traced {tr_cfg['steps']} steps: {len(t.ops)} device ops, "
            f"{sum(1 for o in t.ops if o.span)} attributed to a span, "
            f"busy {t.busy_ns / 1e9:.4f} s of {t.window_s:.4f} s")
    else:
        measured = {"setup_s": setup_s}
        measured.update(gen.end_to_end(state, units, elapsed, latencies))
        for m in cell.e2e:
            if m["name"] in measured:
                metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}

    gen.release(state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = gen.check(state)
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    out = {"correct": bool(correct), "attempted": int(gen.attempted(state)),
           "failed": int(failed if not correct else 0), "metrics": metrics,
           "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    log(f"window {elapsed:.3f} s, {steps} steps, {units} {cell.mix['unit']}, "
        f"setup {setup_s:.3f} s")
    return out


def _start_profile(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    return prof
