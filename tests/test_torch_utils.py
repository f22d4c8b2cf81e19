"""The port's timing, profiling and pytree checkpoint utilities
(``niftymatch_torch/utils/{timing,profiling,checkpoint}.py``) on the CPU,
against ``tests/test_profiling.py`` and ``tests/test_checkpoint.py``.

On the CPU the times are the host's clock and mean nothing for a card;
these tests hold the accounting: the roofline's rates follow from its
counts and the measured time (exactly, with the peaks given explicitly),
an unknown card raises, the trace holds the annotated region, and a
pytree round trip returns its leaves bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from niftymatch_torch.utils import profiling, timing
from niftymatch_torch.utils.checkpoint import load_pytree, save_pytree
from niftymatch_tpu.utils.profiling import RooflineReport as JaxRooflineReport

PEAKS = {"bf16_flops": 1e12, "hbm_gbps": 1e11}


def test_timer_and_benchmark():
    calls = []

    def fn(a, b):
        calls.append(1)
        return a @ b

    x = torch.ones(32, 32)
    with timing.Timer() as t:
        out = t.block_on(fn(x, x))
    assert t.elapsed_ms > 0 and out.shape == (32, 32)
    ms = timing.benchmark(fn, [(x, x), (x + 1, x)], warmup=2, iters=5)
    assert ms > 0 and len(calls) == 1 + 2 + 5


def test_roofline_report(rng):
    M = N = K = 128
    a = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32))
    flops, nbytes = 2 * M * N * K, 4 * (M * K + K * N + M * N)
    rep = profiling.roofline(lambda a, b: a @ b, [(a, b)], flops, nbytes, iters=3, peaks=PEAKS)
    assert [f.name for f in profiling.dataclasses.fields(rep)] == \
        [f.name for f in profiling.dataclasses.fields(JaxRooflineReport)]
    assert rep.wall_s > 0
    np.testing.assert_allclose(rep.achieved_tflops, flops / rep.wall_s / 1e12, rtol=1e-12)
    np.testing.assert_allclose(rep.mxu_utilization, flops / rep.wall_s / PEAKS["bf16_flops"],
                               rtol=1e-12)
    np.testing.assert_allclose(rep.hbm_utilization, nbytes / rep.wall_s / PEAKS["hbm_gbps"],
                               rtol=1e-12)
    assert rep.compute_bound == (flops / nbytes > PEAKS["bf16_flops"] / PEAKS["hbm_gbps"])
    assert "TFLOP/s" in str(rep)


def test_roofline_peaks_by_card_name():
    assert profiling.peaks_of("NVIDIA H100 80GB HBM3") == {"bf16_flops": 989e12,
                                                           "hbm_gbps": 3.35e12}
    with pytest.raises(ValueError, match="no peak rates"):
        profiling.peaks_of("TPU v5 lite")
    with pytest.raises(ValueError, match="no peak rates"):
        profiling.roofline(lambda: None, [()], 1.0, 1.0, device_kind="some other card")


def test_trace_holds_the_annotated_region(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("test-region"):
            x = torch.ones(8, 8) * 2
    assert float(x.sum()) == 128.0
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "test-region" for e in events)


@pytest.mark.parametrize("as_tensors", [False, True])
def test_pytree_roundtrip(tmp_path, rng, as_tensors):
    """``tests/test_checkpoint.py``'s tree, restored into numpy leaves or
    into tensors."""
    tree = {
        "poses": torch.from_numpy(rng.normal(size=(5, 3, 4)).astype(np.float32)),
        "landmarks": torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32)),
        "meta": {"count": torch.tensor(7, dtype=torch.int32),
                 "mask": torch.from_numpy(rng.uniform(size=12) > 0.5)},
    }
    save_pytree(str(tmp_path / "ckpt"), tree)
    like = {"poses": np.zeros((5, 3, 4), np.float32), "landmarks": np.zeros((64, 3), np.float32),
            "meta": {"count": np.zeros((), np.int32), "mask": np.zeros(12, bool)}}
    if as_tensors:
        like = {"poses": torch.zeros(5, 3, 4), "landmarks": torch.zeros(64, 3),
                "meta": {"count": torch.zeros((), dtype=torch.int32),
                         "mask": torch.zeros(12, dtype=torch.bool)}}
    back = load_pytree(str(tmp_path / "ckpt"), like)
    for got, want in ((back["poses"], tree["poses"]), (back["landmarks"], tree["landmarks"]),
                      (back["meta"]["count"], tree["meta"]["count"]),
                      (back["meta"]["mask"], tree["meta"]["mask"])):
        assert isinstance(got, torch.Tensor) == as_tensors
        np.testing.assert_array_equal(np.asarray(got), want.numpy())
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(str(tmp_path / "ckpt"), {"poses": like["poses"]})
