"""Timed variants of kernel K2 (orientation histograms) on the main path's
inputs, on a GPU.

    python3 tools/k2_variants.py [--reps 50]

Builds the kernels, and ``csrc/windows.cu`` once more with its timing
variants and its check of the division (library ``windows_timing``).

First it holds K2's branch-free division against CUDA's ``/``, bit for
bit: every float a in [2^-60, 2^60], of either sign, over eight divisors
(2 pi, the bin's, and seven of the weight's kind, 2 sigma_w^2), and 2^33
random pairs (a, d) with both in that range.

Then it makes the inputs that ``chip_smoke.py`` phase 2 gives K2 (16 bench
scenes of 640x480, their 32,768 keypoint slots) and times, each as the mean
of ``--reps`` replays of a CUDA graph holding one launch (``graph_ms``, as
``chip_smoke.py`` times it) and as the mean launch of ``--reps`` replays of
a graph holding 20 launches, which leaves out the replay's own cost:

* K2 as the package runs it, a warp per valid keypoint, a batch of pixels'
  loads in flight at once, each lane adding into its own histogram column;
* the variant without the adds into the histogram columns, the variant
  without the window's loads (made-up magnitudes and angles), and the
  variant without either: what is left is the slots, the window
  geometry, the weights and the bins (the results of these three are not
  the function's; only their times are read);
* K2 with the Gaussian's sign flipped (``CompatFlags.flipped_gaussian_sign``);
* K2 on the same inputs with every slot invalid: what the slots alone cost
  (each slot's flag read and its zeros written).

The function's runs are held against the plain version (within 1e-4 of
each row's largest bin) and against a rerun (bit for bit).  Prints one
line per run, the card's name and power limit, and a JSON object with
every time and error.  Needs one CUDA card; imports nothing of JAX.
"""

import argparse
import ctypes
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANTS = {1: "no_adds", 2: "no_loads", 3: "no_adds_no_loads"}   # csrc/windows.cu


DIVISORS = (6.283185307179586, 0.02, 0.18, 2.0, 11.52, 23.805, 288.0,
            12345.678)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args()

    import torch

    import chip_smoke
    import niftymatch_torch as nt
    from niftymatch_torch.kernels import _build
    from niftymatch_torch.kernels import windows as kw
    from niftymatch_torch.sift import keypoints_and_planes

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    nt.utils.exact_fp32()
    _build.build_all(_build.SOURCES + ("windows_timing",))
    for line in _build.build_log("windows_timing").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] windows_timing: {line.strip()}")
    timing = _build.load("windows_timing", {
        "nm_orientation_hists_variant":
            [ctypes.c_int] + kw._K2_SIGNATURES["nm_orientation_hists"],
        "nm_quotient_check": [ctypes.c_float, ctypes.c_uint, ctypes.c_uint,
                              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p]})

    def quotient_check(d, lo, count, mode):
        bad = torch.zeros(2, dtype=torch.int64, device=dev)
        _build.check(timing.nm_quotient_check(
            d, lo, count, mode, bad.data_ptr(), bad[1:].data_ptr(),
            _build.stream_ptr(bad)), "K2 division check")
        return [int(v) for v in bad.cpu()]

    lo = int(np.float32(2.0 ** -60).view(np.uint32))
    hi = int(np.float32(2.0 ** 60).view(np.uint32))
    division = {}
    for d in DIVISORS:
        division[f"all a, d={np.float32(d)}"] = quotient_check(
            float(np.float32(d)), lo, hi - lo + 1, 0)
    for seed in range(8):
        division[f"random pairs, seed {seed}"] = quotient_check(
            1.0, 1000003 * seed, 1 << 30, 1)
    checked = sum(v[1] for v in division.values())
    differ = sum(v[0] for v in division.values())
    print(f"[k2] branch-free division against '/': {differ} of {checked} "
          f"quotients differ")
    assert differ == 0, division

    def multi_ms(fn, per_graph=20):
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            for _ in range(per_graph):
                fn()
        return chip_smoke.cuda_ms(graph.replay, args.reps) / per_graph

    cfg = nt.SiftConfig(width=chip_smoke.W, height=chip_smoke.H)
    flipped = dataclasses.replace(
        cfg, compat=nt.CompatFlags(flipped_gaussian_sign=True))
    images = chip_smoke.chunk_images(0, dev)
    mk, planes = keypoints_and_planes(images, cfg)
    b, m = mk["x"].shape
    fl = {k: v.reshape(-1) for k, v in mk.items()}
    image = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(m)
    kp = [fl[k] for k in ("x", "y", "sigma", "octave", "level")]
    valid = fl["valid"]

    def function(flags, config):
        return kw.orientation_hists(planes, *kp, flags, config, image=image)

    def variant(bits):
        out = torch.empty((b * m, 36), dtype=torch.float32, device=dev)
        rc = timing.nm_orientation_hists_variant(
            bits, *kw._geometry_args(planes),
            *(t.data_ptr() for t in (*kp, image, valid)), b * m,
            cfg.max_orientation_radius, kw._sign(cfg), out.data_ptr(),
            _build.stream_ptr(out))
        _build.check(rc, f"K2 timing variant {bits}")
        return out

    def rel_err(got, config):
        want = kw.orientation_hists_plain(planes, *kp, valid, config, image)
        scale = want.abs().amax(dim=-1, keepdim=True).clamp(min=1.0)
        rel = ((got - want).abs() / scale).max().item()
        assert rel <= 1e-4, rel
        return rel

    runs = {"function": lambda: function(valid, cfg),
            "flipped_sign": lambda: function(valid, flipped)}
    runs.update({name: (lambda v=v: variant(v)) for v, name in VARIANTS.items()})
    times, per_launch, errs = {}, {}, {}
    for name, fn in runs.items():
        got = fn()
        if name in ("function", "flipped_sign"):
            errs[name] = rel_err(got, flipped if name == "flipped_sign" else cfg)
            assert torch.equal(got, fn()), f"{name} differs between two runs"
        times[name] = chip_smoke.graph_ms(fn, args.reps)
        per_launch[name] = multi_ms(fn)
        print(f"[k2] {name}: {times[name]:.4f} ms, {per_launch[name]:.4f} ms "
              "a launch in a 20-launch graph"
              + (f", max err / row max {errs[name]:.3e}" if name in errs else ""))
    none = torch.zeros_like(valid)
    assert not function(none, cfg).any()
    times["all_invalid"] = chip_smoke.graph_ms(lambda: function(none, cfg),
                                               args.reps)
    per_launch["all_invalid"] = multi_ms(lambda: function(none, cfg))
    print(f"[k2] all_invalid: {times['all_invalid']:.4f} ms, "
          f"{per_launch['all_invalid']:.4f} ms a launch in a 20-launch graph "
          f"({b * m} slots, {int(valid.sum())} valid in the other runs)")
    smi = chip_smoke.card_line()
    print(smi)
    print(json.dumps({"k2_variants_ms": times, "k2_variants_ms_in_20": per_launch,
                      "max_err_over_row_max": errs, "division_checked": checked,
                      "division_differ": differ, "slots": b * m,
                      "valid": int(valid.sum()), "card": smi}))


if __name__ == "__main__":
    main()
