"""Timed variants of kernel K3 (descriptors) on the main path's inputs, on
a GPU.

    python3 tools/k3_variants.py [--reps 50]

Builds the kernels, and ``csrc/descriptors.cu`` once more with its timing
variants (library ``descriptors_timing``), and makes the inputs that
``chip_smoke.py`` phase 2 gives K3 (16 bench scenes of 640x480, their
keypoints and orientations).  Then it times, each as the mean of
``--reps`` replays of a CUDA graph:

* K3 as the package runs it, each block describing one keypoint at a time
  from the support's spans of its window rows;
* the variant that visits the whole square window;
* the variants without the atomic adds into the bins, and without the
  second pass (the results of these two are not the function's; only
  their times are read);
* K3 with the Gaussian's sign flipped (``CompatFlags.flipped_gaussian_sign``),
  whose fixed-point scale allows for window weights up to 4.8;
* K3 on the same inputs with every slot invalid: what the slots alone cost
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

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANTS = {1: "whole", 2: "no_adds", 4: "no_pass2"}   # csrc/descriptors.cu


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
    _build.build_all(_build.SOURCES + ("descriptors_timing",))
    timing = _build.load("descriptors_timing", {
        "nm_descriptors_variant":
            [ctypes.c_int] + kw._K3_SIGNATURES["nm_descriptors"]})
    cfg = nt.SiftConfig(width=chip_smoke.W, height=chip_smoke.H)
    flipped = dataclasses.replace(
        cfg, compat=nt.CompatFlags(flipped_gaussian_sign=True))
    images = chip_smoke.chunk_images(0, dev)
    mk, planes = keypoints_and_planes(images, cfg)
    b, m = mk["x"].shape
    fl = {k: v.reshape(-1) for k, v in mk.items()}
    image = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(m)
    kp = [fl[k] for k in ("x", "y", "sigma", "octave", "level")]
    angles, avalid = kw.compute_orientations_merged_kernel(
        planes, *kp, fl["valid"], cfg, image=image)
    angle0 = angles[:, 0].contiguous()
    dvalid = (fl["valid"] & avalid[:, 0]).contiguous()

    def function(valid, config):
        return kw.descriptors(planes, *kp, angle0, valid, config, image=image)

    def variant(bits):
        out = torch.empty((b * m, 128), dtype=torch.float32, device=dev)
        rc = timing.nm_descriptors_variant(
            bits, *kw._geometry_args(planes),
            *(t.data_ptr() for t in (*kp, image, angle0, dvalid)), b * m,
            kw._sign(cfg), out.data_ptr(), _build.stream_ptr(out))
        _build.check(rc, f"K3 timing variant {bits}")
        return out

    def rel_err(got, config):
        want = kw.descriptors_plain(planes, *kp, angle0, dvalid, config, image)
        scale = want.abs().amax(dim=-1, keepdim=True).clamp(min=1.0)
        rel = ((got - want).abs() / scale).max().item()
        assert rel <= 1e-4, rel
        return rel

    runs = {"support": lambda: function(dvalid, cfg),
            "flipped_sign": lambda: function(dvalid, flipped)}
    runs.update({name: (lambda v=v: variant(v)) for v, name in VARIANTS.items()})
    times, errs = {}, {}
    for name, fn in runs.items():
        got = fn()
        if name in ("support", "whole", "flipped_sign"):
            errs[name] = rel_err(got, flipped if name == "flipped_sign" else cfg)
            assert torch.equal(got, fn()), f"{name} differs between two runs"
        times[name] = chip_smoke.graph_ms(fn, args.reps)
        print(f"[k3] {name}: {times[name]:.4f} ms"
              + (f", max err / row max {errs[name]:.3e}" if name in errs else ""))
    none = torch.zeros_like(dvalid)
    assert not function(none, cfg).any()
    times["all_invalid"] = chip_smoke.graph_ms(lambda: function(none, cfg),
                                               args.reps)
    print(f"[k3] all_invalid: {times['all_invalid']:.4f} ms "
          f"({b * m} slots, {int(dvalid.sum())} valid in the other runs)")
    smi = chip_smoke.card_line()
    print(smi)
    print(json.dumps({"k3_variants_ms": times, "max_err_over_row_max": errs,
                      "slots": b * m, "valid": int(dvalid.sum()), "card": smi}))


if __name__ == "__main__":
    main()
