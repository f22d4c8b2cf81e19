"""Where kernel K1's time goes (fused distance GEMM + top-2), on a GPU.

    python3 tools/k1_variants.py [--reps 50]

Builds the kernels, and ``csrc/match.cu`` once more with its timing
variants (library ``match_timing``), and makes the operands that
``chip_smoke.py`` gives K1 on the main path (the descriptors of 8 pairs of
640x480 bench scenes, 2048 slots each).  Then it times, in fp32 (3xTF32)
and bf16 mode, each as the mean of ``--reps`` replays of a CUDA graph: the
kernel, and its timing variants that leave one part of the work out: the
fold (1), the products (2), or the streaming of B through shared memory
after the first tile (4).  A variant's results are not the function's;
only its time is read.  Prints one line per variant, the card's name and
power limit, and a JSON object with every time.  Needs one CUDA card;
imports nothing of JAX.
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANTS = {1: "no_fold", 2: "no_product", 4: "no_stream"}   # csrc/match.cu


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args()

    import torch

    import chip_smoke
    import niftymatch_torch as nt
    from niftymatch_torch.kernels import _build
    from niftymatch_torch.kernels import match as k1

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    nt.utils.exact_fp32()
    _build.build_all(_build.SOURCES + ("match_timing",))
    timing = _build.load("match_timing", {
        "nm_match_top2_variant": [ctypes.c_int, ctypes.c_int] + k1._ARGS})
    cfg = nt.SiftConfig(width=chip_smoke.W, height=chip_smoke.H)
    feats = nt.detect_and_describe_batch(chip_smoke.chunk_images(0, dev), cfg,
                                         device=dev)
    n = chip_smoke.CHUNK

    def variant(bits, bf16, a_mat, b_mat, a_norm, b_norm):
        pairs, m, d = a_mat.shape
        out = [torch.empty((pairs, m), dtype=t, device=dev)
               for t in (torch.float32, torch.int32, torch.float32)]
        rc = timing.nm_match_top2_variant(
            int(bf16), bits, a_mat.data_ptr(), b_mat.data_ptr(),
            a_norm.data_ptr(), b_norm.data_ptr(), pairs, m, b_mat.shape[1], d,
            *(t.data_ptr() for t in out), _build.stream_ptr(a_mat))
        _build.check(rc, f"K1 timing variant {bits}")
        return out

    times = {}
    for bf16 in (False, True):
        a_mat, a_norm = k1.prepare_descriptors(feats.desc[:n], bf16)
        b_mat, b_norm = k1.prepare_descriptors(feats.desc[n:], bf16)
        b_norm = torch.where(feats.valid[n:], b_norm,
                             torch.full_like(b_norm, k1.MASKVAL))
        ops = (a_mat, b_mat, a_norm, b_norm)
        runs = {"kernel": lambda: k1.fused_match_topk_prepared(*ops)}
        runs.update({name: (lambda v=v: variant(v, bf16, *ops))
                     for v, name in VARIANTS.items()})
        for name, fn in runs.items():
            key = f"{'bf16' if bf16 else 'fp32'}_{name}"
            times[key] = chip_smoke.graph_ms(fn, args.reps)
            print(f"[k1] {key}: {times[key]:.4f} ms")
    smi = chip_smoke.card_line()
    print(smi)
    print(json.dumps({"k1_variants_ms": times, "card": smi}))


if __name__ == "__main__":
    main()
