"""Where the all-pairs sweep through K1 fp32 and the fp32 oracle part, on
phase 2's 16 frames of 640x480 (8 bench scenes and their 5-px shifts,
2,048 slots each) and on the card.

    python3 tools/ring_oracle_gap.py

For every ordered pair of frames, each row's ratio test (ambiguity 0.8,
not mutual) is computed four ways: K1 fp32 (``allpairs_match_fused``, the
ring's block match), the fp32 oracle on the card (``allpairs_match``),
the same oracle on the CPU, and the oracle's formula in float64 on the
card (the reference).  Prints, for each fp32 way, how many counts and rows
differ from the float64 reference, and how many of those rows have a
float64 margin ``0.8 * min2 - min1`` of at least
``smoke_parallel.MARGIN_EPS`` (rows whose ratio test fp32 noise cannot
decide); and how many rows lie below it.  A reading on the card only.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

AMBIGUITY = 0.8


def reference(desc, valid):
    """The float64 ratio test of every row against every frame: (K, K, N)
    indices, -1 for none."""
    K, N, _ = desc.shape
    d = desc.to(torch.float64)
    norm = (d * d).sum(-1)
    out = torch.empty((K, K, N), dtype=torch.int64, device=desc.device)
    for i in range(K):
        dist = torch.clamp(norm[i][None, :, None] + norm[:, None, :]
                           - 2.0 * torch.matmul(d[i], d.transpose(1, 2)), min=0.0)
        dist = torch.where(valid[:, None, :], dist, torch.full_like(dist, float("inf")))
        two = torch.topk(dist, 2, dim=-1, largest=False)
        m1, m2 = two.values[..., 0], two.values[..., 1]
        ok = (m2 > 0) & (m1 < AMBIGUITY * m2) & valid[i][None, :]
        out[i] = torch.where(ok, two.indices[..., 0], torch.full_like(two.indices[..., 0], -1))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke
    import niftymatch_torch as nt
    from niftymatch_torch.kernels import _build
    from niftymatch_torch.parallel import allpairs_match, allpairs_match_fused
    from niftymatch_torch.utils.smoke_parallel import MARGIN_EPS, margins64

    _build.build_all(("match", "windows", "descriptors"))
    nt.utils.exact_fp32()
    dev = torch.device("cuda")
    feats = nt.detect_and_describe_batch(chip_smoke.chunk_images(0, dev),
                                         nt.SiftConfig(width=640, height=480))
    desc, valid = feats.desc, feats.valid
    print(f"[gap] {chip_smoke.card_line()}; valid features per frame "
          f"{feats.valid.sum(-1).tolist()}")
    ref = reference(desc, valid)
    ill = margins64(desc, valid, AMBIGUITY).abs() < MARGIN_EPS
    print(f"[gap] rows with a float64 margin below {MARGIN_EPS:g}: {int(ill.sum())} of "
          f"{int(valid.sum()) * desc.shape[0]} valid rows")
    for name, idx in (
            ("K1 fp32 sweep", allpairs_match_fused(desc, valid, AMBIGUITY, return_indices=True)),
            ("fp32 oracle, card", allpairs_match(desc, valid, AMBIGUITY, return_indices=True)),
            ("fp32 oracle, CPU", allpairs_match(desc.cpu(), valid.cpu(), AMBIGUITY,
                                                return_indices=True))):
        idx = idx.indices.to(dev).long()
        diff = idx != ref
        dc = ((idx >= 0).sum(-1) - (ref >= 0).sum(-1)).abs()
        print(f"[gap] {name}: {int((dc > 0).sum())} of {dc.numel()} counts differ from the "
              f"float64 reference, by at most {int(dc.max())}; {int(diff.sum())} rows differ, "
              f"{int((diff & ~ill).sum())} of them with a margin of at least {MARGIN_EPS:g}")


if __name__ == "__main__":
    main()
