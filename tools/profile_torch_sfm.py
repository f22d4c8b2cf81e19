"""Where the time of the SfM back-end goes, on a GPU, for the PyTorch port.

    python3 tools/profile_torch_sfm.py

1. One LM iteration of ``bundle_adjust_cg`` on ``chip_smoke.py``'s phase-7c
   problem (``benchmarks/global_ba_eval.py``'s: 512 cameras, 131,072
   landmarks, 2,097,152 observations, 24 CG iterations);
2. one ``estimate_two_view`` on synthetic features (2,048 slots).

Each under ``torch.profiler`` after a warm-up (``smoke_sfm.profile``):
device time by operator (largest first), every host wait on the device
with the port's frames that caused it, and the kernel count.  Needs one
CUDA card; imports nothing of JAX.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_sfm: no CUDA device")
    import niftymatch_torch as nt
    from niftymatch_torch.data import make_feature_sequence, make_scene
    from niftymatch_torch.utils.precision import state_to
    from niftymatch_torch.utils.smoke_sfm import global_problem, profile

    dev = torch.device("cuda")
    problem = state_to(global_problem()[1], dev)
    cfg = nt.BAConfig(max_iterations=1, damping=1e-3, cg_iterations=24)
    nt.bundle_adjust_cg(problem, cfg, device=dev)
    print(f"== 1. one LM iteration of bundle_adjust_cg, {problem.obs_uv.shape[0]} observations")
    print(profile(lambda: nt.bundle_adjust_cg(problem, cfg, device=dev), dev, detail=True))

    scene = make_scene(num_cams=3, num_landmarks=3000, seed=0)
    fa, fb = make_feature_sequence(scene, capacity=2048, device=dev)[:2]
    intr = tuple(float(v) for v in scene.intrinsics)
    rcfg = nt.RansacConfig(iterations=1024, inlier_threshold=4.0)
    nt.estimate_two_view(fa, fb, intr, rcfg, device=dev)
    print("== 2. one estimate_two_view on synthetic features")
    print(profile(lambda: nt.estimate_two_view(fa, fb, intr, rcfg, device=dev), dev,
                  detail=True))


if __name__ == "__main__":
    main()
