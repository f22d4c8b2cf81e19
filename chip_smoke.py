"""Chip smoke test of the PyTorch/CUDA port (``niftymatch_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py linalg     # phase 8f alone, with its build

Builds the hand-written kernels from ``niftymatch_torch/csrc`` and drives the
port's main path, the flagship forward step: SIFT detect + describe on
640x480 grayscale images and ratio-test matching of image pairs, with the
default ``SiftConfig(640, 480)`` (4 octaves, 512 keypoints per level, 2048
features) and the workload of ``bench.py``: 8 pairs (16 images) per chunk,
distinct inputs per call.

Phases (any failed check raises, so the script exits non-zero):
  1. build the kernels; print the build time and the card's name and power
     limit;
  2. hold each kernel (K1 match in fp32 and bf16, K2 orientation, K3
     descriptor) against its plain PyTorch version on the main path's own
     inputs, and K1, K2 and K3 against a second run of themselves (bit for
     bit); and each of K4's nine fold variants (``kernels/fold.py``)
     against its plain version and a second run of itself at both shapes
     of the fold microbenchmark (16 pairs of 1024 x 128 and one pair of
     4096 x 128 uniform descriptors, ``utils/smoke_fold.operands``; the
     second split across 4 CTAs a row block) and at two shapes of no
     tile's multiple (3 pairs of 1000 x 1000, 2 of 1000 x 1), with
     ``kernels.fold.agreement``'s tolerances, ``gemm`` and ``rowsum`` also
     with their sums added to 0 (at 3.4e38 every sum reads 3.4e38), and
     with exact ties planted across the first and last split of
     (4096, 1): the lower column keeps idx1;
  3. the pair path: a scene and the same scene shifted by 5 px, through
     ``make_pair_pipeline``: > 100 matches, median dx = -5.00 +- 0.01;
  4. the batch path: ``detect_and_describe_batch`` on 16 images and one
     batched ``match_pair`` of 8 pairs, with the launch counts reset just
     before and read just after (K1 fp32, K2 and K3 once each), then the
     same 8 pairs through ``match_pair(precision="bf16")``, counted the same
     way (K1 bf16 once); the batch equal to single-image runs within 1e-5,
     and a 96x128 image on the card equal to the CPU run within the repo's
     tolerances;
  5. times with CUDA events: ms per 8-pair chunk over 40 distinct chunks
     (about 2 s) after 3 warm-up chunks, keyframes/s, each stage, and each
     kernel beside its plain version, its bound (the bytes and operations
     this run's keypoints need, K1's on the tensor cores) and (K1) one
     library call computing the same function; and K4's path, the fold
     microbenchmark (``utils/smoke_fold.run``) at (k 1,024, nb 16) and
     (k 4,096, nb 1), counted with the launch counts reset just before and
     read just after: each variant's ms beside its bound, its ms in a
     graph of 20 launches, the replay of a graph of one ``zero_()``, K1
     bf16 on the same operands, each variant's plain ms and, for
     ``current``, one library call (bf16 ``baddbmm`` + ``topk``) at both
     shapes;
  6. geometry and mosaic on the card: phase 3's pair through
     ``align_points`` -> ``ransac(model="homography")`` at the defaults
     (2048 iterations, threshold 9, 2048 slots), H within 1 px of the
     5-px shift at the corners (0.05 px at a 0.1-px threshold), and the
     same call with one injected draw on the card and on the CPU; every
     RANSAC model on 2048 synthetic correspondences (a third outliers),
     with its kernel launches; ``MosaicBuilder`` at its defaults
     over 8 frames of 640x480 cut from a 720x1120 scene, one rotated and
     scaled through ``warp_perspective`` (every frame registers, the chain
     within 1 px at the corners, the canvas matches the scene, one
     ``add_frame`` launches K1 twice and K2 and K3 once); undistortion on
     the card against the CPU; the per-octave oracle against the merged
     path; then ms per ``ransac`` call for each model, ms per ``add_frame``
     and its stages, and the kernel launches of one homography ``ransac``
     and one ``add_frame`` from ``torch.profiler``;
  7. the SfM back-end on the card (``niftymatch_torch/utils/smoke_sfm.py``):
     (7a) two-view pose from 8 rendered 640x480 views of 1,200 landmarks
     (one batched detection, K2 and K3 once; ``estimate_two_view`` on pairs
     (0,1), (1,2), (2,3) at 1024 RANSAC iterations, K1 twice each, counted
     with the counts reset just before and read just after): >= 2 pairs
     with >= 20 inliers, median max |R - R_true| < 0.2
     (``tests/test_rendered_vo.py``'s bars); (7b) dense window BA at
     ``BAConfig()`` on 5 x 1,024 and 16 x 4,096 (cost / 1000, poses within
     2e-3, landmarks within 5e-3, the 5 x 1,024 cost trace equal to the
     CPU's within 1e-3); (7c) PCG BA at 512 cameras x 131,072 landmarks x
     2,097,152 observations (``benchmarks/global_ba_eval.py``'s problem;
     initial cost within 1e-3 and final within 2 % of the JAX package's,
     poses within 0.25); (7d) SE(3) and Sim(3) pose graphs at 256 nodes and
     Sim(3)-CG at 1,200 (cost cut by 50 / 95 / 95 %, ATE down, scale profile
     within 0.2); then ms per call of each, 7c's wall time, M
     obs-updates/s and peak memory, and the launches, device ms and host
     syncs of one ``estimate_two_view`` and of one LM iteration (7b, 7c)
     from ``torch.profiler``;
  8. SLAM tracking on the card (``niftymatch_torch/utils/smoke_slam.py``):
     (8a) ``SlamSystem.process_features`` and ``process_features_batch`` on
     ``make_feature_sequence`` (8 cameras, 400 landmarks, 384 slots,
     ``RansacConfig(512, 4.0)``, window BA every 3 keyframes over 4) with
     one injected RANSAC draw, card against CPU (keyframe flags, inlier
     counts and track ids equal, trajectory within 5e-3 after a Sim(3)
     alignment, room for one borderline RANSAC inlier that flips between
     the two devices' fp32 refits at the gauge pair) and card against a
     second card run (poses bit for bit); (8b) the SLAM loop of
     ``bench.py::bench_slam_loop`` at full width: 113 rendered 640x480
     uint8 frames through ``process_frames`` in chunks of 16, warm-up on
     frames 0-32, frames 33-112 + ``flush_ba`` timed, with the launch
     counts reset just before and read just after (K1 twice a frame plus 8
     per relocalisation verify, K2 and K3 once a chunk): frames/s, the
     accept fraction (>= the JAX package's 1.0 less 0.05), relocalisations,
     inliers, the Sim(3) ATE against the scene (<= 1.5 x the JAX package's
     0.198, ``tools/jax_slam_reference.py``), and one 16-frame chunk's
     launches, kernels, device ms and host waits from ``torch.profiler``;
     (8c) ``global_ba`` on 8b's map (applied, or rejected with its cost
     above the start); (8d) a checkpoint of that map restored into a fresh
     system (trajectory within 1e-6, the last track ids equal), which then
     processes one more frame; (8e) the two-view polish kernel
     (``kernels/refine.py``, ``csrc/refine.cu``) on the inputs that 8b's
     loop passes it, taken from ``estimate_two_view`` on consecutive
     frames of 8b's clip (the E-RANSAC pose and its inliers over the
     loop's 1,024 slots): against the same polish in float64
     (``refine_float64``; cost within 1e-3 of itself, R and t within
     5e-3: fp32 cannot pin these small-baseline poses closer, see
     ``REFINE_POSE_ATOL``), with the fp32 ``refine_relative_pose_plain``'s
     distances printed beside, per pair, and a rerun (bit for bit); its
     ms in a graph of one launch and of 20, with no steps (the launch's
     floor), and the plain version's ms; 8b's timed
     run launches it once a ``slam_step`` (half K1's count); (8f) the
     small-matrix solvers' kernels (``kernels/linalg.py``,
     ``csrc/linalg.cu``: ``svd3x3`` over 512 3 x 3 matrices,
     ``smallest_eigvec`` over 512 9 x 9 DLT normal matrices and 8 x 1,024
     4 x 4 triangulation systems, ``utils/smoke_linalg.py``) against their
     plain versions on the card and a rerun (bit for bit), with each
     kernel's ms in a graph of one launch and of 20, its floor (no sweeps
     or iterations), its bound, the plain version's ms and
     ``torch.linalg.svd`` / ``eigh`` at the same batch;
  9. SLAM loop closure on the card (``niftymatch_torch/utils/smoke_closure.py``):
     (9a) the 12-keyframe closed loop of ``tests/test_slam_e2e.py`` on the
     card and on the CPU with one injected draw (candidates equal up to
     bf16 flips, edges equal, trajectories within 5e-3 after a Sim(3)
     alignment, the test's bars on the card); (9b) the JAX package's 96-frame
     golden closed loop (``benchmarks/ate_artifact.py``'s standard variant)
     through ``process_frames``, ``close_loops``, ``global_ba`` and
     ``finalize(rounds=2)``, its launches counted over the whole run: an
     edge applied, the ATE falls with the closure and ends within 1.5x of
     it and of the JAX package's 0.3936, the bf16 sweep within 2 of the
     oracle at bf16 operand precision and within 2 % + 8 of the fp32
     oracle (its differences printed, at most 5 % outside 2 % + 2), K1
     bf16 once per live keyframe a sweep; the stage
     times and one ``close_loops`` under ``torch.profiler``;
 10. the multi-device layer and the dataset path: (10d,
     ``niftymatch_torch/utils/smoke_dataset.py``) 8b's 113 frames written
     as a TUM RGB-D and an EuRoC directory and run from disk through the
     native loader into ``process_frames`` (8b's poses bit for bit, its
     ATE within 1e-6 from the groundtruth file, the EuRoC frames equal,
     the loader's frames/s, one short chunk under ``utils.profiling.trace``);
     (10a-10c, ``niftymatch_torch/utils/smoke_parallel.py``) at world 1 on
     NCCL in this process and world 2 on gloo in two spawned processes on
     ``cuda:0``: ``shard_detect`` of phase 2's 16 frames and the ring over
     their 16 x 2,048 descriptors and over 9b's keyframe store (world 2
     equal to world 1 bit for bit; against the fp32 oracle every differing
     row one whose ratio test fp32 noise decides; K1 fp32 launches per
     sweep; ms per sweep in each mode; a roofline report), distributed
     PCG BA on 7c's problem and dense BA on 7b's 16 x 4,096 window (world 1
     bit for bit the single-device solvers', world 2 within its bars), and
     9a's loop with its sweep through the ring.

Prints a ``{"geometry": ...}`` line, an ``{"sfm": ...}`` line, a
``{"slam": ...}`` line, a ``{"closure": ...}`` line, a ``{"parallel": ...}``
line, a ``{"dataset": ...}`` line, a ``{"kernels": [...]}`` line (K1-K3,
the polish ``refine_gn`` and the small-matrix solvers with their launches in phase 4 and, as ``slam_launches``,
``closure_launches``, ``ring_launches`` and ``dataset_launches``, in 8b's
timed run, 9b's whole run, 10a's world-1 path (``shard_detect`` and one
mutual ring sweep) and 10d's run from disk; each K4 variant with its
launches in phase 5's microbenchmark and its times there: at both shapes,
the kernel's and in a run of 20), the nvidia-smi line, and as its
last line ``{"ok": true, "device": {...}}``.
Each phase prints its seconds.
Exits non-zero with no result when CUDA is absent or the package is not
beside the script.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

H, W = 480, 640
CHUNK = 8                      # pairs per chunk (16 images), as in bench.py
WARMUP_CHUNKS = 3              # distinct input chunks before the timed run
TIMED_CHUNKS = 40              # distinct input chunks in the timed run (~2 s)
STAGE_REPS = 10                # timed calls of each stage, after 2 warm-ups
MIN_PAIR_MATCHES = 100         # the verify pair at 640x480 gives ~200 features
MIN_BATCH_FEATURES = 100       # per bench image
MIN_BATCH_MATCHES = 50         # per bench pair
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
PEAK_TF32_PER_S = 495e12       # H100 SXM tensor cores, dense TF32
PEAK_BF16_PER_S = 989e12       # H100 SXM tensor cores, dense bf16
# fp32 operations that a window pixel which adds to the result needs (exp,
# division, floor and the add into a bin count one each).  K2: offsets 2,
# r^2 3, weight 3 (scale, exp, times magnitude), bin 4 (times 36, over
# 2 pi, floor, wrap), add 1.  K3: offsets 2, rotation and scaling to bin
# units 8, window weight 6 (squares and sum 3, scale, exp, times
# magnitude), angle wrap and scaling 4, and the nonzero tents of the x, y
# and theta axes from one floor and one fraction, 3 each; then 2 for each
# (ybin, xbin) pair with nonzero tents (tent product, times the weight)
# and 2 for each of its nonzero theta bins (times the tent, add).
K2_OPS_PER_PIXEL = 13
K3_OPS_PER_PIXEL = 29
K3_OPS_PER_PAIR = 2
K3_OPS_PER_BIN = 2
# K4's shapes (k, pairs): benchmarks/fold_micro.py's defaults and its 4K file;
# and the checks' shapes (k, pairs, B rows) of no tile's multiple.
K4_SHAPES = ((1024, 16), (4096, 1))
K4_ODD_SHAPES = ((1000, 3, 1000), (1000, 2, 1))
# fp32 operations of the polish (``csrc/refine.cu``) a correspondence, a
# fused multiply-add counted as two.  The Sampson residual at an E: l0, l1,
# l2, lp0, lp1 and the numerator 4 each, the squared norm 7, its clamp and
# square root 2.  A cost pass adds 4 (the quotient, w r^2 and the add); a
# step's Jacobian pass adds 179: sqrt(max(w, 0)) 2, r 2, c 1, q 2, the two
# vectors 6, the 3 x 3 gradient over E 36, its contractions with the five
# derivative matrices 90, the 15 + 5 sums 40.  A polish is one cost pass
# and, each step, a Jacobian pass and a cost pass; it reads 20 bytes a
# correspondence and R0, t0 once, and writes R, t and the cost.
REFINE_OPS_RESIDUAL = 33
REFINE_OPS_COST = REFINE_OPS_RESIDUAL + 4
REFINE_OPS_JACOBIAN = REFINE_OPS_RESIDUAL + 179
REFINE_ITERATIONS = 10          # refine_relative_pose's default, as the SLAM calls it
REFINE_PAIRS = 8                # consecutive frame pairs of 8b's clip
# 8e's bars against the float64 polish.  On 8b's small-baseline pairs the
# cost valley is flat to fp32: two fp32 implementations of the same steps
# end up to ~1e-3 apart in R and t (the plain fp32 version 4.3e-4 from the
# float64 answer after 10 steps, 1.2e-3 after 40) at costs within 3e-4 of
# each other, while a wrong rotation Jacobian moves R/t by 3e-2 and the
# cost by 2e-2.  So the cost carries the check (the polish lowers it by
# 6-142 %), and R/t is bounded between the two.
REFINE_COST_RTOL = 1e-3
REFINE_POSE_ATOL = 5e-3
# fp32 operations of the small-matrix solvers (``csrc/linalg.cu``) a
# matrix, a fused multiply-add counted as two and a transcendental, a
# square root or a division as one.  svd3x3: E^T E 45 and its symmetrising
# 6; a rotation 7 for its angle (two subtractions, a product, the atan2,
# the half, the cosine, the sine) and 54 for A's columns and rows and V's
# columns, three a sweep; then the square roots 3, U's columns 54, the two
# normalisations 14 each, the projection 11, the cross product 9 and the
# sign 5.  smallest_eigvec at n: the trace and jitter n + 3, the factor
# n(n+1)(2n+1)/6 multiply-adds counted as two and n square roots and
# n(n-1)/2 divisions, and an iteration two substitutions of n^2 operations
# and n divisions each, the norm 2n + 1 and the scaling n + 1.
SVD3X3_OPS = 51 + 3 + 54 + 14 * 2 + 11 + 9 + 5
SVD3X3_OPS_SWEEP = 3 * (7 + 54)
LINALG_SWEEPS = 12             # svd3x3's default, as every caller runs it
LINALG_ITERATIONS = 8          # smallest_eigvec's default, as every caller runs it


def eigvec_ops(n, iterations=LINALG_ITERATIONS):
    factor = n * (n + 1) * (2 * n + 1) // 3 + n + n * (n - 1) // 2
    return n + 3 + factor + iterations * (2 * (n * n + n) + 3 * n + 2)


def make_scene(h, w, seed, n_blobs, device):
    """``bench.py::make_scene``'s blob scene, (h + 16, w + 16): the blob
    parameters are drawn with numpy from the seed, the sum is rendered on
    the card."""
    import torch

    rng = np.random.default_rng(seed)
    params = []
    for _ in range(n_blobs):
        by, bx = rng.uniform(10, h), rng.uniform(10, w)
        bs = rng.uniform(2, 7)
        amp = rng.uniform(60, 255) * rng.choice([-1.0, 1.0])
        params.append((by, bx, bs, amp))
    p = torch.tensor(params, dtype=torch.float32, device=device)
    yy = torch.arange(h + 16, dtype=torch.float32, device=device).view(1, -1, 1)
    xx = torch.arange(w + 16, dtype=torch.float32, device=device).view(1, 1, -1)
    by, bx, bs, amp = (p[:, i].view(-1, 1, 1) for i in range(4))
    blobs = amp * torch.exp(-((yy - by) ** 2 + (xx - bx) ** 2) / (2 * bs**2))
    return blobs.sum(0) + 128.0


def chunk_images(seed0, device):
    """16 images: 8 scenes and the same scenes shifted by 5 px."""
    import torch

    scenes = [make_scene(H, W, seed0 + s, 120, device) for s in range(CHUNK)]
    a = torch.stack([s[:H, :W] for s in scenes])
    b = torch.stack([s[5 : H + 5, 5 : W + 5] for s in scenes])
    return torch.cat([a, b]).contiguous()


def per_call_ms(fn, inputs):
    """ms of each ``fn(x)``, x in ``inputs``, on the card's clock: a CUDA
    event between consecutive calls and no synchronisation between them."""
    import torch

    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(inputs) + 1)]
    events[0].record()
    for x, ev in zip(inputs, events[1:]):
        fn(x)
        ev.record()
    events[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def cuda_ms(fn, reps, warmup=1):
    """Mean ms of ``fn`` on the card: CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps, launches=1):
    """Mean device ms of ``fn`` captured once in a CUDA graph and replayed,
    so the host's launch overhead does not enter a kernel's time; with
    ``launches`` > 1 the graph holds that many calls back to back, and the
    replay's ms is divided by them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, reps) / launches


def window_work(planes, cfg, kp, image, valid, angle0=None, step=256):
    """The work that K2 (``angle0`` None) or K3 must do on this run's data.

    A window pixel is needed where it lies in its octave's image and in
    the function's support: K2's circle, or the part of K3's square
    window where the rotated coordinates give a nonzero tent on both
    spatial axes.  Returns two masks of the planes' shape, the pixels
    whose magnitude must be read (needed by some keypoint) and those whose
    angle must be read (needed, with nonzero magnitude), the fp32
    operations of the needed pixels with nonzero magnitude (the ones that
    add to the result), and the count of those pixels over keypoints."""
    import torch

    from niftymatch_torch.kernels.windows import _window_params
    from niftymatch_torch.ops.descriptor import _spatial_tents, _theta_tents
    from niftymatch_torch.ops.gradients import TWO_PI, div_const, mod_2pi
    from niftymatch_torch.ops.patches import gather_windows, patch_offsets

    sel = valid.nonzero().squeeze(1)
    x, y, sigma, octave, level = (t[sel] for t in kp)
    xo, yo, so, xi, yi, slab = _window_params(planes, x, y, sigma, octave,
                                              level, image[sel])
    r = planes.radius
    k3 = angle0 is not None
    rw = r if k3 else cfg.max_orientation_radius
    if k3:
        sbp = 3.0 * so + 1e-7
        w = torch.floor(math.sqrt(2.0) * sbp * 5 / 2.0 + 0.5).clamp(max=float(r))
        a0 = angle0[sel]
    else:
        w = torch.clamp(torch.floor(3.0 * (1.5 * so)), min=1.0).clamp(max=float(rw))
    ho = torch.full_like(octave, cfg.height) >> octave
    wo = torch.full_like(octave, cfg.width) >> octave
    fy, fx = patch_offsets(rw, x.device)
    iy, ix = fy.long(), fx.long()
    need_mag = torch.zeros(planes.mag.shape, dtype=torch.bool, device=x.device)
    need_ang = torch.zeros_like(need_mag)
    ops = pixels = 0
    for s in range(0, sel.numel(), step):
        c = slice(s, s + step)

        def e(t):  # per keypoint of the step, broadcast over the window
            return t[c][:, None, None]

        dx = fx + e(xi.float() - xo)
        dy = fy + e(yi.float() - yo)
        rows, cols = e(yi.long()) + iy, e(xi.long()) + ix
        need = ((fx.abs() <= e(w)) & (fy.abs() <= e(w)) & (rows >= 0)
                & (rows < e(ho)) & (cols >= 0) & (cols < e(wo)))
        r0, c0 = yi[c] + (r - rw), xi[c] + (r - rw)
        mag = gather_windows(planes.mag, slab[c], r0, c0, 2 * rw + 1)
        if k3:
            st, ct = e(torch.sin(a0)), e(torch.cos(a0))
            nx = (ct * dx + st * dy) / e(sbp)
            ny = (-st * dx + ct * dy) / e(sbp)
            pairs = (_spatial_tents(nx) > 0).sum(-1) * (_spatial_tents(ny) > 0).sum(-1)
            need &= pairs > 0
            ang = gather_windows(planes.ang, slab[c], r0, c0, 2 * rw + 1)
            nt = div_const(8.0 * mod_2pi(ang - e(a0)), TWO_PI)
            bins = pairs * (_theta_tents(nt) > 0).sum(-1)
            per_px = K3_OPS_PER_PIXEL + K3_OPS_PER_PAIR * pairs + K3_OPS_PER_BIN * bins
        else:
            need &= dx * dx + dy * dy < e(w * w) + 0.6
            per_px = K2_OPS_PER_PIXEL
        adds = need & (mag != 0)
        ops += int((adds * per_px).sum())
        pixels += int(adds.sum())
        at = (e(slab.long()).expand_as(need), (rows + r).expand_as(need),
              (cols + r).expand_as(need))
        need_mag[tuple(t[need] for t in at)] = True
        need_ang[tuple(t[adds] for t in at)] = True
    return need_mag, need_ang, ops, pixels


def bound(nbytes, ops, ops_per_s=PEAK_FP32_PER_S):
    """Least ms for the work: bytes at the memory rate or operations at
    their rate (fp32 outside the tensor cores unless given), the larger,
    and which of the two it is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bf16_bound(nbytes, ops):
    """``bound`` with the operations at the tensor cores' bf16 rate."""
    return bound(nbytes, ops, PEAK_BF16_PER_S)


# -- phase 6: geometry and mosaic ------------------------------------------

N_CORR = 2048                  # correspondences, as the 2048 feature slots
MODELS = ("translation", "similarity", "homography", "fundamental",
          "essential", "essential5")
MOSAIC_FRAMES = 8
MOSAIC_STEP = (24, 56)         # (dy, dx) between frames
ROTATED_FRAME = 3              # rendered through warp_perspective
ROT_DEG, ROT_SCALE = 3.0, 1.05


def translation(tx, ty):
    return np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]], np.float64)


def similarity_about(cx, cy, deg, scale):
    c, s = scale * math.cos(math.radians(deg)), scale * math.sin(math.radians(deg))
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return translation(cx, cy) @ rot @ translation(-cx, -cy)


def corners_of(hom, h=None, w=None):
    """Where a 3x3 transform sends the four corners of an h x w frame
    (640x480 by default)."""
    h, w = h or H, w or W
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], float).T
    p = np.asarray(hom, np.float64) @ c
    return (p[:2] / p[2]).T


def synthetic_correspondences(model, seed):
    """N_CORR correspondences of a known model, a third of them outliers,
    made with numpy: pixel coordinates in a 640x480 frame for the 2-D
    models (0.3 px noise), normalised camera coordinates of points seen
    from two poses for the epipolar ones (1e-4 noise).  Returns src, dst,
    the true-inlier mask, the truth (3x3) and the inlier threshold."""
    rng = np.random.default_rng(seed)
    n, out = N_CORR, N_CORR // 3
    truth = np.zeros(n, bool)
    truth[out:] = True
    if model in ("translation", "similarity", "homography"):
        hom = {"translation": translation(7.0, -2.0),
               "similarity": similarity_about(320, 240, ROT_DEG, ROT_SCALE)
               @ translation(12.0, -9.0),
               "homography": np.array([[1.02, 0.03, 5.0], [-0.02, 0.98, -4.0],
                                       [2e-5, -1e-5, 1.0]])}[model]
        src = rng.uniform(0, (W, H), size=(n, 2))
        p = np.c_[src, np.ones(n)] @ hom.T
        dst = p[:, :2] / p[:, 2:] + rng.normal(0, 0.3, (n, 2))
        dst[:out] = rng.uniform(0, (W, H), size=(out, 2))
        return src.astype(np.float32), dst.astype(np.float32), truth, hom, 9.0
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    rot = np.eye(3) + math.sin(0.2) * k + (1 - math.cos(0.2)) * (k @ k)
    t = rng.standard_normal(3)
    t /= np.linalg.norm(t)
    pts = rng.uniform(-1, 1, size=(n, 3))
    pts[:, 2] += 4.0
    x1 = pts[:, :2] / pts[:, 2:] + rng.normal(0, 1e-4, (n, 2))
    p2 = pts @ rot.T + t
    x2 = p2[:, :2] / p2[:, 2:] + rng.normal(0, 1e-4, (n, 2))
    x2[:out] = rng.uniform(-0.5, 0.5, size=(out, 2))
    ess = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]) @ rot
    return x1.astype(np.float32), x2.astype(np.float32), truth, ess, 1e-5


def profiled_launches(fn, top=4):
    """Device events of one call of ``fn`` under torch.profiler: kernels,
    copies and sets apart, the device's busy ms (summed event time) and
    the ``top`` kernel names by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    copies = sum(1 for e in events if e.name.startswith(("Memcpy", "Memset")))
    by_name = {}
    for e in events:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"kernels": len(events) - copies, "copies_and_sets": copies,
            "device_ms": sum(t for _, t in by_name.values()),
            "top": [[name[:60], n, t] for name, (n, t) in heavy]}


def median_ms(fn, reps=10, warmup=2):
    """Median ms on the card's clock of ``reps`` calls after ``warmup``."""
    return float(np.median(per_call_ms(lambda _: fn(), range(warmup + reps))[warmup:]))


def quick_start(nt, fa, fb, mres, dev):
    """The README quick-start on phase 3's pair, and the same call with one
    injected draw on the card and on the CPU."""
    import torch

    from niftymatch_torch.geometry.transforms import transfer_sq_error

    cfg = nt.RansacConfig()
    src, dst, mask = nt.align_points(fa.x, fa.y, fb.x, fb.y, mres.indices, fa.valid,
                                     device=dev)
    shift = corners_of(translation(-5, -5))
    res = nt.ransac(src, dst, mask, cfg, model="homography", device=dev)
    ok, n_inl = bool(res.success), int(res.num_inliers)
    err = np.abs(corners_of(res.transform.cpu()) - shift).max()
    # A sub-pixel threshold keeps only the matches that follow the shift:
    # the default 3 px also takes in matches 0.1-3 px off it (the blob
    # scene is self-similar), which pull the least-squares refit by ~0.5 px.
    fine = nt.ransac(src, dst, mask, nt.RansacConfig(inlier_threshold=0.01),
                     model="homography", device=dev)
    err_fine = np.abs(corners_of(fine.transform.cpu()) - shift).max()
    print(f"[geometry] quick-start: {int(mask.sum())} matches; defaults: {n_inl} inliers, "
          f"corners {err:.4f} px from the (-5, -5) shift; threshold 0.1 px: "
          f"{int(fine.num_inliers)} inliers, corners {err_fine:.4f} px")
    assert ok and n_inl > 100 and err <= 1.0, "quick-start homography is wrong"
    assert bool(fine.success) and int(fine.num_inliers) > 100 and err_fine <= 0.05, \
        "quick-start homography at a sub-pixel threshold is wrong"

    scores = np.random.default_rng(5).gumbel(size=(cfg.iterations, src.shape[0]))
    scores = torch.from_numpy(scores.astype(np.float32))
    rg = nt.ransac(src, dst, mask, cfg, scores=scores, device=dev)
    rc = nt.ransac(src.cpu(), dst.cpu(), mask.cpu(), cfg, scores=scores, device="cpu")
    dc = np.abs(corners_of(rg.transform.cpu()) - corners_of(rc.transform)).max()
    tau = cfg.inlier_threshold
    e_cpu = transfer_sq_error(rc.transform, src.cpu(), dst.cpu()).numpy()
    differ = rg.inliers.cpu().numpy() != rc.inliers.numpy()
    edge = np.abs(e_cpu[differ] - tau).max() if differ.any() else 0.0
    print(f"[geometry] injected draw, card against CPU: corners {dc:.2e} px apart, "
          f"{int(differ.sum())} inlier flags differ (|err - tau| <= {edge:.2e})")
    assert dc <= 1e-3 and edge <= 1e-4 * tau, "card and CPU RANSAC disagree"
    launches = profiled_launches(
        lambda: nt.ransac(src, dst, mask, cfg, model="homography", device=dev))
    print(f"[geometry] one homography ransac call (2048 x 2048): {launches} device events")
    return {"quick_start_inliers": n_inl, "quick_start_corner_err_px": float(err),
            "quick_start_subpixel_inliers": int(fine.num_inliers),
            "quick_start_subpixel_corner_err_px": float(err_fine),
            "card_vs_cpu_corner_px": float(dc), "card_vs_cpu_flag_diffs": int(differ.sum()),
            "ransac_homography_launches": launches}


def every_model(nt, dev):
    """Each RANSAC model once on synthetic correspondences, then its time."""
    import torch

    from niftymatch_torch.geometry.transforms import sampson_sq_error

    out = {}
    for i, model in enumerate(MODELS):
        src, dst, truth, true_t, tau = synthetic_correspondences(model, 100 + i)
        cfg = nt.RansacConfig(inlier_threshold=tau)
        mask = np.ones(N_CORR, bool)

        def call():
            return nt.ransac(src, dst, mask, cfg, model=model, device=dev)

        res = call()
        t = res.transform.cpu().numpy()
        inl = res.inliers.cpu().numpy()
        if model in ("translation", "similarity", "homography"):
            err = float(np.abs(corners_of(t) - corners_of(true_t)).max())
            msg = f"corners {err:.3f} px from the truth"
            good = err < 0.5
        else:
            err = float(sampson_sq_error(torch.from_numpy(t), torch.from_numpy(src),
                                         torch.from_numpy(dst)).numpy()[truth].max())
            share = float(inl[truth].mean())
            msg = f"Sampson error of the true inliers <= {err:.2e}, {share:.4f} flagged"
            good = err < 1e-5 and share >= 0.95
        ms = median_ms(call)
        prof = profiled_launches(call)
        print(f"[geometry] ransac {model}: {int(res.num_inliers)} inliers, {msg}; "
              f"{ms:.3f} ms a call, {prof['kernels']} kernels, {prof['device_ms']:.3f} "
              f"ms of device time")
        assert bool(res.success) and good, f"ransac {model} missed its model"
        out[model] = {"ms": ms, "num_inliers": int(res.num_inliers), "err": err,
                      "launches": prof}
    return out


def mosaic_phase(nt, dev):
    """``MosaicBuilder`` at its defaults over 8 frames of a rendered scene."""
    import torch

    from niftymatch_torch.kernels import _build
    from niftymatch_torch.mosaic import MosaicBuilder, MosaicConfig
    from niftymatch_torch.ops.warp import remap, undistort_map, warp_perspective

    span_y = H + MOSAIC_STEP[0] * (MOSAIC_FRAMES - 1) + 72      # 720
    span_x = W + MOSAIC_STEP[1] * (MOSAIC_FRAMES - 1) + 88      # 1120
    scene = make_scene(span_y - 16, span_x - 16, 21, 300, dev)
    truths, frames = [], []
    for k in range(MOSAIC_FRAMES):
        dy, dx = MOSAIC_STEP[0] * k, MOSAIC_STEP[1] * k
        g = translation(dx, dy)                                # frame -> scene
        if k == ROTATED_FRAME:
            g = g @ similarity_about((W - 1) / 2, (H - 1) / 2, ROT_DEG, ROT_SCALE)
            f = warp_perspective(scene, torch.tensor(g, dtype=torch.float32, device=dev),
                                 (H, W))
        else:
            f = scene[dy:dy + H, dx:dx + W]
        truths.append(g)
        frames.append(f.contiguous())

    mcfg = MosaicConfig(width=W, height=H)
    mb = MosaicBuilder(mcfg, device=dev)
    anchor = translation((mcfg.canvas_width - W) / 2.0, (mcfg.canvas_height - H) / 2.0)
    infos, frame_ms = [], []
    for k, f in enumerate(frames):
        torch.cuda.synchronize()
        if k == 5:
            _build.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        infos.append(mb.add_frame(f))
        end.record()
        end.synchronize()
        frame_ms.append(start.elapsed_time(end))
        if k == 5:
            launches = dict(_build.LAUNCHES)
    print(f"[mosaic] inliers per frame {[i['num_inliers'] for i in infos]}; launches in "
          f"one add_frame: {launches}")
    assert all(i["registered"] for i in infos), "a mosaic frame did not register"
    assert launches == {"k1_match_top2": 2, "k1_match_top2_bf16": 0,
                        "k2_orientation_hist": 1, "k3_descriptor": 1, "refine_gn": 0,
                        "svd3x3": 0, "smallest_eigvec": 2}, \
        ("add_frame did not launch K1 twice, K2 and K3 once and smallest_eigvec "
         "twice")
    chain_err = float(np.abs(corners_of(mb.frame_to_canvas())
                             - corners_of(anchor @ np.linalg.inv(truths[0]) @ truths[-1])).max())
    canvas = mb.result()
    ys, xs = np.nonzero(mb.weights.cpu().numpy() > 0.2)
    ref = scene.cpu().numpy()
    ax, ay = int(anchor[0, 2]), int(anchor[1, 2])
    diff = float(np.median(np.abs(canvas[ys, xs] - ref[ys - ay, xs - ax])))
    print(f"[mosaic] {MOSAIC_FRAMES} frames registered; final chain {chain_err:.3f} px "
          f"from the truth at the corners; median |canvas - scene| {diff:.3f} over "
          f"{len(ys)} covered pixels")
    assert chain_err < 1.0 and diff < 2.0, "mosaic is wrong"

    cam = torch.tensor([500.0, 500.0, 319.5, 239.5])
    dist = torch.tensor([-0.12, 0.03, 0.0])
    mg = undistort_map(cam.to(dev), dist.to(dev), H, W)
    mc = undistort_map(cam, dist, H, W)
    ug = remap(frames[1], *mg).cpu()
    uc = remap(frames[1].cpu(), *mc)
    ud = float((ug - uc).abs().max())
    print(f"[mosaic] undistort_map + remap on the card against the CPU: {ud:.2e}")
    assert ud <= 1e-3, "undistortion differs between card and CPU"

    # Times: add_frame over frames 2-7 (above), then its stages apart, and
    # one more add_frame (frame 7 onto itself) under the profiler.
    feats = [mb._detect(frames[k]) for k in (6, 7)]
    h_canvas = torch.as_tensor(mb.frame_to_canvas(), device=dev)
    stages = {
        "detect_ms": median_ms(lambda: mb._detect(frames[7])),
        "register_ms": median_ms(lambda: mb._register(*feats)),
        "blend_ms": median_ms(lambda: mb._blend(frames[7], h_canvas)),
    }
    prof = profiled_launches(lambda: mb.add_frame(frames[7]))
    return {"add_frame_ms_median": float(np.median(frame_ms[2:])),
            "add_frame_ms": frame_ms, "inliers": [i["num_inliers"] for i in infos],
            "chain_corner_err_px": chain_err, "canvas_median_abs_diff": diff,
            **stages, "add_frame_launches": prof, "undistort_card_vs_cpu": ud}


def per_octave_phase(nt, image, cfg, dev):
    """The per-octave oracle against the merged path (K2/K3) on one image,
    within ``tests/test_sift_e2e.py:74-103``'s tolerances."""
    from niftymatch_torch.sift import detect_and_describe_per_octave

    fo = detect_and_describe_per_octave(image, cfg, device=dev)
    fm = nt.detect_and_describe(image, cfg, device=dev)

    def order(f):
        v = f.valid.cpu().numpy()
        cols = [getattr(f, k).cpu().numpy()[v] for k in ("angle", "y", "x")]
        return v, np.lexsort(cols)

    vo, oo = order(fo)
    vm, om = order(fm)
    assert vo.sum() == vm.sum() > 100, f"per-octave {vo.sum()} against merged {vm.sum()}"
    worst = {}
    for field in ("x", "y", "sigma", "angle", "response", "desc"):
        a = getattr(fo, field).cpu().numpy()[vo][oo]
        b = getattr(fm, field).cpu().numpy()[vm][om]
        worst[field] = float(np.abs(a - b).max())
    print(f"[geometry] per-octave oracle against the merged path, {int(vo.sum())} "
          f"features: max abs diff {worst}")
    assert max(worst.values()) <= 1e-4, "per-octave oracle differs from the merged path"
    return {"per_octave_features": int(vo.sum()), "per_octave_max_diff": worst}


def check_k4(shape, ops, errs, dev, only=None):
    """Phase 2's check of K4's variants (``only`` one of them) on the
    operands ``ops``: against the plain version with ``kernels.fold.
    agreement``'s tolerances and against a second run, bit for bit; ``gemm``
    and ``rowsum`` also with their sums added to 0.  Records each variant's
    largest error in ``errs``; returns the last result."""
    import torch

    from niftymatch_torch.kernels import fold as k4

    a_mat, _, b_mat, b_norm = ops
    d = k4.distances(a_mat, b_mat, b_norm)
    for v in k4.FOLDS if only is None else (only,):
        for base in (k4.BIG, 0.0) if v in ("gemm", "rowsum") else (k4.BIG,):
            got = k4.fold_variant(a_mat, b_mat, b_norm, v, base=base)
            again = k4.fold_variant(a_mat, b_mat, b_norm, v, base=base)
            want = k4.fold_variant_plain(a_mat, b_mat, b_norm, v, base=base)
            torch.cuda.synchronize()
            assert all(torch.equal(u, w) for u, w in zip(got, again)), \
                f"k4 {v} (base {base:g}) at {shape} differs between two runs"
            res = k4.agreement(v, got, want, d, base=base)
            key = k4.launch_name(v)
            errs[key] = max(errs.get(key, 0.0), res["max_abs_err"])
            print(f"[kernels] k4 {v} at (k, nb, n) {shape}, base {base:g}: max abs err "
                  f"{res['max_abs_err']:.3e}, index exempt rows {res['exempt_rows']} of "
                  f"{d.shape[0] * d.shape[1]}; a second run equal bit for bit")
            assert res["ok"], f"k4 {v} (base {base:g}) at {shape} disagrees: {res}"
    return got


def refine_float64(R0, t0, pts_a, pts_b, weights, iterations, damping=1e-6):
    """``sfm.two_view_refine``'s polish in float64: the same damped steps,
    accepts and damping, its Sampson residual and retraction, a float64
    Rodrigues exponential and solve.  The exact answer that 8e holds the
    fp32 kernel and the fp32 plain version to."""
    import torch
    from torch.func import jacfwd

    from niftymatch_torch.sfm import two_view_refine as tr
    from niftymatch_torch.sfm.se3 import hat

    def so3_exp(phi):
        th2 = (phi * phi).sum()
        th = torch.sqrt(th2 + 1e-300)
        small = th2 < 1e-2
        a = torch.where(small, 1 - th2 / 6 + th2 * th2 / 120, torch.sin(th) / th)
        b = torch.where(small, 0.5 - th2 / 24 + th2 * th2 / 720,
                        (1 - torch.cos(th)) / torch.clamp(th2, min=1e-300))
        k = hat(phi)
        return torch.eye(3, dtype=phi.dtype, device=phi.device) + a * k + b * (k @ k)

    R0, t0, pa, pb, w = (x.to(torch.float64) for x in (R0, t0, pts_a, pts_b, weights))
    sw = torch.sqrt(torch.clamp(w, min=0.0))

    def cost_of(R, t):
        return (w * tr._sampson_residuals(hat(t) @ R, pa, pb) ** 2).sum()

    def residuals_of(p, R, t):
        E = hat(tr._retract_t(t, p[3:])) @ (so3_exp(p[:3]) @ R)
        return sw * tr._sampson_residuals(E, pa, pb)

    R, t, cost = R0, t0, cost_of(R0, t0)
    lam = torch.full((), damping, dtype=torch.float64, device=R0.device)
    zero = torch.zeros(5, dtype=torch.float64, device=R0.device)
    eye5 = torch.eye(5, dtype=torch.float64, device=R0.device)
    for _ in range(iterations):
        J = jacfwd(residuals_of)(zero, R, t)
        step = -torch.linalg.solve(J.T @ J + (lam + 1e-9) * eye5, J.T @ residuals_of(zero, R, t))
        Rn, tn = so3_exp(step[:3]) @ R, tr._retract_t(t, step[3:])
        new_cost = cost_of(Rn, tn)
        accept = new_cost < cost
        R, t = torch.where(accept, Rn, R), torch.where(accept, tn, t)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 10.0), 1e-10, 1e4)
    return R, t, cost


def refine_phase(nt, clip, dev):
    """8e: the polish kernel against the exact (float64) polish and its
    fp32 plain version on the card, on the inputs that 8b's SLAM loop
    passes it; ms of both, the bound and the floor of one launch.  Returns
    the kernels line's numbers."""
    import torch
    from unittest import mock

    from niftymatch_torch.features import Features
    from niftymatch_torch.kernels import refine as kr
    from niftymatch_torch.sfm.two_view_refine import refine_relative_pose_plain
    from niftymatch_torch.slam import frontend

    cfg = clip["config"]
    sift = nt.SiftConfig(width=cfg.width, height=cfg.height,
                         max_features=cfg.detector_features)
    imgs = torch.as_tensor(clip["frames"][:REFINE_PAIRS + 1]).to(dev).to(torch.float32)
    batch = nt.detect_and_describe_batch(imgs, sift, device=dev)
    views = [Features(*[f[i] for f in batch]) for i in range(REFINE_PAIRS + 1)]
    with mock.patch.object(frontend, "refine_relative_pose",
                           wraps=frontend.refine_relative_pose) as polish:
        for a, b in zip(views, views[1:]):
            nt.estimate_two_view(a, b, cfg.intrinsics, cfg.ransac, device=dev)
    inputs = [c.args for c in polish.call_args_list]
    assert len(inputs) == REFINE_PAIRS, f"8e: {len(inputs)} polishes for {REFINE_PAIRS} pairs"
    n = inputs[0][2].shape[0]
    assert n == cfg.detector_features, f"8e: the polish got {n} correspondences"
    # The kernel and the fp32 plain version against the float64 polish, per
    # pair; the bars are REFINE_COST_RTOL and REFINE_POSE_ATOL's.
    def gaps(got, want):
        err = max((got[k].double() - want[k].double()).abs().max().item() for k in (0, 1))
        return err, abs(got[2].item() - want[2].item()) / max(abs(want[2].item()), 1e-30)

    errs = {"max_abs_err": 0.0, "cost_rel_err": 0.0, "plain_abs_err": 0.0,
            "plain_cost_rel_err": 0.0, "kernel_vs_plain": 0.0}
    inliers, per_pair = [], []
    for args in inputs:
        got = kr.refine_relative_pose(*args, iterations=REFINE_ITERATIONS)
        again = kr.refine_relative_pose(*args, iterations=REFINE_ITERATIONS)
        plain = refine_relative_pose_plain(*args, iterations=REFINE_ITERATIONS)
        exact = refine_float64(*args, iterations=REFINE_ITERATIONS)
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(got, again)), \
            "refine_gn differs between two runs"
        pair = (*gaps(got, exact), *gaps(plain, exact), gaps(got, plain)[0])
        per_pair.append(pair)
        for key, v in zip(("max_abs_err", "cost_rel_err", "plain_abs_err",
                           "plain_cost_rel_err", "kernel_vs_plain"), pair):
            errs[key] = max(errs[key], v)
        inliers.append(int(args[4].sum().item()))
    print("[slam] 8e per pair, against the float64 polish (kernel R/t, cost; plain R/t, "
          "cost; kernel against plain R/t): " + "; ".join(
              " ".join(f"{v:.2e}" for v in pair) for pair in per_pair))
    assert errs["cost_rel_err"] <= REFINE_COST_RTOL and errs["max_abs_err"] <= REFINE_POSE_ATOL, \
        (f"refine_gn disagrees with the float64 polish: R/t {errs['max_abs_err']:.3e}, "
         f"cost {errs['cost_rel_err']:.3e}")
    # Timed on the pair with the most inliers.
    args = inputs[int(np.argmax(inliers))]
    ms = graph_ms(lambda: kr.refine_relative_pose(*args, iterations=REFINE_ITERATIONS), 20)
    ms_in_run = graph_ms(lambda: kr.refine_relative_pose(*args, iterations=REFINE_ITERATIONS),
                         20, launches=20)
    ms_floor = graph_ms(lambda: kr.refine_relative_pose(*args, iterations=0), 20)
    plain_ms = cuda_ms(lambda: refine_relative_pose_plain(*args, iterations=REFINE_ITERATIONS),
                       3)
    ops = n * (REFINE_OPS_COST + REFINE_ITERATIONS * (REFINE_OPS_JACOBIAN + REFINE_OPS_COST))
    nbytes = 20 * n + 4 * (9 + 3) + 4 * (9 + 3 + 1)
    bound_ms, bound_by = bound(nbytes, ops)
    print(f"[slam] 8e refine_gn on 8b's frames 0-{REFINE_PAIRS} ({REFINE_PAIRS} pairs, N = {n}, "
          f"inliers {inliers}): against the float64 polish R/t max abs err "
          f"{errs['max_abs_err']:.3e} (the fp32 plain version's {errs['plain_abs_err']:.3e}; "
          f"kernel against plain {errs['kernel_vs_plain']:.3e}), cost rel err "
          f"{errs['cost_rel_err']:.3e} (plain {errs['plain_cost_rel_err']:.3e}); a rerun equal "
          f"bit for bit; {ms:.5f} ms a launch ({ms_in_run:.5f} in a graph of 20, "
          f"{ms_floor:.5f} with no steps), plain {plain_ms:.3f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by}: {nbytes} bytes, {ops} ops)")
    return {**errs, "n": n, "inliers": inliers, "ms": ms, "ms_in_run": ms_in_run,
            "ms_no_steps": ms_floor, "plain_ms": plain_ms, "bound": (bound_ms, bound_by),
            "bytes": nbytes, "ops": ops}


def linalg_phase(dev):
    """The small-matrix solvers' kernels (``kernels/linalg.py``,
    ``csrc/linalg.cu``) at the SLAM frame's shapes: ``smoke_linalg``'s
    comparison with the plain versions (raises outside its tolerances),
    then each kernel's ms in a graph of one launch and of 20, its latency
    floor (the kernel with no sweeps or no iterations, in a graph of 20),
    its bound, the plain version's ms (eager, as CPU tensors take it) and
    ``torch.linalg.svd`` / ``eigh`` at the same batch, the library
    yardstick that the port never calls.  Returns the kernels line's rows."""
    import torch

    from niftymatch_torch.geometry import linalg as gl
    from niftymatch_torch.kernels import linalg as kl
    from niftymatch_torch.utils import smoke_linalg

    result = smoke_linalg.compare(dev)
    print(f"[linalg] kernels against the plain versions: {json.dumps(result)}")
    smoke_linalg.check(result)
    E = smoke_linalg.svd_inputs(dev)
    A9 = smoke_linalg.eig9_inputs(dev)
    A4 = smoke_linalg.eig4_inputs(dev)
    cases = (
        ("svd3x3", E, lambda: kl.svd3x3(E), lambda: kl.svd3x3(E, sweeps=0),
         lambda: gl.svd3x3_plain(E), lambda: torch.linalg.svd(E),
         SVD3X3_OPS + LINALG_SWEEPS * SVD3X3_OPS_SWEEP, 4 * (9 + 9 + 3 + 9)),
        ("smallest_eigvec_n9", A9, lambda: kl.smallest_eigvec(A9),
         lambda: kl.smallest_eigvec(A9, 0), lambda: gl.smallest_eigvec_plain(A9),
         lambda: torch.linalg.eigh(A9), eigvec_ops(9), 4 * (81 + 9)),
        ("smallest_eigvec_n4", A4, lambda: kl.smallest_eigvec(A4),
         lambda: kl.smallest_eigvec(A4, 0), lambda: gl.smallest_eigvec_plain(A4),
         lambda: torch.linalg.eigh(A4), eigvec_ops(4), 4 * (16 + 4)),
    )
    rows = {}
    for key, A, kernel, floor, plain, library, ops_each, bytes_each in cases:
        batch = A.numel() // (A.shape[-1] ** 2)
        ops, nbytes = batch * ops_each, batch * bytes_each
        bound_ms, bound_by = bound(nbytes, ops)
        rows[key] = {
            "batch": batch, "ms": graph_ms(kernel, 20),
            "ms_in_run": graph_ms(kernel, 20, launches=20),
            "ms_floor": graph_ms(floor, 20, launches=20),
            "plain_ms": cuda_ms(plain, 5), "library_ms": cuda_ms(library, 20),
            "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops, "bytes": nbytes}
        r = rows[key]
        print(f"[linalg] {key} at a batch of {batch}: {r['ms']:.5f} ms a launch "
              f"({r['ms_in_run']:.5f} in a graph of 20, {r['ms_floor']:.5f} with no "
              f"sweeps or iterations), plain {r['plain_ms']:.3f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {bound_ms:.7f} ms ({bound_by}: "
              f"{nbytes} bytes, {ops} ops)")
    rows["check"] = result
    return rows


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def linalg_only():
    """``python3 chip_smoke.py linalg``: build the small-matrix solvers'
    library and run :func:`linalg_phase` alone."""
    import torch

    from niftymatch_torch.kernels import _build

    build_s = _build.build_all(("linalg",))
    print(f"[build] linalg built in {build_s:.1f} s on {card_line()} (torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})")
    for line in _build.build_log("linalg").splitlines():
        if any(w in line for w in ("registers", "spill", "warning")):
            print(f"[build] linalg.cu: {line.strip()}")
    print(json.dumps({"linalg": linalg_phase(torch.device("cuda"))}))


def main(args=()):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if list(args) == ["linalg"]:
        return linalg_only()
    import niftymatch_torch as nt
    from niftymatch_torch.features import Features
    from niftymatch_torch.kernels import _build
    from niftymatch_torch.kernels import fold as k4
    from niftymatch_torch.kernels import match as k1
    from niftymatch_torch.kernels import windows as kw
    from niftymatch_torch.sift import describe_keypoints, keypoints_and_planes
    from niftymatch_torch.utils import smoke_fold

    dev = torch.device("cuda")
    cfg = nt.SiftConfig(width=W, height=H)
    pcfg = nt.PipelineConfig(sift=cfg)
    nt.utils.exact_fp32()

    phase_s, t_phase = {}, time.perf_counter()   # seconds of each phase

    # -- 1. build -----------------------------------------------------------
    build_s = _build.build_all(_build.SOURCES)
    smi = card_line()
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    print(f"[build] kernels built in {build_s:.1f} s on {card}")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("registers", "spill", "warning", "(C75")):
                print(f"[build] {name}.cu: {line.strip()}")

    phase_s["1"], t_phase = time.perf_counter() - t_phase, time.perf_counter()

    # -- 2. kernels against their plain versions, main-path inputs ----------
    images = chunk_images(0, dev)
    mk, planes = keypoints_and_planes(images, cfg)
    b, m = mk["x"].shape
    fl = {k: v.reshape(-1) for k, v in mk.items()}
    image = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(m)
    kp = [fl[k] for k in ("x", "y", "sigma", "octave", "level")]
    n_valid = int(fl["valid"].sum())
    hk = kw.orientation_hists(planes, *kp, fl["valid"], cfg, image=image)
    hk_again = kw.orientation_hists(planes, *kp, fl["valid"], cfg, image=image)
    hp = kw.orientation_hists_plain(planes, *kp, fl["valid"], cfg, image)
    angles, avalid = kw.compute_orientations_merged_kernel(
        planes, *kp, fl["valid"], cfg, image=image)
    angle0 = angles[:, 0].contiguous()
    dvalid = (fl["valid"] & avalid[:, 0]).contiguous()
    dk = kw.descriptors(planes, *kp, angle0, dvalid, cfg, image=image)
    dk_again = kw.descriptors(planes, *kp, angle0, dvalid, cfg, image=image)
    dp = kw.descriptors_plain(planes, *kp, angle0, dvalid, cfg, image)
    torch.cuda.synchronize()
    assert torch.equal(hk, hk_again), "k2 differs between two runs"
    assert torch.equal(dk, dk_again), "k3 differs between two runs"
    errs = {}
    for key, got, want in (("k2", hk, hp), ("k3", dk, dp)):
        scale = want.abs().amax(dim=-1, keepdim=True).clamp(min=1.0)
        rel = ((got - want).abs() / scale).max().item()
        errs[key] = (got - want).abs().max().item()
        print(f"[kernels] {key}: max abs err {errs[key]:.3e}, max err / row max "
              f"{rel:.3e} over {n_valid} valid of {b * m} slots")
        assert rel <= 1e-4, f"{key} disagrees with its plain version"
        assert torch.isfinite(got).all()

    feats = nt.detect_and_describe_batch(images, cfg, device=dev)
    desc_a, desc_b = feats.desc[:CHUNK], feats.desc[CHUNK:]
    bvalid = feats.valid[CHUNK:]
    k1_inputs = {}
    for bf16 in (False, True):
        a_mat, a_norm = k1.prepare_descriptors(desc_a, bf16)
        b_mat, b_norm = k1.prepare_descriptors(desc_b, bf16)
        b_norm = torch.where(bvalid, b_norm, torch.full_like(b_norm, k1.MASKVAL))
        k1_inputs[bf16] = (a_mat, b_mat, a_norm, b_norm)
        got = k1.fused_match_topk_prepared(*k1_inputs[bf16])
        again = k1.fused_match_topk_prepared(*k1_inputs[bf16])
        w1, wi, w2 = k1.fused_match_topk_plain(*k1_inputs[bf16])
        torch.cuda.synchronize()
        g1, gi, g2 = got
        key = "k1_bf16" if bf16 else "k1"
        assert all(torch.equal(u, v) for u, v in zip(got, again)), \
            f"{key} differs between two runs"
        errs[key] = max((g1 - w1).abs().max().item(), (g2 - w2).abs().max().item())
        if not bf16:
            unique = (w2 - w1) > 1e-3
            bad_idx = int((gi != wi)[unique].sum())
            print(f"[kernels] k1 fp32: max abs err {errs['k1']:.3e}, index "
                  f"mismatches {bad_idx} of {int(unique.sum())} rows with gap > 1e-3")
            assert errs["k1"] <= 2e-3 and bad_idx == 0, "k1 fp32 disagrees"
        else:
            clear = (w2 - w1) > 2e-2 * torch.maximum(w1.abs(), w2.abs())
            agree = (gi == wi)[clear].float().mean().item()
            print(f"[kernels] k1 bf16: max abs err {errs['k1_bf16']:.3e}, index "
                  f"agreement {agree:.5f} over {int(clear.sum())} rows with gap > 2%")
            assert agree > 0.999, "k1 bf16 disagrees"
    print("[kernels] k1 (fp32, bf16), k2 and k3: a second run equals the first "
          "bit for bit")

    # K4 at both shapes of its path and two odd ones; gemm and rowsum also
    # with their sums added to 0, since at 3.4e38 every sum reads 3.4e38;
    # then ties across the splits of (4096, 1).
    for k, nb, n in tuple(s + (None,) for s in K4_SHAPES) + K4_ODD_SHAPES:
        ops4 = smoke_fold.operands(k, nb, dev, n=n)
        check_k4((k, nb, n), ops4, errs, dev)
    rows4 = list(range(0, 4096, 331))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bounds4 = k4.split_bounds(4096, k4.column_splits(1, 4096, 4096, sms))
    assert len(bounds4) == 4, "k4 at (4096, 1) is not split 4 ways"
    ties = [(0, i, bounds4[0][0] + j, bounds4[-1][0] + j) for j, i in enumerate(rows4)]
    tied = smoke_fold.plant_ties(smoke_fold.operands(4096, 1, dev), ties)
    lower = torch.tensor([c for _, _, c, _ in ties], dtype=torch.int32)
    for v in k4.FOLDS:
        g1, gi, g2 = (t[0, rows4].cpu() for t in check_k4((4096, 1, "tied"), tied, errs, dev, v))
        if v not in ("gemm", "rowsum", "min1"):
            assert torch.equal(g1, g2), f"k4 {v}: a planted tie's min2 is not its min1"
        if v in ("current", "pipe", "top2idx", "bf16", "slotpack"):
            assert torch.equal(gi, lower), f"k4 {v}: a tie across splits lost its lower column"
    print(f"[kernels] k4 ties across {len(bounds4)} splits at (4096, 1), {len(ties)} rows: "
          f"min2 = min1, idx1 the lower column")
    a_mat4, _, b_mat4, b_norm4 = smoke_fold.operands(*K4_SHAPES[0], dev)
    a_big4, _, b_big4, b_norm_big4 = smoke_fold.operands(*K4_SHAPES[1], dev)

    phase_s["2"], t_phase = time.perf_counter() - t_phase, time.perf_counter()

    # -- 3. the pair path ---------------------------------------------------
    scene = make_scene(H, W, 0, 80, dev)
    run = nt.make_pair_pipeline(pcfg, device=dev)
    fa, fb, mres = run(scene[:H, :W], scene[5 : H + 5, 5 : W + 5])
    idx = mres.indices.cpu().numpy()
    matched = (idx >= 0) & fa.valid.cpu().numpy()
    dx = fb.x.cpu().numpy()[idx[matched]] - fa.x.cpu().numpy()[matched]
    med = float(np.median(dx))
    print(f"[pair] features {int(fa.count())} / {int(fb.count())}, matches "
          f"{int(matched.sum())}, median dx {med:.4f} (expect -5)")
    assert matched.sum() > MIN_PAIR_MATCHES and abs(med + 5.0) <= 0.01, "pair path is wrong"

    phase_s["3"], t_phase = time.perf_counter() - t_phase, time.perf_counter()

    # -- 4. the batch path (the main path whose launches are counted) ------
    def pair_chunk(imgs):
        f = nt.detect_and_describe_batch(imgs, cfg, device=dev)
        half = [Features(*[t[:CHUNK] for t in f]), Features(*[t[CHUNK:] for t in f])]
        return f, nt.match_pair(*half, device=dev)

    _build.reset_launches()
    fbatch, mbatch = pair_chunk(images)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"[batch] launches in one 8-pair chunk: {launches}")
    assert launches == {k: int(k not in ("k1_match_top2_bf16", "refine_gn", "svd3x3",
                                         "smallest_eigvec"))
                        for k in launches}, "a kernel of the path did not run once"
    halves = [Features(*[t[:CHUNK] for t in fbatch]),
              Features(*[t[CHUNK:] for t in fbatch])]
    _build.reset_launches()
    mbf16 = nt.match_pair(*halves, precision="bf16", device=dev)
    torch.cuda.synchronize()
    bf16_launches = dict(_build.LAUNCHES)
    print(f"[batch] launches in one bf16 match_pair of 8 pairs: {bf16_launches}")
    assert bf16_launches == {k: int(k == "k1_match_top2_bf16") for k in bf16_launches}
    launches["k1_match_top2_bf16"] = bf16_launches["k1_match_top2_bf16"]
    assert fbatch.desc.shape == (2 * CHUNK, cfg.max_features, 128)
    assert mbatch.indices.shape == (CHUNK, cfg.max_features)
    assert torch.isfinite(fbatch.desc).all() and torch.isfinite(fbatch.x).all()
    n_feat = fbatch.count().cpu().numpy()
    n_match = ((mbatch.indices >= 0) & fbatch.valid[:CHUNK]).sum(-1).cpu().numpy()
    print(f"[batch] features per image {n_feat.tolist()}")
    n_match_bf16 = ((mbf16.indices >= 0) & fbatch.valid[:CHUNK]).sum(-1).cpu().numpy()
    print(f"[batch] matches per pair {n_match.tolist()} (bf16: {n_match_bf16.tolist()})")
    assert (n_feat > MIN_BATCH_FEATURES).all() and (n_match > MIN_BATCH_MATCHES).all()
    assert (n_match_bf16 > MIN_BATCH_MATCHES).all()
    worst = 0.0
    for i in range(2 * CHUNK):
        one = nt.detect_and_describe(images[i], cfg, device=dev)
        vb = fbatch.valid[i].cpu().numpy()
        v1 = one.valid.cpu().numpy()
        assert vb.sum() == v1.sum(), f"image {i}: batch and single counts differ"
        ob = np.lexsort((fbatch.y[i].cpu().numpy()[vb], fbatch.x[i].cpu().numpy()[vb]))
        o1 = np.lexsort((one.y.cpu().numpy()[v1], one.x.cpu().numpy()[v1]))
        for field in ("x", "desc"):
            got = getattr(fbatch, field)[i].cpu().numpy()[vb][ob]
            want = getattr(one, field).cpu().numpy()[v1][o1]
            worst = max(worst, float(np.abs(got - want).max()))
    print(f"[batch] batch vs single-image max abs diff {worst:.3e}")
    assert worst <= 1e-5, "batch differs from single-image runs"

    small = nt.SiftConfig(width=128, height=96, max_keypoints_per_level=64,
                          max_features=256)
    img = make_scene(96, 128, 7, 30, dev)[:96, :128]
    fg = nt.detect_and_describe(img, small, device=dev)
    fc = nt.detect_and_describe(img.cpu(), small, device="cpu")
    vg, vc = fg.valid.cpu().numpy(), fc.valid.cpu().numpy()
    assert vg.sum() == vc.sum() > 10, "card and CPU find different keypoints"
    og = np.lexsort((fg.y.cpu().numpy()[vg], fg.x.cpu().numpy()[vg]))
    oc = np.lexsort((fc.y.numpy()[vc], fc.x.numpy()[vc]))
    for field, tol in (("x", 1e-4), ("y", 1e-4), ("angle", 1e-4), ("desc", 2e-3)):
        d = np.abs(getattr(fg, field).cpu().numpy()[vg][og]
                   - getattr(fc, field).numpy()[vc][oc]).max()
        assert d <= tol, f"card vs CPU {field} differs by {d}"
    print(f"[batch] 96x128 on the card equals the CPU run ({int(vg.sum())} features)")

    phase_s["4"], t_phase = time.perf_counter() - t_phase, time.perf_counter()

    # -- 5. times -----------------------------------------------------------
    chunks = [chunk_images(1000 + 100 * c, dev)
              for c in range(WARMUP_CHUNKS + TIMED_CHUNKS)]
    for c in chunks[:WARMUP_CHUNKS]:
        pair_chunk(c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk_times = per_call_ms(pair_chunk, chunks[WARMUP_CHUNKS:])
    host_s = time.perf_counter() - t0
    chunk_ms = sum(chunk_times) / TIMED_CHUNKS
    kf_s = 2 * CHUNK / (chunk_ms / 1000.0)

    stage_fns = {
        "front_end_ms": lambda: keypoints_and_planes(images, cfg),
        "describe_ms": lambda: describe_keypoints(mk, planes, cfg),
        "match_ms": lambda: nt.match_pair(*halves, device=dev),
    }
    stage = {}
    for key, fn in stage_fns.items():
        times = per_call_ms(lambda _: fn(), range(2 + STAGE_REPS))[2:]
        stage[key] = float(np.median(times))

    reps = 20
    k2_ms = graph_ms(lambda: kw.orientation_hists(planes, *kp, fl["valid"], cfg,
                                                   image=image), reps)
    k3_ms = graph_ms(lambda: kw.descriptors(planes, *kp, angle0, dvalid, cfg,
                                            image=image), reps)
    k1_ms = graph_ms(lambda: k1.fused_match_topk_prepared(*k1_inputs[False]), reps)
    k1_bf16_ms = graph_ms(lambda: k1.fused_match_topk_prepared(*k1_inputs[True]), reps)
    k2_plain = cuda_ms(lambda: kw.orientation_hists_plain(
        planes, *kp, fl["valid"], cfg, image), 3)
    k3_plain = cuda_ms(lambda: kw.descriptors_plain(
        planes, *kp, angle0, dvalid, cfg, image), 3)
    k1_plain = cuda_ms(lambda: k1.fused_match_topk_plain(*k1_inputs[False]), 3)
    k1_bf16_plain = cuda_ms(lambda: k1.fused_match_topk_plain(*k1_inputs[True]), 3)

    def k1_library(a_mat, b_mat, a_norm, b_norm):
        # cuBLAS baddbmm + topk; with bf16 operands the distances come out
        # in bf16, the nearest one call gets to the same function.
        d = torch.baddbmm(b_norm[:, None, :].to(a_mat.dtype), a_mat,
                          b_mat.transpose(1, 2), alpha=-2.0)
        return torch.topk(d, 2, dim=-1, largest=False)

    k1_lib = graph_ms(lambda: k1_library(*k1_inputs[False]), reps)
    k1_bf16_lib = graph_ms(lambda: k1_library(*k1_inputs[True]), reps)

    # Bounds from this run's inputs.  K2/K3 read only the needed pixels of
    # the planes; each slot's valid flag is read and its output written,
    # and a valid slot's x, y, sigma, octave, level, image (and K3's
    # angle0) are read.
    bounds = {}
    for key, valid_k, a0, out_w in (("k2", fl["valid"], None, 36),
                                    ("k3", dvalid, angle0, 128)):
        need_mag, need_ang, ops, pix = window_work(planes, cfg, kp, image,
                                                   valid_k, a0)
        n_k = int(valid_k.sum())
        nbytes = (4 * int(need_mag.sum()) + 4 * int(need_ang.sum()) + b * m
                  + (24 + 4 * (a0 is not None)) * n_k + out_w * 4 * b * m)
        bounds[key] = (*bound(nbytes, ops), nbytes, ops, pix)
    # K1: fp32 mode's least work on the tensor cores is 3xTF32, three
    # products at the TF32 rate; bf16 mode's is one at the bf16 rate.
    for key, bf16, products, rate in (("k1", False, 3, PEAK_TF32_PER_S),
                                      ("k1_bf16", True, 1, PEAK_BF16_PER_S)):
        a_mat, b_mat, a_norm, b_norm = k1_inputs[bf16]
        p_, m_, d_ = a_mat.shape
        k1_ops = products * 2 * p_ * m_ * b_mat.shape[1] * d_
        k1_bytes = ((a_mat.numel() + b_mat.numel()) * a_mat.element_size()
                    + (a_norm.numel() + b_norm.numel()) * 4 + 12 * p_ * m_)
        bounds[key] = (*bound(k1_bytes, k1_ops, rate), k1_bytes, k1_ops, None)

    print(f"[time] {card}")
    print(f"[time] 8-pair chunk (16 x 640x480 detect+describe, 8 matches), "
          f"{TIMED_CHUNKS} distinct chunks after {WARMUP_CHUNKS} warm-up: mean "
          f"{chunk_ms:.3f} ms on the card's clock ({1e3 * host_s / TIMED_CHUNKS:.3f} "
          f"on the host's), {kf_s:.1f} keyframes/s; per chunk median "
          f"{np.median(chunk_times):.3f}, min {min(chunk_times):.3f}, max "
          f"{max(chunk_times):.3f} ms")
    print(f"[time] stages of one chunk: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage.items()))
    for key, ms, plain, lib in (("k1", k1_ms, k1_plain, k1_lib),
                                ("k1_bf16", k1_bf16_ms, k1_bf16_plain, k1_bf16_lib),
                                ("k2", k2_ms, k2_plain, None),
                                ("k3", k3_ms, k3_plain, None)):
        bd = bounds[key]
        print(f"[time] {key}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bd[0]:.4f} ms ({bd[1]}: {bd[2]} bytes, {bd[3]} ops)"
              + (f", library {lib:.4f} ms" if lib is not None else ""))

    # K4's path: the fold microbenchmark at both shapes, its launches counted.
    _build.reset_launches()
    k4_rows = {shape: smoke_fold.run(*shape, graph_ms, bf16_bound, reps=reps, device=dev)
               for shape in K4_SHAPES}
    torch.cuda.synchronize()
    k4_launches = dict(_build.K4_LAUNCHES)
    for v in k4.FOLDS:
        assert k4_launches[k4.launch_name(v)] > 0, f"k4 {v} did not run in its benchmark"
    k4_plain = {v: cuda_ms(lambda: k4.fold_variant_plain(a_mat4, b_mat4, b_norm4, v), 3)
                for v in k4.FOLDS}

    def k4_library(a_mat, b_mat, b_norm):
        # `current` in one call: bf16 baddbmm (distances in bf16) + topk.
        d = torch.baddbmm(b_norm[:, None, :].to(a_mat.dtype), a_mat,
                          b_mat.transpose(1, 2), alpha=-2.0)
        return torch.topk(d, 2, dim=-1, largest=False)

    k4_lib = {K4_SHAPES[0]: graph_ms(lambda: k4_library(a_mat4, b_mat4, b_norm4), reps),
              K4_SHAPES[1]: graph_ms(lambda: k4_library(a_big4, b_big4, b_norm_big4), reps)}
    for shape, rows in k4_rows.items():
        print(f"[time] k4 fold microbenchmark, k {shape[0]}, nb {shape[1]} (bound "
              f"{rows[0]['bound_ms']:.5f} ms, {rows[0]['bound_by']}; a graph of one zero_() "
              f"{rows[0]['timer_floor_ms']:.5f} ms): " + ", ".join(
                  f"{r['fold']} {r['ms']:.5f} ms ({r['pct_of_bound']:.1f} %, "
                  f"{r['us_over_rowsum']:+.2f} us; in a run {r['ms_in_run']:.5f})"
                  for r in rows))
    print(f"[time] k4 plain ms at k 1024, nb 16: {k4_plain}; library (current: bf16 "
          f"baddbmm + topk) {k4_lib[K4_SHAPES[0]]:.5f} ms, at k 4096, nb 1 "
          f"{k4_lib[K4_SHAPES[1]]:.5f} ms; launches {k4_launches}")

    phase_s["5"], t_phase = time.perf_counter() - t_phase, time.perf_counter()

    # -- 6. geometry and mosaic --------------------------------------------
    geometry = quick_start(nt, fa, fb, mres, dev)
    geometry["ransac"] = every_model(nt, dev)
    geometry["mosaic"] = mosaic_phase(nt, dev)
    geometry.update(per_octave_phase(nt, scene[:H, :W], cfg, dev))

    phase_s["6"], t_phase = time.perf_counter() - t_phase, time.perf_counter()

    # -- 7. the SfM back-end -----------------------------------------------
    from niftymatch_torch.utils import smoke_sfm

    sfm = smoke_sfm.run(dev)
    phase_s["7"], t_phase = time.perf_counter() - t_phase, time.perf_counter()

    # -- 8. SLAM tracking ---------------------------------------------------
    from niftymatch_torch.utils import smoke_slam

    slam, clip_8b = smoke_slam.run(dev)
    slam_launches = slam["loop"]["timed_launches"]
    for name in ("k1_match_top2", "k2_orientation_hist", "k3_descriptor"):
        assert slam_launches[name] > 0, f"{name} did not run in the SLAM loop"
    assert 2 * slam_launches["refine_gn"] == slam_launches["k1_match_top2"], \
        f"8b did not launch the polish once a slam_step: {slam_launches}"
    refine = refine_phase(nt, clip_8b, dev)
    errs["refine"] = refine["max_abs_err"]
    bounds["refine"] = (*refine["bound"], refine["bytes"], refine["ops"], None)
    linalg = linalg_phase(dev)
    phase_s["8"], t_phase = time.perf_counter() - t_phase, time.perf_counter()

    # -- 9. SLAM loop closure ----------------------------------------------
    from niftymatch_torch.utils import smoke_closure

    closure, store_9b, cfg_9b = smoke_closure.run(dev)
    closure_launches = closure["golden"]["launches"]
    for name in ("k1_match_top2", "k1_match_top2_bf16", "k2_orientation_hist",
                 "k3_descriptor", "refine_gn"):
        assert closure_launches[name] > 0, f"{name} did not run in the closed loop"
    phase_s["9"], t_phase = time.perf_counter() - t_phase, time.perf_counter()

    # -- 10. the multi-device layer and the dataset path -------------------
    from niftymatch_torch.utils import smoke_dataset, smoke_parallel

    dataset, dataset_launches = smoke_dataset.run(
        dev, clip_8b["frames"], clip_8b["scene"], clip_8b["config"], clip_8b["poses"],
        clip_8b["ate"], clip_8b["warmup"])
    parallel, ring_launches = smoke_parallel.run(dev, images, store_9b,
                                                 cfg_9b.loop_min_matches, cfg_9b.loop_min_gap)
    for name in ("k1_match_top2", "k2_orientation_hist", "k3_descriptor"):
        assert ring_launches[name] > 0, f"{name} did not run on the ring's path"
    phase_s["10"] = time.perf_counter() - t_phase
    print("[phases] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))

    def row(key, name, source, replaces, ms, plain, lib):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "slam_launches": slam_launches[name],
                "closure_launches": closure_launches[name],
                "ring_launches": ring_launches[name],
                "dataset_launches": dataset_launches[name],
                "max_abs_err": errs[key], "ms": ms, "plain_ms": plain,
                "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                "library_ms": lib}

    def k4_row(v):
        at = {shape: next(r for r in rows if r["fold"] == v)
              for shape, rows in k4_rows.items()}
        main, big = at[K4_SHAPES[0]], at[K4_SHAPES[1]]
        return {"name": k4.launch_name(v), "route": "cuda",
                "source": "niftymatch_torch/csrc/fold_micro.cu",
                "replaces": "benchmarks/fold_micro.py:59",
                "launches": k4_launches[k4.launch_name(v)],
                "max_abs_err": errs[k4.launch_name(v)], "ms": main["ms"],
                "plain_ms": k4_plain[v], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"],
                "library_ms": k4_lib[K4_SHAPES[0]] if v == "current" else None,
                "ms_in_run": main["ms_in_run"],
                "timer_floor_ms": main["timer_floor_ms"],
                "ms_k4096_nb1": big["ms"], "ms_in_run_k4096_nb1": big["ms_in_run"],
                "bound_ms_k4096_nb1": big["bound_ms"],
                "library_ms_k4096_nb1": k4_lib[K4_SHAPES[1]] if v == "current" else None}

    kernels = [
        row("k1", "k1_match_top2", "niftymatch_torch/csrc/match.cu",
            "niftymatch_tpu/pallas/match.py:54", k1_ms, k1_plain, k1_lib),
        row("k1_bf16", "k1_match_top2_bf16", "niftymatch_torch/csrc/match.cu",
            "niftymatch_tpu/pallas/match.py:54", k1_bf16_ms, k1_bf16_plain,
            k1_bf16_lib),
        row("k2", "k2_orientation_hist", "niftymatch_torch/csrc/windows.cu",
            "niftymatch_tpu/pallas/windows.py:161", k2_ms, k2_plain, None),
        row("k3", "k3_descriptor", "niftymatch_torch/csrc/descriptors.cu",
            "niftymatch_tpu/pallas/windows.py:363", k3_ms, k3_plain, None),
        {**row("refine", "refine_gn", "niftymatch_torch/csrc/refine.cu", None,
               refine["ms"], refine["plain_ms"], None),
         "n": refine["n"], "cost_rel_err": refine["cost_rel_err"],
         "plain_abs_err": refine["plain_abs_err"], "kernel_vs_plain": refine["kernel_vs_plain"],
         "ms_in_run": refine["ms_in_run"], "ms_no_steps": refine["ms_no_steps"]},
    ] + [{"name": name, "route": "cuda", "source": "niftymatch_torch/csrc/linalg.cu",
          "replaces": None, "launches": launches[name], "slam_launches": slam_launches[name],
          "closure_launches": closure_launches[name], "ring_launches": ring_launches[name],
          "dataset_launches": dataset_launches[name], **linalg[key]}
         for name, key in (("svd3x3", "svd3x3"), ("smallest_eigvec", "smallest_eigvec_n9"),
                           ("smallest_eigvec", "smallest_eigvec_n4"))
         ] + [k4_row(v) for v in k4.FOLDS]
    print(json.dumps({"e2e": {"chunk_ms": chunk_ms, "keyframes_per_s": kf_s,
                              "host_chunk_ms": 1e3 * host_s / TIMED_CHUNKS,
                              "chunk_ms_median": float(np.median(chunk_times)),
                              "chunk_ms_min": min(chunk_times),
                              "chunk_ms_max": max(chunk_times),
                              **stage, "k1_bf16_ms": k1_bf16_ms,
                              "valid_keypoints": n_valid,
                              "k2_adding_pixels": bounds["k2"][4],
                              "k3_adding_pixels": bounds["k3"][4],
                              "k4_fold_micro": {f"k{k}_nb{nb}": rows
                                                for (k, nb), rows in k4_rows.items()}}}))
    print(json.dumps({"geometry": geometry}))
    print(json.dumps({"sfm": sfm}))
    print(json.dumps({"slam": slam}))
    print(json.dumps({"closure": closure}, default=str))
    print(json.dumps({"parallel": parallel}, default=str))
    print(json.dumps({"dataset": dataset}, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
