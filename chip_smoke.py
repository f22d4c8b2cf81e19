"""Chip smoke test of the PyTorch/CUDA port (``niftymatch_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``niftymatch_torch/csrc`` and drives the
port's main path, the flagship forward step: SIFT detect + describe on
640x480 grayscale images and ratio-test matching of image pairs, with the
default ``SiftConfig(640, 480)`` (4 octaves, 512 keypoints per level, 2048
features) and the workload of ``bench.py``: 8 pairs (16 images) per chunk,
distinct inputs per call.

Phases (any failed check raises, so the script exits non-zero):
  1. build the kernels; print the build time and the card's name and power
     limit;
  2. hold each kernel (K1 match, K2 orientation, K3 descriptor) against its
     plain PyTorch version on the main path's own inputs;
  3. the pair path: a scene and the same scene shifted by 5 px, through
     ``make_pair_pipeline``: > 100 matches, median dx = -5.00 +- 0.01;
  4. the batch path: ``detect_and_describe_batch`` on 16 images and one
     batched ``match_pair`` of 8 pairs, with the launch counts reset just
     before and read just after (each kernel once), the batch equal to
     single-image runs within 1e-5, and a 96x128 image on the card equal
     to the CPU run within the repo's tolerances;
  5. times with CUDA events: ms per 8-pair chunk over 40 distinct chunks
     (about 2 s) after 3 warm-up chunks, keyframes/s, each stage, and each
     kernel beside its plain version, its bound (the bytes and operations
     this run's keypoints need) and (K1) one library call computing the
     same function.

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and as its last
line ``{"ok": true, "device": {...}}``.  Exits non-zero with no result when
CUDA is absent or the package is not beside the script.
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


def graph_ms(fn, reps):
    """Mean device ms of ``fn`` captured once in a CUDA graph and replayed,
    so the host's launch overhead does not enter a kernel's time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


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


def bound(nbytes, ops):
    """Least ms for the work: bytes at the memory rate or fp32 operations
    at the fp32 rate, the larger, and which of the two it is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import niftymatch_torch as nt
    from niftymatch_torch.features import Features
    from niftymatch_torch.kernels import _build
    from niftymatch_torch.kernels import match as k1
    from niftymatch_torch.kernels import windows as kw
    from niftymatch_torch.sift import describe_keypoints, keypoints_and_planes

    dev = torch.device("cuda")
    cfg = nt.SiftConfig(width=W, height=H)
    pcfg = nt.PipelineConfig(sift=cfg)
    nt.utils.exact_fp32()

    # -- 1. build -----------------------------------------------------------
    build_s = _build.build_all()
    smi = card_line()
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    print(f"[build] kernels built in {build_s:.1f} s on {card}")
    for name in ("windows", "match"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}.cu: {line.strip()}")

    # -- 2. kernels against their plain versions, main-path inputs ----------
    images = chunk_images(0, dev)
    mk, planes = keypoints_and_planes(images, cfg)
    b, m = mk["x"].shape
    fl = {k: v.reshape(-1) for k, v in mk.items()}
    image = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(m)
    kp = [fl[k] for k in ("x", "y", "sigma", "octave", "level")]
    n_valid = int(fl["valid"].sum())
    hk = kw.orientation_hists(planes, *kp, fl["valid"], cfg, image=image)
    hp = kw.orientation_hists_plain(planes, *kp, fl["valid"], cfg, image)
    angles, avalid = kw.compute_orientations_merged_kernel(
        planes, *kp, fl["valid"], cfg, image=image)
    angle0 = angles[:, 0].contiguous()
    dvalid = (fl["valid"] & avalid[:, 0]).contiguous()
    dk = kw.descriptors(planes, *kp, angle0, dvalid, cfg, image=image)
    dp = kw.descriptors_plain(planes, *kp, angle0, dvalid, cfg, image)
    torch.cuda.synchronize()
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
        g1, gi, g2 = k1.fused_match_topk_prepared(*k1_inputs[bf16])
        w1, wi, w2 = k1.fused_match_topk_plain(*k1_inputs[bf16])
        torch.cuda.synchronize()
        if not bf16:
            errs["k1"] = max((g1 - w1).abs().max().item(), (g2 - w2).abs().max().item())
            unique = (w2 - w1) > 1e-3
            bad_idx = int((gi != wi)[unique].sum())
            print(f"[kernels] k1 fp32: max abs err {errs['k1']:.3e}, index "
                  f"mismatches {bad_idx} of {int(unique.sum())} rows with gap > 1e-3")
            assert errs["k1"] <= 2e-3 and bad_idx == 0, "k1 fp32 disagrees"
        else:
            clear = (w2 - w1) > 2e-2 * torch.maximum(w1.abs(), w2.abs())
            agree = (gi == wi)[clear].float().mean().item()
            print(f"[kernels] k1 bf16: index agreement {agree:.5f} over "
                  f"{int(clear.sum())} rows with gap > 2%")
            assert agree > 0.999, "k1 bf16 disagrees"

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
    assert all(v == 1 for v in launches.values()), "a kernel did not run once"
    assert fbatch.desc.shape == (2 * CHUNK, cfg.max_features, 128)
    assert mbatch.indices.shape == (CHUNK, cfg.max_features)
    assert torch.isfinite(fbatch.desc).all() and torch.isfinite(fbatch.x).all()
    n_feat = fbatch.count().cpu().numpy()
    n_match = ((mbatch.indices >= 0) & fbatch.valid[:CHUNK]).sum(-1).cpu().numpy()
    print(f"[batch] features per image {n_feat.tolist()}")
    print(f"[batch] matches per pair {n_match.tolist()}")
    assert (n_feat > MIN_BATCH_FEATURES).all() and (n_match > MIN_BATCH_MATCHES).all()
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
        "match_ms": lambda: nt.match_pair(
            Features(*[t[:CHUNK] for t in fbatch]),
            Features(*[t[CHUNK:] for t in fbatch]), device=dev),
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
    a_mat, b_mat, a_norm, b_norm = k1_inputs[False]
    bt = b_mat.transpose(1, 2)

    def k1_library():
        d = torch.baddbmm(b_norm[:, None, :], a_mat, bt, alpha=-2.0)
        return torch.topk(d, 2, dim=-1, largest=False)

    k1_lib = graph_ms(k1_library, reps)

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
    p_, m_, d_ = a_mat.shape
    k1_ops = 2 * p_ * m_ * b_mat.shape[1] * d_
    k1_bytes = (a_mat.numel() + b_mat.numel()) * 4 + (a_norm.numel()
                + b_norm.numel()) * 4 + 12 * p_ * m_
    bounds["k1"] = (*bound(k1_bytes, k1_ops), k1_bytes, k1_ops, None)

    print(f"[time] {card}")
    print(f"[time] 8-pair chunk (16 x 640x480 detect+describe, 8 matches), "
          f"{TIMED_CHUNKS} distinct chunks after {WARMUP_CHUNKS} warm-up: mean "
          f"{chunk_ms:.3f} ms on the card's clock ({1e3 * host_s / TIMED_CHUNKS:.3f} "
          f"on the host's), {kf_s:.1f} keyframes/s; per chunk median "
          f"{np.median(chunk_times):.3f}, min {min(chunk_times):.3f}, max "
          f"{max(chunk_times):.3f} ms")
    print(f"[time] stages of one chunk: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage.items()))
    for key, ms, plain, lib in (("k1", k1_ms, k1_plain, k1_lib), ("k2", k2_ms, k2_plain, None),
                                ("k3", k3_ms, k3_plain, None)):
        bd = bounds[key]
        print(f"[time] {key}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bd[0]:.4f} ms ({bd[1]}: {bd[2]} bytes, {bd[3]} ops)"
              + (f", library {lib:.4f} ms" if lib is not None else ""))
    print(f"[time] k1 bf16: kernel {k1_bf16_ms:.4f} ms")

    def row(key, name, source, replaces, ms, plain, lib):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs[key], "ms": ms, "plain_ms": plain,
                "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                "library_ms": lib}

    kernels = [
        row("k1", "k1_match_top2", "niftymatch_torch/csrc/match.cu",
            "niftymatch_tpu/pallas/match.py:54", k1_ms, k1_plain, k1_lib),
        row("k2", "k2_orientation_hist", "niftymatch_torch/csrc/windows.cu",
            "niftymatch_tpu/pallas/windows.py:161", k2_ms, k2_plain, None),
        row("k3", "k3_descriptor", "niftymatch_torch/csrc/windows.cu",
            "niftymatch_tpu/pallas/windows.py:363", k3_ms, k3_plain, None),
    ]
    print(json.dumps({"e2e": {"chunk_ms": chunk_ms, "keyframes_per_s": kf_s,
                              "host_chunk_ms": 1e3 * host_s / TIMED_CHUNKS,
                              "chunk_ms_median": float(np.median(chunk_times)),
                              "chunk_ms_min": min(chunk_times),
                              "chunk_ms_max": max(chunk_times),
                              **stage, "k1_bf16_ms": k1_bf16_ms,
                              "valid_keypoints": n_valid,
                              "k2_adding_pixels": bounds["k2"][4],
                              "k3_adding_pixels": bounds["k3"][4]}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
