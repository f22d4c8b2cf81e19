"""Where the time of one 8-pair chunk goes, on a GPU, for the PyTorch port.

    python3 tools/profile_torch_chunk.py [--top 25] [--reps 7]

Runs the main path of ``chip_smoke.py`` (``detect_and_describe_batch`` on 16
640x480 bench scenes and one batched ``match_pair`` of 8 pairs) on one
chunk of inputs, after two warm-up runs on another.  It times that chunk
``--reps`` times without the profiler, each run alone between two
synchronisations, then runs it once more under ``torch.profiler``.  It
prints the device time summed by kernel name (largest first), the kernel
count, the device's busy time (the union of its kernel and copy intervals
in the trace) and the idle share of the chunk's wall time: busy time over
the unprofiled wall times of the same inputs (median, and the range over
the reps), beside the profiled run's own wall time, which the profiler
inflates.  Needs one CUDA card; imports nothing of JAX.
"""

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def busy_ms(intervals):
    """Length of the union of (start, end) intervals in us, as ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--reps", type=int, default=7)
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    import niftymatch_torch as nt
    from niftymatch_torch.features import Features

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = nt.SiftConfig(width=chip_smoke.W, height=chip_smoke.H)
    chunks = [chip_smoke.chunk_images(2000 + 100 * c, dev) for c in range(2)]

    def pair_chunk(imgs):
        f = nt.detect_and_describe_batch(imgs, cfg, device=dev)
        half = [Features(*[t[:8] for t in f]), Features(*[t[8:] for t in f])]
        return nt.match_pair(*half, device=dev)

    def timed_chunk():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pair_chunk(chunks[1])
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    for _ in range(2):
        pair_chunk(chunks[0])
    walls = [timed_chunk() for _ in range(args.reps)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall = timed_chunk()

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    wall = statistics.median(walls)
    print(f"card: {chip_smoke.card_line()}")
    print(f"chunk: {len(kernels)} kernels, device busy {busy:.3f} ms; unprofiled "
          f"wall over {args.reps} runs median {wall:.3f} ms (min {min(walls):.3f}, "
          f"max {max(walls):.3f}): idle share {1 - busy / wall:.3f} "
          f"({1 - busy / min(walls):.3f} to {1 - busy / max(walls):.3f}); "
          f"profiled wall {prof_wall:.3f} ms, idle share {1 - busy / prof_wall:.3f}")
    print(f"{'device ms':>10} {'calls':>6}  kernel")
    for name, (n, t) in rows[: args.top]:
        print(f"{t / 1e3:10.3f} {n:6d}  {name[:110]}")


if __name__ == "__main__":
    main()
