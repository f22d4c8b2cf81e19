// K3: raw 128-D SIFT descriptors for Hopper (sm_90a).
//
// Replaces niftymatch_tpu/pallas/windows.py:363 _desc_kernel (pallas_call at
// :566, descriptors_pallas :493).
//
// What it computes: for each keypoint slot, the 4x4 spatial x 8 angle
// histogram of the gradient pixels in a square window around it, with
// trilinear tents: a pixel at rotated, scaled coordinates (nx, ny) and
// angle bin coordinate nt adds mag * exp(-(nx^2 + ny^2) / 8) * wy * wx * wt,
// each tent max(0, 1 - |n - centre|), the spatial centres at b - 1.5 and
// the 8 angle bins circular.  The plain PyTorch version is
// niftymatch_torch/kernels/windows.py::descriptors_plain
// (ops/descriptor.py::_descriptor_core).  The planes' layout is in
// window_geometry.cuh.
//
// What bounds it on this card: bytes.  The pixels that must be read are the
// parts of the windows inside each keypoint's rotated 4x4 support (about
// half of the square), 48 MB for the main path's 16 images at 640x480:
// 14 us at 3.35 TB/s.  Its fp32 arithmetic, ~45 operations per adding
// pixel, is a quarter of that.
//
// The design:
// * A persistent grid, as many 256-thread blocks as the card holds at
//   once.  Block b takes slots b, b + grid, ...: each warp writes the zeros
//   of its invalid slots, coalesced, and the block describes the valid ones
//   one at a time, so an invalid slot costs no scheduled block.
// * Only the support is visited.  For each window row a thread computes
//   the span of columns where |nx| and |ny| can be below 2.5 (a pixel of
//   margin on each side) inside the square |ox|, |oy| <= w, and a prefix
//   sum over the rows flattens the spans into one index.
// * The visited pixels are staged into shared memory with cp.async, all in
//   flight at once (3,072 at a time, which holds a whole window on the
//   main path), so the window costs one memory latency, not one per pixel.
//   Warps copy rows; threads then walk the staged pixels, neighbours on
//   neighbours.
// * Only the nonzero tents are computed: one floor and one fraction per
//   axis give the two bins each axis touches, so a pixel makes at most
//   2 x 2 x 2 adds.  1/sbp and NBO/2pi are per-keypoint multiplies, and
//   angle0 is wrapped into [0, 2pi) once, so theta = ang - angle0 wraps
//   with one compare and add (ang is in [0, 2pi), ops/gradients.py).
// * Accumulation is deterministic: unsigned 32-bit fixed point with
//   integer atomics, whose sum does not depend on their order, into 16
//   copies of the 128 bins (thread t into copy t % 16, so neighbouring
//   threads, which often add to the same bin, rarely collide), summed at
//   the end.  A first pass sums the magnitudes of the visited pixels, B
//   (times the window's largest weight in the support, 4.77, when the
//   Gaussian's sign is flipped).  Every pixel's terms over all bins sum to
//   at most its magnitude times its window weight, so each bin, all copies
//   together, is at most B.  With B < 2^e the scale is 2^(31-e): a bin
//   stays below 2^31 plus half a unit per term and cannot overflow, and one
//   unit is at most B / 2^30.  The result is the same on every run and for
//   every batch that holds the keypoint.
//
// Numerics: built with FMA contraction (its own source file; K2 in
// windows.cu keeps -fmad=false).  The weights are continuous in nx, ny and
// nt, so a multiply by a reciprocal, a fused multiply-add or __expf moves a
// term by an ulp or two; the tests bound the difference from the plain
// version relative to each row's largest bin.  The window radius is a
// floor, so it is computed with separately rounded operations, as the
// plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_geometry.cuh"

namespace {

constexpr int NBO = 8;
constexpr int NBP = 4;
constexpr int DESC_LEN = NBP * NBP * NBO;
constexpr float BINS_PER_RADIAN = 1.2732395447351628f;  // NBO / 2pi
constexpr float SQRT2_F = 1.4142135623730951f;
constexpr float DESC_MAGNIF = 3.0f;
constexpr float MACHINE_EPS = 1.0e-7f;
constexpr float SUPPORT = 2.5f;          // some tent is nonzero for |n| < 2.5
constexpr float FLIPPED_WINDOW_MAX = 4.8f;  // > exp((2.5^2 + 2.5^2) / 8)
constexpr int CAP = 3072;       // window pixels staged in shared memory at once
constexpr int MAX_ROWS = 128;   // window rows: 2 pad + 1 <= 128
constexpr int THREADS = 256;    // per block, which describes one keypoint
constexpr unsigned FULL = 0xffffffffu;

struct Slots {
  const float *x, *y, *sigma, *angle0;
  const int *octave, *level, *image;
  const bool* valid;
  int m;
};

// Per-keypoint constants.
struct Keypoint {
  const float* mag;
  const float* ang;
  float rx, ry, st, ct, inv_sbp, reach, angle0;
  int w, wp;
};

constexpr int COPIES = 16;             // of the histogram: thread t adds
constexpr int HIST_LD = DESC_LEN + 1;  // into copy t % 16, bank (c + b) % 32

struct Shared {
  float mag[CAP];           // the staged pixels, in the order of the spans
  float ang[CAP];
  short2 at[CAP];           // their (oy, ox)
  unsigned hist[COPIES * HIST_LD];  // fixed-point bins
  int excl[MAX_ROWS];       // each row's first index among the visited pixels
  int len[MAX_ROWS];        // and its span
  int x0[MAX_ROWS];
  // The round's keypoints, each loaded by the thread of its slot.
  float x[THREADS], y[THREADS], sigma[THREADS], angle0[THREADS];
  int octave[THREADS], level[THREADS], image[THREADS];
  int row_part[MAX_ROWS / 32];
  float part[THREADS / 32];
  unsigned todo[THREADS / 32];  // the valid slots of this round, a bit each
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// Narrows [lo, hi] to the columns ox with |a ox + b| < reach.
__device__ __forceinline__ void clip(float a, float b, float reach, float& lo,
                                     float& hi) {
  if (fabsf(a) < 1e-3f) {  // |a ox| < 1 for the |ox| < 1000 of any window
    if (fabsf(b) > reach + 1.0f) hi = lo - 1.0f;
    return;
  }
  const float u = (-reach - b) / a;
  const float v = (reach - b) / a;
  lo = fmaxf(lo, fminf(u, v));
  hi = fminf(hi, fmaxf(u, v));
}

// First column and length of the part of window row oy whose rotated
// coordinates can fall in the support, with a pixel of margin.
__device__ __forceinline__ void row_span(const Keypoint& k, int oy, int& x0,
                                         int& len) {
  const float dy = (float)oy + k.ry;
  float lo = (float)-k.w, hi = (float)k.w;
  // nx sbp = ct (ox + rx) + st dy, ny sbp = ct dy - st (ox + rx)
  clip(k.ct, k.ct * k.rx + k.st * dy, k.reach, lo, hi);
  clip(-k.st, k.ct * dy - k.st * k.rx, k.reach, lo, hi);
  x0 = 0;
  len = 0;
  if (lo <= hi) {
    x0 = max(-k.w, (int)ceilf(lo) - 1);
    len = max(0, min(k.w, (int)floorf(hi) + 1) - x0 + 1);
  }
}

__device__ __forceinline__ void add_fixed(unsigned* bin, float v) {
  atomicAdd(bin, __float2uint_rn(v));
}

// Copies the visited pixels [c0, c1) into shared memory: warp w takes rows
// w, w + warps, ..., its lanes neighbouring pixels of the row.
__device__ __forceinline__ void stage(const Keypoint& kp, Shared& s,
                                      int rows, int c0, int c1) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += THREADS / 32) {
    const int e = s.excl[r], len = s.len[r];
    if (e + len <= c0 || e >= c1) continue;
    const int oy = r - kp.w, x0 = s.x0[r];
    const ptrdiff_t row = (ptrdiff_t)oy * kp.wp;
    for (int i = lane; i < len; i += 32) {
      const int q = e + i - c0;
      if (q < 0 || q >= c1 - c0) continue;
      cp_async4(&s.mag[q], kp.mag + row + x0 + i);
      cp_async4(&s.ang[q], kp.ang + row + x0 + i);
      s.at[q] = make_short2((short)oy, (short)(x0 + i));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The raw descriptor of the round's valid slot i (slot k), by the whole
// block.
__device__ void describe(const Geometry& g, int i, int k, float sign,
                         Shared& s, float* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Centre c = keypoint_centre(g, s.x[i], s.y[i], s.sigma[i], s.octave[i],
                                   s.level[i], s.image[i]);
  const float sbp = __fadd_rn(__fmul_rn(DESC_MAGNIF, c.so), MACHINE_EPS);
  const float w_r = floorf(__fadd_rn(
      __fmul_rn(__fmul_rn(__fmul_rn(SQRT2_F, sbp), 5.0f), 0.5f), 0.5f));
  const float a0 = s.angle0[i];
  Keypoint kp;
  kp.mag = g.planes_mag + c.offset;
  kp.ang = g.planes_ang + c.offset;
  kp.rx = (float)c.xi - c.xo;
  kp.ry = (float)c.yi - c.yo;
  kp.st = sinf(a0);
  kp.ct = cosf(a0);
  kp.inv_sbp = 1.0f / sbp;
  kp.reach = SUPPORT * sbp;
  kp.angle0 = floor_mod(a0, TWO_PI_F);
  kp.w = min((int)w_r, g.pad);
  kp.wp = g.wp;
  const int rows = 2 * kp.w + 1;

  // The spans of the window rows and their prefix sum.
  if (tid < MAX_ROWS) {
    int x0 = 0, len = 0;
    if (tid < rows) row_span(kp, tid - kp.w, x0, len);
    int incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    s.len[tid] = len;
    s.x0[tid] = x0;
    s.excl[tid] = incl - len;
    if (lane == 31) s.row_part[warp] = incl;
  }
  for (int t = tid; t < COPIES * HIST_LD; t += THREADS) s.hist[t] = 0u;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < MAX_ROWS / 32; ++w) {
    if (tid < MAX_ROWS && w < warp) s.excl[tid] += s.row_part[w];
    total += s.row_part[w];
  }
  __syncthreads();

  // Pass 1: the bound B on every bin, and from it the fixed-point scale.
  float msum = 0.0f;
  for (int c0 = 0; c0 < total; c0 += CAP) {
    const int c1 = min(total, c0 + CAP);
    stage(kp, s, rows, c0, c1);
    for (int q = tid; q < c1 - c0; q += THREADS) msum += s.mag[q];
    if (c1 < total) __syncthreads();  // before the next chunk overwrites it
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) msum += __shfl_xor_sync(FULL, msum, d);
  if (lane == 0) s.part[warp] = msum;
  __syncthreads();
  msum = 0.0f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) msum += s.part[w];
  int e;
  frexpf(msum * (sign > 0.0f ? FLIPPED_WINDOW_MAX : 1.0f), &e);
  const int shift = min(max(31 - e, -120), 120);
  const float scale = ldexpf(1.0f, shift);

  // Pass 2: each pixel's nonzero tents into the fixed-point bins.  With
  // one chunk the pixels are still staged from pass 1.
  unsigned* const mine = s.hist + (tid % COPIES) * HIST_LD;
  for (int c0 = 0; c0 < total; c0 += CAP) {
    const int c1 = min(total, c0 + CAP);
    if (total > CAP) stage(kp, s, rows, c0, c1);
    for (int q = tid; q < c1 - c0; q += THREADS) {
      const float mg = s.mag[q];
      if (mg == 0.0f) continue;  // adds 0 to every bin
      const short2 at = s.at[q];
      const float dx = (float)at.y + kp.rx;
      const float dy = (float)at.x + kp.ry;
      const float nx = (kp.ct * dx + kp.st * dy) * kp.inv_sbp;
      const float ny = (kp.ct * dy - kp.st * dx) * kp.inv_sbp;
      const float ux = nx + 1.5f;  // spatial bin b is centred at u = b
      const float uy = ny + 1.5f;
      if (!(ux > -1.0f && ux < 4.0f && uy > -1.0f && uy < 4.0f)) continue;
      const float wv = __expf(sign * (nx * nx + ny * ny) * 0.125f) * mg;
      float theta = s.ang[q] - kp.angle0;
      if (theta < 0.0f) theta += TWO_PI_F;
      const float nt = theta * BINS_PER_RADIAN;
      const float fx = floorf(ux), fy = floorf(uy), ft = floorf(nt);
      const float tx = ux - fx, ty = uy - fy, tt = nt - ft;
      const int ix = (int)fx, iy = (int)fy;
      const int it0 = (int)ft & (NBO - 1);  // nt rounded up to 8 is bin 0
      const int it1 = (it0 + 1) & (NBO - 1);
      const float wt0 = (1.0f - tt) * scale;
      const float wt1 = tt * scale;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int yb = iy + a;
        if ((unsigned)yb >= (unsigned)NBP) continue;
        const float wy = wv * (a ? ty : 1.0f - ty);
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int xb = ix + b;
          if ((unsigned)xb >= (unsigned)NBP) continue;
          const float l = wy * (b ? tx : 1.0f - tx);
          unsigned* h = mine + (yb * NBP + xb) * NBO;
          add_fixed(h + it0, l * wt0);
          add_fixed(h + it1, l * wt1);
        }
      }
    }
    __syncthreads();
  }

  // The copies' sum is exact: a bin's total is below 2^32 (see the top).
  const float unscale = ldexpf(1.0f, -shift);
  float* o = out + (size_t)k * DESC_LEN;
  for (int t = tid; t < DESC_LEN; t += THREADS) {
    unsigned q = 0u;
#pragma unroll
    for (int c = 0; c < COPIES; ++c) q += s.hist[c * HIST_LD + t];
    o[t] = (float)q * unscale;
  }
  __syncthreads();  // the next slot reuses the shared memory
}

// A persistent grid: block b takes slots b, b + grid, b + 2 grid, ...,
// THREADS of them a round.  Warp w writes the zeros of the round's invalid
// slots 32 w .. 32 w + 31, and the block describes the valid ones one after
// the other.
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
descriptor_kernel(Geometry g, Slots sl, float sign, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& s = *reinterpret_cast<Shared*>(smem);
  const int t = threadIdx.x, step = gridDim.x, lane = t & 31, warp = t >> 5;
  for (int base = blockIdx.x; base < sl.m; base += step * THREADS) {
    const int k = base + t * step;
    const bool valid = k < sl.m && sl.valid[k];
    if (valid) {
      s.x[t] = sl.x[k];
      s.y[t] = sl.y[k];
      s.sigma[t] = sl.sigma[k];
      s.angle0[t] = sl.angle0[k];
      s.octave[t] = sl.octave[k];
      s.level[t] = sl.level[k];
      s.image[t] = sl.image[k];
    }
    const unsigned todo = __ballot_sync(FULL, valid);
    unsigned zero = __ballot_sync(FULL, k < sl.m && !valid);
    if (lane == 0) s.todo[warp] = todo;
    while (zero != 0u) {
      const int i = __ffs(zero) - 1;
      zero &= zero - 1u;
      const int ki = base + (32 * warp + i) * step;
      reinterpret_cast<float4*>(out + (size_t)ki * DESC_LEN)[lane] =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    for (int w = 0; w < THREADS / 32; ++w) {
      for (unsigned bits = s.todo[w]; bits != 0u; bits &= bits - 1u) {
        const int i = 32 * w + __ffs(bits) - 1;
        describe(g, i, base + i * step, sign, s, out);
      }
    }
    __syncthreads();  // before the next round's flags
  }
}

int launch(const Geometry& g, const Slots& sl, float sign, void* out,
           void* stream) {
  constexpr int smem = (int)sizeof(Shared);
  static int grid = 0;  // resident blocks on the card, found once
  if (grid == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(
        descriptor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e == cudaSuccess) e = cudaGetDevice(&device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, descriptor_kernel, THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    grid = max(1, sms * per_sm);
  }
  descriptor_kernel<<<min(grid, sl.m), THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      g, sl, sign, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

Slots make_slots(const void* x, const void* y, const void* sigma,
                 const void* octave, const void* level, const void* image,
                 const void* angle0, const void* valid, int m) {
  Slots sl;
  sl.x = static_cast<const float*>(x);
  sl.y = static_cast<const float*>(y);
  sl.sigma = static_cast<const float*>(sigma);
  sl.angle0 = static_cast<const float*>(angle0);
  sl.octave = static_cast<const int*>(octave);
  sl.level = static_cast<const int*>(level);
  sl.image = static_cast<const int*>(image);
  sl.valid = static_cast<const bool*>(valid);
  sl.m = m;
  return sl;
}

}  // namespace

extern "C" int nm_descriptors(
    const void* mag, const void* ang, int num_images, int num_octaves,
    int num_levels, int hp, int wp, int pad, const void* x, const void* y,
    const void* sigma, const void* octave, const void* level,
    const void* image, const void* angle0, const void* valid, int m,
    float sign, void* out, void* stream) {
  if (m <= 0) return 0;
  if (2 * pad + 1 > MAX_ROWS) return (int)cudaErrorInvalidValue;
  return launch(
      make_geometry(mag, ang, num_images, num_octaves, num_levels, hp, wp, pad),
      make_slots(x, y, sigma, octave, level, image, angle0, valid, m), sign,
      out, stream);
}
