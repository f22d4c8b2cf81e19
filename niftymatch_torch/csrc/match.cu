// K1: fused descriptor-distance GEMM + running top-2, for Hopper (sm_90a).
//
// Replaces niftymatch_tpu/pallas/match.py:54 _match_kernel (pallas_call at
// :192 in _fused_call; reached by fused_match_topk :248 and
// match_descriptors_pallas :313).
//
// What it computes, for each pair p and each A row i:
//   (min1, argmin1, min2) over the B rows j of  ||b_j||^2 - 2 a_i.b_j,
// then adds ||a_i||^2 and clamps at 0.  Invalid B rows arrive with
// ||b||^2 = 1e30, so a row that sees no valid B reports min1 >= 1e29.  Ties
// go to the lowest column; min2 counts an equal value at another column.
// The A x B distance matrix is never stored.  The plain PyTorch version is
// niftymatch_torch/kernels/match.py::fused_match_topk_plain.
//
// What bounds it on this card: tensor-core arithmetic.  The main path runs
// 8 pairs of 2048 x 2048 x 128, 8.6 GFLOP, against 16.8 MB of fp32
// operands (5 us at 3.35 TB/s).  fp32 mode splits each operand into two
// TF32 parts, x = hi + lo with hi = tf32(x) and lo = x - hi, and
// accumulates lo.hi + hi.lo + hi.hi in fp32 (3xTF32: three products, 0.052
// ms at 495 TFLOP/s; the dropped lo.lo and lo's bits below TF32 leave about
// 2^-21 of each product, far inside the fp32 gate, and plain TF32 is not
// used).  bf16 mode multiplies the bf16 operands with fp32 accumulation
// (0.0087 ms at 989 TFLOP/s).
//
// The design:
// * A block owns 128 A rows of one pair, two warpgroups of 64.  A is copied
//   once through shared memory into registers (ldmatrix, in the wgmma A
//   fragment layout), where it stays for the whole sweep over B: in fp32
//   mode already split into hi and lo (Veltkamp's split, full-rate fp32
//   operations), so no A value is split twice.
// * B streams through shared memory in tiles of 64 rows x the full depth,
//   three stages deep with cp.async, stored in wgmma's K-major core-matrix
//   layout (8 rows x 16 bytes contiguous, no swizzle).  In fp32 mode the
//   block splits each tile once into a hi and a lo tile (two stages, in the
//   space A's rows took).
// * Each warpgroup runs wgmma.mma_async (m64n64k8 TF32, m64n64k16 bf16)
//   with A from registers and B from shared memory: per 8-deep step in
//   fp32 mode lo.hi, hi.lo and hi.hi into the same fp32 accumulators.
//   While a tile's wgmmas run, the tile after next is copied and the next
//   one split.
// * The fold: after the wgmmas, every thread folds its accumulator
//   fragments into a running (min1, idx1, min2) for its 2 rows, even and
//   odd columns apart (four independent chains), visiting its columns in
//   increasing order, so a strict < keeps the lowest column.  A row's 64
//   columns of a tile are spread over the 4 lanes that share it; after the
//   sweep each row's chains and lanes merge, the merge taking the lower
//   column on a tie.  The result is the same on every run.  Folding one
//   tile while the next tile's wgmmas run would hide the fold, but nvcc
//   then waits for the wgmmas before the fold all the same.
// * The batch of pairs is the grid's y axis: one launch per chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;            // descriptor length
constexpr int BM = 128;           // A rows per block: two warpgroups of 64
constexpr int BN = 64;            // B rows per tile: the wgmma's N
constexpr int THREADS = 256;
constexpr int STEP_BYTES = 32;    // depth of one wgmma: 8 fp32, 16 bf16
constexpr int ACC = BN / 2;       // accumulators per thread (64 x BN / 128)
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before the
// async proxy (wgmma) reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four 8x8 matrices of 16-bit pairs from shared memory: lane l gives the
// address of row l % 8 of matrix l / 8 and receives, of each matrix j,
// row (l / 4) % 8, 32-bit column l % 4, in r[j].  Read as 32-bit words this
// is a warp's 16-row slice of the wgmma A fragment for both types below.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A K-major shared-memory operand without swizzle: 8-row x 16-byte core
// matrices, lbo bytes apart along K and sbo bytes apart along N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4)
         | (uint64_t)(lbo >> 4) << 16 | (uint64_t)(sbo >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// x = hi + lo exactly, hi with 11 significant bits (a TF32 value):
// Veltkamp's split with full-rate fp32 operations, kept from contracting.
// The tensor core reads lo's top 11 significant bits.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  const float c = __fmul_rn(x, 8193.0f);
  hi = __fsub_rn(c, __fsub_rn(c, x));
  lo = __fsub_rn(x, hi);
}

// The 32 fp32 accumulators of an m64n64 wgmma, asm operands %0 to %31.
#define NM_ACC_REGS                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define NM_ACC_OUTS(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
  "+f"(d[31])

// fp32 operands, 3xTF32 products.
struct F32x3 {
  using T = float;
  static constexpr int STEPS = D * 4 / STEP_BYTES;  // 16
  static constexpr int HALVES = 2;                  // hi and lo

  // d (+)= a . b over one 8-deep step; accumulate = 0 overwrites d.
  static __device__ __forceinline__ void wgmma(float (&d)[ACC],
                                               const unsigned (&a)[4],
                                               uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        NM_ACC_REGS ", {%32, %33, %34, %35}, %37, p, 1, 1;\n}\n"
        : NM_ACC_OUTS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate),
          "l"(b));
  }
};

// bf16 operands, fp32 accumulation.
struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr int STEPS = D * 2 / STEP_BYTES;  // 8
  static constexpr int HALVES = 1;

  static __device__ __forceinline__ void wgmma(float (&d)[ACC],
                                               const unsigned (&a)[4],
                                               uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        NM_ACC_REGS ", {%32, %33, %34, %35}, %37, p, 1, 1, 0;\n}\n"
        : NM_ACC_OUTS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate),
          "l"(b));
  }
};

template <class Mode>
struct Layout {
  static constexpr int ROW_BYTES = D * (int)sizeof(typename Mode::T);
  static constexpr int CHUNKS = ROW_BYTES / 16;   // 16-byte chunks per row
  static constexpr int LDA = ROW_BYTES + 16;      // padded A row (ldmatrix)
  static constexpr int TILE = BN * ROW_BYTES;     // one B tile
  static constexpr int RAW = 3;                   // stages of B and its norms
  // The split tiles (fp32: hi and lo, two stages), which A's rows occupy
  // before they move into registers.
  static constexpr int SPLIT = Mode::HALVES == 2 ? 4 * TILE : 0;
  static constexpr int A_REGION = BM * LDA > SPLIT ? BM * LDA : SPLIT;
  static constexpr int SMEM = A_REGION + RAW * TILE + RAW * BN * 4;
  // Byte offset of element (row, chunk) of a tile in the core-matrix
  // layout: core matrix (row / 8, chunk), 128 bytes each, chunks contiguous.
  static __device__ __forceinline__ int at(int row, int chunk) {
    return ((row >> 3) * CHUNKS + chunk) * 128 + (row & 7) * 16;
  }
};

// Merge partial top-2 (b1, bi, b2) into (a1, ai, a2); a tie of the two
// minima goes to the lower column.
__device__ __forceinline__ void merge(float& a1, int& ai, float& a2, float b1,
                                      int bi, float b2) {
  if (b1 < a1 || (b1 == a1 && (unsigned)bi < (unsigned)ai)) {
    a2 = fminf(a1, b2);
    a1 = b1;
    ai = bi;
  } else {
    a2 = fminf(a2, b1);
  }
}

// Timing variants, the template argument V of the kernel: 0 is the
// function; each bit leaves one part of the work out.  Only a build with
// NM_TIMING_VARIANTS (tools/k1_variants.py) instantiates the others.
constexpr int SKIP_FOLD = 1;     // the fold only sums the accumulators
constexpr int SKIP_PRODUCT = 2;  // no wgmma: the fold sees zero products
constexpr int SKIP_STREAM = 4;   // B's first tile stands in for every tile

template <class Mode, int V>
__global__ void __launch_bounds__(THREADS, 1)
match_top2_kernel(const typename Mode::T* __restrict__ a,
                  const typename Mode::T* __restrict__ b,
                  const float* __restrict__ anorm,
                  const float* __restrict__ bnorm, int m, int n,
                  float* __restrict__ min1_out, int* __restrict__ idx1_out,
                  float* __restrict__ min2_out) {
  using L = Layout<Mode>;
  constexpr int STEPS = Mode::STEPS;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* As = smem;                  // [BM][LDA]; then [2][hi, lo]
  unsigned char* Bs = smem + L::A_REGION;    // [RAW][TILE]
  float* bn_s = reinterpret_cast<float*>(Bs + L::RAW * L::TILE);  // [RAW][BN]

  const int pair = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const unsigned char* ap =
      reinterpret_cast<const unsigned char*>(a + (size_t)pair * m * D);
  const unsigned char* bp =
      reinterpret_cast<const unsigned char*>(b + (size_t)pair * n * D);
  const float* bnp = bnorm + (size_t)pair * n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slab = 16 * warp;  // the warp's 16 rows: 64 per warpgroup
  const int tiles = (n + BN - 1) / BN;
  auto stage = [&](int tile) { return (V & SKIP_STREAM) ? 0 : tile; };

  auto load_b = [&](int tile) {
    if (tile >= tiles || ((V & SKIP_STREAM) && tile > 0)) return;
    const int n0 = tile * BN;
    unsigned char* dst = Bs + (tile % L::RAW) * L::TILE;
    for (int e = tid; e < BN * L::CHUNKS; e += THREADS) {
      const int r = e / L::CHUNKS, c = e % L::CHUNKS;
      const bool ok = n0 + r < n;
      cp_async16(dst + L::at(r, c),
                 bp + (size_t)(ok ? n0 + r : 0) * L::ROW_BYTES + c * 16, ok);
    }
    if (tid < BN) {  // a column past n reads +inf: it never wins
      float* dn = bn_s + (tile % L::RAW) * BN + tid;
      if (n0 + tid < n) cp_async4(dn, bnp + n0 + tid);
      else *dn = __int_as_float(0x7f800000);
    }
  };
  // The split is elementwise, so it walks the tile linearly: neighbouring
  // threads on neighbouring 16 bytes.
  auto split_b = [&](int tile) {
    if (Mode::HALVES == 1 || tile >= tiles) return;
    const float4* raw = reinterpret_cast<const float4*>(
        Bs + (stage(tile) % L::RAW) * L::TILE);
    float4* hi = reinterpret_cast<float4*>(As + (tile & 1) * 2 * L::TILE);
    float4* lo = hi + L::TILE / 16;
    for (int i = tid; i < L::TILE / 16; i += THREADS) {
      const float4 v = raw[i];
      float4 vh, vl;
      split_tf32(v.x, vh.x, vl.x);
      split_tf32(v.y, vh.y, vl.y);
      split_tf32(v.z, vh.z, vl.z);
      split_tf32(v.w, vh.w, vl.w);
      hi[i] = vh;
      lo[i] = vl;
    }
  };

  for (int e = tid; e < BM * L::CHUNKS; e += THREADS) {
    const int r = e / L::CHUNKS, c = e % L::CHUNKS;
    const bool ok = row0 + r < m;
    cp_async16(As + r * L::LDA + c * 16,
               ap + (size_t)(ok ? row0 + r : 0) * L::ROW_BYTES + c * 16, ok);
  }
  load_b(0);
  cp_async_commit();  // group: A and B's first tile
  load_b(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // A's fragments for every step, kept in registers.
  unsigned afr[Mode::HALVES][STEPS][4];
  {
    const int r = lane & 7, j = lane >> 3;
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      unsigned q[4];
      ldmatrix_x4(q, As + (slab + r + 8 * (j & 1)) * L::LDA + s * STEP_BYTES
                         + 16 * (j >> 1));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (Mode::HALVES == 2) {
          float hi, lo;
          split_tf32(__uint_as_float(q[i]), hi, lo);
          afr[0][s][i] = __float_as_uint(hi);
          afr[Mode::HALVES - 1][s][i] = __float_as_uint(lo);
        } else {
          afr[0][s][i] = q[i];
        }
      }
    }
  }
  __syncthreads();  // the A region now takes the split B tiles
  split_b(0);
  fence_proxy_async();
  __syncthreads();

  // Running top-2 of rows g and g + 8 of the slab, over even and odd
  // columns apart: four independent chains.
  float m1[2][2], m2[2][2];
  int i1[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      m1[r][odd] = BIG;
      m2[r][odd] = BIG;
      i1[r][odd] = -1;
    }

  // Folds a tile's fragments into the running top-2: acc[4 j + q] is row
  // slab + g (+8 for q >= 2), column 8 j + 2 t (+1 for odd q) of the tile,
  // and the columns are visited in increasing order.
  auto fold = [&](const float (&acc)[ACC], int tile) {
    const float* bnt = bn_s + (stage(tile) % L::RAW) * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int odd = 0; odd < 2; ++odd) {
        const int cl = 8 * j + 2 * t + odd;
        const float bv = bnt[cl];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float v = acc[4 * j + 2 * r + odd];
          if constexpr ((V & SKIP_FOLD) != 0) {
            m2[r][odd] += v;
            continue;
          }
          const float d = bv - 2.0f * v;
          if (d < m1[r][odd]) {
            m2[r][odd] = m1[r][odd];
            m1[r][odd] = d;
            i1[r][odd] = tile * BN + cl;
          } else if (d < m2[r][odd]) {
            m2[r][odd] = d;
          }
        }
      }
  };

  // One tile: its wgmmas are issued, and while they run the tile after
  // next is copied and the next one split; then its fragments are folded.
  const unsigned lbo = 128, sbo = L::CHUNKS * 128;  // see L::at
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
  for (int tile = 0; tile < tiles; ++tile) {
    const unsigned char* hi =
        Mode::HALVES == 2 ? As + (tile & 1) * 2 * L::TILE
              : Bs + (stage(tile) % L::RAW) * L::TILE;
    const unsigned char* lo = hi + L::TILE;
    if constexpr ((V & SKIP_PRODUCT) == 0) {
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const int kb = s * STEP_BYTES / 16 * 128;  // two core matrices a step
        if (Mode::HALVES == 2) {
          Mode::wgmma(acc, afr[Mode::HALVES - 1][s],
                      smem_desc(hi + kb, lbo, sbo), s > 0);
          Mode::wgmma(acc, afr[0][s], smem_desc(lo + kb, lbo, sbo), 1);
        }
        Mode::wgmma(acc, afr[0][s], smem_desc(hi + kb, lbo, sbo),
                    Mode::HALVES == 2 || s > 0);
      }
      wgmma_commit();
    }
    load_b(tile + 2);
    cp_async_commit();  // possibly empty: the group count stays in step
    cp_async_wait<1>();  // this thread's copies of the next tile
    if (Mode::HALVES == 2) {
      __syncthreads();  // everyone's copies of the next tile
      split_b(tile + 1);
    }
    fence_proxy_async();
    wgmma_wait();
    fold(acc, tile);
    __syncthreads();  // the next tile's split and copies are everyone's
  }

  // Merge a row's odd columns into its even ones, then the 4 lanes of the
  // row (they differ in t); each row is one warp's.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float a1 = m1[r][0], a2 = m2[r][0];
    int ai = i1[r][0];
    merge(a1, ai, a2, m1[r][1], i1[r][1], m2[r][1]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float b1 = __shfl_xor_sync(FULL, a1, off);
      const float b2 = __shfl_xor_sync(FULL, a2, off);
      const int bi = __shfl_xor_sync(FULL, ai, off);
      merge(a1, ai, a2, b1, bi, b2);
    }
    const int row = row0 + slab + g + 8 * r;
    if (t == 0 && row < m) {
      const size_t o = (size_t)pair * m + row;
      const float an = anorm[o];
      min1_out[o] = fmaxf(a1 + an, 0.0f);
      idx1_out[o] = ai;
      min2_out[o] = fmaxf(a2 + an, 0.0f);
    }
  }
}

template <class Mode, int V>
int launch(const void* a, const void* b, const void* anorm, const void* bnorm,
           int pairs, int m, int n, int d, void* min1, void* idx1, void* min2,
           void* stream) {
  if (d != D || pairs <= 0 || m <= 0 || n <= 0 || pairs > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = Layout<Mode>::SMEM;
  static bool attribute_set = false;  // once per kernel, before any capture
  if (!attribute_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        match_top2_kernel<Mode, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attribute_set = true;
  }
  using T = typename Mode::T;
  dim3 grid((m + BM - 1) / BM, pairs);
  match_top2_kernel<Mode, V>
      <<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<const T*>(b),
          static_cast<const float*>(anorm), static_cast<const float*>(bnorm),
          m, n, static_cast<float*>(min1), static_cast<int*>(idx1),
          static_cast<float*>(min2));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nm_match_top2_f32(const void* a, const void* b,
                                 const void* anorm, const void* bnorm,
                                 int pairs, int m, int n, int d, void* min1,
                                 void* idx1, void* min2, void* stream) {
  return launch<F32x3, 0>(a, b, anorm, bnorm, pairs, m, n, d, min1, idx1,
                          min2, stream);
}

extern "C" int nm_match_top2_bf16(const void* a, const void* b,
                                  const void* anorm, const void* bnorm,
                                  int pairs, int m, int n, int d, void* min1,
                                  void* idx1, void* min2, void* stream) {
  return launch<Bf16, 0>(a, b, anorm, bnorm, pairs, m, n, d, min1, idx1, min2,
                         stream);
}

#ifdef NM_TIMING_VARIANTS
// A timing variant (one SKIP_* bit) of either mode.
extern "C" int nm_match_top2_variant(int bf16, int variant, const void* a,
                                     const void* b, const void* anorm,
                                     const void* bnorm, int pairs, int m,
                                     int n, int d, void* min1, void* idx1,
                                     void* min2, void* stream) {
#define NM_VARIANT(V)                                                       \
  case V:                                                                   \
    return bf16 ? launch<Bf16, V>(a, b, anorm, bnorm, pairs, m, n, d, min1, \
                                  idx1, min2, stream)                       \
                : launch<F32x3, V>(a, b, anorm, bnorm, pairs, m, n, d,      \
                                   min1, idx1, min2, stream);
  switch (variant) {
    NM_VARIANT(1)
    NM_VARIANT(2)
    NM_VARIANT(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef NM_VARIANT
}
#endif
