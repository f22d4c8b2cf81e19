// K4: the fold microbenchmark, K1's bf16 tile loop with the top-2 fold
// swapped for one of nine variants, for Hopper (sm_90a).
//
// Replaces benchmarks/fold_micro.py:59 _variant_kernel (pallas_call at :287
// in _variant_call).  The plain PyTorch versions are
// niftymatch_torch/kernels/fold.py::fold_variant_plain.
//
// What it computes, for each pair p and each A row i, with bf16 operands
// and fp32 accumulation: d_j = ||b_j||^2 - 2 a_i.b_j over the B rows j (no
// ||a||^2 and no clamp, unlike K1), folded into (min1, idx1, min2); fields a
// variant does not produce keep their initial values, 3.4e38 and -1:
//   gemm      min1 = base + the sum of -2 a.b at column 0 of every B tile
//             (a consume only: every product is still computed, since the
//             wgmmas are issued whole; see FoldSum for what it reads);
//   rowsum    min1 = base + the sum of -2 a.b over every column;
//             base is 3.4e38 in the benchmark, which hides the sum; a check
//             of the sums passes 0;
//   min1      the minimum of d;
//   current   K1's fold: (min1, argmin, min2), ties to the lowest column,
//             min2 counting an equal value at another column;
//   pipe      current, with the next tile's wgmmas issued before this
//             tile's fold (two accumulator sets);
//   top2noi   the two smallest values by a min/max tournament, no index;
//   top2idx   the tournament, then one pass for the lowest column that
//             holds the minimum;
//   slotpack  int32 keys (bits(d + 256) & ~0x7FFF) | column, ordered as the
//             values are (d + 256 > 0), the two smallest decoded back as
//             value - 256: values keep 8 mantissa bits;
//   bf16      current on d rounded to bf16.
// K1 itself on the same operands (the TPU benchmark's `full`) is
// kernels/match.py's launch of match.cu.
//
// What bounds it on this card: tensor-core arithmetic.  The default shape,
// 16 pairs of 1024 x 1024 x 128, is 4.29 GFLOP (4.34 us at 989 TFLOP/s)
// against 8.5 MB of operands (2.5 us at 3.35 TB/s); so is one pair of 4096.
//
// The design is K1's bf16 loop (match_tile.cuh): a block owns 128 A rows
// of one pair in registers, B streams through shared memory in 64-row
// tiles, three stages deep with cp.async, and each warpgroup runs wgmma
// m64n64k16 per tile.  The fold is the template argument: a struct whose
// `fold` takes one tile's accumulator fragments (rows g and g + 8 of the
// warp's 16, columns 8 j + 2 t (+1) of the tile) and whose `finish` merges a
// row's chains and its 4 lanes.  `pipe` keeps two accumulator sets: tile
// t's group is retired, tile t + 1's committed, and tile t folded while it
// runs.  Whether ptxas lets the fold run under the wgmmas shows in its -v
// output (a serialisation warning, C7514) and in the time.

#include "match_tile.cuh"

namespace {

constexpr float BIAS = 256.0f;      // slotpack: d + BIAS > 0
constexpr int KEY_COLS = 0x7FFF;    // slotpack: the column bits of a key
constexpr int KEY_NONE = 0x7FFFFFFF;

__device__ __forceinline__ int shfl(int v, int off) {
  return __shfl_xor_sync(FULL, v, off);
}
__device__ __forceinline__ float shfl(float v, int off) {
  return __shfl_xor_sync(FULL, v, off);
}

// Top-2 of two value pairs (x1 <= x2, y1 <= y2), duplicates counted.
__device__ __forceinline__ void top2_values(float& x1, float& x2, float y1,
                                            float y2) {
  const float lo = fminf(x1, y1);
  x2 = fminf(fmaxf(x1, y1), fminf(x2, y2));
  x1 = lo;
}

// One tile's wgmma group: acc = a . b over the full depth, A from
// registers, the tile at `bt` in shared memory.
__device__ __forceinline__ void issue_tile(float (&acc)[ACC],
                                           const unsigned (&afr)[Bf16::STEPS][4],
                                           const unsigned char* bt) {
  constexpr unsigned lbo = 128, sbo = Layout<Bf16>::CHUNKS * 128;  // L::at
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < Bf16::STEPS; ++s)
    Bf16::wgmma(acc, afr[s], smem_desc(bt + s * STEP_BYTES / 16 * 128, lbo, sbo),
                s > 0);
  wgmma_commit();
}

// The running (min1, idx1, min2) of K1's fold: rows r = 0, 1 (g, g + 8) and
// even and odd columns apart, four independent chains.  `Round` rounds d
// first (bf16) or not.
template <bool Round>
struct FoldCurrent {
  float m1[2][2], m2[2][2];
  int i1[2][2];
  __device__ void init() {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        m1[r][o] = BIG;
        m2[r][o] = BIG;
        i1[r][o] = -1;
      }
  }
  __device__ __forceinline__ void fold(const float (&acc)[ACC],
                                       const float* bnt, int col0, int t) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const int cl = 8 * j + 2 * t + o;
        const float bv = bnt[cl];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float d = bv - 2.0f * acc[4 * j + 2 * r + o];
          if (Round) d = __bfloat162float(__float2bfloat16_rn(d));
          if (d < m1[r][o]) {
            m2[r][o] = m1[r][o];
            m1[r][o] = d;
            i1[r][o] = col0 + cl;
          } else if (d < m2[r][o]) {
            m2[r][o] = d;
          }
        }
      }
  }
  __device__ __forceinline__ void finish(int r, float& v1, int& i, float& v2) {
    v1 = m1[r][0];
    v2 = m2[r][0];
    i = i1[r][0];
    merge(v1, i, v2, m1[r][1], i1[r][1], m2[r][1]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float b1 = shfl(v1, off), b2 = shfl(v2, off);
      const int bi = shfl(i, off);
      merge(v1, i, v2, b1, bi, b2);
    }
  }
};

// gemm (All = false) and rowsum (All = true): a sum of -2 a.b, added to
// `base` at the end (3.4e38 in the benchmark); lane t = 0 holds column 0
// of a tile.  ptxas (CUDA
// 12.8) crashes on a kernel that leaves a wgmma's accumulators unread: on
// a fold that reads column 0 only, and on a GEMM main loop that
// accumulates over the tiles and reads only the last.  So gemm reads every
// accumulator of every tile, all but column 0's weighted by 0 (kept: no
// fast math), one FMA each, as rowsum does.
template <bool All>
struct FoldSum {
  float s[2];
  float base;  // what min1 adds the sum to: the kernel's `base` argument
  __device__ void init() { s[0] = s[1] = 0.0f; }
  __device__ __forceinline__ void fold(const float (&acc)[ACC], const float*,
                                       int, int) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const bool col0 = j == 0 && o == 0;
          s[r] = fmaf(All || col0 ? -2.0f : 0.0f, acc[4 * j + 2 * r + o], s[r]);
        }
  }
  __device__ __forceinline__ void finish(int r, float& v1, int& i, float& v2) {
    float v = s[r];
    if (All) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) v += shfl(v, off);
    }
    v1 = base + v;
    i = -1;
    v2 = BIG;
  }
};

struct FoldMin1 {
  float m[2][2];
  __device__ void init() { m[0][0] = m[0][1] = m[1][0] = m[1][1] = BIG; }
  __device__ __forceinline__ void fold(const float (&acc)[ACC],
                                       const float* bnt, int, int t) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const float bv = bnt[8 * j + 2 * t + o];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          m[r][o] = fminf(m[r][o], bv - 2.0f * acc[4 * j + 2 * r + o]);
      }
  }
  __device__ __forceinline__ void finish(int r, float& v1, int& i, float& v2) {
    v1 = fminf(m[r][0], m[r][1]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) v1 = fminf(v1, shfl(v1, off));
    i = -1;
    v2 = BIG;
  }
};

// top2noi (Index = false) and top2idx (Index = true): per tile and row, a
// min/max tournament over the thread's 16 columns gives the tile's two
// smallest values; top2idx then finds the lowest of those columns that
// holds the minimum.  The tile's pair merges into the running one; the
// index moves only on a strictly smaller minimum, so the earlier (lower)
// column keeps a tie.
template <bool Index>
struct FoldTournament {
  float m1[2], m2[2];
  int i1[2];
  __device__ void init() {
    m1[0] = m1[1] = m2[0] = m2[1] = BIG;
    i1[0] = i1[1] = -1;
  }
  __device__ __forceinline__ void fold(const float (&acc)[ACC],
                                       const float* bnt, int col0, int t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float d[16];  // d[2 j + o]: column 8 j + 2 t + o, increasing
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int o = 0; o < 2; ++o)
          d[2 * j + o] = bnt[8 * j + 2 * t + o] - 2.0f * acc[4 * j + 2 * r + o];
      float lo[8], hi[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        lo[k] = fminf(d[2 * k], d[2 * k + 1]);
        hi[k] = fmaxf(d[2 * k], d[2 * k + 1]);
      }
#pragma unroll
      for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
        for (int k = 0; k < w; ++k) top2_values(lo[k], hi[k], lo[k + w], hi[k + w]);
      const float t1 = lo[0], t2 = hi[0];
      if (Index) {
        int ti = 0;
#pragma unroll
        for (int k = 15; k >= 0; --k)
          ti = d[k] == t1 ? col0 + 8 * (k >> 1) + 2 * t + (k & 1) : ti;
        if (t1 < m1[r]) {
          m2[r] = fminf(m1[r], t2);
          m1[r] = t1;
          i1[r] = ti;
        } else {
          m2[r] = fminf(m2[r], t1);
        }
      } else {
        top2_values(m1[r], m2[r], t1, t2);
      }
    }
  }
  __device__ __forceinline__ void finish(int r, float& v1, int& i, float& v2) {
    v1 = m1[r];
    v2 = m2[r];
    i = i1[r];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float b1 = shfl(v1, off), b2 = shfl(v2, off);
      const int bi = shfl(i, off);
      if (Index) merge(v1, i, v2, b1, bi, b2);
      else top2_values(v1, v2, b1, b2);
    }
  }
};

// slotpack: the two smallest int32 keys of each chain by integer min/max.
struct FoldSlotpack {
  int k1[2][2], k2[2][2];
  __device__ void init() {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int o = 0; o < 2; ++o) k1[r][o] = k2[r][o] = KEY_NONE;
  }
  __device__ __forceinline__ void fold(const float (&acc)[ACC],
                                       const float* bnt, int col0, int t) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const int cl = 8 * j + 2 * t + o;
        const float bv = bnt[cl] + BIAS;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float d = bv - 2.0f * acc[4 * j + 2 * r + o];
          const int key = (__float_as_int(d) & ~KEY_COLS) | (col0 + cl);
          k2[r][o] = min(k2[r][o], max(k1[r][o], key));
          k1[r][o] = min(k1[r][o], key);
        }
      }
  }
  __device__ __forceinline__ void finish(int r, float& v1, int& i, float& v2) {
    int a1 = min(k1[r][0], k1[r][1]);
    int a2 = min(max(k1[r][0], k1[r][1]), min(k2[r][0], k2[r][1]));
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const int b1 = shfl(a1, off), b2 = shfl(a2, off);
      a2 = min(max(a1, b1), min(a2, b2));
      a1 = min(a1, b1);
    }
    v1 = __int_as_float(a1 & ~KEY_COLS) - BIAS;
    i = a1 & KEY_COLS;
    v2 = __int_as_float(a2 & ~KEY_COLS) - BIAS;
  }
};

// The fold variants, in kernels/fold.py's FOLDS order.
enum { GEMM, ROWSUM, MIN1, CURRENT, PIPE, TOP2NOI, TOP2IDX, SLOTPACK, BF16 };

template <int F> struct FoldOf;
template <> struct FoldOf<GEMM> { using T = FoldSum<false>; };
template <> struct FoldOf<ROWSUM> { using T = FoldSum<true>; };
template <> struct FoldOf<MIN1> { using T = FoldMin1; };
template <> struct FoldOf<CURRENT> { using T = FoldCurrent<false>; };
template <> struct FoldOf<PIPE> { using T = FoldCurrent<false>; };
template <> struct FoldOf<TOP2NOI> { using T = FoldTournament<false>; };
template <> struct FoldOf<TOP2IDX> { using T = FoldTournament<true>; };
template <> struct FoldOf<SLOTPACK> { using T = FoldSlotpack; };
template <> struct FoldOf<BF16> { using T = FoldCurrent<true>; };

template <int F>
__global__ void __launch_bounds__(THREADS, 1)
fold_kernel(const __nv_bfloat16* __restrict__ a,
            const __nv_bfloat16* __restrict__ b,
            const float* __restrict__ bnorm, int m, int n, float base,
            float* __restrict__ min1_out, int* __restrict__ idx1_out,
            float* __restrict__ min2_out) {
  using L = Layout<Bf16>;
  constexpr int STEPS = Bf16::STEPS;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* As = smem;                  // [BM][LDA]
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
  const int slab = 16 * warp;
  const int tiles = (n + BN - 1) / BN;

  auto load_b = [&](int tile) {
    if (tile >= tiles) return;
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

  unsigned afr[STEPS][4];
  {
    const int r = lane & 7, j = lane >> 3;
#pragma unroll
    for (int s = 0; s < STEPS; ++s)
      ldmatrix_x4(afr[s], As + (slab + r + 8 * (j & 1)) * L::LDA + s * STEP_BYTES
                              + 16 * (j >> 1));
  }
  fence_proxy_async();
  __syncthreads();

  typename FoldOf<F>::T op;
  op.init();
  if constexpr (F == GEMM || F == ROWSUM) op.base = base;
  auto issue = [&](float (&acc)[ACC], int tile) {
    issue_tile(acc, afr, Bs + (tile % L::RAW) * L::TILE);
  };
  auto fold = [&](const float (&acc)[ACC], int tile) {
    op.fold(acc, bn_s + (tile % L::RAW) * BN, tile * BN, t);
  };

  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
  if constexpr (F != PIPE) {
    // K1's order: a tile's wgmmas, the copy of the tile after next, the
    // wait for the wgmmas, the fold.
    for (int tile = 0; tile < tiles; ++tile) {
      issue(acc, tile);
      load_b(tile + 2);
      cp_async_commit();   // possibly empty: the group count stays in step
      cp_async_wait<1>();  // this thread's copies of the next tile
      fence_proxy_async();
      wgmma_wait();
      fold(acc, tile);
      __syncthreads();     // the next tile's copies are everyone's
    }
  } else {
    // Tile t + 1's wgmmas run while tile t is folded: at the top of step t
    // tile t's group (the only one in flight) is retired and only tile
    // t + 1's copy group is pending; after the barrier every thread has
    // also finished folding tile t - 1, so its stage takes tile t + 2.
    // Tile t + 1's group is then issued into the other accumulator set,
    // and tile t folded under it.
    float acc2[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc2[i] = 0.0f;
    issue(acc, 0);
    auto step = [&](float (&cur)[ACC], float (&next)[ACC], int tile) {
      wgmma_wait();
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
      load_b(tile + 2);
      cp_async_commit();
      if (tile + 1 < tiles) issue(next, tile + 1);
      fold(cur, tile);
    };
    for (int tile = 0; tile < tiles; tile += 2) {
      step(acc, acc2, tile);
      if (tile + 1 < tiles) step(acc2, acc, tile + 1);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v1, v2;
    int i;
    op.finish(r, v1, i, v2);
    const int row = row0 + slab + g + 8 * r;
    if (t == 0 && row < m) {
      const size_t o = (size_t)pair * m + row;
      min1_out[o] = v1;
      idx1_out[o] = i;
      min2_out[o] = v2;
    }
  }
}

template <int F>
int launch(const void* a, const void* b, const void* bnorm, int pairs, int m,
           int n, float base, void* min1, void* idx1, void* min2,
           void* stream) {
  constexpr int smem = Layout<Bf16>::SMEM;
  static bool attribute_set = false;  // once per kernel, before any capture
  if (!attribute_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fold_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attribute_set = true;
  }
  dim3 grid((m + BM - 1) / BM, pairs);
  fold_kernel<F><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const float*>(bnorm), m, n, base, static_cast<float*>(min1),
      static_cast<int*>(idx1), static_cast<float*>(min2));
  return (int)cudaGetLastError();
}

}  // namespace

// One fold variant (kernels/fold.py's FOLDS index) on bf16 operands a
// (pairs, m, 128) and b (pairs, n, 128) with fp32 norms (pairs, n); `base`
// is what gemm and rowsum add their sums to (the others ignore it).
extern "C" int nm_fold_variant(int fold, const void* a, const void* b,
                               const void* bnorm, int pairs, int m, int n,
                               int d, float base, void* min1, void* idx1,
                               void* min2, void* stream) {
  if (d != D || pairs <= 0 || m <= 0 || n <= 0 || pairs > 65535 ||
      n > KEY_COLS + 1)
    return (int)cudaErrorInvalidValue;
#define NM_FOLD(F) \
  case F:          \
    return launch<F>(a, b, bnorm, pairs, m, n, base, min1, idx1, min2, stream);
  switch (fold) {
    NM_FOLD(GEMM)
    NM_FOLD(ROWSUM)
    NM_FOLD(MIN1)
    NM_FOLD(CURRENT)
    NM_FOLD(PIPE)
    NM_FOLD(TOP2NOI)
    NM_FOLD(TOP2IDX)
    NM_FOLD(SLOTPACK)
    NM_FOLD(BF16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef NM_FOLD
}
