// K4: the fold microbenchmark, a bf16 distance GEMM with one of nine top-2
// folds, for Hopper (sm_90a).
//
// Replaces benchmarks/fold_micro.py:59 _variant_kernel (pallas_call at :287
// in _variant_call).  The plain PyTorch versions are
// niftymatch_torch/kernels/fold.py::fold_variant_plain.
//
// What it computes, for each pair p and each A row i, with bf16 operands
// and fp32 accumulation: d_j = ||b_j||^2 - 2 a_i.b_j over the B rows j (no
// ||a||^2 and no clamp, unlike K1), folded into (min1, idx1, min2); fields a
// variant does not produce keep their initial values, 3.4e38 and -1:
//   gemm      min1 = base + the sum of -2 a.b at every 64th column (column
//             0 of each of K1's 64-wide tiles; a consume only: every
//             product is still computed, since the wgmmas are issued whole;
//             see FoldSum for what it reads);
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
//             value - 256: values keep 8 mantissa bits; with a single
//             column min2 is 3.4e38, as in the other variants;
//   bf16      current on d rounded to bf16.
// K1 itself on the same operands (the TPU benchmark's `full`) is
// kernels/match.py's launch of match.cu, which this file leaves alone.
//
// What bounds it on this card: tensor-core arithmetic.  The default shape,
// 16 pairs of 1024 x 1024 x 128, is 4.29 GFLOP (4.34 us at 989 TFLOP/s)
// against 8.5 MB of operands (2.5 us at 3.35 TB/s); so is one pair of 4096.
//
// The design (fold_tile.cuh holds the pieces):
// - The grid is (row blocks of 128, column splits, pairs).  The wrapper
//   picks the split count (a power of two up to 8) so that the grid fills
//   the 132 SMs once (kernels/fold.py::column_splits): 1 at 16 pairs of
//   1024, 4 at one pair of 4096, where a CTA a row block leaves 100
//   SMs idle.
//   Each CTA folds its split's whole 128-column tiles into a partial
//   (min1, idx1, min2) per row; the last CTA of a row block to finish (a
//   counter that it resets for the next launch) merges the splits in
//   column order with K1's rule, so no result depends on which CTA
//   finishes first.  (A thread block cluster a row block, merging in
//   distributed shared memory, was measured: clusters of 4 do not fit 32
//   at once on the H100, and (4,096, 1) took two waves.)
// - Warp specialisation: one producer warp (in a warpgroup that gives its
//   registers to the consumers with setmaxnreg) streams B tiles through a
//   ring of 4 stages: two TMA boxes a tile (64 of depth each, 128-byte
//   swizzle, rows past n zero-filled) and the tile's norms (+inf past n),
//   with a full and an empty mbarrier per stage.  Two consumer warpgroups
//   each hold 64 A rows in registers and take turns on the tensor cores
//   (named barriers): while one issues its wgmmas on a tile, the other
//   folds the tile it has just multiplied.  No block-wide barrier in the
//   loop.
// - wgmma m64n128k16 (8 per tile and warpgroup, A from registers, B from
//   the swizzled tile): 64 accumulators a thread, folded as 32 columns of
//   2 rows.  `pipe` also keeps the next tile's 64 in flight.

#include "match_tile.cuh"
#include "fold_tile.cuh"

namespace {

constexpr float BIAS = 256.0f;      // slotpack: d + BIAS > 0
constexpr int KEY_COLS = 0x7FFF;    // slotpack: the column bits of a key
constexpr int KEY_NONE = 0x7FFFFFFF;
constexpr int KEY_INF = 0x7F800000; // slotpack: a key at or above has no value
constexpr int SUM_STRIDE = 64;      // gemm: the columns it sums (K1's tile)

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

// The pairwise top-2 tournament of W + W pairs (lo[k] <= hi[k]) into pair 0,
// unrolled whole so that every index is a constant.
template <int W, int N>
__device__ __forceinline__ void tournament(float (&lo)[N], float (&hi)[N]) {
#pragma unroll
  for (int k = 0; k < W; ++k) top2_values(lo[k], hi[k], lo[k + W], hi[k + W]);
  if constexpr (W > 1) tournament<W / 2>(lo, hi);
}

// A row's result over some columns, three 32-bit words whose meaning is the
// fold's: what a CTA leaves for the merge of the column splits.
struct Part {
  unsigned w0, w1, w2;
};
__device__ __forceinline__ unsigned fbits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ float fval(unsigned w) { return __uint_as_float(w); }

// The folds.  NJ column groups of 8 a tile: a thread's accumulators of one
// tile are acc[4 j + 2 r + o], rows g + 8 r of its warp's 16, columns
// 8 j + 2 t + o.  `fold` takes one tile; `finish` merges a row's chains and
// its 4 lanes into a Part; `combine` merges the Part of the next columns
// into `a`; `emit` gives (min1, idx1, min2).

// The running (min1, idx1, min2) of K1's fold: rows r = 0, 1 (g, g + 8) and
// even and odd columns apart, four independent chains.  `Round` rounds d
// first (bf16) or not.
template <bool Round, int NJ>
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
  __device__ __forceinline__ void fold(const float (&acc)[4 * NJ],
                                       const float* bnt, int col0, int t) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
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
  __device__ __forceinline__ Part finish(int r) {
    float v1 = m1[r][0], v2 = m2[r][0];
    int i = i1[r][0];
    merge(v1, i, v2, m1[r][1], i1[r][1], m2[r][1]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float b1 = shfl(v1, off), b2 = shfl(v2, off);
      const int bi = shfl(i, off);
      merge(v1, i, v2, b1, bi, b2);
    }
    return Part{fbits(v1), (unsigned)i, fbits(v2)};
  }
  static __device__ __forceinline__ void combine(Part& a, const Part& b) {
    float a1 = fval(a.w0), a2 = fval(a.w2);
    int ai = (int)a.w1;
    merge(a1, ai, a2, fval(b.w0), (int)b.w1, fval(b.w2));
    a = Part{fbits(a1), (unsigned)ai, fbits(a2)};
  }
  static __device__ __forceinline__ void emit(const Part& p, float, float& v1,
                                              int& i, float& v2) {
    v1 = fval(p.w0);
    i = (int)p.w1;
    v2 = fval(p.w2);
  }
};

// gemm (All = false) and rowsum (All = true): a sum of -2 a.b, added to
// `base` once, at the end (3.4e38 in the benchmark); lane t = 0 holds the
// columns gemm sums.  ptxas (CUDA 12.8) crashes on a kernel that leaves a
// wgmma's accumulators unread: on a fold that reads one column only, and
// on a GEMM main loop that accumulates over the tiles and reads only the
// last.  So gemm reads every accumulator of every tile, all but its own
// columns weighted by 0 (kept: no fast math), one FMA each, as rowsum does.
template <bool All, int NJ>
struct FoldSum {
  float s[2];
  __device__ void init() { s[0] = s[1] = 0.0f; }
  __device__ __forceinline__ void fold(const float (&acc)[4 * NJ], const float*,
                                       int, int) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const bool summed = j % (SUM_STRIDE / 8) == 0 && o == 0;
          s[r] = fmaf(All || summed ? -2.0f : 0.0f, acc[4 * j + 2 * r + o], s[r]);
        }
  }
  __device__ __forceinline__ Part finish(int r) {
    float v = s[r];
    if (All) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) v += shfl(v, off);
    }
    return Part{fbits(v), 0u, 0u};
  }
  static __device__ __forceinline__ void combine(Part& a, const Part& b) {
    a.w0 = fbits(fval(a.w0) + fval(b.w0));
  }
  static __device__ __forceinline__ void emit(const Part& p, float base,
                                              float& v1, int& i, float& v2) {
    v1 = base + fval(p.w0);
    i = -1;
    v2 = BIG;
  }
};

template <int NJ>
struct FoldMin1 {
  float m[2][2];
  __device__ void init() { m[0][0] = m[0][1] = m[1][0] = m[1][1] = BIG; }
  __device__ __forceinline__ void fold(const float (&acc)[4 * NJ],
                                       const float* bnt, int, int t) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const float bv = bnt[8 * j + 2 * t + o];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          m[r][o] = fminf(m[r][o], bv - 2.0f * acc[4 * j + 2 * r + o]);
      }
  }
  __device__ __forceinline__ Part finish(int r) {
    float v = fminf(m[r][0], m[r][1]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) v = fminf(v, shfl(v, off));
    return Part{fbits(v), 0u, 0u};
  }
  static __device__ __forceinline__ void combine(Part& a, const Part& b) {
    a.w0 = fbits(fminf(fval(a.w0), fval(b.w0)));
  }
  static __device__ __forceinline__ void emit(const Part& p, float, float& v1,
                                              int& i, float& v2) {
    v1 = fval(p.w0);
    i = -1;
    v2 = BIG;
  }
};

// top2noi (Index = false) and top2idx (Index = true): per tile and row, a
// min/max tournament over the thread's 2 NJ columns gives the tile's two
// smallest values; top2idx then finds the lowest of those columns that
// holds the minimum.  The tile's pair merges into the running one; the
// index moves only on a strictly smaller minimum, so the earlier (lower)
// column keeps a tie.
template <bool Index, int NJ>
struct FoldTournament {
  static constexpr int V = 2 * NJ;  // values a row and tile
  float m1[2], m2[2];
  int i1[2];
  __device__ void init() {
    m1[0] = m1[1] = m2[0] = m2[1] = BIG;
    i1[0] = i1[1] = -1;
  }
  __device__ __forceinline__ void fold(const float (&acc)[4 * NJ],
                                       const float* bnt, int col0, int t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float d[V];  // d[2 j + o]: column 8 j + 2 t + o, increasing
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int o = 0; o < 2; ++o)
          d[2 * j + o] = bnt[8 * j + 2 * t + o] - 2.0f * acc[4 * j + 2 * r + o];
      float lo[V / 2], hi[V / 2];
#pragma unroll
      for (int k = 0; k < V / 2; ++k) {
        lo[k] = fminf(d[2 * k], d[2 * k + 1]);
        hi[k] = fmaxf(d[2 * k], d[2 * k + 1]);
      }
      tournament<V / 4>(lo, hi);
      const float t1 = lo[0], t2 = hi[0];
      if (Index) {
        int ti = 0;
#pragma unroll
        for (int k = V - 1; k >= 0; --k)
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
  __device__ __forceinline__ Part finish(int r) {
    float v1 = m1[r], v2 = m2[r];
    int i = i1[r];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float b1 = shfl(v1, off), b2 = shfl(v2, off);
      const int bi = shfl(i, off);
      if (Index) merge(v1, i, v2, b1, bi, b2);
      else top2_values(v1, v2, b1, b2);
    }
    return Part{fbits(v1), (unsigned)i, fbits(v2)};
  }
  static __device__ __forceinline__ void combine(Part& a, const Part& b) {
    float a1 = fval(a.w0), a2 = fval(a.w2);
    int ai = (int)a.w1;
    if (Index) merge(a1, ai, a2, fval(b.w0), (int)b.w1, fval(b.w2));
    else top2_values(a1, a2, fval(b.w0), fval(b.w2));
    a = Part{fbits(a1), (unsigned)ai, fbits(a2)};
  }
  static __device__ __forceinline__ void emit(const Part& p, float, float& v1,
                                              int& i, float& v2) {
    v1 = fval(p.w0);
    i = Index ? (int)p.w1 : -1;
    v2 = fval(p.w2);
  }
};

// slotpack: the two smallest int32 keys of each chain by integer min/max;
// its Part holds the two keys.
template <int NJ>
struct FoldSlotpack {
  int k1[2][2], k2[2][2];
  __device__ void init() {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int o = 0; o < 2; ++o) k1[r][o] = k2[r][o] = KEY_NONE;
  }
  __device__ __forceinline__ void fold(const float (&acc)[4 * NJ],
                                       const float* bnt, int col0, int t) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
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
  __device__ __forceinline__ Part finish(int r) {
    int a1 = min(k1[r][0], k1[r][1]);
    int a2 = min(max(k1[r][0], k1[r][1]), min(k2[r][0], k2[r][1]));
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const int b1 = shfl(a1, off), b2 = shfl(a2, off);
      a2 = min(max(a1, b1), min(a2, b2));
      a1 = min(a1, b1);
    }
    return Part{(unsigned)a1, 0u, (unsigned)a2};
  }
  static __device__ __forceinline__ void combine(Part& a, const Part& b) {
    const int a1 = (int)a.w0, a2 = (int)a.w2, b1 = (int)b.w0, b2 = (int)b.w2;
    a.w2 = (unsigned)min(max(a1, b1), min(a2, b2));
    a.w0 = (unsigned)min(a1, b1);
  }
  static __device__ __forceinline__ void emit(const Part& p, float, float& v1,
                                              int& i, float& v2) {
    const int a1 = (int)p.w0, a2 = (int)p.w2;
    v1 = __int_as_float(a1 & ~KEY_COLS) - BIAS;
    i = a1 & KEY_COLS;
    // The key of a column past n (d = +inf), or none: no second value.
    v2 = (a2 & ~KEY_COLS) >= KEY_INF ? BIG : __int_as_float(a2 & ~KEY_COLS) - BIAS;
  }
};

// The fold variants, in kernels/fold.py's FOLDS order.
enum { GEMM, ROWSUM, MIN1, CURRENT, PIPE, TOP2NOI, TOP2IDX, SLOTPACK, BF16 };

template <int F, int NJ> struct FoldOf;
template <int NJ> struct FoldOf<GEMM, NJ> { using T = FoldSum<false, NJ>; };
template <int NJ> struct FoldOf<ROWSUM, NJ> { using T = FoldSum<true, NJ>; };
template <int NJ> struct FoldOf<MIN1, NJ> { using T = FoldMin1<NJ>; };
template <int NJ> struct FoldOf<CURRENT, NJ> { using T = FoldCurrent<false, NJ>; };
template <int NJ> struct FoldOf<PIPE, NJ> { using T = FoldCurrent<false, NJ>; };
template <int NJ> struct FoldOf<TOP2NOI, NJ> { using T = FoldTournament<false, NJ>; };
template <int NJ> struct FoldOf<TOP2IDX, NJ> { using T = FoldTournament<true, NJ>; };
template <int NJ> struct FoldOf<SLOTPACK, NJ> { using T = FoldSlotpack<NJ>; };
template <int NJ> struct FoldOf<BF16, NJ> { using T = FoldCurrent<true, NJ>; };

// --- the warp-specialised kernel --------------------------------------------

constexpr int STAGES = 4;                 // B tiles in flight
constexpr int ROWS = 128;                 // A rows a CTA: 64 a consumer warpgroup
constexpr int MAX_SPLITS = 8;             // splits of a pair's columns at most
constexpr int CONSUMER_THREADS = 256;     // two consumer warpgroups
constexpr int WS_THREADS = 384;           // and the producer's warpgroup
constexpr int PRODUCER_REGS = 40;         // 128 x 40 + 256 x 232 <= 65,536
constexpr int CONSUMER_REGS = 232;
constexpr unsigned FULL_ARRIVALS = 33;    // the TMA's expect_tx, 32 norm lanes
constexpr unsigned EMPTY_ARRIVALS = 8;    // each consumer warp
constexpr int BAR_TURN = 1;               // named barriers 1, 2: each warpgroup's turn
constexpr int BAR_CONSUMERS = 3;          // the consumers, for the split merge
constexpr int WS_SMEM = 1024 /* alignment */ + STAGES * WIDE_TILE_BYTES
                        + STAGES * WIDE_N * 4 + 2 * STAGES * 8 + 16;

template <int F>
__global__ void __launch_bounds__(WS_THREADS, 1)
fold_kernel(const __grid_constant__ CUtensorMap bmap,
            const __nv_bfloat16* __restrict__ a, const float* __restrict__ bnorm,
            int m, int n, int splits, float base, float* __restrict__ min1_out,
            int* __restrict__ idx1_out, float* __restrict__ min2_out,
            unsigned* __restrict__ scratch, int* __restrict__ counters) {
  using Op = typename FoldOf<F, WIDE_N / 8>::T;
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: the tiles start there.
  unsigned char* tiles = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* norms = reinterpret_cast<float*>(tiles + STAGES * WIDE_TILE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(norms + STAGES * WIDE_N);
  uint64_t* empty = full + STAGES;
  int* last = reinterpret_cast<int*>(empty + STAGES);  // this CTA merges

  const int block = blockIdx.x, split = blockIdx.y, pair = blockIdx.z;
  const int tiles_n = (n + WIDE_N - 1) / WIDE_N;
  const int first = split * tiles_n / splits;  // this split's tiles
  const int count = (split + 1) * tiles_n / splits - first;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], FULL_ARRIVALS);
      mbar_init(&empty[s], EMPTY_ARRIVALS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= CONSUMER_THREADS / 32) {
    // The producer warpgroup: its first warp streams the tiles, the other
    // three only give up their registers.
    reg_dealloc<PRODUCER_REGS>();
    if (warp == CONSUMER_THREADS / 32) {
      const float* bnp = bnorm + (size_t)pair * n;
      float nv[WIDE_N / 32];  // the next tile's norms, loaded a tile ahead
      auto norms_of = [&](int i) {
        const int c0 = (first + i) * WIDE_N;
#pragma unroll
        for (int q = 0; q < WIDE_N / 32; ++q) {
          const int col = c0 + lane + 32 * q;  // a column past n reads +inf
          nv[q] = col < n ? __ldg(bnp + col) : __int_as_float(0x7f800000);
        }
      };
      norms_of(0);
      for (int i = 0; i < count; ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        if (lane == 0) {
          unsigned char* dst = tiles + s * WIDE_TILE_BYTES;
          const int n0 = (first + i) * WIDE_N;
          mbar_arrive_expect_tx(&full[s], WIDE_TILE_BYTES);
          tma_load_3d(dst, &bmap, &full[s], 0, n0, pair);
          tma_load_3d(dst + HALF_BYTES, &bmap, &full[s], SWIZZLE_BYTES / 2, n0, pair);
        }
        float* dn = norms + s * WIDE_N;
#pragma unroll
        for (int q = 0; q < WIDE_N / 32; ++q) dn[lane + 32 * q] = nv[q];
        mbar_arrive(&full[s]);
        if (i + 1 < count) norms_of(i + 1);
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const int row_g = block * ROWS + 64 * wg + 16 * (warp & 3) + g;  // and + 8

    // The warp's 16 A rows as wgmma A fragments (K1's layout), straight
    // from global memory: k-step s, word 8 s + t (+ 4) of rows g, g + 8.
    unsigned afr[Bf16::STEPS][4];
    const unsigned* ap = reinterpret_cast<const unsigned*>(a + (size_t)pair * m * D);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_g + 8 * r;
      const bool ok = row < m;
      const unsigned* ar = ap + (size_t)(ok ? row : 0) * (D / 2);
#pragma unroll
      for (int s = 0; s < Bf16::STEPS; ++s) {
        afr[s][r] = ok ? __ldg(ar + 8 * s + t) : 0u;
        afr[s][2 + r] = ok ? __ldg(ar + 8 * s + 4 + t) : 0u;
      }
    }

    Op op;
    op.init();
    auto issue = [&](float (&acc)[WIDE_ACC], int i) {
      const unsigned char* bt = tiles + (i % STAGES) * WIDE_TILE_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < Bf16::STEPS; ++s)
        wgmma_bf16_n128(acc, afr[s],
                        sw128_desc(bt + (s >> 2) * HALF_BYTES + (s & 3) * STEP_BYTES),
                        s > 0);
      wgmma_commit();
    };
    // Tile i's wgmmas, when it has landed and it is this warpgroup's turn;
    // then the other's turn (warpgroup 1 gives none after its last).
    auto take_turn = [&](float (&acc)[WIDE_ACC], int i) {
      mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
      named_sync(BAR_TURN + wg, CONSUMER_THREADS);
      issue(acc, i);
      if (wg == 0 || i + 1 < count) named_arrive(BAR_TURN + (wg ^ 1), CONSUMER_THREADS);
    };
    // Tile i's fold; then the warp gives the stage back.
    auto fold = [&](const float (&acc)[WIDE_ACC], int i) {
      op.fold(acc, norms + (i % STAGES) * WIDE_N, (first + i) * WIDE_N, t);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[i % STAGES]);
    };

    if (wg == 1) named_arrive(BAR_TURN, CONSUMER_THREADS);  // warpgroup 0 first
    float acc[WIDE_ACC];
#pragma unroll
    for (int i = 0; i < WIDE_ACC; ++i) acc[i] = 0.0f;
    if constexpr (F != PIPE) {
      for (int i = 0; i < count; ++i) {
        take_turn(acc, i);
        wgmma_wait();
        fence_regs(acc);
        fold(acc, i);
      }
    } else {
      // At the top of each step only tile i's group is in flight: retire
      // it, issue tile i + 1's into the other set, and fold tile i under
      // it.  The loop runs while two more tiles follow, so that its issues
      // are unconditional (with a conditional issue inside the loop ptxas
      // serialised the wgmmas, C7515); the last one or two tiles follow.
      float acc2[WIDE_ACC];
#pragma unroll
      for (int i = 0; i < WIDE_ACC; ++i) acc2[i] = 0.0f;
      take_turn(acc, 0);
      int i = 0;
      for (; i + 2 < count; i += 2) {
        wgmma_wait();
        fence_regs(acc);
        take_turn(acc2, i + 1);
        fold(acc, i);
        wgmma_wait();
        fence_regs(acc2);
        take_turn(acc, i + 2);
        fold(acc2, i + 1);
      }
      wgmma_wait();
      fence_regs(acc);
      if (i + 1 < count) {
        take_turn(acc2, i + 1);
        fold(acc, i);
        wgmma_wait();
        fence_regs(acc2);
        fold(acc2, i + 1);
      } else {
        fold(acc, i);
      }
    }

    // Each row's result; with more than one split, each CTA leaves its
    // rows' Parts in `scratch`, and the row block's last CTA to arrive
    // merges them in column order (so no result depends on which CTA
    // finishes first) and leaves the counter at zero for the next launch.
    auto write = [&](const Part& p, int row) {
      float v1, v2;
      int i;
      Op::emit(p, base, v1, i, v2);
      const size_t o = (size_t)pair * m + row;
      min1_out[o] = v1;
      idx1_out[o] = i;
      min2_out[o] = v2;
    };
    const size_t plane = (size_t)gridDim.z * splits * m;  // words of each field
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const Part p = op.finish(r);
      const int row = row_g + 8 * r;
      if (t == 0 && row < m) {
        if (splits == 1) {
          write(p, row);
        } else {
          const size_t o = ((size_t)pair * splits + split) * m + row;
          scratch[o] = p.w0;
          scratch[plane + o] = p.w1;
          scratch[2 * plane + o] = p.w2;
        }
      }
    }
    if (splits > 1) {
      named_sync(BAR_CONSUMERS, CONSUMER_THREADS);  // the CTA's Parts written
      int* counter = counters + (size_t)pair * gridDim.x + block;
      if (tid == 0) *last = atomic_add_acq_rel(counter, 1) == splits - 1;
      named_sync(BAR_CONSUMERS, CONSUMER_THREADS);
      if (*last) {
        const int row = block * ROWS + tid;
        if (tid < ROWS && row < m) {
          auto part = [&](int s) {
            const size_t o = ((size_t)pair * splits + s) * m + row;
            return Part{__ldcg(scratch + o), __ldcg(scratch + plane + o),
                        __ldcg(scratch + 2 * plane + o)};
          };
          Part p = part(0);
          for (int s = 1; s < splits; ++s) Op::combine(p, part(s));
          write(p, row);
        }
        if (tid == 0) *counter = 0;
      }
    }
  }
}

template <int F>
int launch(const CUtensorMap& bmap, const void* a, const void* bnorm, int pairs,
           int m, int n, int splits, float base, void* min1, void* idx1,
           void* min2, void* scratch, void* counters, void* stream) {
  static bool attribute_set = false;  // once per kernel, before any capture
  if (!attribute_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fold_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, WS_SMEM);
    if (e != cudaSuccess) return (int)e;
    attribute_set = true;
  }
  dim3 grid((m + ROWS - 1) / ROWS, splits, pairs);
  fold_kernel<F><<<grid, WS_THREADS, WS_SMEM, static_cast<cudaStream_t>(stream)>>>(
      bmap, static_cast<const __nv_bfloat16*>(a), static_cast<const float*>(bnorm),
      m, n, splits, base, static_cast<float*>(min1), static_cast<int*>(idx1),
      static_cast<float*>(min2), static_cast<unsigned*>(scratch),
      static_cast<int*>(counters));
  return (int)cudaGetLastError();
}

// The checks and the tensor map of nm_fold_variant; returns 0 or an error.
int prepare(CUtensorMap* bmap, const void* b, int pairs, int m, int n, int d,
            int splits, const void* scratch, const void* counters) {
  if (d != D || pairs <= 0 || m <= 0 || n <= 0 || pairs > 65535 ||
      n > KEY_COLS + 1 || splits < 1 || splits > MAX_SPLITS ||
      splits > (n + WIDE_N - 1) / WIDE_N ||
      (splits > 1 && (scratch == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  return b_tensor_map(bmap, b, pairs, n);
}

}  // namespace

// One fold variant (kernels/fold.py's FOLDS index) on bf16 operands a
// (pairs, m, 128) and b (pairs, n, 128) with fp32 norms (pairs, n); `base`
// is what gemm and rowsum add their sums to (the others ignore it).  Each
// pair's B tiles are split into `splits` parts (1 to 8, at most one a tile),
// one CTA each; with more than one, `scratch` holds 3 x pairs x splits x m
// words of partials and `counters` pairs x ceil(m / 128) zeros, which every
// launch leaves zero.
extern "C" int nm_fold_variant(int fold, const void* a, const void* b,
                               const void* bnorm, int pairs, int m, int n,
                               int d, float base, void* min1, void* idx1,
                               void* min2, int splits, void* scratch,
                               void* counters, void* stream) {
  CUtensorMap bmap;
  const int rc = prepare(&bmap, b, pairs, m, n, d, splits, scratch, counters);
  if (rc != 0) return rc;
#define NM_FOLD(F)                                                          \
  case F:                                                                   \
    return launch<F>(bmap, a, bnorm, pairs, m, n, splits, base, min1, idx1, \
                     min2, scratch, counters, stream);
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
