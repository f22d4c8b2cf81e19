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
// What bounds it on this card: fp32 arithmetic.  The main path runs 8 pairs
// of 2048 x 2048 x 128, 8.6 GFLOP, which is 0.128 ms at the 67 TFLOP/s of
// fp32 outside the tensor cores, against 16.8 MB of operands (5 us at
// 3.35 TB/s).  fp32 stays exact (no TF32); bf16 operands are widened to
// fp32 as they are loaded and every product and sum is fp32.
//
// The simple design: a block of 256 threads owns 64 A rows of one pair and
// keeps them in shared memory, transposed, for the whole sweep; B streams
// through shared memory in 64-row tiles, 32 values of depth at a time.
// Each thread computes a 4x4 register tile of dot products with float4
// shared-memory loads and folds it straight into a running (min1, idx1,
// min2) for its 4 rows, visiting its columns in increasing order so a
// strict < keeps the lowest column.  After the sweep the 16 threads that
// share a row merge their partial top-2s with warp shuffles (lowest column
// wins a tie) and one of them writes the row.  The batch of pairs is the
// grid's y axis: one launch per chunk.  wgmma/TMA tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;       // descriptor length
constexpr int TM = 64;       // A rows per block
constexpr int TN = 64;       // B rows per tile
constexpr int KC = 32;       // depth per B stage
constexpr int LD = TM + 4;   // padded leading dim (keeps float4 alignment)
constexpr int THREADS = 256;
constexpr float BIG = 3.4e38f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
match_top2_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ anorm,
                  const float* __restrict__ bnorm, int m, int n,
                  float* __restrict__ min1_out, int* __restrict__ idx1_out,
                  float* __restrict__ min2_out) {
  __shared__ __align__(16) float as[D][LD];   // as[k][row] = A[row0+row][k]
  __shared__ __align__(16) float bs[KC][LD];  // bs[k][col] = B[n0+col][k0+k]
  __shared__ float bn_s[TN];

  const int pair = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const T* ap = a + (size_t)pair * m * D;
  const T* bp = b + (size_t)pair * n * D;
  const float* bnp = bnorm + (size_t)pair * n;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  for (int e = tid; e < TM * D; e += THREADS) {
    const int r = e / D, k = e % D;
    as[k][r] = (row0 + r < m) ? to_f32(ap[(size_t)(row0 + r) * D + k]) : 0.0f;
  }

  float m1[4], m2[4];
  int i1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m1[i] = BIG;
    m2[i] = BIG;
    i1[i] = -1;
  }

  for (int n0 = 0; n0 < n; n0 += TN) {
    __syncthreads();  // the previous tile's fold has read bn_s
    if (tid < TN) bn_s[tid] = (n0 + tid < n) ? bnp[n0 + tid] : 0.0f;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < D; k0 += KC) {
      __syncthreads();  // every thread is done with the previous stage
      for (int e = tid; e < TN * KC; e += THREADS) {
        const int c = e / KC, k = e % KC;
        bs[k][c] = (n0 + c < n) ? to_f32(bp[(size_t)(n0 + c) * D + k0 + k])
                                : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&as[k0 + k][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * br[j];
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= n) break;
      const float bnv = bn_s[tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = bnv - 2.0f * acc[i][j];
        if (d < m1[i]) {
          m2[i] = m1[i];
          m1[i] = d;
          i1[i] = col;
        } else if (d < m2[i]) {
          m2[i] = d;
        }
      }
    }
  }

  // Merge the 16 partial top-2s of each row (lanes differing in tx only).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float a1 = m1[i], a2 = m2[i];
    int ai = i1[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float b1 = __shfl_xor_sync(0xffffffffu, a1, off);
      const float b2 = __shfl_xor_sync(0xffffffffu, a2, off);
      const int bi = __shfl_xor_sync(0xffffffffu, ai, off);
      const bool take =
          (b1 < a1) || (b1 == a1 && (unsigned)bi < (unsigned)ai);
      if (take) {
        a2 = fminf(b2, a1);
        a1 = b1;
        ai = bi;
      } else {
        a2 = fminf(a2, b1);
      }
    }
    const int r = row0 + ty * 4 + i;
    if (tx == 0 && r < m) {
      const size_t o = (size_t)pair * m + r;
      const float an = anorm[o];
      min1_out[o] = fmaxf(a1 + an, 0.0f);
      idx1_out[o] = ai;
      min2_out[o] = fmaxf(a2 + an, 0.0f);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* anorm, const void* bnorm,
           int pairs, int m, int n, int d, void* min1, void* idx1, void* min2,
           void* stream) {
  if (d != D || pairs <= 0 || m <= 0 || n <= 0 || pairs > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((m + TM - 1) / TM, pairs);
  match_top2_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(anorm), static_cast<const float*>(bnorm), m, n,
      static_cast<float*>(min1), static_cast<int*>(idx1),
      static_cast<float*>(min2));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nm_match_top2_f32(const void* a, const void* b,
                                 const void* anorm, const void* bnorm,
                                 int pairs, int m, int n, int d, void* min1,
                                 void* idx1, void* min2, void* stream) {
  return launch<float>(a, b, anorm, bnorm, pairs, m, n, d, min1, idx1, min2,
                       stream);
}

extern "C" int nm_match_top2_bf16(const void* a, const void* b,
                                  const void* anorm, const void* bnorm,
                                  int pairs, int m, int n, int d, void* min1,
                                  void* idx1, void* min2, void* stream) {
  return launch<__nv_bfloat16>(a, b, anorm, bnorm, pairs, m, n, d, min1, idx1,
                               min2, stream);
}
