// The two-view geometry's small-matrix solvers, one launch a call, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's geometry/linalg.py writes
// svd3x3 (a cyclic Jacobi eigendecomposition of E^T E) and
// smallest_eigvec (inverse iteration on a jittered Cholesky factor) as
// chains of scalar operations that XLA fuses into one program under jit.
// The port's plain versions (niftymatch_torch/geometry/linalg.py, which
// CPU tensors take) run them eagerly on whole (..., n, n) tensors a
// rotation, a column or a triangular solve at a time: ~512 launches an
// svd3x3 and ~130 a smallest_eigvec, each a few microseconds of host time
// for well under a microsecond of device work.  The SLAM frame calls them
// ~20 times.  Here each call is one launch.
//
// What it computes, as the plain versions do:
// * nm_svd3x3: A = E^T E, symmetrised; `sweeps` cyclic Jacobi sweeps with
//   the rotations in the order (0,1), (0,2), (1,2), each from
//   theta = 0.5 atan2(2 a_pq, a_qq - a_pp) and applied to columns p and q
//   of A and V, then to rows p and q of A; the eigenpairs sorted
//   descending by the compare-swap network (0,1), (0,2), (1,2) with strict
//   comparisons; S = sqrt(max(w, 0)); U = E V / max(S, 1e-12) a column,
//   its first column normalised, its second by Gram-Schmidt against it,
//   its third the cross product of the two, signed against E v3 / s3;
//   Vt = V^T.  Every vector norm is floored at 1e-20.
// * nm_smallest_eigvec: for symmetric n x n A (n <= 9), A + (1e-6 tr(A)/n
//   + 1e-30) I factored by an unpivoted Cholesky a column at a time with
//   its pivots floored at 1e-30, then `iterations` rounds of a forward
//   and a backward substitution from the caller's start vector, each
//   round normalised by 1 / max(|x|, 1e-30).
//
// What bounds it on this card: latency.  A 3 x 3 SVD is ~4 kFLOP, a 9 x 9
// inverse iteration ~2.5 kFLOP, over 36 to 360 bytes in and out a matrix;
// the SLAM's batches are 512 to 8,192 matrices, a few MFLOP and a few
// hundred KB a launch: nanoseconds of arithmetic or bytes, so the launch
// and one thread's dependent chain of a few thousand instructions set the
// time.  Hence one thread a matrix, every entry in registers (the loops
// over entries unrolled at compile time, n a template parameter), no
// shared memory, no barriers, 128 threads a block over ceil(batch / 128)
// blocks.  Nothing is reduced across threads, so a rerun gives the same
// bits.
//
// The device code of both solvers lives in linalg.cuh, which ransac.cu
// also includes for its fits.
//
// Numerics: fp32 throughout, precise atan2f, sinf, cosf, sqrtf and IEEE
// division (no --use_fast_math, no __sinf): the port runs fp32 with TF32
// off.  nvcc may contract multiplies and adds, and the sums run in
// another order than the plain versions' matrix products, so results
// agree with them to rounding, not to the bit.

#include <cuda_runtime.h>

#include "linalg.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_N = 9;

__global__ void __launch_bounds__(THREADS)
svd3x3_kernel(const float* __restrict__ E_in, float* __restrict__ U_out,
              float* __restrict__ S_out, float* __restrict__ Vt_out,
              int batch, int sweeps) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= batch) return;
  float S[3], u1[3], u2[3], u3[3], V[3][3];
  svd3x3(E_in + 9 * i, sweeps, S, u1, u2, u3, V);

#pragma unroll
  for (int r = 0; r < 3; ++r) {
    U_out[9 * i + 3 * r + 0] = u1[r];
    U_out[9 * i + 3 * r + 1] = u2[r];
    U_out[9 * i + 3 * r + 2] = u3[r];
    S_out[3 * i + r] = S[r];
#pragma unroll
    for (int c = 0; c < 3; ++c) Vt_out[9 * i + 3 * r + c] = V[c][r];
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS)
smallest_eigvec_kernel(const float* __restrict__ A_in, const float* __restrict__ start,
                       float* __restrict__ x_out, int batch, int iterations) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= batch) return;
  float x[N];
  smallest_eigvec<N>(A_in + (size_t)N * N * i, start, iterations, x);
#pragma unroll
  for (int k = 0; k < N; ++k) x_out[(size_t)N * i + k] = x[k];
}

template <int N>
void launch_eigvec(const float* A, const float* start, float* x, int batch,
                   int iterations, cudaStream_t stream) {
  smallest_eigvec_kernel<N><<<(batch + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      A, start, x, batch, iterations);
}

}  // namespace

extern "C" int nm_svd3x3(const void* E, void* U, void* S, void* Vt, int batch,
                         int sweeps, void* stream) {
  if (batch <= 0 || sweeps < 0) return (int)cudaErrorInvalidValue;
  svd3x3_kernel<<<(batch + THREADS - 1) / THREADS, THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(E), static_cast<float*>(U), static_cast<float*>(S),
      static_cast<float*>(Vt), batch, sweeps);
  return (int)cudaGetLastError();
}

extern "C" int nm_smallest_eigvec(const void* A, const void* start, void* x, int batch,
                                  int n, int iterations, void* stream) {
  if (batch <= 0 || iterations < 0 || n < 1 || n > MAX_N)
    return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(A);
  const float* s0 = static_cast<const float*>(start);
  float* out = static_cast<float*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: launch_eigvec<1>(a, s0, out, batch, iterations, st); break;
    case 2: launch_eigvec<2>(a, s0, out, batch, iterations, st); break;
    case 3: launch_eigvec<3>(a, s0, out, batch, iterations, st); break;
    case 4: launch_eigvec<4>(a, s0, out, batch, iterations, st); break;
    case 5: launch_eigvec<5>(a, s0, out, batch, iterations, st); break;
    case 6: launch_eigvec<6>(a, s0, out, batch, iterations, st); break;
    case 7: launch_eigvec<7>(a, s0, out, batch, iterations, st); break;
    case 8: launch_eigvec<8>(a, s0, out, batch, iterations, st); break;
    default: launch_eigvec<9>(a, s0, out, batch, iterations, st); break;
  }
  return (int)cudaGetLastError();
}
