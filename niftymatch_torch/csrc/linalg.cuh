// The small-matrix solvers' device code, which linalg.cu (one launch a
// batch of matrices) and ransac.cu (inside every RANSAC fit) share: the
// 3 x 3 SVD by cyclic Jacobi on E^T E and the smallest eigenvector by
// inverse iteration on a jittered Cholesky factor.  linalg.cu's note says
// what each computes and why one thread holds a whole matrix in registers.

#pragma once

#include <cuda_runtime.h>

namespace {

// Rotation (p, q) of a 3 x 3 Jacobi sweep: A <- J^T A J, V <- V J, with J
// the identity but for J[p][p] = J[q][q] = c, J[p][q] = s, J[q][p] = -s.
template <int p, int q>
__device__ __forceinline__ void rotate(float A[3][3], float V[3][3]) {
  const float theta = 0.5f * atan2f(2.0f * A[p][q], A[q][q] - A[p][p]);
  const float c = cosf(theta), s = sinf(theta);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float ap = A[r][p], aq = A[r][q];
    A[r][p] = c * ap - s * aq;
    A[r][q] = s * ap + c * aq;
    const float vp = V[r][p], vq = V[r][q];
    V[r][p] = c * vp - s * vq;
    V[r][q] = s * vp + c * vq;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float rp = A[p][k], rq = A[q][k];
    A[p][k] = c * rp - s * rq;
    A[q][k] = s * rp + c * rq;
  }
}

// Compare-swap of eigenpairs a and b (w and V's columns): b goes first
// when it is strictly larger.
template <int a, int b>
__device__ __forceinline__ void cswap_desc(float w[3], float V[3][3]) {
  if (w[b] > w[a]) {
    const float t = w[a];
    w[a] = w[b];
    w[b] = t;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float u = V[r][a];
      V[r][a] = V[r][b];
      V[r][b] = u;
    }
  }
}

// max(x, lo) that keeps a NaN, as torch.clamp does (fmaxf drops it).
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void unit3(float v[3]) {
  const float n = clamp_min(sqrtf(dot3(v, v)), 1e-20f);
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = v[k] / n;
}

// SVD of one row-major 3 x 3 E read from e: S descending, U's columns u1,
// u2, u3 and V (Vt = V^T), after `sweeps` Jacobi sweeps of E^T E.
__device__ __forceinline__ void svd3x3(const float* e, int sweeps, float S[3],
                                       float u1[3], float u2[3], float u3[3],
                                       float V[3][3]) {
  float E[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) E[r][c] = e[3 * r + c];

  float A[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      A[r][c] = E[0][r] * E[0][c] + E[1][r] * E[1][c] + E[2][r] * E[2][c];
      V[r][c] = r == c ? 1.0f : 0.0f;
    }
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = r + 1; c < 3; ++c) A[r][c] = A[c][r] = 0.5f * (A[r][c] + A[c][r]);

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    rotate<0, 1>(A, V);
    rotate<0, 2>(A, V);
    rotate<1, 2>(A, V);
  }

  float w[3] = {A[0][0], A[1][1], A[2][2]};
  cswap_desc<0, 1>(w, V);
  cswap_desc<0, 2>(w, V);
  cswap_desc<1, 2>(w, V);

  float col[3][3];  // col[k] = E v_k / max(s_k, 1e-12)
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    S[k] = sqrtf(clamp_min(w[k], 0.0f));
    const float d = clamp_min(S[k], 1e-12f);
#pragma unroll
    for (int r = 0; r < 3; ++r)
      col[k][r] = (E[r][0] * V[0][k] + E[r][1] * V[1][k] + E[r][2] * V[2][k]) / d;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) u1[r] = col[0][r];
  unit3(u1);
  const float proj = dot3(u1, col[1]);
#pragma unroll
  for (int r = 0; r < 3; ++r) u2[r] = col[1][r] - proj * u1[r];
  unit3(u2);
  u3[0] = u1[1] * u2[2] - u1[2] * u2[1];
  u3[1] = u1[2] * u2[0] - u1[0] * u2[2];
  u3[2] = u1[0] * u2[1] - u1[1] * u2[0];
  if (dot3(u3, col[2]) < 0.0f) {
#pragma unroll
    for (int r = 0; r < 3; ++r) u3[r] = -u3[r];
  }
}

// Unit eigenvector x of the smallest eigenvalue of the symmetric N x N
// row-major a (N <= 9): a + (1e-6 tr(a)/N + 1e-30) I factored by an
// unpivoted Cholesky with its pivots floored at 1e-30, then `iterations`
// rounds of inverse iteration from `start`.  Reads a's diagonal and lower
// triangle only.
template <int N>
__device__ __forceinline__ void smallest_eigvec(const float* a, const float* start,
                                                int iterations, float x[N]) {
  float tr = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) tr += a[N * j + j];
  const float eps = 1e-6f * (tr / (float)N) + 1e-30f;

  // The lower factor, a column at a time: L[k][j] for k >= j.
  float L[N][N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = a[N * j + j] + eps;
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    const float d = sqrtf(clamp_min(s, 1e-30f));
    L[j][j] = d;
#pragma unroll
    for (int r = j + 1; r < N; ++r) {
      float t = a[N * r + j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[r][k] * L[j][k];
      L[r][j] = t / d;
    }
  }

#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = start[k];
  for (int it = 0; it < iterations; ++it) {
    float y[N];
#pragma unroll
    for (int r = 0; r < N; ++r) {  // L y = x
      float s = x[r];
#pragma unroll
      for (int k = 0; k < r; ++k) s -= L[r][k] * y[k];
      y[r] = s / L[r][r];
    }
#pragma unroll
    for (int r = N - 1; r >= 0; --r) {  // L^T x = y
      float s = y[r];
#pragma unroll
      for (int k = r + 1; k < N; ++k) s -= L[k][r] * x[k];
      x[r] = s / L[r][r];
    }
    float nn = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) nn += x[k] * x[k];
    const float inv = 1.0f / clamp_min(sqrtf(nn), 1e-30f);
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] *= inv;
  }
}

}  // namespace
