// The two-view Gauss-Newton polish in one kernel, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package runs the polish
// (niftymatch_tpu/sfm/two_view_refine.py) as XLA-fused code under jit; the
// port's plain version (niftymatch_torch/sfm/two_view_refine.py, which CPU
// tensors take) builds each step's Jacobian with torch.func.jacfwd, some
// 590 launches a step and ~5,900 a polish, each a few microseconds of host
// time for a few hundred nanoseconds of device work.  Here the whole polish
// is one launch: the SLAM loop calls it once a frame.
//
// What it computes, as the plain version does: from (R0, t0) and N
// weighted correspondences, `iterations` damped Gauss-Newton steps on the
// 5-DoF relative pose (3 rotation tangents, 2 tangents of t's sphere)
// minimising sum_i w_i r_i^2, r_i the Sampson residual of E = hat(t) R.
// A step solves (J^T J + (lambda + 1e-9) I) d = -J^T r (J and r weighted
// by sqrt(max(w, 0))) by an unpivoted Cholesky factor with a 1e-20 pivot
// floor, retracts R by so3_exp and t along _tangent_basis(t), and is
// accepted when the cost falls; lambda is halved on an accept, multiplied
// by 10 on a reject and clamped to [1e-10, 1e4].  Outputs R, t and the
// final cost.  The Jacobian is analytic: at the current pose
//   dE/d(rotation tangent k) = hat(t/|t|) hat(e_k) R,
//   dE/d(translation tangent j) = hat((b_j - t (t.b_j)/|t|^2) / |t|) R,
// (b1, b2) the tangent basis, and each correspondence's gradient of
// r over E's nine entries, contracted with those five matrices, gives its
// row of J.  The gradient through the 1e-12 clamp of the Sampson
// denominator is zero where the clamp binds, as in the plain version.
//
// What bounds it on this card: latency.  At the SLAM's N = 1,024 the work
// is ~2 MFLOP over 20 KB of inputs (30 ns of arithmetic, 6 ns of bytes),
// but each step is a chain of dependent phases: the five derivative
// matrices, a block-wide sum of 20 numbers, a 5 x 5 solve and retraction on
// one thread, a block-wide sum of the new cost, the accept.  So the design
// cuts phases and barriers, not bytes:
// * One CTA runs the whole polish; the inputs are staged once into shared
//   memory (up to STAGE_MAX correspondences; beyond that they are read from
//   device memory through L1 in every pass).
// * Each thread takes correspondences tid, tid + T, ... and keeps its 15
//   entries of J^T J's upper triangle and 5 of J^T r in registers.
// * Block sums in a fixed order: a shuffle tree in each warp, then warp 0
//   sums the warps' partials with a second shuffle tree.  No atomics, so a
//   rerun gives the same bits.
// * Thread 0 keeps the pose, the cost and lambda in registers and does the
//   serial work (the derivative matrices, the solve, the retraction, the
//   accept); four barriers a step.
//
// Numerics: fp32 throughout, nvcc may contract multiplies and adds (the
// polish is a continuous function of its inputs); the sums run in another
// order than the plain version's.  so3_exp takes the Taylor branch of
// _exp_coeffs below theta = 0.1, as the plain version does.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int MAX_WARPS = 32;
constexpr int NSUM = 20;          // 15 of J^T J's upper triangle + 5 of J^T r
constexpr int STAGE_MAX = 2048;   // correspondences staged: 5 floats each, 40 KB
constexpr float SMALL2 = 0.01f;   // so3_exp's branch on theta^2 (_SMALL^2)

// out = hat(v) M for row-major 3 x 3 M.
__device__ __forceinline__ void hat_mul(const float v[3], const float M[9],
                                        float out[9]) {
  for (int c = 0; c < 3; ++c) {
    out[c] = -v[2] * M[3 + c] + v[1] * M[6 + c];
    out[3 + c] = v[2] * M[c] - v[0] * M[6 + c];
    out[6 + c] = -v[1] * M[c] + v[0] * M[3 + c];
  }
}

__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float norm3(const float v[3]) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

// _tangent_basis: two unit vectors orthogonal to t.
__device__ void tangent_basis(const float t[3], float b1[3], float b2[3]) {
  const float ref[3] = {fabsf(t[0]) < 0.9f ? 1.f : 0.f,
                        fabsf(t[0]) < 0.9f ? 0.f : 1.f, 0.f};
  cross(t, ref, b1);
  float n = fmaxf(norm3(b1), 1e-12f);
  for (int k = 0; k < 3; ++k) b1[k] /= n;
  cross(t, b1, b2);
  n = fmaxf(norm3(b2), 1e-12f);
  for (int k = 0; k < 3; ++k) b2[k] /= n;
}

// Rn = so3_exp(phi) R.
__device__ void exp_mul(const float phi[3], const float R[9], float Rn[9]) {
  const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  float A, B;
  if (th2 < SMALL2) {
    A = 1.f - th2 / 6.f + th2 * th2 / 120.f;
    B = 0.5f - th2 / 24.f + th2 * th2 / 720.f;
  } else {
    const float th = sqrtf(th2);
    A = sinf(th) / th;
    B = (1.f - cosf(th)) / th2;
  }
  const float K[9] = {0.f, -phi[2], phi[1], phi[2], 0.f, -phi[0],
                      -phi[1], phi[0], 0.f};
  float X[9];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      const float k2 = K[3 * r] * K[c] + K[3 * r + 1] * K[3 + c] +
                       K[3 * r + 2] * K[6 + c];
      X[3 * r + c] = (r == c ? 1.f : 0.f) + A * K[3 * r + c] + B * k2;
    }
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      Rn[3 * r + c] = X[3 * r] * R[c] + X[3 * r + 1] * R[3 + c] +
                      X[3 * r + 2] * R[6 + c];
}

struct Sampson {
  float l0, l1, lp0, lp1, num, den;
  bool live;  // the denominator's clamp does not bind
};

__device__ __forceinline__ Sampson sampson(const float* E, float x, float y,
                                           float u, float v) {
  Sampson s;
  s.l0 = E[0] * x + E[1] * y + E[2];
  s.l1 = E[3] * x + E[4] * y + E[5];
  const float l2 = E[6] * x + E[7] * y + E[8];
  s.lp0 = E[0] * u + E[3] * v + E[6];
  s.lp1 = E[1] * u + E[4] * v + E[7];
  s.num = u * s.l0 + v * s.l1 + l2;
  const float q = s.l0 * s.l0 + s.l1 * s.l1 + s.lp0 * s.lp0 + s.lp1 * s.lp1;
  s.live = q >= 1e-12f;
  s.den = sqrtf(fmaxf(q, 1e-12f));
  return s;
}

// Sums each thread's K values over the block in a fixed order; thread 0
// returns with the totals in v.  Begins with no barrier: the caller's
// previous barrier separates it from the last reader of `part`.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
  if (lane == 0)
    for (int k = 0; k < K; ++k) part[warp * K + k] = v[k];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = lane < warps ? part[lane * K + k] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
    }
  }
}

__global__ void __launch_bounds__(THREADS) refine_kernel(
    const float* __restrict__ R0, const float* __restrict__ t0,
    const float* __restrict__ pts_a, const float* __restrict__ pts_b,
    const float* __restrict__ weights, int n, int iterations, float damping,
    float* __restrict__ R_out, float* __restrict__ t_out,
    float* __restrict__ cost_out) {
  __shared__ float stage[5 * STAGE_MAX];
  __shared__ float part[MAX_WARPS * NSUM];
  __shared__ float sE[9];       // E at the pose, t normalised
  __shared__ float sD[5][9];    // dE / d(tangent k) there
  __shared__ float sEn[9];      // E at the candidate pose
  const int tid = threadIdx.x, T = blockDim.x;

  const float* pa = pts_a;
  const float* pb = pts_b;
  const float* pw = weights;
  if (n <= STAGE_MAX) {
    for (int i = tid; i < 2 * n; i += T) {
      stage[i] = pts_a[i];
      stage[2 * n + i] = pts_b[i];
    }
    for (int i = tid; i < n; i += T) stage[4 * n + i] = weights[i];
    pa = stage;
    pb = stage + 2 * n;
    pw = stage + 4 * n;
  }

  // Thread 0's state: the pose, its cost, the damping.
  float R[9], t[3], cost = 0.f, lam = damping;
  if (tid == 0) {
    for (int k = 0; k < 9; ++k) R[k] = R0[k];
    for (int k = 0; k < 3; ++k) t[k] = t0[k];
    hat_mul(t, R, sEn);
  }
  __syncthreads();

  // sum_i w_i r_i^2 at sEn, on thread 0.
  auto cost_at_En = [&]() {
    float c[1] = {0.f};
    for (int i = tid; i < n; i += T) {
      const Sampson s = sampson(sEn, pa[2 * i], pa[2 * i + 1], pb[2 * i], pb[2 * i + 1]);
      const float r = s.num / s.den;
      c[0] += pw[i] * r * r;
    }
    block_sum<1>(c, part);
    return c[0];
  };
  {
    const float c = cost_at_En();
    if (tid == 0) cost = c;
  }

  for (int it = 0; it < iterations; ++it) {
    float b1[3], b2[3], Rn[9], tn[3];  // thread 0's basis and candidate
    if (tid == 0) {
      const float tnorm = fmaxf(norm3(t), 1e-12f);
      const float tu[3] = {t[0] / tnorm, t[1] / tnorm, t[2] / tnorm};
      hat_mul(tu, R, sE);
      for (int k = 0; k < 3; ++k) {   // hat(tu) hat(e_k) R
        const float e[3] = {k == 0 ? 1.f : 0.f, k == 1 ? 1.f : 0.f,
                            k == 2 ? 1.f : 0.f};
        float M[9];
        hat_mul(e, R, M);
        hat_mul(tu, M, sD[k]);
      }
      tangent_basis(t, b1, b2);
      const float tnorm2 = tnorm * tnorm;
      const float* bs[2] = {b1, b2};
      for (int j = 0; j < 2; ++j) {
        const float tb = (t[0] * bs[j][0] + t[1] * bs[j][1] + t[2] * bs[j][2]) / tnorm2;
        const float d[3] = {(bs[j][0] - t[0] * tb) / tnorm, (bs[j][1] - t[1] * tb) / tnorm,
                            (bs[j][2] - t[2] * tb) / tnorm};
        hat_mul(d, R, sD[3 + j]);
      }
    }
    __syncthreads();

    // Each thread's rows of J (5) and r: J^T J and J^T r.
    float acc[NSUM];
#pragma unroll
    for (int k = 0; k < NSUM; ++k) acc[k] = 0.f;
    for (int i = tid; i < n; i += T) {
      const float x = pa[2 * i], y = pa[2 * i + 1], u = pb[2 * i], v = pb[2 * i + 1];
      const float sw = sqrtf(fmaxf(pw[i], 0.f));
      const Sampson s = sampson(sE, x, y, u, v);
      const float r = sw * (s.num / s.den);
      // dr/dE_ij = c ((b_i - q l_i) a_j - q b_i lp_j), a = (x, y, 1),
      // b = (u, v, 1), l = (l0, l1, 0), lp = (lp0, lp1, 0).
      const float c = sw / s.den;
      const float q = s.live ? s.num / (s.den * s.den) : 0.f;
      const float a[3] = {x, y, 1.f}, b[3] = {u, v, 1.f};
      const float bl[3] = {u - q * s.l0, v - q * s.l1, 1.f};
      const float lp[3] = {q * s.lp0, q * s.lp1, 0.f};
      float G[9];
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int m = 0; m < 3; ++m) G[3 * p + m] = c * (bl[p] * a[m] - b[p] * lp[m]);
      float J[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        float s_k = 0.f;
#pragma unroll
        for (int e = 0; e < 9; ++e) s_k += G[e] * sD[k][e];
        J[k] = s_k;
      }
      int idx = 0;
#pragma unroll
      for (int p = 0; p < 5; ++p)
#pragma unroll
        for (int m = p; m < 5; ++m) acc[idx++] += J[p] * J[m];
#pragma unroll
      for (int p = 0; p < 5; ++p) acc[15 + p] += J[p] * r;
    }
    block_sum<NSUM>(acc, part);

    if (tid == 0) {
      // H = J^T J + (lambda + 1e-9) I; its lower Cholesky factor, a column
      // at a time, pivots clamped to 1e-20; then L y = g, L^T x = y.
      float H[5][5];
      int idx = 0;
      for (int p = 0; p < 5; ++p)
        for (int m = p; m < 5; ++m) H[p][m] = H[m][p] = acc[idx++];
      const float diag = lam + 1e-9f;
      for (int p = 0; p < 5; ++p) H[p][p] += diag;
      float L[5][5] = {};
      for (int j = 0; j < 5; ++j) {
        float s[5];
        for (int i = j; i < 5; ++i) {
          float dot = 0.f;
          for (int k = 0; k < j; ++k) dot += L[i][k] * L[j][k];
          s[i] = H[i][j] - dot;
        }
        const float d = sqrtf(fmaxf(s[j], 1e-20f));
        L[j][j] = d;
        for (int i = j + 1; i < 5; ++i) L[i][j] = s[i] / d;
      }
      float y[5], step[5];
      for (int i = 0; i < 5; ++i) {
        float s = acc[15 + i];
        for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
        y[i] = s / L[i][i];
      }
      for (int i = 4; i >= 0; --i) {
        float s = y[i];
        for (int k = i + 1; k < 5; ++k) s -= L[k][i] * step[k];
        step[i] = s / L[i][i];
      }
      for (int i = 0; i < 5; ++i) step[i] = -step[i];
      exp_mul(step, R, Rn);
      for (int k = 0; k < 3; ++k) tn[k] = t[k] + b1[k] * step[3] + b2[k] * step[4];
      const float nn = fmaxf(norm3(tn), 1e-12f);
      for (int k = 0; k < 3; ++k) tn[k] /= nn;
      hat_mul(tn, Rn, sEn);
    }
    __syncthreads();
    const float new_cost = cost_at_En();
    if (tid == 0) {
      if (new_cost < cost) {
        for (int k = 0; k < 9; ++k) R[k] = Rn[k];
        for (int k = 0; k < 3; ++k) t[k] = tn[k];
        cost = new_cost;
        lam *= 0.5f;
      } else {
        lam *= 10.f;
      }
      lam = fminf(fmaxf(lam, 1e-10f), 1e4f);
    }
  }

  if (tid == 0) {
    for (int k = 0; k < 9; ++k) R_out[k] = R[k];
    for (int k = 0; k < 3; ++k) t_out[k] = t[k];
    *cost_out = cost;
  }
}

}  // namespace

extern "C" int nm_refine_relative_pose(const void* R0, const void* t0,
                                       const void* pts_a, const void* pts_b,
                                       const void* weights, int n,
                                       int iterations, float damping, void* R,
                                       void* t, void* cost, void* stream) {
  if (n < 0 || iterations < 0) return (int)cudaErrorInvalidValue;
  refine_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R0), static_cast<const float*>(t0),
      static_cast<const float*>(pts_a), static_cast<const float*>(pts_b),
      static_cast<const float*>(weights), n, iterations, damping,
      static_cast<float*>(R), static_cast<float*>(t), static_cast<float*>(cost));
  return (int)cudaGetLastError();
}
