// RANSAC for the essential matrix and the homography in two launches, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's geometry/ransac.py draws,
// fits and scores every hypothesis as one XLA program under jit.  The
// port's plain version (ransac_plain in niftymatch_torch/geometry/
// ransac.py, which CPU tensors take) runs it eagerly: k rounds of a masked
// argmax over the (I, N) draw to pick the samples, two Hartley
// normalisations and a normal matrix over dense (I, N) weight rows that
// are 0 but at the k samples, the small-matrix solvers and some 60 eager
// operations around them, the errors, the winner, then the whole fitter
// again for the refit: ~370 launches a call, each a few microseconds of
// host time for well under a microsecond of device work.  The SLAM frame
// runs two RANSACs.  Here each is two launches.
//
// What it computes, as ransac_plain does for "essential" (k = 8, the
// Sampson error, the winner by inlier count) and "homography" (k = 4, the
// transfer error, the winner by the MSAC loss sum min(err, tau)):
// * nm_ransac_hypotheses, one warp a hypothesis.  The sample: the k
//   largest masked scores of the hypothesis's row of the draw, the largest
//   first and the lowest column among exact ties; a valid score of -inf is
//   never taken, and a row with a NaN among its valid scores takes none
//   (its amax is NaN).  A row with fewer than k takes what it has and is
//   not live.  Only comparisons touch the draw, so the samples are the
//   plain version's, bit for bit.  The fit from those points, weight 1
//   each: the weighted Hartley normalisation of both point sets (centroid
//   0, mean norm sqrt(2)); the 9 x 9 normal matrix of the 8-point rows
//   (E) or of the two DLT rows a point (H); its smallest eigenvector
//   (smallest_eigvec, 8 iterations).  E: svd3x3 (12 sweeps), the rank-2
//   projection, Td^T Fn Ts, unit Frobenius norm, svd3x3 again, the
//   (s, s, 0) projection with s the mean of the first two singular values,
//   unit Frobenius norm.  H: Td^-1 Hn Ts by the adjugate (zeros where
//   |det Td| <= 1e-20), divided by H[2][2] unless |H[2][2]| <= 1e-12.  The
//   score over the N points: E the count of masked err < tau, times live;
//   H the sum of min(err, tau) over the mask, +inf unless live.
// * nm_ransac_refit, one block.  The winner: E the first index of the
//   largest count, H the first index of the smallest score, a NaN counting
//   as the smallest (torch.argmax / argmin), so an all-dead batch picks 0.
//   Its inliers (masked err < tau); with refit and at least k of them, the
//   same fit over all N points weighted by those flags; its errors; the
//   refit kept when E's count does not fall or H's MSAC score does not
//   rise.  Writes the transform, the inlier flags, their count and
//   success (at least k valid points and k inliers).
//
// What bounds it on this card: latency.  At the SLAM's I = 512, N = 1,024
// the work is ~5 kFLOP a fit, 2 MB of draw read once and 524,288 error
// evaluations a model: about a microsecond of bytes or arithmetic.  What
// takes the time is one fit's dependent chain (two 3 x 3 SVDs of 12 Jacobi
// sweeps and a 9 x 9 inverse iteration for E).  So:
// * The first launch gives each hypothesis a warp: the lanes split the
//   row's scores (each keeps its best k in registers, then k rounds of a
//   warp argmax take the heads) and later its N points; the fit runs on
//   every lane of the warp at once, all lanes on the same samples, in
//   registers, with no shared memory and no barrier.
// * The second launch is one block: the winner, the Hartley sums, the
//   normal matrix and the scores are block sums, and every thread runs
//   the refit's solve on the block's sums.
// * Every sum is in a fixed order (each lane or thread its own points in
//   ascending order, then a shuffle tree, then the warps' partials one
//   after another); no atomics, so a rerun gives the same bits.
// * The solvers' device code is linalg.cu's (linalg.cuh).
//
// Numerics: fp32 throughout, precise atan2f, sinf, cosf, sqrtf and IEEE
// division (no --use_fast_math): the port runs fp32 with TF32 off.  nvcc
// may contract multiplies and adds in the fits, whose sums run over the
// samples only and in another order than the plain version's, so models
// agree with it to rounding.  The errors are written with __fmul_rn and
// __fadd_rn in the plain version's order of operations, so a model gives
// the plain version's inlier flags and both launches score a model alike.
// The fits read their samples only: a coordinate that is not finite
// poisons every plain fit (0 x inf), but only the hypotheses that sample it
// here.

#include <cuda_runtime.h>
#include <math.h>

#include "linalg.cuh"

namespace {

constexpr int ESSENTIAL = 0, HOMOGRAPHY = 1;   // kernels/ransac.py's MODELS
constexpr int WARPS = 4;                       // hypotheses a block, first launch
constexpr int REFIT_THREADS = 256;
constexpr int REFIT_WARPS = REFIT_THREADS / 32;
constexpr int NM = 45;                         // the normal matrix's lower triangle
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_COL = 0x7fffffff;
constexpr float SQRT2 = 1.41421356237309515f;  // float32(math.sqrt(2.0))

template <int MODEL>
__host__ __device__ constexpr int min_samples() { return MODEL == ESSENTIAL ? 8 : 4; }

__device__ __forceinline__ int tri(int a, int b) { return a * (a + 1) / 2 + b; }  // b <= a

// --- the errors, in the plain version's order of operations ---------------

__device__ __forceinline__ float affine(float a, float x, float b, float y, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// transforms.transfer_sq_error: ||H(src) - dst||^2, the projective
// denominator kept at +-1e-12.
__device__ __forceinline__ float transfer_error(const float H[9], float x, float y,
                                                float u, float v) {
  const float xp = affine(H[0], x, H[1], y, H[2]);
  const float yp = affine(H[3], x, H[4], y, H[5]);
  float w = affine(H[6], x, H[7], y, H[8]);
  const float tiny = w < 0.0f ? -1e-12f : 1e-12f;
  w = fabsf(w) > 1e-12f ? w : tiny;
  const float dx = __fsub_rn(__fdiv_rn(xp, w), u), dy = __fsub_rn(__fdiv_rn(yp, w), v);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// transforms.sampson_sq_error: the first-order epipolar error of
// dst^T F src = 0.
__device__ __forceinline__ float sampson_error(const float F[9], float x, float y,
                                               float u, float v) {
  const float l0 = affine(F[0], x, F[1], y, F[2]);
  const float l1 = affine(F[3], x, F[4], y, F[5]);
  const float l2 = affine(F[6], x, F[7], y, F[8]);
  const float lp0 = affine(F[0], u, F[3], v, F[6]);
  const float lp1 = affine(F[1], u, F[4], v, F[7]);
  const float num = affine(u, l0, v, l1, l2);
  const float den = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(l0, l0), __fmul_rn(l1, l1)),
                                        __fmul_rn(lp0, lp0)), __fmul_rn(lp1, lp1));
  return __fdiv_rn(__fmul_rn(num, num), clamp_min(den, 1e-12f));
}

template <int MODEL>
__device__ __forceinline__ float point_error(const float M[9], const float* src,
                                             const float* dst, int i) {
  const float x = src[2 * i], y = src[2 * i + 1], u = dst[2 * i], v = dst[2 * i + 1];
  return MODEL == ESSENTIAL ? sampson_error(M, x, y, u, v)
                            : transfer_error(M, x, y, u, v);
}

// min(err, tau) that keeps a NaN, as torch.clamp(max=) does.
__device__ __forceinline__ float msac_term(float e, float tau) { return e > tau ? tau : e; }

// --- the fit ---------------------------------------------------------------

// The similarity T = [[s, 0, -s mx], [0, s, -s my], [0, 0, 1]] that takes
// weighted points to centroid 0 and mean norm sqrt(2).
struct Hartley {
  float mx, my, s;
};

__device__ __forceinline__ float mean_of(float sum, float wsum) { return sum / wsum; }

__device__ __forceinline__ float hartley_scale(float dist_sum, float wsum) {
  return SQRT2 / clamp_min(dist_sum / wsum, 1e-12f);
}

__device__ __forceinline__ void hartley_matrix(const Hartley& h, float T[3][3]) {
  T[0][0] = h.s;  T[0][1] = 0.0f; T[0][2] = -h.s * h.mx;
  T[1][0] = 0.0f; T[1][1] = h.s;  T[1][2] = -h.s * h.my;
  T[2][0] = 0.0f; T[2][1] = 0.0f; T[2][2] = 1.0f;
}

// Adds w times one correspondence's rows r r^T (normalised src (x, y), dst
// (u, v)) to the normal matrix's lower triangle.
template <int MODEL>
__device__ __forceinline__ void add_rows(float acc[NM], float x, float y, float u,
                                         float v, float w) {
  if (MODEL == ESSENTIAL) {
    const float r[9] = {u * x, u * y, u, v * x, v * y, v, x, y, 1.0f};
#pragma unroll
    for (int a = 0; a < 9; ++a)
#pragma unroll
      for (int b = 0; b <= a; ++b) acc[tri(a, b)] += (w * r[a]) * r[b];
  } else {
    const float r1[9] = {0.0f, 0.0f, 0.0f, -x, -y, -1.0f, v * x, v * y, v};
    const float r2[9] = {x, y, 1.0f, 0.0f, 0.0f, 0.0f, -u * x, -u * y, -u};
#pragma unroll
    for (int a = 0; a < 9; ++a)
#pragma unroll
      for (int b = 0; b <= a; ++b)
        acc[tri(a, b)] += (w * r1[a]) * r1[b] + (w * r2[a]) * r2[b];
  }
}

__device__ __forceinline__ void matmul3(const float A[3][3], const float B[3][3],
                                        float C[3][3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      C[r][c] = A[r][0] * B[0][c] + A[r][1] * B[1][c] + A[r][2] * B[2][c];
}

__device__ __forceinline__ void unit_frobenius(float F[3][3]) {
  float ss = 0.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) ss += F[r][c] * F[r][c];
  const float n = clamp_min(sqrtf(ss), 1e-20f);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) F[r][c] = F[r][c] / n;
}

// U diag(s0, s1, 0) V^T from svd3x3's factors.
__device__ __forceinline__ void rank2(const float u1[3], const float u2[3],
                                      const float u3[3], const float V[3][3], float s0,
                                      float s1, float out[3][3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[r][c] = (u1[r] * s0) * V[c][0] + (u2[r] * s1) * V[c][1] + (u3[r] * 0.0f) * V[c][2];
}

// The model from the normal matrix's lower triangle and the two
// normalisations: fit_essential or fit_homography after their sums.
template <int MODEL>
__device__ __forceinline__ void solve_model(const float acc[NM], const Hartley& hs,
                                            const Hartley& hd, const float* start,
                                            int sweeps, int iterations, float model[9]) {
  float M[81];
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int b = 0; b <= a; ++b) M[9 * a + b] = M[9 * b + a] = acc[tri(a, b)];
  float e[9];
  smallest_eigvec<9>(M, start, iterations, e);
  float Ts[3][3], Td[3][3], N[3][3], out[3][3];
  hartley_matrix(hs, Ts);
  hartley_matrix(hd, Td);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) N[r][c] = e[3 * r + c];
  if (MODEL == ESSENTIAL) {
    float S[3], u1[3], u2[3], u3[3], V[3][3], F[3][3], TdT[3][3], G[3][3];
    svd3x3(e, sweeps, S, u1, u2, u3, V);
    rank2(u1, u2, u3, V, S[0], S[1], F);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) TdT[r][c] = Td[c][r];
    matmul3(TdT, F, G);
    matmul3(G, Ts, F);
    unit_frobenius(F);
    svd3x3(&F[0][0], sweeps, S, u1, u2, u3, V);
    const float s = 0.5f * (S[0] + S[1]);
    rank2(u1, u2, u3, V, s, s, out);
    unit_frobenius(out);
  } else {
    float B[3][3];
    matmul3(N, Ts, B);
    // geometry.linalg._solve3x3_cols(Td, B): the adjugate, then the
    // determinant; zeros where |det| <= 1e-20.
    const float(&a)[3][3] = Td;
    const float c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
    const float c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2];
    const float c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
    const float det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02;
    const float c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2];
    const float c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0];
    const float c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1];
    const float c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1];
    const float c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2];
    const float c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0];
    const float adj[3][3] = {{c00, c10, c20}, {c01, c11, c21}, {c02, c12, c22}};
    const bool ok = fabsf(det) > 1e-20f;
    const float safe = ok ? det : 1.0f;
    matmul3(adj, B, out);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) out[r][c] = ok ? out[r][c] / safe : 0.0f;
    const float h22 = out[2][2];
    const float div = fabsf(h22) > 1e-12f ? h22 : 1.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) out[r][c] = out[r][c] / div;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) model[3 * r + c] = out[r][c];
}

// --- the first launch: the hypotheses --------------------------------------

// The k columns of one row's sample, ascending in cols[0, found); the other
// slots hold NO_COL.  Every lane returns the same.
template <int K>
__device__ __forceinline__ int draw_sample(const float* __restrict__ row,
                                           const unsigned char* __restrict__ mask, int n,
                                           int lane, int cols[K]) {
  float s[K];  // this lane's best k, largest first, lowest column first among ties
  int c[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    s[j] = -INFINITY;
    c[j] = NO_COL;
  }
  bool nan = false;
  for (int i = lane; i < n; i += 32) {
    if (!mask[i]) continue;
    const float v = row[i];
    nan |= v != v;
    if (v > s[K - 1]) {
      s[K - 1] = v;
      c[K - 1] = i;
#pragma unroll
      for (int j = K - 1; j > 0; --j)
        if (s[j] > s[j - 1]) {
          const float ts = s[j];
          s[j] = s[j - 1];
          s[j - 1] = ts;
          const int tc = c[j];
          c[j] = c[j - 1];
          c[j - 1] = tc;
        }
    }
  }
  const bool any_nan = __any_sync(FULL, nan);
  int found = 0;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    float bs = s[0];
    int bc = c[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(FULL, bs, o);
      const int oc = __shfl_xor_sync(FULL, bc, o);
      if (os > bs || (os == bs && oc < bc)) {
        bs = os;
        bc = oc;
      }
    }
    const bool take = bs > -INFINITY && !any_nan;
    cols[r] = take ? bc : NO_COL;
    found += take;
    if (c[0] == bc) {  // the lane that owns the column pops its head
#pragma unroll
      for (int j = 0; j < K - 1; ++j) {
        s[j] = s[j + 1];
        c[j] = c[j + 1];
      }
      s[K - 1] = -INFINITY;
      c[K - 1] = NO_COL;
    }
  }
  // Ascending columns (NO_COL last), so a sample set gives one model
  // whatever order its scores ranked it in.
#pragma unroll
  for (int i = 0; i < K - 1; ++i)
#pragma unroll
    for (int j = 0; j < K - 1 - i; ++j)
      if (cols[j] > cols[j + 1]) {
        const int t = cols[j];
        cols[j] = cols[j + 1];
        cols[j + 1] = t;
      }
  return found;
}

// The model from the sample's points, weight 1 each and 0 in the slots
// past `found`.
template <int MODEL>
__device__ __forceinline__ void fit_sample(const float* __restrict__ src,
                                           const float* __restrict__ dst, const int* cols,
                                           const float* start, int sweeps, int iterations,
                                           float model[9]) {
  constexpr int K = min_samples<MODEL>();
  float p[4][K], w[K];  // src x, src y, dst x, dst y
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool ok = cols[j] != NO_COL;
    const int i = ok ? cols[j] : 0;
    w[j] = ok ? 1.0f : 0.0f;
    p[0][j] = ok ? src[2 * i] : 0.0f;
    p[1][j] = ok ? src[2 * i + 1] : 0.0f;
    p[2][j] = ok ? dst[2 * i] : 0.0f;
    p[3][j] = ok ? dst[2 * i + 1] : 0.0f;
  }
  float wsum = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j) wsum += w[j];
  wsum = clamp_min(wsum, 1e-12f);
  Hartley h[2];
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    float sx = 0.0f, sy = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      sx += p[2 * side][j] * w[j];
      sy += p[2 * side + 1][j] * w[j];
    }
    h[side].mx = mean_of(sx, wsum);
    h[side].my = mean_of(sy, wsum);
    float dist = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float dx = p[2 * side][j] - h[side].mx, dy = p[2 * side + 1][j] - h[side].my;
      dist += sqrtf(dx * dx + dy * dy) * w[j];
    }
    h[side].s = hartley_scale(dist, wsum);
  }
  float acc[NM];
#pragma unroll
  for (int t = 0; t < NM; ++t) acc[t] = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j)
    add_rows<MODEL>(acc, (p[0][j] - h[0].mx) * h[0].s, (p[1][j] - h[0].my) * h[0].s,
                    (p[2][j] - h[1].mx) * h[1].s, (p[3][j] - h[1].my) * h[1].s, w[j]);
  solve_model<MODEL>(acc, h[0], h[1], start, sweeps, iterations, model);
}

template <int MODEL>
__global__ void __launch_bounds__(WARPS * 32)
hypotheses_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                  const unsigned char* __restrict__ mask, const float* __restrict__ scores,
                  const float* __restrict__ start, float* __restrict__ models,
                  float* __restrict__ keys, int n, int iters, float tau, int sweeps,
                  int iterations) {
  constexpr int K = min_samples<MODEL>();
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (h >= iters) return;  // the whole warp
  int cols[K];
  const int found = draw_sample<K>(scores + (size_t)h * n, mask, n, lane, cols);
  float model[9];
  fit_sample<MODEL>(src, dst, cols, start, sweeps, iterations, model);

  int count = 0;
  float msac = 0.0f;
  for (int i = lane; i < n; i += 32) {
    if (!mask[i]) continue;
    const float e = point_error<MODEL>(model, src, dst, i);
    if (MODEL == ESSENTIAL)
      count += e < tau;
    else
      msac = __fadd_rn(msac, msac_term(e, tau));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    count += __shfl_xor_sync(FULL, count, o);
    msac = __fadd_rn(msac, __shfl_xor_sync(FULL, msac, o));
  }
  if (lane == 0) {
    const bool live = found >= K;
#pragma unroll
    for (int j = 0; j < 9; ++j) models[9 * h + j] = model[j];
    keys[h] = MODEL == ESSENTIAL ? (live ? (float)count : 0.0f) : (live ? msac : INFINITY);
  }
}

// --- the second launch: the winner and its refit ---------------------------

// Whether key a at index ia beats key b at ib: E the larger count, H the
// smaller score with a NaN smallest; the lower index among equals.
template <int MODEL>
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  if (MODEL == HOMOGRAPHY) {
    const bool na = a != a, nb = b != b;
    if (na || nb) return na && (!nb || ia < ib);
    return a < b || (a == b && ia < ib);
  }
  return a > b || (a == b && ia < ib);
}

// Sums each thread's J values over the block in a fixed order and returns
// the totals to every thread.  Opens and closes with a barrier, so `part`
// is free before and after.
template <int J, typename T>
__device__ __forceinline__ void block_sum(T (&v)[J], T* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[j] += __shfl_xor_sync(FULL, v[j], o);
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < J; ++j) part[warp * J + j] = v[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < J; ++j) {
    v[j] = part[j];
    for (int w = 1; w < REFIT_WARPS; ++w) v[j] += part[w * J + j];
  }
  __syncthreads();
}

// The count of masked err < tau under `model` and their MSAC sum; with
// `write`, the flags go to inliers.
template <int MODEL>
__device__ __forceinline__ void score_block(const float model[9], const float* src,
                                            const float* dst, const unsigned char* mask,
                                            int n, float tau, unsigned char* inliers,
                                            bool write, int* icount, float* fpart,
                                            int& count, float& msac) {
  int c[1] = {0};
  float m[1] = {0.0f};
  for (int i = threadIdx.x; i < n; i += REFIT_THREADS) {
    bool in = false;
    if (mask[i]) {
      const float e = point_error<MODEL>(model, src, dst, i);
      in = e < tau;
      m[0] = __fadd_rn(m[0], msac_term(e, tau));
    }
    c[0] += in;
    if (write) inliers[i] = in;
  }
  block_sum<1>(c, icount);
  block_sum<1>(m, fpart);
  count = c[0];
  msac = m[0];
}

template <int MODEL>
__global__ void __launch_bounds__(REFIT_THREADS)
refit_kernel(const float* __restrict__ src, const float* __restrict__ dst,
             const unsigned char* __restrict__ mask, const float* __restrict__ start,
             const float* __restrict__ models, const float* __restrict__ keys,
             float* __restrict__ transform, unsigned char* __restrict__ inliers,
             int* __restrict__ num_inliers, unsigned char* __restrict__ success, int n,
             int iters, float tau, int refit, int sweeps, int iterations) {
  constexpr int K = min_samples<MODEL>();
  __shared__ float fpart[REFIT_WARPS * NM];
  __shared__ int ipart[REFIT_WARPS];
  __shared__ float best_key[REFIT_WARPS];
  __shared__ int best_idx[REFIT_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // The winner.
  float bk = MODEL == ESSENTIAL ? -INFINITY : INFINITY;
  int bi = NO_COL;
  for (int h = threadIdx.x; h < iters; h += REFIT_THREADS)
    if (beats<MODEL>(keys[h], h, bk, bi)) {
      bk = keys[h];
      bi = h;
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ok = __shfl_xor_sync(FULL, bk, o);
    const int oi = __shfl_xor_sync(FULL, bi, o);
    if (beats<MODEL>(ok, oi, bk, bi)) {
      bk = ok;
      bi = oi;
    }
  }
  if (lane == 0) {
    best_key[warp] = bk;
    best_idx[warp] = bi;
  }
  __syncthreads();
  bk = best_key[0];
  bi = best_idx[0];
  for (int w = 1; w < REFIT_WARPS; ++w)
    if (beats<MODEL>(best_key[w], best_idx[w], bk, bi)) {
      bk = best_key[w];
      bi = best_idx[w];
    }
  float best[9], model[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) best[j] = model[j] = models[9 * bi + j];

  // Its inliers, and the valid points.
  int count;
  float unused;
  score_block<MODEL>(best, src, dst, mask, n, tau, inliers, true, ipart, fpart, count,
                     unused);
  int valid[1] = {0};
  for (int i = threadIdx.x; i < n; i += REFIT_THREADS) valid[0] += mask[i] != 0;
  block_sum<1>(valid, ipart);

  int num = count;
  if (refit && count >= K) {
    // The fit over all N points weighted by the winner's flags (each
    // thread reads back the flags it wrote).
    float sums[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // w, src x, src y, dst x, dst y
    for (int i = threadIdx.x; i < n; i += REFIT_THREADS) {
      const float w = inliers[i] ? 1.0f : 0.0f;
      sums[0] += w;
      sums[1] += src[2 * i] * w;
      sums[2] += src[2 * i + 1] * w;
      sums[3] += dst[2 * i] * w;
      sums[4] += dst[2 * i + 1] * w;
    }
    block_sum<5>(sums, fpart);
    const float wsum = clamp_min(sums[0], 1e-12f);
    Hartley hs, hd;
    hs.mx = mean_of(sums[1], wsum);
    hs.my = mean_of(sums[2], wsum);
    hd.mx = mean_of(sums[3], wsum);
    hd.my = mean_of(sums[4], wsum);
    float dist[2] = {0.0f, 0.0f};
    for (int i = threadIdx.x; i < n; i += REFIT_THREADS) {
      const float w = inliers[i] ? 1.0f : 0.0f;
      const float sx = src[2 * i] - hs.mx, sy = src[2 * i + 1] - hs.my;
      const float dx = dst[2 * i] - hd.mx, dy = dst[2 * i + 1] - hd.my;
      dist[0] += sqrtf(sx * sx + sy * sy) * w;
      dist[1] += sqrtf(dx * dx + dy * dy) * w;
    }
    block_sum<2>(dist, fpart);
    hs.s = hartley_scale(dist[0], wsum);
    hd.s = hartley_scale(dist[1], wsum);
    float acc[NM];
#pragma unroll
    for (int t = 0; t < NM; ++t) acc[t] = 0.0f;
    for (int i = threadIdx.x; i < n; i += REFIT_THREADS) {
      if (!inliers[i]) continue;
      add_rows<MODEL>(acc, (src[2 * i] - hs.mx) * hs.s, (src[2 * i + 1] - hs.my) * hs.s,
                      (dst[2 * i] - hd.mx) * hd.s, (dst[2 * i + 1] - hd.my) * hd.s, 1.0f);
    }
    block_sum<NM>(acc, fpart);
    solve_model<MODEL>(acc, hs, hd, start, sweeps, iterations, model);

    // The refit is kept unless it scores worse than the winner.
    int re_count;
    float re_msac;
    score_block<MODEL>(model, src, dst, mask, n, tau, inliers, false, ipart, fpart,
                       re_count, re_msac);
    const bool keep = MODEL == ESSENTIAL ? re_count >= count : re_msac <= bk;
    if (keep) {
      score_block<MODEL>(model, src, dst, mask, n, tau, inliers, true, ipart, fpart,
                         re_count, re_msac);
      num = re_count;
    } else {
#pragma unroll
      for (int j = 0; j < 9; ++j) model[j] = best[j];
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 9; ++j) transform[j] = model[j];
    *num_inliers = num;
    *success = valid[0] >= K && num >= K;
  }
}

template <int MODEL>
int launch_hypotheses(const float* src, const float* dst, const unsigned char* mask,
                      const float* scores, const float* start, float* models, float* keys,
                      int n, int iters, float tau, int sweeps, int iterations,
                      cudaStream_t stream) {
  hypotheses_kernel<MODEL><<<(iters + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
      src, dst, mask, scores, start, models, keys, n, iters, tau, sweeps, iterations);
  return (int)cudaGetLastError();
}

template <int MODEL>
int launch_refit(const float* src, const float* dst, const unsigned char* mask,
                 const float* start, const float* models, const float* keys,
                 float* transform, unsigned char* inliers, int* num, unsigned char* success,
                 int n, int iters, float tau, int refit, int sweeps, int iterations,
                 cudaStream_t stream) {
  refit_kernel<MODEL><<<1, REFIT_THREADS, 0, stream>>>(
      src, dst, mask, start, models, keys, transform, inliers, num, success, n, iters, tau,
      refit, sweeps, iterations);
  return (int)cudaGetLastError();
}

bool bad_model(int model) { return model != ESSENTIAL && model != HOMOGRAPHY; }

}  // namespace

extern "C" int nm_ransac_hypotheses(const void* src, const void* dst, const void* mask,
                                    const void* scores, const void* start, void* models,
                                    void* keys, int n, int iters, int model, float tau,
                                    int sweeps, int iterations, void* stream) {
  if (n <= 0 || iters <= 0 || sweeps < 0 || iterations < 0 || bad_model(model))
    return (int)cudaErrorInvalidValue;
  auto* launch = model == ESSENTIAL ? &launch_hypotheses<ESSENTIAL>
                                    : &launch_hypotheses<HOMOGRAPHY>;
  return launch(static_cast<const float*>(src), static_cast<const float*>(dst),
                static_cast<const unsigned char*>(mask), static_cast<const float*>(scores),
                static_cast<const float*>(start), static_cast<float*>(models),
                static_cast<float*>(keys), n, iters, tau, sweeps, iterations,
                static_cast<cudaStream_t>(stream));
}

extern "C" int nm_ransac_refit(const void* src, const void* dst, const void* mask,
                               const void* start, const void* models, const void* keys,
                               void* transform, void* inliers, void* num_inliers,
                               void* success, int n, int iters, int model, float tau,
                               int refit, int sweeps, int iterations, void* stream) {
  if (n <= 0 || iters <= 0 || sweeps < 0 || iterations < 0 || bad_model(model))
    return (int)cudaErrorInvalidValue;
  auto* launch = model == ESSENTIAL ? &launch_refit<ESSENTIAL> : &launch_refit<HOMOGRAPHY>;
  return launch(static_cast<const float*>(src), static_cast<const float*>(dst),
                static_cast<const unsigned char*>(mask), static_cast<const float*>(start),
                static_cast<const float*>(models), static_cast<const float*>(keys),
                static_cast<float*>(transform), static_cast<unsigned char*>(inliers),
                static_cast<int*>(num_inliers), static_cast<unsigned char*>(success), n,
                iters, tau, refit, sweeps, iterations, static_cast<cudaStream_t>(stream));
}
