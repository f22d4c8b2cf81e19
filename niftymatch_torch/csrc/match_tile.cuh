// The tile machinery that K1 (match.cu) and K4 (fold_micro.cu) share, for
// Hopper (sm_90a): cp.async copies, ldmatrix, wgmma with A from registers
// and B from shared memory in the K-major core-matrix layout, the operand
// modes (3xTF32 fp32, bf16) and the block's shared-memory layout, and the
// top-2 merge.  match.cu's note says what each piece is for.

#pragma once

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

}  // namespace
