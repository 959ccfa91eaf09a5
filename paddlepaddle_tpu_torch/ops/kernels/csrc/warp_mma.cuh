// Warp-level building blocks shared by the port's Hopper kernels
// (flash_attention.cu, gather_gemm.cu; gather_gemm_sm90.cu takes the
// cp.async copy): 16-byte cp.async copies, ldmatrix
// fragment loads, the bf16 mma.sync m16n8k16 product with f32 accumulation,
// and warp_mma, one warp's 16-row product in the m16n8 accumulator layout
// (FMA in full f32 for float operands, the tensor cores for bf16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src,
                                           bool ok) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int n = ok ? 16 : 0;                 // 0 bytes read: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l%8 of matrix l/8. Plain: lane (g, t) receives row g, columns 2t, 2t+1 of
// each matrix; .trans: row 2t and 2t+1, column g (the matrix transposed).
// The "memory" clobber keeps the compiler from hoisting a load above the
// plain stores that staged its tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[j] += A[16 x K] . B[K x cols 8j..8j+7], the warp's 16-row product in the
// m16n8 accumulator layout: lane l holds rows l/4 and l/4 + 8, columns
// 2*(l%4) and 2*(l%4) + 1 of each 8-column block j. A is row-major with K
// contiguous (row stride lda). B(k, n) lies at B[n*ldb + k] when B_KC (a tile
// whose rows are B's columns: K or Q read as a transpose) and at B[k*ldb + n]
// otherwise (V, dO, K or Q read as they are, a weight tile).
template <typename T, int NT, int K, bool B_KC>
__device__ __forceinline__ void warp_mma(const T* __restrict__ A, int lda,
                                         const T* __restrict__ B, int ldb,
                                         float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    static_assert(NT % 2 == 0, "B tiles are loaded in pairs");
    const int mi = lane >> 3, r = lane & 7;   // ldmatrix: matrix, row
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      // matrices (rows 0-7 | 8-15) x (k kk.. | kk+8..) -> a0, a1, a2, a3
      uint32_t a[4];
      ldmatrix_x4(a, A + (r + (mi & 1) * 8) * lda + kk + (mi >> 1) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        // b[0], b[1]: tile j (k kk.., kk+8..); b[2], b[3]: tile j + 1
        uint32_t b[4];
        const int n0 = (j + (mi >> 1)) * 8, k0 = kk + (mi & 1) * 8;
        if constexpr (B_KC) {
          ldmatrix_x4(b, B + (n0 + r) * ldb + k0);
        } else {
          ldmatrix_x4_trans(b, B + (k0 + r) * ldb + n0);
        }
        mma_bf16_16816(acc[j], a[0], a[1], a[2], a[3], b[0], b[1]);
        mma_bf16_16816(acc[j + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      const float a_lo = A[g * lda + k], a_hi = A[(g + 8) * lda + k];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = j * 8 + 2 * t;
        const float b0 = B_KC ? B[n * ldb + k] : B[k * ldb + n];
        const float b1 = B_KC ? B[(n + 1) * ldb + k] : B[k * ldb + n + 1];
        acc[j][0] = fmaf(a_lo, b0, acc[j][0]);
        acc[j][1] = fmaf(a_lo, b1, acc[j][1]);
        acc[j][2] = fmaf(a_hi, b0, acc[j][2]);
        acc[j][3] = fmaf(a_hi, b1, acc[j][3]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

}  // namespace
