// Warp-level building blocks shared by the port's f32 kernels
// (flash_attention.cu, flash_varlen.cu, gather_gemm.cu; gather_gemm_sm90.cu
// takes the cp.async copy): 16-byte cp.async copies, a paired f32 store, and
// warp_mma, one warp's 16-row product in the m16n8 accumulator layout by FMA
// in full f32. bf16 products run on wgmma in the *_sm90.cu kernels.

#pragma once

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

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// acc[j] += A[16 x K] . B[K x cols 8j..8j+7], the warp's 16-row product in the
// m16n8 accumulator layout: lane l holds rows l/4 and l/4 + 8, columns
// 2*(l%4) and 2*(l%4) + 1 of each 8-column block j. A is row-major with K
// contiguous (row stride lda). B(k, n) lies at B[n*ldb + k] when B_KC (a tile
// whose rows are B's columns: K or Q read as a transpose) and at B[k*ldb + n]
// otherwise (V, dO, K or Q read as they are, a weight tile). f32 only.
template <typename T, int NT, int K, bool B_KC>
__device__ __forceinline__ void warp_mma(const T* __restrict__ A, int lda,
                                         const T* __restrict__ B, int ldb,
                                         float (&acc)[NT][4]) {
  static_assert(std::is_same<T, float>::value, "FMA in full f32 only");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
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

template <int NT>
__device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

}  // namespace
