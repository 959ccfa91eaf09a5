// Tile machinery shared by the port's flash-attention kernels
// (flash_attention.cu, dense; flash_varlen.cu, packed varlen): the CTA shape
// (4 warps, 16 rows each), the streamed tile widths, the softmax constants,
// the quad reductions of the m16n8 accumulator layout, the staging of an
// accumulator block through shared memory, 16-byte cp.async row loads with
// zero fill, row stores, each kernel's shared-memory size, and the opt-in
// to more than 48 KB of dynamic shared memory.

#pragma once

#include "warp_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int BM = kWarps * 16;     // rows a CTA owns, 16 per warp
constexpr int kFwdBN = 64;          // keys per streamed tile (forward, dQ)
constexpr int kDkvBN = 32;          // queries per streamed tile (dK/dV)
constexpr float kNegInf = -1e30f;
// exp(x) = exp2(x * log2(e)): logits and lse run in log2 units inside the
// kernels, so one multiply applies both the softmax scale and log2(e)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// -------------------------------------------------------------------------
// small helpers

// reductions over the 4 lanes that share a row of an m16n8 accumulator
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// write an accumulator-layout block into a [16][ld] tile of type T
template <typename T, int NT>
__device__ __forceinline__ void stage(T* dst, int ld, const float (&x)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    store2(dst + g * ld + j * 8 + 2 * t, x[j][0], x[j][1]);
    store2(dst + (g + 8) * ld + j * 8 + 2 * t, x[j][2], x[j][3]);
  }
}

// rows [r0, r0 + ROWS) of one (b, h) slice, whose row r starts at
// src + r * rs, into a [ROWS][D + 16/sizeof(T)] tile; rows at or past n are
// zero-filled
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0, int n,
                                          size_t rs) {
  constexpr int VEC = 16 / sizeof(T), CPR = D / VEC, LD = D + VEC;
  for (int i = threadIdx.x; i < ROWS * CPR; i += kThreads) {
    const int r = i / CPR, c = i - (i / CPR) * CPR;
    const bool ok = r0 + r < n;
    const T* s = ok ? src + (size_t)(r0 + r) * rs + c * VEC : src;
    cp_async16(dst + r * LD + c * VEC, s, ok);
  }
}

// write rows row0 and row0 + 8 of an accumulator block (scaled per row) to
// the [b, s, h, d] tensor at base, skipping rows at or past n
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* base, size_t rs, int row0, int n,
                                           const float (&x)[NT][4],
                                           float scale0, float scale1) {
  const int t = threadIdx.x & 3;
  if (row0 < n) {
    T* d = base + (size_t)row0 * rs + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      store2(d + j * 8, x[j][0] * scale0, x[j][1] * scale0);
  }
  if (row0 + 8 < n) {
    T* d = base + (size_t)(row0 + 8) * rs + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      store2(d + j * 8, x[j][2] * scale1, x[j][3] * scale1);
  }
}

// shared memory of one CTA, in bytes
template <typename T, int D>
constexpr size_t fwd_smem() {
  constexpr size_t VEC = 16 / sizeof(T);
  return ((size_t)BM + 4 * kFwdBN) * (D + VEC) * sizeof(T)        // q, k/v x2
         + (size_t)kWarps * 16 * (kFwdBN + VEC) * sizeof(T);       // p staging
}
template <typename T, int D>
constexpr size_t dq_smem() {
  constexpr size_t VEC = 16 / sizeof(T);
  return (2 * (size_t)BM + 4 * kFwdBN) * (D + VEC) * sizeof(T)    // q, dO, k/v x2
         + (size_t)kWarps * 16 * (kFwdBN + VEC) * sizeof(T);       // ds staging
}
template <typename T, int D>
constexpr size_t dkv_smem() {
  constexpr size_t VEC = 16 / sizeof(T);
  return (2 * (size_t)BM + 4 * kDkvBN) * (D + VEC) * sizeof(T)    // k, v, q/dO x2
         + 2 * (size_t)kDkvBN * sizeof(float)                      // lse, delta
         + (size_t)kWarps * 16 * (kDkvBN + VEC) * sizeof(T);       // p/ds staging
}

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace
