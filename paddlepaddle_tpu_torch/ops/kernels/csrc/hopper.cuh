// Hopper (sm_90a) building blocks in inline PTX, shared by the port's
// warpgroup kernels (flash_fwd_sm90.cu, flash_bwd_sm90.cu,
// flash_varlen_sm90.cu, gather_gemm_sm90.cu): mbarriers, the proxy fence,
// TMA tile loads through a tensor map, the shared-memory matrix descriptor
// of a 128-byte-swizzled tile, the wgmma products those kernels issue (bf16
// in, f32 accumulators; the dense flash kernels' products also in fp16),
// A fragments read from a swizzled tile by ldmatrix, the attention kernels'
// work on accumulator registers (exp2, bf16 / fp16 packing, accumulators as
// A fragments, RS products over a tile, row stores),
// register reallocation between warpgroups, and the host-side encoding of a
// tiled tensor map through the driver entry point (no -lcuda).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

// -------------------------------------------------------------------------
// mbarriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// one arrival that also expects `bytes` of transactions (TMA completions)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase with this parity has completed; a wait
// that lasts ~2^34 cycles (seconds) traps, so a lost arrival fails the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  long long start = 0;
  do {
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// orders this thread's generic-proxy shared-memory writes (plain stores,
// completed cp.async copies) before later async-proxy reads (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -------------------------------------------------------------------------
// TMA

// a 3-D box of `map` at coordinates (c0 innermost .. c2) into shared memory;
// completion is counted on `bar` in bytes
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// a 4-D box of `map` at coordinates (c0 innermost .. c3) into shared memory;
// completion is counted on `bar` in bytes
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -------------------------------------------------------------------------
// wgmma

// Descriptor of a tile stored as rows of 128 bytes (64 bf16) with the
// 128-byte swizzle TMA applies, 1024-byte aligned per 8-row group set:
// start address, leading byte offset `lbo`, stride byte offset 1024 (eight
// rows of 128 bytes), layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The wgmma operand type of an element type: "bf16" for __nv_bfloat16,
// "f16" for __half. Every product below takes T (bf16 by default); the
// instruction, its register layout and its rate are the same for both.
template <typename T>
constexpr bool is_f16 = std::is_same<T, __half>::value;

#define HOPPER_ACC64                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),               \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),               \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),          \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),          \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),          \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),          \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),          \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),          \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),          \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),          \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HOPPER_ACC32                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),               \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),               \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),          \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),          \
  "+f"(d[30]), "+f"(d[31])

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory; TB is
// the trans-b immediate
#define HOPPER_WGMMA_M64N128K16_SS(TY, TB)                                  \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"       \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "        \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "        \
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "        \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "        \
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "        \
      "%62, %63"                                                            \
      "}, %64, %65, p, 1, 1, 0, " TB ";\n}\n"                              \
      : HOPPER_ACC64                                                      \
      : "l"(da), "l"(db), "r"(accumulate))

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory, K-major
#define HOPPER_WGMMA_M64N64K16_SS(TY)                                       \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"        \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "        \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "        \
      "%26, %27, %28, %29, %30, %31"                                        \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                   \
      : HOPPER_ACC32                                                      \
      : "l"(da), "l"(db), "r"(accumulate))

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers; TB is the
// trans-b immediate
#define HOPPER_WGMMA_M64N64K16_RS(TY, TB, ACCUMULATE)                       \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"        \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "        \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "        \
      "%26, %27, %28, %29, %30, %31"                                        \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, " TB ";\n}\n"                \
      : HOPPER_ACC32                                                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),              \
        "r"(ACCUMULATE))

// d[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B from shared memory, both
// K-major (B stored as [128][16..]: rows are B's columns)
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t da, uint64_t db,
                                                    int accumulate) {
  if constexpr (is_f16<T>)
    HOPPER_WGMMA_M64N128K16_SS("f16", "0");
  else
    HOPPER_WGMMA_M64N128K16_SS("bf16", "0");
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128]: A from shared memory K-major, B
// from shared memory N-major (trans-b): [16 k rows][128 n] stored as two
// 64-column blocks of rows of 128 bytes, `lbo` bytes apart (the descriptor's
// leading byte offset), each 8-row group 1024 bytes after the last
__device__ __forceinline__ void wgmma_m64n128k16_ss_tb(float (&d)[64],
                                                       uint64_t da,
                                                       uint64_t db,
                                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B from shared memory, both
// K-major (B stored as [64][16..]: rows are B's columns)
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   int accumulate) {
  if constexpr (is_f16<T>)
    HOPPER_WGMMA_M64N64K16_SS("f16");
  else
    HOPPER_WGMMA_M64N64K16_SS("bf16");
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (the m16n8k16 A
// fragment of each warp's 16 rows), B from shared memory stored N-major
// ([16 k rows][64 n], rows of 128 bytes), hence trans-b = 1
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  if constexpr (is_f16<T>)
    HOPPER_WGMMA_M64N64K16_RS("f16", "1", 1);
  else
    HOPPER_WGMMA_M64N64K16_RS("bf16", "1", 1);
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]: A from registers, B from shared
// memory K-major (stored as [64][16..]: rows are B's columns)
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_rs_kmajor(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  if constexpr (is_f16<T>)
    HOPPER_WGMMA_M64N64K16_RS("f16", "0", accumulate);
  else
    HOPPER_WGMMA_M64N64K16_RS("bf16", "0", accumulate);
}

// The m16n8k16 A fragments of 16 rows (from row0) of a tile stored as
// [rows][64] bf16 with the 128-byte swizzle, for the four k16 steps of its
// 64 columns: one ldmatrix.x4 a step (lane l addresses row l % 8 + 8 (l / 8
// % 2) and 16-byte chunk 2 kk + l / 16, which the swizzle moves to chunk
// c ^ (row % 8)). `block` is 1024-byte aligned.
__device__ __forceinline__ void a_frags_sw128(uint32_t (&a)[4][4],
                                              const void* block, int row0,
                                              int lane) {
  const int r = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t row = smem_addr(block) + r * 128;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 2 + (lane >> 4);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
        : "r"(row + ((c ^ (r & 7)) << 4))
        : "memory");
  }
}

// -------------------------------------------------------------------------
// accumulator registers of the attention kernels

// 2^x on the multi-function unit, results below 2^-126 flushed to 0 (a
// probability that small is nothing beside its row's largest, which is 1)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two floats rounded to fp16 (to nearest; past 65504 they become inf, which
// is left as it is: a loss scaler reads it)
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (is_f16<T>)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

// the accumulator of a 64 x N product to A fragments of T: k step kk takes
// 8-column blocks 2kk and 2kk + 1
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void to_a_frags(const float (&x)[N / 2],
                                           uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int jb = 0; jb < N / 8; ++jb) {
    a[jb / 2][(jb & 1) * 2 + 0] = pack2<T>(x[4 * jb + 0], x[4 * jb + 1]);
    a[jb / 2][(jb & 1) * 2 + 1] = pack2<T>(x[4 * jb + 2], x[4 * jb + 3]);
  }
}

template <int NB>
__device__ __forceinline__ void fence_acc(float (&acc)[NB][32]) {
#pragma unroll
  for (int blk = 0; blk < NB; ++blk) fence_regs(acc[blk]);
}

// acc[blk] += A B over STEPS k16 steps: A from registers, B the N-major
// [STEPS * 16][64] swizzled blocks of a tile, one per 64-wide d block,
// `block_bytes` apart
template <int NB, int STEPS, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_acc(float (&acc)[NB][32],
                                             const uint32_t (&a)[STEPS][4],
                                             const unsigned char* tile,
                                             uint32_t block_bytes) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
#pragma unroll
    for (int blk = 0; blk < NB; ++blk)
      wgmma_m64n64k16_rs<T>(acc[blk], a[kk],
                         desc_sw128(tile + blk * block_bytes + kk * 16 * 128,
                                    1024));
}

// rows row0 and row0 + 8 of a 64 x D accumulator to T [b, s, h, d] rows
// (row stride rs), skipping rows at or past S
template <int NB, typename T>
__device__ __forceinline__ void store_rows(T* base, size_t rs, int row0,
                                           int S, int t,
                                           const float (&acc)[NB][32]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row < S) {
      T* dst = base + (size_t)row * rs + 2 * t;
#pragma unroll
      for (int blk = 0; blk < NB; ++blk)
#pragma unroll
        for (int jb = 0; jb < 8; ++jb)
          *reinterpret_cast<uint32_t*>(dst + blk * 64 + jb * 8) = pack2<T>(
              acc[blk][4 * jb + 2 * r], acc[blk][4 * jb + 2 * r + 1]);
    }
  }
}

// -------------------------------------------------------------------------
// register reallocation between warpgroups (all four warps execute it)

template <int N> __device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -------------------------------------------------------------------------
// host: tiled tensor maps through the driver entry point

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A [b, s, h, d] tensor of 2-byte elements (d contiguous; bf16 by default,
// `dtype` CU_TENSOR_MAP_DATA_TYPE_FLOAT16 for fp16) as a 4-D map (d, h, s, b)
// whose box is 64 elements of d by `rows` positions of one (b, h): one
// 128-byte-swizzled [rows][64] tile per load. Positions past s read as zero.
inline cudaError_t bshd_map(
    CUtensorMap* map, const void* base, int B, int S, int H, int D, int rows,
    CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, dtype, 4,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the tensor-map type of an element type
template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return is_f16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A contiguous [n2, n1, n0] bf16 tensor as a 3-D map (n0 innermost) whose
// box is 64 elements of n0 by `rows` of n1 in one n2: one
// 128-byte-swizzled [rows][64] tile per load. Rows past n1 read as zero.
inline cudaError_t bf16_map_3d(CUtensorMap* map, const void* base,
                               uint64_t n0, uint64_t n1, uint64_t n2,
                               int rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {n0 * 2, n0 * n1 * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
