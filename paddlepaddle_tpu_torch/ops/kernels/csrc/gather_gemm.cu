// Gather-GEMM expert FFN for Hopper (sm_90a) in f32: the two phases of
// gather_gemm_sm90.cu on plain FMA tiles, CUDA C++ with a plain C entry per
// phase.
//
// Replaces the TPU kernel _gather_ffn_kernel of
// paddlepaddle_tpu/ops/kernels/gather_gemm.py:80 (pallas_call in
// gather_gemm_ffn :147) for f32; bf16 runs on gather_gemm_sm90.cu, whose
// header states the function, the split and the bound. Two launches a call:
//   gather_gateup_f32  hmid[e, c, :] = silu(xr @ wg[e]) * (xr @ wu[e])
//   expert_down_f32    out[e*C + c, :] = hmid[e, c, :] @ wd[e]
// xr = x[slot[e*C + c]], a zero row for a sentinel (>= T, or negative); a
// sentinel slot's hmid and out rows are exact zeros. hmid [E, C, h] stays in
// f32, so the result is the fused f32 function's, in full f32 (FMA, no
// TF32): this path serves the parity runs at small widths, where wgmma's
// TF32 rounding would be the only difference from the CPU.
//
// Design (simple): grid (ceil(C / 32), N / 128, E); a CTA owns 32 slots and
// 128 output columns, 8 warps in a 2 x 4 grid of 16 x 32 tiles, and streams
// its A rows ([32][32], gathered by token row or read in place) and its one
// or two weight tiles ([32][128]) through two 16-byte cp.async stages;
// sentinel rows are zero-filled (src-size 0) and read nothing. Neither the
// tile nor the shared memory depends on d or h.

#include "warp_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int BM = 32, BN = 128, BK = 32, VEC = 4;
constexpr int WM = BM / 16;               // warps along the rows
constexpr int WN = kWarps / WM;           // warps along the columns
constexpr int NW = BN / WN;               // columns a warp owns
constexpr int NT = NW / 8;                // its n8 accumulator tiles
// rows padded by 16 bytes, as in warp_mma's other callers
constexpr int LDA = BK + VEC;
constexpr int LDB = BN + VEC;
constexpr size_t kStage = (size_t)(BM * LDA + 2 * BK * LDB) * sizeof(float);
constexpr size_t kSmem = 2 * kStage + BM * sizeof(int);

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// kGateUp: A rows are x[token row] (K = d), B are wg[e] and wu[e] [d, h],
// dst is hmid (N = h). Otherwise A rows are hmid[e, c] (K = h), B is wd[e]
// [h, d], dst is out (N = d).
template <bool kGateUp>
__global__ void __launch_bounds__(kThreads)
phase_kernel(const float* __restrict__ a, const int* __restrict__ slot,
             const float* __restrict__ b0, const float* __restrict__ b1,
             float* __restrict__ dst, int Tn, int C, int K, int N) {
  const int e = blockIdx.z, n0 = blockIdx.y * BN, c0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp - (warp / WN) * WN;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem[];
  int* src_s = reinterpret_cast<int*>(smem + 2 * kStage);   // A row, or -1
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const int c = c0 + r;
    const int s = c < C ? slot[(size_t)e * C + c] : -1;
    const bool ok = s >= 0 && s < Tn;
    src_s[r] = !ok ? -1 : kGateUp ? s : e * C + c;
  }
  __syncthreads();

  const size_t wsz = (size_t)K * N;
  const float* b0e = b0 + e * wsz;
  const float* b1e = kGateUp ? b1 + e * wsz : nullptr;
  auto load = [&](int buf, int kt) {
    float* as = reinterpret_cast<float*>(smem + buf * kStage);
    float* bs = as + BM * LDA;
    constexpr int AC = BK / VEC, BC = BN / VEC;
    for (int q = threadIdx.x; q < BM * AC; q += kThreads) {
      const int r = q / AC, cc = q - r * AC;
      const int row = src_s[r];
      cp_async16(as + r * LDA + cc * VEC,
                 a + (size_t)(row >= 0 ? row : 0) * K + kt * BK + cc * VEC,
                 row >= 0);
    }
    for (int q = threadIdx.x; q < BK * BC; q += kThreads) {
      const int r = q / BC, cc = q - r * BC;
      const size_t off = (size_t)(kt * BK + r) * N + n0 + cc * VEC;
      cp_async16(bs + r * LDB + cc * VEC, b0e + off, true);
      if (kGateUp) cp_async16(bs + (BK + r) * LDB + cc * VEC, b1e + off, true);
    }
  };

  const int nk = K / BK;
  float acc[NT][4], acc_u[NT][4];
  zero(acc);
  zero(acc_u);
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load((kt + 1) & 1, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = reinterpret_cast<const float*>(smem + (kt & 1) * kStage);
    const float* bs = as + BM * LDA;
    warp_mma<float, NT, BK, false>(as + wm * 16 * LDA, LDA, bs + wn * NW, LDB,
                                   acc);
    if (kGateUp)
      warp_mma<float, NT, BK, false>(as + wm * 16 * LDA, LDA,
                                     bs + BK * LDB + wn * NW, LDB, acc_u);
    __syncthreads();            // stage kt & 1 free again
  }

  const int r0 = c0 + wm * 16 + g;
  float* o = dst + ((size_t)e * C + r0) * N + n0 + wn * NW + 2 * t;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = kGateUp ? silu(acc[j][i]) * acc_u[j][i] : acc[j][i];
    if (r0 < C) store2(o + j * 8, v[0], v[1]);
    if (r0 + 8 < C) store2(o + 8 * (size_t)N + j * 8, v[2], v[3]);
  }
}

template <bool kGateUp>
cudaError_t launch(const float* a, const int* slot, const float* b0,
                   const float* b1, float* dst, int T, int E, int C, int K,
                   int N, cudaStream_t st) {
  if (T <= 0 || E <= 0 || E > 65535 || C <= 0 || K <= 0 || N <= 0 ||
      K % BK || N % BN || N / BN > 65535)
    return cudaErrorInvalidValue;
  auto kern = phase_kernel<kGateUp>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((C + BM - 1) / BM, N / BN, E);
  kern<<<grid, kThreads, kSmem, st>>>(a, slot, b0, b1, dst, T, C, K, N);
  return cudaGetLastError();
}

}  // namespace

// Each entry returns a cudaError_t code: 0 on a successful launch. None
// synchronises; a fault during the run shows at the caller's next sync.
extern "C" {

// hmid [E, C, h] = silu(x[slot] @ wg) * (x[slot] @ wu), zero rows for
// sentinel slots. x [T, d]; slot [E*C] int32; wg, wu [E, d, h]; f32.
int gather_gateup_f32_launch(const void* x, const void* slot, const void* wg,
                             const void* wu, void* hmid, int T, int E, int C,
                             int d, int h, void* stream) {
  return (int)launch<true>(
      static_cast<const float*>(x), static_cast<const int*>(slot),
      static_cast<const float*>(wg), static_cast<const float*>(wu),
      static_cast<float*>(hmid), T, E, C, d, h,
      static_cast<cudaStream_t>(stream));
}

// out [E*C, d] = hmid[e, c] @ wd[e], zero rows for sentinel slots. hmid
// [E, C, h]; slot [E*C] int32; wd [E, h, d]; f32.
int expert_down_f32_launch(const void* hmid, const void* slot, const void* wd,
                           void* out, int T, int E, int C, int d, int h,
                           void* stream) {
  return (int)launch<false>(
      static_cast<const float*>(hmid), static_cast<const int*>(slot),
      static_cast<const float*>(wd), nullptr, static_cast<float*>(out), T, E,
      C, h, d, static_cast<cudaStream_t>(stream));
}

// dynamic shared memory of a CTA (the same for both phases)
long gather_gemm_f32_smem_bytes(int phase) {
  (void)phase;
  return (long)kSmem;
}

const char* gather_gemm_f32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
