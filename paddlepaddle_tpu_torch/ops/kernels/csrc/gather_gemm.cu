// Gather-GEMM expert FFN for Hopper (sm_90a): the MoE dispatch gather and
// the SwiGLU expert FFN in one kernel, CUDA C++ with a plain C entry.
//
// Replaces the TPU kernel _gather_ffn_kernel of
// paddlepaddle_tpu/ops/kernels/gather_gemm.py:80 (pallas_call in
// gather_gemm_ffn :147). Same function: for expert e and capacity slot c,
//   out[e*C + c] = (silu(xr @ wg[e]) * (xr @ wu[e])) @ wd[e],
//   xr = x[slot[e*C + c]], or a zero row where the slot holds a sentinel
//   (>= T, or negative), so an unfilled slot gives an exact zero row.
// x [T, d], slot [E*C] int32 (token rows), wg/wu [E, d, h], wd [E, h, d],
// out [E*C, d] in x's type. Both products accumulate in f32.
//
// What the TPU kernel keeps out of device memory, this one keeps out too:
// the gathered rows, the [rows, 2h] gate/up product and the [rows, h]
// activation never exist in device memory; only out is written.
//
// Design (simple and correct first):
//   * Grid (ceil(C/BM), E): the row block on blockIdx.x and the expert on
//     blockIdx.y, so the CTAs of one expert run together and share its
//     3*d*h weights (17.3 MB at d 2048, h 1408, bf16) in the 50 MB L2. There
//     is no scalar prefetch: each CTA loads its own BM slot indices into
//     shared memory first. A sentinel row clamps its address to row 0 and is
//     zero-filled by cp.async with src-size 0, so nothing is ever read out of
//     bounds. The ragged last row block (C not a multiple of BM) is masked on
//     store.
//   * Shared memory is the constraint. The CTA keeps hmid = silu(g) * u,
//     [BM, h], on chip (bf16: BM 32, 90 KB at h 1408; f32: BM 16, 90 KB) and
//     streams everything else through two stage buffers with 16-byte
//     cp.async copies (tile i+1 in flight while tile i is computed):
//       product 1, per 128-column tile of h: gathered-x K-tiles [BM, BK]
//         with the gate and up column tiles [BK, 128] side by side, so gate
//         column j and up column j land in the same warp and silu(g) * u is
//         formed in the epilogue and written to hmid;
//       product 2, per 128-column tile of d: wd K-tiles [BK, 128] against
//         hmid, then the store of out.
//     One loop walks product 1's tiles and then product 2's, so the first wd
//     tile is already in flight during the last product-1 tile. 8 warps: a
//     2 x 4 (bf16) or 1 x 8 (f32) grid over the BM x 128 output tile.
//   * Numerics. bf16: both products on the tensor cores (mma.sync m16n8k16,
//     bf16 in, f32 accumulate), so product 1 is exact per product as on the
//     TPU; hmid is rounded to bf16 when it is stored for product 2's tensor
//     cores, where the TPU kernel keeps it in f32. That rounding (relative
//     2^-9 per element of hmid) is this kernel's one departure, and
//     chip_smoke.py holds the kernel to the plain f32 version with a bound
//     derived from it. f32: FMA in full f32 (no TF32) with hmid kept in f32.
//   * Bound at the main-path shape (E 64, C 320, d 2048, h 1408, bf16):
//     2*E*C*(2*d*h + h*d) = 3.54e11 flop, 0.358 ms at 989 TFLOP/s; the
//     weights once (1.107 GB) plus the gathered rows and out (2 x 83.9 MB),
//     1.275 GB, 0.381 ms at 3.35 TB/s: at the ridge, bound by bytes. Known
//     limits, for later work: with BM 32 rows a CTA reads each expert weight
//     tile for only 32 rows, so the weights cross from L2 to shared memory
//     ceil(C/BM) times; mma.sync rather than wgmma; no TMA or warp
//     specialisation.
//
// Limits checked by the Python wrapper before launch (gather_gemm_supported):
// f32 or bf16; d and h multiples of 128; shared memory 2*STAGE + BM*(h+VEC)
// element bytes + BM ints within 227 KB (h <= 2304 for bf16, <= 2432 for
// f32); E <= 65535; 16-byte aligned contiguous tensors.

#include "warp_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int BN = 128;            // columns of an output tile (h, then d)
constexpr size_t kMaxSmem = 232448;

template <typename T> struct Rows;
template <> struct Rows<__nv_bfloat16> { static constexpr int BM = 32, BK = 64; };
template <> struct Rows<float> { static constexpr int BM = 16, BK = 32; };

template <typename T>
struct Plan {
  static constexpr int BM = Rows<T>::BM;   // slots a CTA owns
  static constexpr int BK = Rows<T>::BK;   // depth of a streamed tile
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int WM = BM / 16;       // warps along the rows
  static constexpr int WN = kWarps / WM;   // warps along the columns
  static constexpr int NW = BN / WN;       // columns a warp owns
  static constexpr int NT = NW / 8;        // its n8 accumulator tiles
  // rows padded by 16 bytes, so ldmatrix rows hit distinct banks
  static constexpr int LDX = BK + VEC;
  static constexpr int LDW = BN + VEC;
  static constexpr size_t STAGE1 = (size_t)(BM * LDX + 2 * BK * LDW) * sizeof(T);
  static constexpr size_t STAGE2 = (size_t)BK * LDW * sizeof(T);
  static constexpr size_t STAGE = STAGE1 > STAGE2 ? STAGE1 : STAGE2;
  static size_t smem(int h) {
    return 2 * STAGE + (size_t)BM * (h + VEC) * sizeof(T) + BM * sizeof(int);
  }
};

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// start the copies of streamed tile i into one stage buffer: product-1 tile
// (column tile nt of h, K-tile kt of d) or product-2 tile (column tile dt of
// d, K-tile kt of h)
template <typename T>
__device__ __forceinline__ void load_tile(unsigned char* stage, int i, int n1,
                                          int nk1, int nk2, const T* x,
                                          const int* idx_s, const T* wg,
                                          const T* wu, const T* wd, int d,
                                          int h) {
  using P = Plan<T>;
  constexpr int VEC = P::VEC, WC = BN / VEC;
  if (i < n1) {
    const int nt = i / nk1, kt = i - nt * nk1;
    T* xs = reinterpret_cast<T*>(stage);
    T* gs = xs + P::BM * P::LDX;
    T* us = gs + P::BK * P::LDW;
    constexpr int XC = P::BK / VEC;
    for (int q = threadIdx.x; q < P::BM * XC; q += kThreads) {
      const int r = q / XC, cc = q - r * XC;
      const int row = idx_s[r];
      const bool ok = row >= 0;
      const T* src = x + (size_t)(ok ? row : 0) * d + kt * P::BK + cc * VEC;
      cp_async16(xs + r * P::LDX + cc * VEC, src, ok);
    }
    for (int q = threadIdx.x; q < P::BK * WC; q += kThreads) {
      const int r = q / WC, cc = q - r * WC;
      const size_t off = (size_t)(kt * P::BK + r) * h + nt * BN + cc * VEC;
      cp_async16(gs + r * P::LDW + cc * VEC, wg + off, true);
      cp_async16(us + r * P::LDW + cc * VEC, wu + off, true);
    }
  } else {
    const int j = i - n1, dt = j / nk2, kt = j - dt * nk2;
    T* ws = reinterpret_cast<T*>(stage);
    for (int q = threadIdx.x; q < P::BK * WC; q += kThreads) {
      const int r = q / WC, cc = q - r * WC;
      const size_t off = (size_t)(kt * P::BK + r) * d + dt * BN + cc * VEC;
      cp_async16(ws + r * P::LDW + cc * VEC, wd + off, true);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_ffn_kernel(const T* __restrict__ x, const int* __restrict__ slot,
                  const T* __restrict__ wg, const T* __restrict__ wu,
                  const T* __restrict__ wd, T* __restrict__ out, int Tn, int C,
                  int d, int h) {
  using P = Plan<T>;
  const int e = blockIdx.y, c0 = blockIdx.x * P::BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / P::WN, wn = warp - (warp / P::WN) * P::WN;
  const int g = lane >> 2, t = lane & 3;
  const int ldh = h + P::VEC;

  extern __shared__ __align__(16) unsigned char smem[];
  T* hmid = reinterpret_cast<T*>(smem + 2 * P::STAGE);          // [BM][ldh]
  int* idx_s = reinterpret_cast<int*>(hmid + (size_t)P::BM * ldh);  // [BM]

  for (int r = threadIdx.x; r < P::BM; r += kThreads) {
    const int c = c0 + r;
    const int s = c < C ? slot[(size_t)e * C + c] : -1;
    idx_s[r] = (s >= 0 && s < Tn) ? s : -1;
  }
  __syncthreads();

  const size_t wsz = (size_t)d * h;
  const T* wge = wg + e * wsz;
  const T* wue = wu + e * wsz;
  const T* wde = wd + e * wsz;
  const int nk1 = d / P::BK, n1 = (h / BN) * nk1;
  const int nk2 = h / P::BK, n2 = (d / BN) * nk2;
  const int total = n1 + n2;

  load_tile<T>(smem, 0, n1, nk1, nk2, x, idx_s, wge, wue, wde, d, h);
  cp_async_commit();

  float acc[P::NT][4], acc_u[P::NT][4];   // acc: gate, then out
  for (int i = 0; i < total; ++i) {
    const unsigned char* st = smem + (i & 1) * P::STAGE;
    if (i + 1 < total) {
      load_tile<T>(smem + ((i + 1) & 1) * P::STAGE, i + 1, n1, nk1, nk2, x,
                   idx_s, wge, wue, wde, d, h);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i < n1) {
      const int nt = i / nk1, kt = i - nt * nk1;
      const T* xs = reinterpret_cast<const T*>(st) + wm * 16 * P::LDX;
      const T* gs = reinterpret_cast<const T*>(st) + P::BM * P::LDX;
      const T* us = gs + P::BK * P::LDW;
      if (kt == 0) {
        zero(acc);
        zero(acc_u);
      }
      warp_mma<T, P::NT, P::BK, false>(xs, P::LDX, gs + wn * P::NW, P::LDW, acc);
      warp_mma<T, P::NT, P::BK, false>(xs, P::LDX, us + wn * P::NW, P::LDW,
                                       acc_u);
      if (kt == nk1 - 1) {
        T* hr = hmid + (wm * 16 + g) * ldh + nt * BN + wn * P::NW + 2 * t;
#pragma unroll
        for (int j = 0; j < P::NT; ++j) {
          store2(hr + j * 8, silu(acc[j][0]) * acc_u[j][0],
                 silu(acc[j][1]) * acc_u[j][1]);
          store2(hr + 8 * ldh + j * 8, silu(acc[j][2]) * acc_u[j][2],
                 silu(acc[j][3]) * acc_u[j][3]);
        }
      }
    } else {
      const int jj = i - n1, dt = jj / nk2, kt = jj - dt * nk2;
      const T* ws = reinterpret_cast<const T*>(st);
      if (kt == 0) zero(acc);
      warp_mma<T, P::NT, P::BK, false>(hmid + wm * 16 * ldh + kt * P::BK, ldh,
                                       ws + wn * P::NW, P::LDW, acc);
      if (kt == nk2 - 1) {
        const int r0 = c0 + wm * 16 + g;
        T* o = out + ((size_t)e * C + r0) * d + dt * BN + wn * P::NW + 2 * t;
#pragma unroll
        for (int j = 0; j < P::NT; ++j) {
          if (r0 < C) store2(o + j * 8, acc[j][0], acc[j][1]);
          if (r0 + 8 < C) store2(o + 8 * (size_t)d + j * 8, acc[j][2], acc[j][3]);
        }
      }
    }
    __syncthreads();            // stage buffer i & 1 (and hmid) free again
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* slot, const void* wg,
                   const void* wu, const void* wd, void* out, int Tn, int E,
                   int C, int d, int h, cudaStream_t st) {
  using P = Plan<T>;
  if (d % BN || h % BN || d % P::BK || h % P::BK) return cudaErrorInvalidValue;
  const size_t smem = P::smem(h);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = gather_ffn_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((C + P::BM - 1) / P::BM, E);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const int*>(slot),
      static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<const T*>(wd), static_cast<T*>(out), Tn, C, d, h);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 on a successful launch. Does not
// synchronise; a fault during the run shows at the caller's next sync.
extern "C" {

int gather_gemm_launch(const void* x, const void* slot, const void* wg,
                       const void* wu, const void* wd, void* out, int T, int E,
                       int C, int d, int h, int is_bf16, void* stream) {
  if (T <= 0 || E <= 0 || E > 65535 || C <= 0 || d <= 0 || h <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, slot, wg, wu, wd, out, T, E, C, d, h, st);
  return (int)launch<float>(x, slot, wg, wu, wd, out, T, E, C, d, h, st);
}

// the smallest dynamic shared memory the kernel needs at hidden width h
long gather_gemm_smem_bytes(int h, int is_bf16) {
  return is_bf16 ? (long)Plan<__nv_bfloat16>::smem(h)
                 : (long)Plan<float>::smem(h);
}

const char* gather_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
