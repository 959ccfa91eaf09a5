// Gather-GEMM expert FFN for Hopper (sm_90a) in bf16: two warp-specialised,
// wgmma-computed kernels. CUDA C++ with a plain C entry per kernel.
//
// Replaces the TPU kernel _gather_ffn_kernel of
// paddlepaddle_tpu/ops/kernels/gather_gemm.py:80 (pallas_call in
// gather_gemm_ffn :147) for bf16; the f32 path is gather_gemm.cu (the same
// two phases on FMA tiles: wgmma would round f32 to TF32). Same function:
// for expert e and capacity slot c,
//   out[e*C + c] = (silu(xr @ wg[e]) * (xr @ wu[e])) @ wd[e],
//   xr = x[slot[e*C + c]], or a zero row where the slot holds a sentinel
//   (>= T, or negative), so an unfilled slot gives an exact zero row.
// x [T, d], slot [E*C] int32 (token rows), wg/wu [E, d, h], wd [E, h, d],
// out [E*C, d] bf16. Both products accumulate in f32.
//
// Two launches a call, deterministic, no atomics:
//   gather_gateup_sm90  hmid[e, c, :] = bf16(silu(xr @ wg[e]) * (xr @ wu[e]))
//   expert_down_sm90    out[e*C + c, :] = hmid[e, c, :] @ wd[e]
// hmid [E, C, h] bf16 is allocated by the caller. The TPU kernel keeps it
// in VMEM; here it makes one round trip through device memory (2 E C h
// bytes each way: 115 MB, ~0.034 ms at the DeepSeekMoE shape below), and in
// return neither kernel's shared memory depends on d or h, so every d and h
// that are multiples of 128 are taken. hmid is rounded to bf16 before the
// down product, as the fused kernel it replaces did (relative 2^-9 an
// element; chip_smoke.py holds the call to the plain f32 version with the
// bound that implies).
//
// Design (both kernels):
//   * CTA = 3 warpgroups over an output tile of 128 slots of one expert:
//     warpgroup 0 is the producer (setmaxnreg 40), warpgroups 1 and 2 the
//     consumers of 64 slots each (setmaxnreg 232), holding their f32
//     accumulators in registers. Stages in shared memory form a ring, each
//     guarded by a full barrier and an empty barrier (the 8 consumer warps
//     arrive when their wgmmas on it have retired); the ring is 192 KB, so
//     one CTA runs on an SM. (A persistent form, one CTA an SM walking the
//     tiles and filling the next one's stages during the last one's
//     epilogue, was 29% slower in phase A: its statically strided walk lets
//     the CTAs that share a weight tile drift apart.)
//   * Tile order: blockIdx.x walks the row tiles of one (expert, column
//     tile) first, then its column tiles, then the experts, so the ceil(C /
//     128) CTAs that read one weight tile run side by side: it leaves device
//     memory about once and is read from L2 ceil(C / 128) times (3 at C 320;
//     the fused kernel with its 32-row blocks read it 10 times).
//   * Operands are 128-byte-swizzled [rows][64] bf16 tiles. Weight tiles
//     come by TMA through 3-D maps over [E, d, h] / [E, h, d] (one [64 k][64
//     n] box per 64 columns); their rows run along N, so the products read
//     B N-major (wgmma trans-b, m64n128k16, the two 64-column boxes 8 KB
//     apart). A is K-major: [128 slots][64 k].
//   * gather_gateup_sm90: TMA cannot gather rows, so the whole producer
//     warpgroup fetches the gathered x K-tiles with 16-byte cp.async, eight
//     chunks a thread, applying the swizzle by hand (chunk c of row r lands
//     at chunk c ^ (r % 8)); a sentinel row is zero-filled (src-size 0) and
//     reads nothing. Each producer thread's copies arrive on the stage's
//     full barrier as they land (cp.async.mbarrier.arrive.noinc), beside
//     the TMA bytes of the gate and up tiles (129 arrivals); a consumer
//     fences the stage into the async proxy (fence.proxy.async) before its
//     wgmmas read it. (A producer that waited two stages for its own copies
//     and arrived itself was 8% slower.) One k-step of 64 issues 4 x 2
//     wgmmas (gate and up) per consumer, and one group stays in flight while
//     the next stage is awaited. Epilogue: silu(g) * u in f32, rounded to
//     bf16, stored from the registers. Measured at the main shape (PERF.md):
//     the kernel takes as long without its wgmmas, and 6% less with half
//     the weight bytes, so the round trip of a stage sets its pace; L2
//     prefetches of the tiles ahead of the ring made it slower.
//   * expert_down_sm90: one producer thread loads A (hmid) through a 3-D map
//     over [E, C, h] (rows past C read as zero, so no expert reads another's
//     rows) and wd by TMA, 256 columns of d a tile where d allows it (the
//     A tile then serves twice the columns: 12% faster than 128 at the
//     main shape), else 128. The store is masked: rows c >= C are never
//     written, so out is [E*C, d] with no slice or copy; a sentinel slot's
//     row is written as zero whatever hmid holds.
//   * Sentinels: the capacity maps put unfilled slots in a contiguous tail
//     per expert. A consumer whose 64 slots are all sentinels issues no
//     wgmma and writes zero rows (its stages still pass through it); a CTA
//     with no filled slot loads nothing and only writes its zero rows.
//
// Bound at the main-path shape (E 64, C 320, T 8192, d 2048, h 1408, 16384
// filled slots): 2 * 16384 * 3 d h = 2.84e11 flop, 0.287 ms at 989 TFLOP/s;
// the weights once (1.107 GB) plus x, slot and out, 1.225 GB, 0.366 ms at
// 3.35 TB/s: bound by bytes, the weights. What the design does about it:
// each weight tile crosses from device memory about once and is reused
// from L2 by the CTAs of one expert that run together; the weight stream
// is TMA-fed from a producer warpgroup while two consumers keep the tensor
// cores busy. Known limits: the hmid round trip; each k-step of either
// kernel moves 48 KB from L2 into shared memory for 4.2 Mflop (the x K-tiles
// are re-read once per 128-column tile of h); each CTA fills its ring and
// stores its tile with no overlap across tiles; the epilogue stores from
// registers without TMA.
//
// Limits checked by the Python wrapper before launch
// (gather_gemm_supported): bf16; d and h multiples of 128; 16-byte aligned
// contiguous tensors.

#include <limits.h>

#include "hopper.cuh"
#include "warp_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;                  // slots a CTA
constexpr int kBK = 64;                   // depth of a k-step
constexpr int kConsumers = 2;             // consumer warpgroups, 64 slots each
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr uint32_t kBox = 64 * 64 * 2;    // one [64][64] bf16 weight box
constexpr uint32_t kATile = kBM * kBK * 2;   // one [128][64] bf16 A tile
// both kernels: a 192 KB stage ring, then the mbarriers (room for 8 stages)
constexpr uint32_t kRing = 192 * 1024;
constexpr uint32_t kBarBytes = 8 * 2 * 8;

// gather_gateup_sm90: 128 columns of h a CTA; a stage holds the gathered x
// tile and the gate and up tiles (two boxes each)
constexpr int kGateUpBN = 128;
constexpr uint32_t kGateUpStage = kATile + 2 * (kGateUpBN / 64) * kBox;
constexpr int kGateUpStages = kRing / kGateUpStage;   // 4
// the ring, the row indices, the barriers, and the slack that aligns the
// ring to 1024 bytes
constexpr size_t kGateUpSmem = kRing + kBM * sizeof(int) + kBarBytes + 1024;

// expert_down_sm90: BN columns of d a CTA, kDownWideBN where d allows it
// (the A tile is read once for twice the columns), else 128
constexpr int kDownWideBN = 256;
template <int BN> struct Down {
  static constexpr uint32_t kStage = kATile + (BN / 64) * kBox;
  static constexpr int kStages = kRing / kStage;       // 6 at 128, 4 at 256
};
constexpr size_t kDownSmem = kRing + kBarBytes + 1024;

constexpr size_t kMaxSmem = 232448;
static_assert(kGateUpSmem <= kMaxSmem && kDownSmem <= kMaxSmem,
              "shared memory plan too large");
static_assert(kGateUpStages <= 8 && Down<128>::kStages <= 8,
              "barrier room for 8 stages");

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// the slot's token row, or -1 for a sentinel
__device__ __forceinline__ int token_row(const int* slot, int e, int c, int C,
                                         int Tn) {
  if (c >= C) return -1;
  const int s = slot[(size_t)e * C + c];
  return (s >= 0 && s < Tn) ? s : -1;
}

// zero rows [r0, r1) of a tile of `cols` columns at `dst` (row stride ld)
__device__ __forceinline__ void zero_rows(bf16* dst, size_t ld, int r0,
                                          int r1, int cols, int tid,
                                          int nthreads) {
  const int chunks = cols / 8;
  for (int q = tid; q < (r1 - r0) * chunks; q += nthreads) {
    const int r = r0 + q / chunks, cc = q - (q / chunks) * chunks;
    *reinterpret_cast<uint4*>(dst + r * ld + cc * 8) = make_uint4(0, 0, 0, 0);
  }
}

// one arrival on `bar` when this thread's cp.async copies so far have
// landed, counted against the barrier's expected arrivals
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(hopper::smem_addr(bar))
               : "memory");
}

// the block's (row tile, column tile, expert), row tiles fastest
__device__ __forceinline__ void tile_of(int C, int n_cols, int& c0, int& n0,
                                        int& e, int bn) {
  const int n_rt = (C + kBM - 1) / kBM;
  int b = blockIdx.x;
  c0 = (b % n_rt) * kBM;
  b /= n_rt;
  n0 = (b % (n_cols / bn)) * bn;
  e = b / (n_cols / bn);
}

__global__ void __launch_bounds__(kThreads, 1)
gather_gateup_sm90(const __grid_constant__ CUtensorMap tm_g,
                   const __grid_constant__ CUtensorMap tm_u,
                   const bf16* __restrict__ x, const int* __restrict__ slot,
                   bf16* __restrict__ hmid, int Tn, int C, int d, int h) {
  constexpr int ST = kGateUpStages, BN = kGateUpBN, NB = BN / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  int* idx_s = reinterpret_cast<int*>(smem + ST * kGateUpStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(idx_s + kBM);
  uint64_t* empty = full + ST;

  int c0, n0, e;
  tile_of(C, h, c0, n0, e, BN);
  const int tid = threadIdx.x, wg = tid / 128;
  bool mine = false;
  if (tid < kBM) {
    const int row = token_row(slot, e, c0 + tid, C, Tn);
    idx_s[tid] = row;
    mine = row >= 0;
  }
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(&full[i], 128 + 1);   // producer threads + TMA
      hopper::mbar_init(&empty[i], kConsumers * 4);
    }
    hopper::mbar_fence_init();
  }
  const int live0 = __syncthreads_or(tid < 64 && mine);
  const int live1 = __syncthreads_or(tid >= 64 && tid < 128 && mine);
  bf16* hbase = hmid + ((size_t)e * C + c0) * h + n0;
  const int rows = min(kBM, C - c0);
  if (!live0 && !live1) {
    zero_rows(hbase, h, 0, rows, BN, tid, kThreads);
    return;
  }
  const int nk = d / kBK;

  if (wg == 0) {
    // ---------------- producer: thread 0 issues the weight TMA loads; every
    // thread copies chunk (tid & 7) of x rows (tid >> 3) + 16 j, and its
    // copies arrive on the stage's full barrier as they land
    hopper::regs_dealloc<40>();
    const int cc = tid & 7;
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % ST;
      hopper::mbar_wait(&empty[st], ((kt / ST) & 1) ^ 1);
      unsigned char* xs = smem + st * kGateUpStage;
      if (tid == 0) {
        hopper::mbar_arrive_expect_tx(&full[st], 2 * NB * kBox);
        for (int nb = 0; nb < NB; ++nb) {
          hopper::tma_load_3d(xs + kATile + nb * kBox, &tm_g, &full[st],
                              n0 + nb * 64, kt * kBK, e);
          hopper::tma_load_3d(xs + kATile + (NB + nb) * kBox, &tm_u,
                              &full[st], n0 + nb * 64, kt * kBK, e);
        }
      }
#pragma unroll
      for (int j = 0; j < kBM / 16; ++j) {
        const int r = (tid >> 3) + 16 * j;
        const int row = idx_s[r];
        const bf16* src =
            x + (size_t)(row >= 0 ? row : 0) * d + kt * kBK + cc * 8;
        cp_async16(xs + r * 128 + ((cc ^ (r & 7)) << 4), src, row >= 0);
      }
      cp_async_arrive_noinc(&full[st]);
    }
  } else {
    // ---------------- consumers: 64 slots each
    hopper::regs_alloc<232>();
    const int cw = wg - 1;
    const int wi = (tid / 32) & 3;
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    float ag[64], au[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) ag[i] = au[i] = 0.f;
    if (cw ? live1 : live0) {
      hopper::fence_regs(ag);
      hopper::fence_regs(au);
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % ST;
        hopper::mbar_wait(&full[st], (kt / ST) & 1);
        // the x tile was written by cp.async (the generic proxy); wgmma
        // reads it through the async proxy
        hopper::fence_proxy_async();
        const unsigned char* xs = smem + st * kGateUpStage;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t da =
              hopper::desc_sw128(xs + cw * 64 * 128 + kk * 32, 16);
          const uint64_t dg =
              hopper::desc_sw128(xs + kATile + kk * 16 * 128, kBox);
          const uint64_t du = hopper::desc_sw128(
              xs + kATile + NB * kBox + kk * 16 * 128, kBox);
          hopper::wgmma_m64n128k16_ss_tb(ag, da, dg, 1);
          hopper::wgmma_m64n128k16_ss_tb(au, da, du, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();              // k-step kt - 1 has retired
        if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(kt - 1) % ST]);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(ag);
      hopper::fence_regs(au);
      if (lane == 0) hopper::mbar_arrive(&empty[(nk - 1) % ST]);
    } else {
      // all 64 slots are sentinels: pass the stages on, write zero rows
      for (int kt = 0; kt < nk; ++kt) {
        hopper::mbar_wait(&full[kt % ST], (kt / ST) & 1);
        if (lane == 0) hopper::mbar_arrive(&empty[kt % ST]);
      }
    }
    // epilogue: rows r and r + 8 of the tile, straight from the registers
    const int r = cw * 64 + wi * 16 + g;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = r + half * 8;
      if (rr < rows) {
        bf16* dst = hbase + (size_t)rr * h + 2 * t;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int i = 4 * j + 2 * half;
          *reinterpret_cast<uint32_t*>(dst + j * 8) =
              hopper::pack_bf16(silu(ag[i]) * au[i],
                                silu(ag[i + 1]) * au[i + 1]);
        }
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
expert_down_sm90(const __grid_constant__ CUtensorMap tm_h,
                 const __grid_constant__ CUtensorMap tm_d,
                 const int* __restrict__ slot, bf16* __restrict__ out, int Tn,
                 int C, int d, int h) {
  constexpr int ST = Down<BN>::kStages, NB = BN / 64, NA = BN / 128;
  constexpr uint32_t kDownStage = Down<BN>::kStage;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * kDownStage);
  uint64_t* empty = full + ST;

  int c0, n0, e;
  tile_of(C, d, c0, n0, e, BN);
  const int tid = threadIdx.x, wg = tid / 128;
  const bool mine = tid < kBM && token_row(slot, e, c0 + tid, C, Tn) >= 0;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], kConsumers * 4);
    }
    hopper::mbar_fence_init();
  }
  const int live0 = __syncthreads_or(tid < 64 && mine);
  const int live1 = __syncthreads_or(tid >= 64 && tid < 128 && mine);
  bf16* obase = out + ((size_t)e * C + c0) * d + n0;
  const int rows = min(kBM, C - c0);
  if (!live0 && !live1) {
    zero_rows(obase, d, 0, rows, BN, tid, kThreads);
    return;
  }
  const int nk = h / kBK;

  if (wg == 0) {
    // ---------------- producer: one thread issues every TMA load
    hopper::regs_dealloc<40>();
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % ST;
        hopper::mbar_wait(&empty[st], ((kt / ST) & 1) ^ 1);
        unsigned char* as = smem + st * kDownStage;
        hopper::mbar_arrive_expect_tx(&full[st], kATile + NB * kBox);
        hopper::tma_load_3d(as, &tm_h, &full[st], kt * kBK, c0, e);
        for (int nb = 0; nb < NB; ++nb)
          hopper::tma_load_3d(as + kATile + nb * kBox, &tm_d, &full[st],
                              n0 + nb * 64, kt * kBK, e);
      }
    }
  } else {
    // ---------------- consumers: 64 slots each
    hopper::regs_alloc<232>();
    const int cw = wg - 1;
    const int wi = (tid / 32) & 3;
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    float acc[NA][64];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[a][i] = 0.f;
    if (cw ? live1 : live0) {
#pragma unroll
      for (int a = 0; a < NA; ++a) hopper::fence_regs(acc[a]);
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % ST;
        hopper::mbar_wait(&full[st], (kt / ST) & 1);
        const unsigned char* as = smem + st * kDownStage;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t da =
              hopper::desc_sw128(as + cw * 64 * 128 + kk * 32, 16);
#pragma unroll
          for (int a = 0; a < NA; ++a)
            hopper::wgmma_m64n128k16_ss_tb(
                acc[a], da,
                hopper::desc_sw128(
                    as + kATile + 2 * a * kBox + kk * 16 * 128, kBox),
                1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(kt - 1) % ST]);
      }
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < NA; ++a) hopper::fence_regs(acc[a]);
      if (lane == 0) hopper::mbar_arrive(&empty[(nk - 1) % ST]);
    } else {
      for (int kt = 0; kt < nk; ++kt) {
        hopper::mbar_wait(&full[kt % ST], (kt / ST) & 1);
        if (lane == 0) hopper::mbar_arrive(&empty[kt % ST]);
      }
    }
    // epilogue: masked stores; a sentinel slot's row is zero
    const int r = cw * 64 + wi * 16 + g;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = r + half * 8;
      if (rr < rows) {
        const bool keep = token_row(slot, e, c0 + rr, C, Tn) >= 0;
        bf16* dst = obase + (size_t)rr * d + 2 * t;
#pragma unroll
        for (int a = 0; a < NA; ++a)
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int i = 4 * j + 2 * half;
            *reinterpret_cast<uint32_t*>(dst + a * 128 + j * 8) =
                keep ? hopper::pack_bf16(acc[a][i], acc[a][i + 1]) : 0u;
          }
      }
    }
  }
}

template <int BN>
cudaError_t launch_down(const void* hmid, const void* slot, const void* wd,
                        void* out, int T, int E, int C, int d, int h,
                        cudaStream_t stream) {
  CUtensorMap mh, md;
  cudaError_t err = hopper::bf16_map_3d(&mh, hmid, h, C, E, kBM);
  if (err == cudaSuccess) err = hopper::bf16_map_3d(&md, wd, d, h, E, kBK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(expert_down_sm90<BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDownSmem);
  if (err != cudaSuccess) return err;
  const int grid = E * ((C + kBM - 1) / kBM) * (d / BN);
  expert_down_sm90<BN><<<grid, kThreads, kDownSmem, stream>>>(
      mh, md, static_cast<const int*>(slot), static_cast<__nv_bfloat16*>(out),
      T, C, d, h);
  return cudaGetLastError();
}

cudaError_t check_shape(int T, int E, int C, int d, int h) {
  if (T <= 0 || E <= 0 || C <= 0 || d <= 0 || h <= 0 || d % 128 || h % 128)
    return cudaErrorInvalidValue;
  const long long tiles = (long long)E * ((C + kBM - 1) / kBM);
  if (tiles * (h / 128) > INT_MAX || tiles * (d / 128) > INT_MAX)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// Each entry returns a cudaError_t code: 0 on a successful launch. None
// synchronises; a fault during the run shows at the caller's next sync.
extern "C" {

// hmid [E, C, h] = bf16(silu(x[slot] @ wg) * (x[slot] @ wu)), zero rows for
// sentinel slots. x [T, d]; slot [E*C] int32; wg, wu [E, d, h]; all bf16
// but slot.
int gather_gateup_sm90_launch(const void* x, const void* slot, const void* wg,
                              const void* wu, void* hmid, int T, int E, int C,
                              int d, int h, void* stream) {
  cudaError_t err = check_shape(T, E, C, d, h);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mg, mu;
  err = hopper::bf16_map_3d(&mg, wg, h, d, E, kBK);
  if (err == cudaSuccess) err = hopper::bf16_map_3d(&mu, wu, h, d, E, kBK);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gather_gateup_sm90,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kGateUpSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = E * ((C + kBM - 1) / kBM) * (h / kGateUpBN);
  gather_gateup_sm90<<<grid, kThreads, kGateUpSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      mg, mu, static_cast<const bf16*>(x), static_cast<const int*>(slot),
      static_cast<bf16*>(hmid), T, C, d, h);
  return (int)cudaGetLastError();
}

// out [E*C, d] = hmid[e, c] @ wd[e], zero rows for sentinel slots. hmid
// [E, C, h]; slot [E*C] int32; wd [E, h, d]; all bf16 but slot.
int expert_down_sm90_launch(const void* hmid, const void* slot,
                            const void* wd, void* out, int T, int E, int C,
                            int d, int h, void* stream) {
  const cudaError_t err = check_shape(T, E, C, d, h);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % kDownWideBN == 0)
    return (int)launch_down<kDownWideBN>(hmid, slot, wd, out, T, E, C, d, h,
                                         st);
  return (int)launch_down<128>(hmid, slot, wd, out, T, E, C, d, h, st);
}

// dynamic shared memory of a CTA: phase 0 gather_gateup, 1 expert_down
long gather_gemm_sm90_smem_bytes(int phase) {
  return phase == 0 ? (long)kGateUpSmem : (long)kDownSmem;
}

const char* gather_gemm_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
