// Flash-attention backward for Hopper (sm_90a) in bf16 and fp16: the dQ
// kernel and the dK/dV kernel, warp-specialised, TMA-fed, wgmma-computed.
// CUDA C++ with a plain C entry per kernel and element type.
//
// Replaces the TPU kernels of paddlepaddle_tpu/ops/kernels/flash_attention.py
// for bf16 or fp16 at head dims 64 and 128 (each kernel is templated on the
// element type T: the wgmma operand type, the tensor maps, the rounding of
// P and dS and the stores of dQ, dK and dV follow it):
//   flash_bwd_dq_sm90_kernel  <- _dq_kernel  :139 (pallas_call in
//                                _pallas_backward :268)
//   flash_bwd_dkv_sm90_kernel <- _dkv_kernel :172 (pallas_call :277)
// The f32 path stays on flash_bwd_dq_kernel / flash_bwd_dkv_kernel in
// flash_attention.cu (full-f32 FMA: wgmma would round f32 to TF32). Same
// function and contract as those kernels: q, dO [b, s_q, h, d] and k, v
// [b, s_k, h, d] read in place; lse and delta = rowsum(dO * O) f32
// [b*h, s_q] (lse in natural log, delta formed by the caller); query i sees
// key j when j <= i + (s_k - s_q) (bottom-right causal rule) or always;
// p = exp(s * scale - lse) in f32, ds = p (dp - delta) scale, dq = ds K,
// dk = ds^T q, dv = p^T dO with f32 accumulation, p and ds rounded to T
// before they feed a product; outputs in T; any length, the ragged last
// tiles masked. Every output row has one writer: no atomics, and the results
// are the same bits from launch to launch. In fp16 a value past 65504 (a
// loss-scaled dO can take dS, dQ, dK or dV there) becomes inf and is kept:
// that is what a dynamic loss scaler reads to skip the step.
//
// Design (both kernels):
//   * CTA = 3 warpgroups over 128 rows of one (b, h): warpgroup 0 is the
//     producer (setmaxnreg 24), warpgroups 1 and 2 the consumers of 64 rows
//     each (setmaxnreg 240). One producer thread issues every TMA load: the
//     CTA's own 128 rows of two operands once, then the other side's 64-row
//     tiles into a ring of stages, each guarded by a full barrier
//     (transaction bytes) and an empty barrier (the 8 consumer warps arrive
//     when done).
//   * TMA: tiled 4-D maps (d, h, s, b) over the [b, s, h, d] tensors
//     (hopper::bshd_map), boxes of 64 d by 64 or 128 positions stored as
//     [rows][64] with the 128-byte swizzle; positions past s_q or s_k are
//     zero-filled.
//   * P and dS are formed on the accumulator registers of the first two
//     products, rounded to T and fed straight to the next wgmma as its
//     register A operand (the m64nNk16 accumulator is the m16n8k16 A
//     fragment); that product's B operand is read N-major (trans-b) from
//     the swizzled tile. Nothing is staged through shared memory.
//   * dK/dV: the CTA owns 128 keys (keys are the wgmma M dimension); K and V
//     stay in shared memory, Q and dO stream in 64-query tiles through 2
//     stages. Per tile and consumer: S^T = K Q^T and dP^T = V dO^T (m64n64k16
//     SS, both operands K-major), P^T = exp2(S^T c - lse2[col]), dV += P^T dO
//     (RS) in flight while dS^T = P^T (dP^T - delta[col]) scale is formed,
//     then dK += dS^T Q (RS); the tile ends with every group retired, and
//     the two consumer warpgroups fill each other's gaps on the tensor
//     cores. (Issuing tile i + 1's S^T and dP^T before dK of tile i retires
//     made ptxas serialise the wgmmas, C7515, and was slower.) lse and delta
//     of the tile's queries are not 16-byte aligned rows in general
//     (s_q % 4 != 0), so a second producer warp copies them into shared
//     memory with 4-byte loads (lse in log2 units, and +1e30 past s_q so that
//     zero-filled queries give p = 0 whatever dO holds) and arrives on the
//     stage's full barrier. A consumer skips the tiles its keys cannot see;
//     the grid runs the first (heaviest causal) key tiles first.
//   * dQ: the CTA owns 128 queries (the M dimension); Q and dO stay in shared
//     memory and each consumer warp also holds its 16 rows of both as wgmma
//     A fragments (ldmatrix from the swizzled tiles, once), K and V stream in
//     64-key tiles through 3 stages, and each row's lse and delta sit in
//     registers. Per tile: S = Q K^T and dP = dO V^T (m64n64k16 RS, K and V
//     K-major: half the shared-memory reads of SS), dS in registers, dQ +=
//     dS K (RS, K read N-major). dQ of tile j is issued together with S and
//     dP of tile j + 1, and tile j + 1's P and dS are formed while it is in
//     flight; the last tile is peeled off the loop so that every step
//     commits the same three groups and every wait_group count is static. A
//     consumer stops at its rows' causal limit; the grid runs the last
//     (heaviest causal) query tiles first.
//
// Bound: at the training shape (b 4, s 2048, h 32, d 128, causal) the
// products are ~1000 operations a byte moved, far above the card's ridge
// (~295 for bf16): both kernels are bound by operations, 3U for dQ and 4U
// for dK/dV with U = 2 b h d x (visible pairs), against 989 TFLOP/s. What the
// design does about it: every product is a wgmma fed by TMA from a producer
// warp, both consumer warpgroups interleave on the tensor cores, causal tiles
// past the diagonal are never loaded or computed, and P and dS never leave
// the registers. Known limits: the dK/dV products are m64n64 (64 keys by 64
// queries a consumer, set by the register budget of two d x 64 f32
// accumulators), and their SS form reads as many shared-memory bytes as the
// tensor cores consume; each consumer's tile is a chain of dependent
// products; recomputing S and dP in both kernels costs 2U more than a kernel
// with an atomic dQ would.
//
// Limits checked by the Python wrapper before launch: bf16 or fp16, d in
// {64, 128},
// causal only with s_q <= s_k, b*h <= 65535, 16-byte aligned contiguous
// tensors.

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;               // rows a CTA (queries or keys)
constexpr int kConsumers = 2;          // consumer warpgroups, 64 rows each
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kDqBN = 64;              // keys a dQ tile (m64n64 RS for S)
constexpr int kDqStages = 3;
constexpr int kDkvBQ = 64;             // queries a dK/dV tile
constexpr int kDkvStages = 2;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kRowBytes = 64 * 2;  // one swizzled row: 64 2-byte values

// -------------------------------------------------------------------------
// dQ: one (b*h, 128-query tile), looping over key tiles

template <int D> struct DqCfg {
  static constexpr int kBlocks = D / 64;
  static constexpr uint32_t kResBytes = kBlocks * kBM * kRowBytes;     // Q, dO
  static constexpr uint32_t kTileBytes = kBlocks * kDqBN * kRowBytes;  // K, V
  static constexpr size_t kSmem = 2 * (size_t)kResBytes +
                                  2 * (size_t)kDqStages * kTileBytes +
                                  8 * (1 + 2 * kDqStages) + 1024;
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dq, int H, int Sq,
                         int Sk, float scale, int causal) {
  using C = DqCfg<D>;
  constexpr int NB = C::kBlocks, BN = kDqBN, ST = kDqStages;
  constexpr uint32_t kResBlock = kBM * kRowBytes, kTileBlock = BN * kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;                        // [NB][128][64]
  unsigned char* do_s = q_s + C::kResBytes;         // [NB][128][64]
  unsigned char* k_s = do_s + C::kResBytes;         // [ST][NB][BN][64]
  unsigned char* v_s = k_s + ST * C::kTileBytes;    // [ST][NB][BN][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + ST * C::kTileBytes);
  uint64_t* res_full = bars;
  uint64_t* full_bar = bars + 1;
  uint64_t* empty_bar = full_bar + ST;

  const int n_qt = (Sq + kBM - 1) / kBM;
  const int qi = n_qt - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = qi * kBM;
  const int off = Sk - Sq;
  const int n_kv = (Sk + BN - 1) / BN;
  const int n_visit =
      causal ? min(n_kv, (min(q0 + kBM, Sq) + off + BN - 1) / BN) : n_kv;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(res_full, 1);
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(&full_bar[i], 1);
      hopper::mbar_init(&empty_bar[i], kConsumers * 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer: one thread issues every TMA load
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(res_full, 2 * C::kResBytes);
      for (int blk = 0; blk < NB; ++blk) {
        hopper::tma_load_4d(q_s + blk * kResBlock, &tm_q, res_full, blk * 64,
                            h, q0, b);
        hopper::tma_load_4d(do_s + blk * kResBlock, &tm_do, res_full,
                            blk * 64, h, q0, b);
      }
      for (int j = 0; j < n_visit; ++j) {
        const int st = j % ST;
        hopper::mbar_wait(&empty_bar[st], ((j / ST) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full_bar[st], 2 * C::kTileBytes);
        for (int blk = 0; blk < NB; ++blk) {
          hopper::tma_load_4d(k_s + (st * NB + blk) * kTileBlock, &tm_k,
                              &full_bar[st], blk * 64, h, j * BN, b);
          hopper::tma_load_4d(v_s + (st * NB + blk) * kTileBlock, &tm_v,
                              &full_bar[st], blk * 64, h, j * BN, b);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each
    hopper::regs_alloc<240>();
    const int cw = wg - 1;
    const int wi = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r0 = q0 + cw * 64;                // this warpgroup's first row
    const int row0 = r0 + wi * 16 + g;          // this thread's rows: +0, +8
    const float sl2 = scale * kLog2e;
    float nl[2], dl[2];                         // -lse (log2 units), delta
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      nl[r] = row < Sq ? -lse[(size_t)bh * Sq + row] * kLog2e : kNegInf;
      dl[r] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
    }
    // key tiles this warpgroup's rows can see (none for rows past s_q)
    const int n_c =
        r0 >= Sq ? 0
                 : causal ? min(n_kv, (min(r0 + 64, Sq) + off + BN - 1) / BN)
                          : n_kv;

    float acc[NB][32];
#pragma unroll
    for (int blk = 0; blk < NB; ++blk)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[blk][i] = 0.f;
    float s[BN / 2], dp[BN / 2];       // S and dP of the tile in flight
    uint32_t da[BN / 16][4];           // dS in T: A fragments

    uint32_t qa[NB][4][4], doa[NB][4][4];   // this warp's Q and dO rows

    // S = Q K^T and dP = dO V^T of key tile j (two commit groups), Q and dO
    // from registers
    auto issue_s_dp = [&](int j) {
      const unsigned char* kt = k_s + (j % ST) * NB * kTileBlock;
      const unsigned char* vt = v_s + (j % ST) * NB * kTileBlock;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_m64n64k16_rs_kmajor<T>(
            s, qa[kk / 4][kk % 4],
            hopper::desc_sw128(kt + (kk / 4) * kTileBlock + (kk % 4) * 32, 16),
            kk > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_m64n64k16_rs_kmajor<T>(
            dp, doa[kk / 4][kk % 4],
            hopper::desc_sw128(vt + (kk / 4) * kTileBlock + (kk % 4) * 32, 16),
            kk > 0);
      hopper::wgmma_commit();
    };
    // dQ += dS K of key tile j (one commit group)
    auto issue_dq = [&](int j) {
      hopper::wgmma_rs_acc<NB, BN / 16, T>(
          acc, da, k_s + (j % ST) * NB * kTileBlock, kTileBlock);
      hopper::wgmma_commit();
    };
    // s -> P, masked where the tile needs it (uniform across the warpgroup)
    auto probs = [&](int j) {
      const bool whole = (j + 1) * BN <= Sk &&
                         (!causal || (j + 1) * BN - 1 <= r0 + off);
#pragma unroll
      for (int jb = 0; jb < BN / 8; ++jb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p =
              hopper::fast_exp2(fmaf(s[4 * jb + e], sl2, nl[e >> 1]));
          if (!whole) {
            const int col = j * BN + jb * 8 + 2 * t + (e & 1);
            const int row = row0 + (e >> 1) * 8;
            if (!(col < Sk && (!causal || col <= row + off))) p = 0.f;
          }
          s[4 * jb + e] = p;
        }
    };
    // dS = P (dP - delta) scale, in dp
    auto grads = [&]() {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]) * scale;
    };

    hopper::mbar_wait(res_full, 0);
#pragma unroll
    for (int blk = 0; blk < NB; ++blk) {
      hopper::a_frags_sw128(qa[blk], q_s + blk * kResBlock,
                            cw * 64 + wi * 16, lane);
      hopper::a_frags_sw128(doa[blk], do_s + blk * kResBlock,
                            cw * 64 + wi * 16, lane);
    }
    if (n_c > 0) {
      hopper::mbar_wait(&full_bar[0], 0);
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      issue_s_dp(0);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);
      probs(0);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
      grads();
      hopper::to_a_frags<BN, T>(dp, da);
      // every step but the last commits S, dP of tile j + 1 and dQ of tile
      // j, so the wait counts below are static
      for (int j = 0; j + 1 < n_c; ++j) {
        hopper::mbar_wait(&full_bar[(j + 1) % ST], ((j + 1) / ST) & 1);
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        hopper::fence_acc(acc);
        hopper::wgmma_fence();
        issue_s_dp(j + 1);
        issue_dq(j);
        hopper::wgmma_wait<2>();               // S of tile j + 1 is in
        hopper::fence_regs(s);
        probs(j + 1);
        hopper::wgmma_wait<1>();               // dP of tile j + 1 is in
        hopper::fence_regs(dp);
        grads();
        hopper::wgmma_wait<0>();               // dQ of tile j is in
        hopper::fence_acc(acc);
        if (lane == 0) hopper::mbar_arrive(&empty_bar[j % ST]);
        hopper::to_a_frags<BN, T>(dp, da);
      }
      const int j = n_c - 1;                   // the last tile's dQ
      hopper::fence_acc(acc);
      hopper::wgmma_fence();
      issue_dq(j);
      hopper::wgmma_wait<0>();
      hopper::fence_acc(acc);
      if (lane == 0) hopper::mbar_arrive(&empty_bar[j % ST]);
    }
    // tiles the CTA loads for the other warpgroup's rows only
    for (int j = n_c; j < n_visit; ++j) {
      hopper::mbar_wait(&full_bar[j % ST], (j / ST) & 1);
      if (lane == 0) hopper::mbar_arrive(&empty_bar[j % ST]);
    }

    hopper::store_rows<NB>(dq + ((size_t)b * Sq * H + h) * D, (size_t)H * D,
                           row0, Sq, t, acc);
  }
}

// -------------------------------------------------------------------------
// dK/dV: one (b*h, 128-key tile), looping over query tiles from the causal
// start

template <int D> struct DkvCfg {
  static constexpr int kBlocks = D / 64;
  static constexpr uint32_t kResBytes = kBlocks * kBM * kRowBytes;     // K, V
  static constexpr uint32_t kTileBytes = kBlocks * kDkvBQ * kRowBytes; // Q, dO
  static constexpr size_t kSmem = 2 * (size_t)kResBytes +
                                  2 * (size_t)kDkvStages * kTileBytes +
                                  2 * kDkvStages * kDkvBQ * 4 +
                                  8 * (1 + 2 * kDkvStages) + 1024;
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int H,
                          int Sq,
                          int Sk, float scale, int causal) {
  using C = DkvCfg<D>;
  constexpr int NB = C::kBlocks, BQ = kDkvBQ, ST = kDkvStages;
  constexpr uint32_t kResBlock = kBM * kRowBytes, kTileBlock = BQ * kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* k_s = smem;                        // [NB][128][64]
  unsigned char* v_s = k_s + C::kResBytes;          // [NB][128][64]
  unsigned char* q_s = v_s + C::kResBytes;          // [ST][NB][BQ][64]
  unsigned char* do_s = q_s + ST * C::kTileBytes;   // [ST][NB][BQ][64]
  float* lse_s = reinterpret_cast<float*>(do_s + ST * C::kTileBytes);  // [ST][BQ]
  float* dl_s = lse_s + ST * BQ;                                       // [ST][BQ]
  uint64_t* bars = reinterpret_cast<uint64_t*>(dl_s + ST * BQ);
  uint64_t* res_full = bars;
  uint64_t* full_bar = bars + 1;
  uint64_t* empty_bar = full_bar + ST;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * kBM;
  const int off = Sk - Sq;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int start = causal ? max(k0 - off, 0) / BQ : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(res_full, 1);
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(&full_bar[i], 1 + 32);   // TMA thread + lse warp
      hopper::mbar_init(&empty_bar[i], kConsumers * 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer: one thread issues every TMA load, warp 1
    // copies each tile's lse and delta
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(res_full, 2 * C::kResBytes);
      for (int blk = 0; blk < NB; ++blk) {
        hopper::tma_load_4d(k_s + blk * kResBlock, &tm_k, res_full, blk * 64,
                            h, k0, b);
        hopper::tma_load_4d(v_s + blk * kResBlock, &tm_v, res_full, blk * 64,
                            h, k0, b);
      }
      for (int i = start; i < n_qt; ++i) {
        const int n = i - start, st = n % ST;
        hopper::mbar_wait(&empty_bar[st], ((n / ST) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full_bar[st], 2 * C::kTileBytes);
        for (int blk = 0; blk < NB; ++blk) {
          hopper::tma_load_4d(q_s + (st * NB + blk) * kTileBlock, &tm_q,
                              &full_bar[st], blk * 64, h, i * BQ, b);
          hopper::tma_load_4d(do_s + (st * NB + blk) * kTileBlock, &tm_do,
                              &full_bar[st], blk * 64, h, i * BQ, b);
        }
      }
    } else if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x & 31;
      const float* lse_row = lse + (size_t)bh * Sq;
      const float* dl_row = delta + (size_t)bh * Sq;
      for (int i = start; i < n_qt; ++i) {
        const int n = i - start, st = n % ST;
        hopper::mbar_wait(&empty_bar[st], ((n / ST) & 1) ^ 1);
#pragma unroll
        for (int c = lane; c < BQ; c += 32) {
          const int col = i * BQ + c;
          // queries past s_q: p = 2^(s c - 1e30) = 0
          lse_s[st * BQ + c] = col < Sq ? lse_row[col] * kLog2e : 1e30f;
          dl_s[st * BQ + c] = col < Sq ? dl_row[col] : 0.f;
        }
        hopper::mbar_arrive(&full_bar[st]);
      }
    }
  } else {
    // ---------------- consumers: 64 keys each
    hopper::regs_alloc<240>();
    const int cw = wg - 1;
    const int wi = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int key0 = k0 + cw * 64;              // this warpgroup's first key
    const int key_r = key0 + wi * 16 + g;       // this thread's keys: +0, +8
    const float sl2 = scale * kLog2e;
    // the first query tile with a query that sees one of this warpgroup's
    // keys (none for keys past s_k)
    const int start_c =
        key0 >= Sk ? n_qt : causal ? max(key0 - off, 0) / BQ : 0;

    float dk_acc[NB][32], dv_acc[NB][32];
#pragma unroll
    for (int blk = 0; blk < NB; ++blk)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[blk][i] = dv_acc[blk][i] = 0.f;
    float s[BQ / 2], dp[BQ / 2];       // S^T and dP^T of the tile
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];   // P^T, dS^T in T

    hopper::mbar_wait(res_full, 0);
    for (int i = start; i < n_qt; ++i) {
      const int n = i - start, st = n % ST;
      hopper::mbar_wait(&full_bar[st], (n / ST) & 1);
      if (i >= start_c) {
        const unsigned char* qt = q_s + st * NB * kTileBlock;
        const unsigned char* dot = do_s + st * NB * kTileBlock;
        // S^T = K Q^T and dP^T = V dO^T (two commit groups)
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int blk = kk / 4, kin = (kk % 4) * 32;
          hopper::wgmma_m64n64k16_ss<T>(
              s,
              hopper::desc_sw128(k_s + blk * kResBlock +
                                     cw * 64 * kRowBytes + kin, 16),
              hopper::desc_sw128(qt + blk * kTileBlock + kin, 16), kk > 0);
        }
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int blk = kk / 4, kin = (kk % 4) * 32;
          hopper::wgmma_m64n64k16_ss<T>(
              dp,
              hopper::desc_sw128(v_s + blk * kResBlock +
                                     cw * 64 * kRowBytes + kin, 16),
              hopper::desc_sw128(dot + blk * kTileBlock + kin, 16), kk > 0);
        }
        hopper::wgmma_commit();

        // P^T = 2^(S^T c - lse2[col]); the causal mask only on tiles at the
        // diagonal (uniform across the warpgroup)
        const float* ls = lse_s + st * BQ;
        const float* dls = dl_s + st * BQ;
        const bool diag = causal && i * BQ + off < key0 + 63;
        hopper::wgmma_wait<1>();               // S^T is in
        hopper::fence_regs(s);
#pragma unroll
        for (int jb = 0; jb < BQ / 8; ++jb) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(ls + jb * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = hopper::fast_exp2(
                fmaf(s[4 * jb + e], sl2, -((e & 1) ? l2.y : l2.x)));
            if (diag) {
              const int col = i * BQ + jb * 8 + 2 * t + (e & 1);
              if (col + off < key_r + (e >> 1) * 8) p = 0.f;
            }
            s[4 * jb + e] = p;
          }
        }
        hopper::to_a_frags<BQ, T>(s, pa);
        // dV += P^T dO, in flight while dS^T is formed
        hopper::fence_acc(dv_acc);
        hopper::wgmma_fence();
        hopper::wgmma_rs_acc<NB, BQ / 16, T>(dv_acc, pa, dot, kTileBlock);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();               // dP^T is in
        hopper::fence_regs(dp);
#pragma unroll
        for (int jb = 0; jb < BQ / 8; ++jb) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(dls + jb * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * jb + e] = s[4 * jb + e] *
                             (dp[4 * jb + e] - ((e & 1) ? d2.y : d2.x)) *
                             scale;
        }
        hopper::to_a_frags<BQ, T>(dp, da);
        // dK += dS^T Q
        hopper::fence_acc(dk_acc);
        hopper::wgmma_fence();
        hopper::wgmma_rs_acc<NB, BQ / 16, T>(dk_acc, da, qt, kTileBlock);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_acc(dk_acc);
        hopper::fence_acc(dv_acc);
      }
      if (lane == 0) hopper::mbar_arrive(&empty_bar[st]);
    }

    const size_t base = ((size_t)b * Sk * H + h) * D;
    hopper::store_rows<NB>(dk + base, (size_t)H * D, key_r, Sk, t, dk_acc);
    hopper::store_rows<NB>(dv + base, (size_t)H * D, key_r, Sk, t, dv_acc);
  }
}

// -------------------------------------------------------------------------
// launches

template <int D, typename T>
cudaError_t maps(CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv,
                 CUtensorMap* mdo, const void* q, const void* k,
                 const void* v, const void* dout, int B, int H, int Sq,
                 int Sk, int q_rows, int k_rows) {
  constexpr CUtensorMapDataType ty = hopper::tma_type<T>();
  cudaError_t e = hopper::bshd_map(mq, q, B, Sq, H, D, q_rows, ty);
  if (e == cudaSuccess)
    e = hopper::bshd_map(mdo, dout, B, Sq, H, D, q_rows, ty);
  if (e == cudaSuccess) e = hopper::bshd_map(mk, k, B, Sk, H, D, k_rows, ty);
  if (e == cudaSuccess) e = hopper::bshd_map(mv, v, B, Sk, H, D, k_rows, ty);
  return e;
}

template <int D, typename T>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int H, int Sq, int Sk, float scale,
                   int causal, cudaStream_t st) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e =
      maps<D, T>(&mq, &mk, &mv, &mdo, q, k, v, dout, B, H, Sq, Sk, kBM, kDqBN);
  if (e != cudaSuccess) return e;
  auto kern = flash_bwd_dq_sm90_kernel<D, T>;
  constexpr size_t smem = DqCfg<D>::kSmem;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kBM - 1) / kBM, B * H);
  kern<<<grid, kThreads, smem, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), H, Sq, Sk, scale,
      causal);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int H, int Sq, int Sk,
                    float scale, int causal, cudaStream_t st) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e =
      maps<D, T>(&mq, &mk, &mv, &mdo, q, k, v, dout, B, H, Sq, Sk, kDkvBQ,
                 kBM);
  if (e != cudaSuccess) return e;
  auto kern = flash_bwd_dkv_sm90_kernel<D, T>;
  constexpr size_t smem = DkvCfg<D>::kSmem;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sk + kBM - 1) / kBM, B * H);
  kern<<<grid, kThreads, smem, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Sq, int Sk, int causal) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B * H > 65535 ||
         (causal && Sq > Sk);
}

template <typename T>
int dq_launch(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int H,
              int Sq, int Sk, int D, float scale, int causal, void* stream) {
  if (bad_shape(B, H, Sq, Sk, causal)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)bwd_dq<64, T>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, scale, causal, st);
  if (D == 128) return (int)bwd_dq<128, T>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int Sq, int Sk, int D, float scale, int causal,
               void* stream) {
  if (bad_shape(B, H, Sq, Sk, causal)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)bwd_dkv<64, T>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, scale, causal, st);
  if (D == 128) return (int)bwd_dkv<128, T>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each entry returns a cudaError_t code: 0 on a successful launch. None
// synchronises. Tensors are contiguous [b, s, h, d] of the entry's type,
// bf16 or fp16 (q, dout, dq: s = Sq; k, v, dk, dv: s = Sk); lse and delta
// are f32 [b*h, Sq].
extern "C" {

int flash_bwd_dq_sm90_launch(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int B, int H,
                             int Sq, int Sk, int D, float scale, int causal,
                             void* stream) {
  return dq_launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk,
                                  D, scale, causal, stream);
}

int flash_bwd_dq_sm90_fp16_launch(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, int B, int H, int Sq, int Sk,
                                  int D, float scale, int causal,
                                  void* stream) {
  return dq_launch<__half>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, D,
                           scale, causal, stream);
}

int flash_bwd_dkv_sm90_launch(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int B,
                              int H, int Sq, int Sk, int D, float scale,
                              int causal, void* stream) {
  return dkv_launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                   Sq, Sk, D, scale, causal, stream);
}

int flash_bwd_dkv_sm90_fp16_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int H, int Sq,
                                   int Sk, int D, float scale, int causal,
                                   void* stream) {
  return dkv_launch<__half>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk,
                            D, scale, causal, stream);
}

const char* flash_bwd_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
