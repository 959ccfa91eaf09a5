// Packed varlen flash attention for Hopper (sm_90a) in bf16: the forward and
// the dK/dV kernel, warp-specialised, TMA-fed, wgmma-computed. CUDA C++ with
// a plain C entry per kernel.
//
// Replaces the TPU kernels of paddlepaddle_tpu/ops/kernels/flash_varlen.py
// for bf16 at head dims 64 and 128:
//   varlen_fwd_sm90_kernel     <- _vfwd_kernel :123 (pallas_call in
//                                 _varlen_pallas_fwd :233)
//   varlen_bwd_dkv_sm90_kernel <- _vdkv_kernel :184 (pallas_call in
//                                 _varlen_pallas_bwd :284)
// The bf16 dQ and every f32 kernel stay in flash_varlen.cu. Same function
// and contract as those kernels: q [tq, h, d] and k/v [tk, h, d] hold packed
// sequences bounded by the int32 prefix sums cu_q, cu_k [B + 1] on the
// device (never read back); query row i of segment s sees key j when j lies
// in segment s of k and, causal, j <= i + (cu_k[s+1] - cu_q[s+1]) (the
// per-segment bottom-right rule). Rows at or past cu_q[B] and rows that see
// no key get out exactly 0 and lse exactly -1e30; keys that no row sees get
// dK and dV exactly 0. lse and delta are f32 [h, tq], lse in natural log;
// the backward recomputes p = exp(s * scale - lse) on visible pairs and
// forms ds = p (dp - delta) scale. Every output row has one writer: no
// atomics, the same bits from launch to launch.
//
// Design: the dense pair's (flash_fwd_sm90.cu, flash_bwd_sm90.cu
// flash_bwd_dkv_sm90_kernel) over the packed layout read as [1, t, h, d]:
//   * CTA = 3 warpgroups over 128 rows of one head: warpgroup 0 the TMA
//     producer (setmaxnreg down), warpgroups 1 and 2 consumers of 64 rows
//     each (setmaxnreg up). Tiled 4-D maps (hopper::bshd_map, b = 1), boxes
//     of 64 d by 64 or 128 rows with the 128-byte swizzle, zero-filled past
//     t; a box may start at any row.
//   * Before the role split the producer warpgroup binary-searches the
//     prefix sums for the ranges of the CTA's 128 rows, one row a thread
//     (varlen_ranges.cuh), while the TMA load of the CTA's own rows (Q, or
//     K and V) is already in flight, and leaves, for each consumer's 64
//     rows, the union [x, y) and the intersection [z, w) of their ranges in
//     shared memory. The CTA streams the tiles of the
//     union of both, starting at its first visible column, not at a
//     multiple of the tile; a consumer computes the tiles that meet its own
//     union and passes the others on. Each consumer thread keeps its two
//     rows' [lo, hi) in registers.
//   * Only a tile outside the consumer's intersection (a segment boundary,
//     the causal diagonal, a row without a range, the end of the union)
//     compares each element with its row's range; a masked probability is
//     selected to 0, never exp(s - m) times a mask (a row without a key has
//     m = -1e30, and any leak would give inf or NaN). The forward tests
//     each element once: a visible logit is scaled there, a masked one
//     becomes -inf, and 2^(-inf - m) is exactly 0 for the finite m every
//     row keeps.
//   * The grid runs heads fastest, (h, row tile): the CTAs in flight work
//     on the same rows of every head, so the K and V (Q and dO) tiles they
//     stream share segments and stay in L2.
//   * Forward: 128-key tiles through a ring of 3 stages with separate K and
//     V full barriers; S = Q K^T by wgmma m64n128k16 SS, the online softmax
//     in log2 units on the accumulator registers, P rounded to bf16 in
//     registers for O += P V (m64n64k16 RS, V read N-major); S of tile j + 1
//     is issued with P V of tile j. Rows with an empty range write 0 and an
//     lse of -1e30.
//   * dK/dV: the CTA owns 128 keys, K and V resident; Q and dO stream in
//     64-query tiles through 2 stages; S^T = K Q^T and dP^T = V dO^T by
//     m64n64k16 SS, dV += P^T dO and dK += dS^T Q by RS with P^T and dS^T in
//     registers. A second producer warp copies each tile's lse (log2 units)
//     and delta with 4-byte loads (a segment starts at any row, so these
//     rows are not 16-byte aligned) and arrives on the stage's full barrier.
//
// Bound: at a packed training batch of Llama-3-8B attention (t 8256, h 32,
// d 128, causal segments of 64-2048 tokens) the visible pairs take 4d
// (forward) and 8d (dK/dV) operations a pair, ~1000 operations a byte
// moved: both kernels are bound by operations against 989 TFLOP/s. What
// limits them beyond the dense kernels' limits: tiles at segment ends and
// diagonals are computed whole and masked (the mask's compares cost ~8% of
// each kernel at that batch), a CTA's work follows its segments' lengths
// (2080 CTAs of 1 to 16 tiles in a ragged last wave; running the longest
// first, from a plan over the prefix sums, was slower, as the CTAs in
// flight then read the keys of different segments), and a CTA whose rows
// span two segments streams the keys of both.
//
// Limits checked by the Python wrapper before launch: bf16, d in {64, 128},
// h <= 65535, len(cu_q) == len(cu_k), tq, tk >= 1, 16-byte aligned
// contiguous tensors; by the C entry: at most 65535 row tiles of 128 (they
// ride the grid's y dimension).

#include "hopper.cuh"
#include "varlen_ranges.cuh"

namespace {

constexpr int kBM = 128;               // rows a CTA (queries or keys)
constexpr int kConsumers = 2;          // consumer warpgroups, 64 rows each
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kFwdBN = 128;            // keys a forward tile
constexpr int kFwdStages = 3;
constexpr int kDkvBQ = 64;             // queries a dK/dV tile
constexpr int kDkvStages = 2;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr uint32_t kRowBytes = 64 * 2;  // one swizzled row: 64 bf16

// the tiles [first, last) of a stream of `bn`-wide tiles from column x that
// meet the range [lo, hi); none for an empty range
__device__ __forceinline__ int2 tiles_meeting(int x, int bn, int lo, int hi) {
  if (lo >= hi) return make_int2(0, 0);
  return make_int2((lo - x) / bn, (hi - x + bn - 1) / bn);
}

// The ranges of the CTA's kBM rows r0 + r, searched by the producer
// warpgroup, one row a thread: warp w leaves the span of rows
// [32 w, 32 w + 32) in parts[w] (shared memory). After a __syncthreads,
// sp[c] is the union (x, y) and the intersection (z, w) over consumer c's
// 64 rows.
template <bool QUERY_ROWS>
__device__ __forceinline__ void cta_spans(int4* parts, int4 (&sp)[kConsumers],
                                          const int* __restrict__ cu_q,
                                          const int* __restrict__ cu_k,
                                          int nseg, int Tq, int Tk,
                                          int causal, int r0) {
  if (threadIdx.x < 128) {
    __syncwarp();
    const int w = threadIdx.x / 32;
    varlen::row_spans<32, QUERY_ROWS>(nullptr, nullptr, parts + w, cu_q,
                                      cu_k, nseg, Tq, Tk, causal,
                                      r0 + 32 * w);
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kConsumers; ++c) {
    const int4 a = parts[2 * c], b = parts[2 * c + 1];
    sp[c] = make_int4(min(a.x, b.x), max(a.y, b.y), max(a.z, b.z),
                      min(a.w, b.w));
  }
}

// -------------------------------------------------------------------------
// forward: out and lse for one (head, 128-row packed query tile)

template <int D> struct FwdCfg {
  static constexpr int kBlocks = D / 64;            // 64-wide d blocks
  static constexpr uint32_t kBlockBytes = kBM * kRowBytes;   // [128][64]
  static constexpr uint32_t kTileBytes = kBlocks * kBlockBytes;
  // Q, then K stages, then V stages, then the partial spans and the
  // barriers; 1024-byte aligned
  static constexpr size_t kSmem = (size_t)(1 + 2 * kFwdStages) * kTileBytes +
                                  sizeof(int4) * 4 +
                                  8 * (1 + 3 * kFwdStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
varlen_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, const int* __restrict__ cu_q,
                       const int* __restrict__ cu_k, int nseg, int H, int Tq,
                       int Tk, float scale, int causal) {
  using C = FwdCfg<D>;
  constexpr int NB = C::kBlocks, ST = kFwdStages, BN = kFwdBN;
  constexpr uint32_t kBlock = C::kBlockBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;                                   // [NB][128][64]
  unsigned char* k_s = q_s + C::kTileBytes;                    // [ST][NB][128][64]
  unsigned char* v_s = k_s + ST * C::kTileBytes;               // [ST][NB][128][64]
  int4* parts = reinterpret_cast<int4*>(v_s + ST * C::kTileBytes);  // [4]
  uint64_t* bars = reinterpret_cast<uint64_t*>(parts + 4);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * kBM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(&k_full[i], 1);
      hopper::mbar_init(&v_full[i], 1);
      hopper::mbar_init(&empty[i], kConsumers * 4);
    }
    hopper::mbar_fence_init();
    // Q does not depend on the ranges: its load overlaps their search
    hopper::mbar_arrive_expect_tx(q_full, C::kTileBytes);
    for (int blk = 0; blk < NB; ++blk)
      hopper::tma_load_4d(q_s + blk * kBlock, &tm_q, q_full, blk * 64, h, q0,
                          0);
  }
  int4 sp[kConsumers];
  cta_spans<true>(parts, sp, cu_q, cu_k, nseg, Tq, Tk, causal, q0);
  // the CTA streams the keys of the union of both consumers' rows
  const int x = min(sp[0].x, sp[1].x), y = max(sp[0].y, sp[1].y);
  const int n_visit = x < y ? (y - x + BN - 1) / BN : 0;

  if (wg == 0) {
    // ---------------- producer: one thread issues every TMA load
    hopper::regs_dealloc<40>();
    // with no key to visit no consumer waits for Q: it must land before the
    // CTA exits
    if (threadIdx.x == 0 && n_visit == 0) hopper::mbar_wait(q_full, 0);
    if (threadIdx.x == 0) {
      for (int j = 0; j < n_visit; ++j) {
        const int st = j % ST;
        hopper::mbar_wait(&empty[st], ((j / ST) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&k_full[st], C::kTileBytes);
        for (int blk = 0; blk < NB; ++blk)
          hopper::tma_load_4d(k_s + (st * NB + blk) * kBlock, &tm_k,
                              &k_full[st], blk * 64, h, x + j * BN, 0);
        hopper::mbar_arrive_expect_tx(&v_full[st], C::kTileBytes);
        for (int blk = 0; blk < NB; ++blk)
          hopper::tma_load_4d(v_s + (st * NB + blk) * kBlock, &tm_v,
                              &v_full[st], blk * 64, h, x + j * BN, 0);
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each
    hopper::regs_alloc<232>();
    const int cw = wg - 1;                    // consumer index
    const int wi = (threadIdx.x / 32) & 3;    // warp within the warpgroup
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int row0 = q0 + cw * 64 + wi * 16 + g;   // this thread's rows: +0, +8
    const float sl2 = scale * kLog2e;
    int lo[2], hi[2];                         // the keys each row sees
    // this warpgroup's tiles [j0, j1) and the intersection [z, w) of its
    // rows' ranges, where no element needs the mask
    const int4 span = cw == 0 ? sp[0] : sp[1];
    const int2 own = tiles_meeting(x, BN, span.x, span.y);
    const int j0 = own.x, j1 = own.y;

    float o[NB][32];
#pragma unroll
    for (int blk = 0; blk < NB; ++blk)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[blk][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // l: this thread's part

    float s[64];          // S of the tile in flight, then its probabilities
    uint32_t pa[8][4];    // P in bf16: A fragments of the 8 16-key steps

    // S = Q K^T of key tile j over d in 16-wide steps (one commit group)
    auto issue_qk = [&](int j) {
      const int st = j % ST;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int blk = kk / 4, kin = (kk % 4) * 32;        // bytes into a row
        const uint64_t da = hopper::desc_sw128(
            q_s + blk * kBlock + cw * 64 * kRowBytes + kin, 16);
        const uint64_t db =
            hopper::desc_sw128(k_s + (st * NB + blk) * kBlock + kin, 16);
        hopper::wgmma_m64n128k16_ss(s, da, db, kk > 0);
      }
      hopper::wgmma_commit();
    };
    // O += P V of key tile j in 16-key steps (one commit group)
    auto issue_pv = [&](int j) {
      hopper::wgmma_rs_acc<NB, BN / 16>(o, pa, v_s + (j % ST) * NB * kBlock,
                                        kBlock);
      hopper::wgmma_commit();
    };
    // online softmax of tile j on s, in log2 units: s becomes the
    // probabilities, m and l move on, and alpha rescales what O holds. Only
    // a tile outside the intersection (uniform across the warpgroup) tests
    // its elements, once: a visible logit is scaled there and a masked one
    // becomes -inf, whose 2^(-inf - m) is exactly 0 for the finite m every
    // row keeps (-1e30 until it sees a key)
    auto softmax = [&](int j, float (&alpha)[2]) {
      const int c0 = x + j * BN;
      const bool full = c0 >= span.z && c0 + BN <= span.w;
      float mx[2] = {kNegInf, kNegInf};
      if (full) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      } else {
        // column c0 + 8 jb + 2t + (e & 1) is visible to row r when
        // 8 jb + (e & 1) lies in [lo[r] - c0 - 2t, hi[r] - c0 - 2t)
        const int b_lo[2] = {lo[0] - c0 - 2 * t, lo[1] - c0 - 2 * t};
        const int b_hi[2] = {hi[0] - c0 - 2 * t, hi[1] - c0 - 2 * t};
        const float minus_inf = __int_as_float(0xff800000);
#pragma unroll
        for (int jb = 0; jb < 16; ++jb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = jb * 8 + (e & 1), r = e >> 1;
            const float v = k >= b_lo[r] && k < b_hi[r]
                                ? s[4 * jb + e] * sl2 : minus_inf;
            s[4 * jb + e] = v;
            mx[r] = fmaxf(mx[r], v);
          }
      }
      const float c = full ? sl2 : 1.f;       // s's scale in log2 units
      float nm[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = mx[r];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const float m_new = fmaxf(m[r], v * c);
        alpha[r] = hopper::fast_exp2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
        nm[r] = -m_new;
      }
#pragma unroll
      for (int jb = 0; jb < 16; ++jb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              hopper::fast_exp2(fmaf(s[4 * jb + e], c, nm[e >> 1]));
          s[4 * jb + e] = p;
          l[e >> 1] += p;
        }
    };
    // a tile this warpgroup's rows do not see: wait for it, pass it on
    auto pass = [&](int j) {
      hopper::mbar_wait(&k_full[j % ST], (j / ST) & 1);
      hopper::mbar_wait(&v_full[j % ST], (j / ST) & 1);
      if (lane == 0) hopper::mbar_arrive(&empty[j % ST]);
    };

    for (int j = 0; j < j0; ++j) pass(j);
    if (j0 < j1) {
      // Tile j0's S and softmax; then each step issues S of tile j + 1 and
      // O += P V of tile j together, runs tile j + 1's softmax while P V is
      // in flight, and rescales O once P V has landed.
      float alpha[2];
      hopper::mbar_wait(q_full, 0);
      hopper::mbar_wait(&k_full[j0 % ST], (j0 / ST) & 1);
      hopper::fence_regs(s);
      hopper::wgmma_fence();
      issue_qk(j0);
      // the rows' ranges, searched while the first S is in flight
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int2 a = varlen::keys_of_query(cu_q, cu_k, nseg, Tq, Tk,
                                             causal, row0 + r * 8);
        lo[r] = a.x;
        hi[r] = a.y;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      softmax(j0, alpha);
      hopper::to_a_frags<BN>(s, pa);
      // every step but the last issues two commit groups, so wait<1> is
      // known to retire S while P V stays in flight
      for (int j = j0; j + 1 < j1; ++j) {
        hopper::mbar_wait(&k_full[(j + 1) % ST], ((j + 1) / ST) & 1);
        hopper::mbar_wait(&v_full[j % ST], (j / ST) & 1);
        hopper::fence_regs(s);
        hopper::fence_acc(o);
        hopper::wgmma_fence();
        issue_qk(j + 1);
        hopper::wgmma_fence();
        issue_pv(j);
        hopper::wgmma_wait<1>();               // S of tile j + 1 is in
        hopper::fence_regs(s);
        softmax(j + 1, alpha);
        hopper::wgmma_wait<0>();               // P V of tile j is in
        hopper::fence_acc(o);
        if (lane == 0) hopper::mbar_arrive(&empty[j % ST]);
#pragma unroll
        for (int blk = 0; blk < NB; ++blk)
#pragma unroll
          for (int jb = 0; jb < 8; ++jb) {
            o[blk][4 * jb + 0] *= alpha[0];
            o[blk][4 * jb + 1] *= alpha[0];
            o[blk][4 * jb + 2] *= alpha[1];
            o[blk][4 * jb + 3] *= alpha[1];
          }
        hopper::to_a_frags<BN>(s, pa);
      }
      const int j = j1 - 1;                    // the last tile's P V
      hopper::mbar_wait(&v_full[j % ST], (j / ST) & 1);
      hopper::fence_acc(o);
      hopper::wgmma_fence();
      issue_pv(j);
      hopper::wgmma_wait<0>();
      hopper::fence_acc(o);
      if (lane == 0) hopper::mbar_arrive(&empty[j % ST]);
    }
    for (int j = j1; j < n_visit; ++j) pass(j);

    // epilogue: rows row0 and row0 + 8, straight from the registers; a row
    // that saw no key has l == 0 and o == 0: out 0, lse -1e30
    float lt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = l[r];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      lt[r] = v;
    }
    const float inv0 = 1.f / fmaxf(lt[0], 1e-30f);
    const float inv1 = 1.f / fmaxf(lt[1], 1e-30f);
#pragma unroll
    for (int blk = 0; blk < NB; ++blk)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        o[blk][4 * jb + 0] *= inv0;
        o[blk][4 * jb + 1] *= inv0;
        o[blk][4 * jb + 2] *= inv1;
        o[blk][4 * jb + 3] *= inv1;
      }
    hopper::store_rows<NB>(out + (size_t)h * D, (size_t)H * D, row0, Tq, t,
                           o);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + r * 8;
        if (row < Tq)
          lse[(size_t)h * Tq + row] =
              lt[r] > 0.f ? m[r] * kLn2 + logf(lt[r]) : kNegInf;
      }
    }
  }
}

// -------------------------------------------------------------------------
// dK/dV: one (head, 128-key packed tile), over the query tiles that see it

template <int D> struct DkvCfg {
  static constexpr int kBlocks = D / 64;
  static constexpr uint32_t kResBytes = kBlocks * kBM * kRowBytes;     // K, V
  static constexpr uint32_t kTileBytes = kBlocks * kDkvBQ * kRowBytes; // Q, dO
  static constexpr size_t kSmem = 2 * (size_t)kResBytes +
                                  2 * (size_t)kDkvStages * kTileBytes +
                                  2 * kDkvStages * kDkvBQ * 4 +
                                  sizeof(int4) * 4 +
                                  8 * (1 + 2 * kDkvStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
varlen_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv,
                           const int* __restrict__ cu_q,
                           const int* __restrict__ cu_k, int nseg, int H,
                           int Tq, int Tk, float scale, int causal) {
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
  int4* parts = reinterpret_cast<int4*>(dl_s + ST * BQ);             // [4]
  uint64_t* bars = reinterpret_cast<uint64_t*>(parts + 4);
  uint64_t* res_full = bars;
  uint64_t* full_bar = bars + 1;
  uint64_t* empty_bar = full_bar + ST;

  const int h = blockIdx.x;
  const int k0 = blockIdx.y * kBM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(res_full, 1);
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(&full_bar[i], 1 + 32);   // TMA thread + lse warp
      hopper::mbar_init(&empty_bar[i], kConsumers * 4);
    }
    hopper::mbar_fence_init();
    // K and V do not depend on the ranges: their load overlaps the search
    hopper::mbar_arrive_expect_tx(res_full, 2 * C::kResBytes);
    for (int blk = 0; blk < NB; ++blk) {
      hopper::tma_load_4d(k_s + blk * kResBlock, &tm_k, res_full, blk * 64,
                          h, k0, 0);
      hopper::tma_load_4d(v_s + blk * kResBlock, &tm_v, res_full, blk * 64,
                          h, k0, 0);
    }
  }
  int4 sp[kConsumers];
  cta_spans<false>(parts, sp, cu_q, cu_k, nseg, Tq, Tk, causal, k0);
  // the CTA streams the queries of the union of both consumers' keys
  const int x = min(sp[0].x, sp[1].x), y = max(sp[0].y, sp[1].y);
  const int n_visit = x < y ? (y - x + BQ - 1) / BQ : 0;

  if (wg == 0) {
    // ---------------- producer: one thread issues every TMA load, warp 1
    // copies each tile's lse and delta
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 0) {
      // with no query to visit no consumer waits for K and V: they must
      // land before the CTA exits
      if (n_visit == 0) hopper::mbar_wait(res_full, 0);
      for (int i = 0; i < n_visit; ++i) {
        const int st = i % ST;
        hopper::mbar_wait(&empty_bar[st], ((i / ST) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full_bar[st], 2 * C::kTileBytes);
        for (int blk = 0; blk < NB; ++blk) {
          hopper::tma_load_4d(q_s + (st * NB + blk) * kTileBlock, &tm_q,
                              &full_bar[st], blk * 64, h, x + i * BQ, 0);
          hopper::tma_load_4d(do_s + (st * NB + blk) * kTileBlock, &tm_do,
                              &full_bar[st], blk * 64, h, x + i * BQ, 0);
        }
      }
    } else if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x & 31;
      const float* lse_row = lse + (size_t)h * Tq;
      const float* dl_row = delta + (size_t)h * Tq;
      for (int i = 0; i < n_visit; ++i) {
        const int st = i % ST;
        hopper::mbar_wait(&empty_bar[st], ((i / ST) & 1) ^ 1);
#pragma unroll
        for (int c = lane; c < BQ; c += 32) {
          const int col = x + i * BQ + c;
          // queries past tq: p = 2^(s c - 1e30) = 0
          lse_s[st * BQ + c] = col < Tq ? lse_row[col] * kLog2e : 1e30f;
          dl_s[st * BQ + c] = col < Tq ? dl_row[col] : 0.f;
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
    const int key_r = k0 + cw * 64 + wi * 16 + g;   // this thread's keys: +0, +8
    const float sl2 = scale * kLog2e;
    int lo[2], hi[2];                         // the queries that see each key
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int2 a = varlen::queries_of_key(cu_q, cu_k, nseg, Tq, Tk, causal,
                                            key_r + r * 8);
      lo[r] = a.x;
      hi[r] = a.y;
    }
    // this warpgroup's query tiles [i0, i1) and the intersection [z, w) of
    // its keys' ranges, where no element needs the mask
    const int4 span = cw == 0 ? sp[0] : sp[1];
    const int2 own = tiles_meeting(x, BQ, span.x, span.y);
    const int i0 = own.x, i1 = own.y;

    float dk_acc[NB][32], dv_acc[NB][32];
#pragma unroll
    for (int blk = 0; blk < NB; ++blk)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[blk][i] = dv_acc[blk][i] = 0.f;
    float s[BQ / 2], dp[BQ / 2];       // S^T and dP^T of the tile
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];   // P^T, dS^T in bf16

    if (i0 < i1) hopper::mbar_wait(res_full, 0);
    for (int i = 0; i < n_visit; ++i) {
      const int st = i % ST;
      hopper::mbar_wait(&full_bar[st], (i / ST) & 1);
      if (i >= i0 && i < i1) {
        const unsigned char* qt = q_s + st * NB * kTileBlock;
        const unsigned char* dot = do_s + st * NB * kTileBlock;
        // S^T = K Q^T and dP^T = V dO^T (two commit groups)
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int blk = kk / 4, kin = (kk % 4) * 32;
          hopper::wgmma_m64n64k16_ss(
              s,
              hopper::desc_sw128(k_s + blk * kResBlock +
                                     cw * 64 * kRowBytes + kin, 16),
              hopper::desc_sw128(qt + blk * kTileBlock + kin, 16), kk > 0);
        }
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int blk = kk / 4, kin = (kk % 4) * 32;
          hopper::wgmma_m64n64k16_ss(
              dp,
              hopper::desc_sw128(v_s + blk * kResBlock +
                                     cw * 64 * kRowBytes + kin, 16),
              hopper::desc_sw128(dot + blk * kTileBlock + kin, 16), kk > 0);
        }
        hopper::wgmma_commit();

        // P^T = 2^(S^T c - lse2[col]); the mask only outside the
        // intersection (uniform across the warpgroup)
        const float* ls = lse_s + st * BQ;
        const float* dls = dl_s + st * BQ;
        const int c0 = x + i * BQ;
        const bool full = c0 >= span.z && c0 + BQ <= span.w;
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
            if (!full) {
              const int col = c0 + jb * 8 + 2 * t + (e & 1);
              if (col < lo[e >> 1] || col >= hi[e >> 1]) p = 0.f;
            }
            s[4 * jb + e] = p;
          }
        }
        hopper::to_a_frags<BQ>(s, pa);
        // dV += P^T dO, in flight while dS^T is formed
        hopper::fence_acc(dv_acc);
        hopper::wgmma_fence();
        hopper::wgmma_rs_acc<NB, BQ / 16>(dv_acc, pa, dot, kTileBlock);
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
        hopper::to_a_frags<BQ>(dp, da);
        // dK += dS^T Q
        hopper::fence_acc(dk_acc);
        hopper::wgmma_fence();
        hopper::wgmma_rs_acc<NB, BQ / 16>(dk_acc, da, qt, kTileBlock);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_acc(dk_acc);
        hopper::fence_acc(dv_acc);
      }
      if (lane == 0) hopper::mbar_arrive(&empty_bar[st]);
    }

    const size_t base = (size_t)h * D;
    hopper::store_rows<NB>(dk + base, (size_t)H * D, key_r, Tk, t, dk_acc);
    hopper::store_rows<NB>(dv + base, (size_t)H * D, key_r, Tk, t, dv_acc);
  }
}

// -------------------------------------------------------------------------
// launches

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, const void* cu_q, const void* cu_k, int nseg,
                int H, int Tq, int Tk, float scale, int causal,
                cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  cudaError_t e = hopper::bshd_map(&mq, q, 1, Tq, H, D, kBM);
  if (e == cudaSuccess) e = hopper::bshd_map(&mk, k, 1, Tk, H, D, kFwdBN);
  if (e == cudaSuccess) e = hopper::bshd_map(&mv, v, 1, Tk, H, D, kFwdBN);
  if (e != cudaSuccess) return e;
  auto kern = varlen_fwd_sm90_kernel<D>;
  constexpr size_t smem = FwdCfg<D>::kSmem;
  e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  // heads fastest: the CTAs in flight share their rows' segments, and with
  // them the K and V tiles they stream from L2
  dim3 grid(H, (Tq + kBM - 1) / kBM);
  kern<<<grid, kThreads, smem, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      static_cast<const int*>(cu_q), static_cast<const int*>(cu_k), nseg, H,
      Tq, Tk, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, const void* cu_q, const void* cu_k,
                    int nseg, int H, int Tq, int Tk, float scale, int causal,
                    cudaStream_t st) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e = hopper::bshd_map(&mq, q, 1, Tq, H, D, kDkvBQ);
  if (e == cudaSuccess) e = hopper::bshd_map(&mdo, dout, 1, Tq, H, D, kDkvBQ);
  if (e == cudaSuccess) e = hopper::bshd_map(&mk, k, 1, Tk, H, D, kBM);
  if (e == cudaSuccess) e = hopper::bshd_map(&mv, v, 1, Tk, H, D, kBM);
  if (e != cudaSuccess) return e;
  auto kern = varlen_bwd_dkv_sm90_kernel<D>;
  constexpr size_t smem = DkvCfg<D>::kSmem;
  e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(H, (Tk + kBM - 1) / kBM);           // heads fastest, as above
  kern<<<grid, kThreads, smem, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), static_cast<const int*>(cu_q),
      static_cast<const int*>(cu_k), nseg, H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

// row tiles ride the grid's y dimension
bool bad_shape(int nseg, int H, int Tq, int Tk) {
  return nseg < 0 || H <= 0 || H > 65535 || Tq <= 0 || Tk <= 0 ||
         (Tq + kBM - 1) / kBM > 65535 || (Tk + kBM - 1) / kBM > 65535;
}

}  // namespace

// Each entry returns a cudaError_t code: 0 on a successful launch. None
// synchronises; a fault during the run shows at the caller's next sync.
// Tensors are contiguous bf16 packed [t, H, D] (q, out, dout: t = Tq; k, v,
// dk, dv: t = Tk); lse and delta are f32 [H, Tq]; cu_q and cu_k are int32
// [nseg + 1] on the device.
extern "C" {

int varlen_fwd_sm90_launch(const void* q, const void* k, const void* v,
                           void* out, void* lse, const void* cu_q,
                           const void* cu_k, int nseg, int H, int Tq, int Tk,
                           int D, float scale, int causal, void* stream) {
  if (bad_shape(nseg, H, Tq, Tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)fwd<64>(q, k, v, out, lse, cu_q, cu_k, nseg, H, Tq, Tk, scale, causal, st);
  if (D == 128) return (int)fwd<128>(q, k, v, out, lse, cu_q, cu_k, nseg, H, Tq, Tk, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

int varlen_bwd_dkv_sm90_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk, void* dv,
                               const void* cu_q, const void* cu_k, int nseg,
                               int H, int Tq, int Tk, int D, float scale,
                               int causal, void* stream) {
  if (bad_shape(nseg, H, Tq, Tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)bwd_dkv<64>(q, k, v, dout, lse, delta, dk, dv, cu_q, cu_k, nseg, H, Tq, Tk, scale, causal, st);
  if (D == 128) return (int)bwd_dkv<128>(q, k, v, dout, lse, delta, dk, dv, cu_q, cu_k, nseg, H, Tq, Tk, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

const char* varlen_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
