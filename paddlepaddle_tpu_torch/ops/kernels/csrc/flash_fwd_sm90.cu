// Flash-attention forward for Hopper (sm_90a) in bf16 and fp16:
// warp-specialised, TMA-fed, wgmma-computed. CUDA C++ with a plain C entry
// per element type.
//
// Replaces the TPU kernel `_fwd_kernel` (paddlepaddle_tpu/ops/kernels/
// flash_attention.py:97, pallas_call in `_pallas_forward` :229) for bf16 or
// fp16 q, k, v at head dims 64 and 128 (the TPU kernel takes either type:
// its gate tests only the head dim, and AMP sends fp16 to it); the two
// instantiations differ only in the wgmma operand type, the tensor maps'
// element type, the rounding of P and the store of O, all in T. The f32
// path stays on `flash_fwd_kernel` in
// flash_attention.cu (full-f32 FMA: wgmma would round f32 to TF32). Same
// function and contract as that kernel: q [b, s_q, h, d], k/v [b, s_k, h, d]
// read in place; query i sees key j when j <= i + (s_k - s_q) (bottom-right
// causal rule) or always (full); f32 logits masked with -1e30, online softmax
// with f32 running max, sum and accumulator, division by max(l, 1e-30); out
// in q's type and lse [b*h, s_q] f32 in natural log; any length, the ragged
// last tile masked. The dQ and dK/dV kernels take this lse. In fp16 an O
// past 65504 becomes inf and is stored as such.
//
// Design:
//   * CTA = 3 warpgroups over 128 query rows of one (b, h): warpgroup 0 is the
//     producer, warpgroups 1 and 2 the consumers of 64 rows each. The
//     producer gives up registers (setmaxnreg 40), the consumers take them
//     (232). One thread of the producer issues every load by TMA: Q once,
//     then for each 128-key tile its K and V tiles into a ring of 3
//     buffers (229 KB of shared memory with Q at d 128), each guarded by a full barrier (transaction bytes) and an empty
//     barrier (the 8 consumer warps arrive when done with the stage). K and V
//     have separate full barriers, so S = Q K^T starts when K has landed.
//   * TMA: one tiled map each for q, k, v, 4-D (d, h, s, b) over the
//     [b, s, h, d] tensors, built on the host per call with
//     cuTensorMapEncodeTiled (reached through cudaGetDriverEntryPoint, no
//     -lcuda) and passed as __grid_constant__ CUtensorMap. A box is 64 d by
//     128 positions, stored as [rows][64] with the 128-byte swizzle; d 128
//     takes two boxes a tile. Positions past s_q or s_k are zero-filled.
//   * S = Q K^T: wgmma m64n128k16, both operands from shared memory
//     (K-major), f32 accumulators in registers: d / 16 instructions a tile.
//   * Online softmax on the accumulator registers in log2 units: the row max
//     is taken over the raw products and scaled once, and each probability
//     is one FFMA (x * scale * log2(e) - m) and one ex2.approx.ftz, the
//     multi-function unit being as busy as the tensor cores at this tile
//     shape. Only the tiles at the causal diagonal or the ragged end evaluate
//     the mask; the row sum is kept per thread and reduced across the row's
//     4 lanes once, at the end.
//   * O += P V: P is rounded to T in registers and fed to wgmma m64n64k16
//     as its register A operand (the accumulator layout of S is the m16n8k16
//     A fragment, two 8-column blocks a 16-key step); V comes from shared
//     memory N-major (trans-b). Nothing is staged through shared memory and
//     nothing goes through ldmatrix; O stays in registers until the epilogue.
//   * Within a consumer warpgroup, S of key tile j + 1 and O += P V of tile
//     j are issued together as two commit groups, and tile j + 1's softmax
//     runs while P V is in flight; O is rescaled once P V has landed. The
//     last tile is peeled off the loop so that every step commits the same
//     two groups: ptxas can then see that wait_group 1 retires S, and does
//     not serialise the wgmmas. A consumer holds a stage one tile longer
//     than it would without the overlap, hence the third stage: with two,
//     the overlapped loop was slower than the plain one. The two consumer
//     warpgroups interleave on the tensor cores besides.
//   * Grid (query tiles, b*h), the last (heaviest causal) query tiles first;
//     key tiles past the CTA's causal limit are never loaded.
//
// Bound: at the training shape (b 4, s 2048, h 32, d 128, causal) the two
// products are ~1000 operations a byte moved, far above the card's ridge
// (~295 for bf16): the kernel is bound by operations, 4 b h d x (visible
// pairs) against 989 TFLOP/s. What limits it: the rescale and the bf16
// conversion of P still wait for P V, the two consumer warpgroups are not
// scheduled against each other (no ping-pong), and the output is stored from
// registers without TMA.
//
// Limits checked by the Python wrapper before launch: bf16 or fp16, d in
// {64, 128},
// causal only with s_q <= s_k, b*h <= 65535, 16-byte aligned contiguous
// tensors.

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;               // query rows a CTA
constexpr int kBN = 128;               // keys a tile
constexpr int kConsumers = 2;          // consumer warpgroups, 64 rows each
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr uint32_t kBlockBytes = 128 * 64 * 2;   // one [128][64] 2-byte box

template <int D> struct Cfg {
  static constexpr int kBlocks = D / 64;            // 64-wide d blocks
  static constexpr int kStages = 3;                 // K/V ring depth
  static constexpr uint32_t kTileBytes = kBlocks * kBlockBytes;
  // Q, then K stages, then V stages, then the barriers; 1024-byte aligned
  static constexpr size_t kSmem =
      (size_t)(1 + 2 * kStages) * kTileBytes + 8 * (1 + 3 * kStages) + 1024;
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      T* __restrict__ out,
                      float* __restrict__ lse, int H, int Sq, int Sk,
                      float scale, int causal) {
  using C = Cfg<D>;
  constexpr int NB = C::kBlocks, ST = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;                                   // [NB][128][64]
  unsigned char* k_s = q_s + C::kTileBytes;                    // [ST][NB][128][64]
  unsigned char* v_s = k_s + ST * C::kTileBytes;               // [ST][NB][128][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + ST * C::kTileBytes);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;

  const int n_qt = (Sq + kBM - 1) / kBM;
  const int qi = n_qt - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = qi * kBM;
  const int off = Sk - Sq;
  const int n_kv = (Sk + kBN - 1) / kBN;
  const int n_visit =
      causal ? min(n_kv, (min(q0 + kBM, Sq) + off + kBN - 1) / kBN) : n_kv;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(&k_full[i], 1);
      hopper::mbar_init(&v_full[i], 1);
      hopper::mbar_init(&empty[i], kConsumers * 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer: one thread issues every TMA load
    hopper::regs_dealloc<40>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, C::kTileBytes);
      for (int blk = 0; blk < NB; ++blk)
        hopper::tma_load_4d(q_s + blk * kBlockBytes, &tm_q, q_full, blk * 64,
                            h, q0, b);
      for (int j = 0; j < n_visit; ++j) {
        const int st = j % ST;
        hopper::mbar_wait(&empty[st], ((j / ST) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&k_full[st], C::kTileBytes);
        for (int blk = 0; blk < NB; ++blk)
          hopper::tma_load_4d(k_s + (st * NB + blk) * kBlockBytes, &tm_k,
                              &k_full[st], blk * 64, h, j * kBN, b);
        hopper::mbar_arrive_expect_tx(&v_full[st], C::kTileBytes);
        for (int blk = 0; blk < NB; ++blk)
          hopper::tma_load_4d(v_s + (st * NB + blk) * kBlockBytes, &tm_v,
                              &v_full[st], blk * 64, h, j * kBN, b);
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each
    hopper::regs_alloc<232>();
    const int cw = wg - 1;                    // consumer index
    const int wi = (threadIdx.x / 32) & 3;    // warp within the warpgroup
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r0 = q0 + cw * 64;              // this warpgroup's first row
    const int row0 = r0 + wi * 16 + g;        // this thread's rows: row0, +8
    const float sl2 = scale * kLog2e;

    float o[NB][32];
#pragma unroll
    for (int blk = 0; blk < NB; ++blk)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[blk][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // l: this thread's part

    float s[64];          // S of the tile in flight, then its probabilities
    uint32_t pa[8][4];    // P in T: A fragments of the 8 16-key steps

    // S = Q K^T of key tile j over d in 16-wide steps (one commit group)
    auto issue_qk = [&](int j) {
      const int st = j % ST;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int blk = kk / 4, kin = (kk % 4) * 32;        // bytes into a row
        const uint64_t da = hopper::desc_sw128(
            q_s + blk * kBlockBytes + cw * 64 * 128 + kin, 16);
        const uint64_t db = hopper::desc_sw128(
            k_s + (st * NB + blk) * kBlockBytes + kin, 16);
        hopper::wgmma_m64n128k16_ss<T>(s, da, db, kk > 0);
      }
      hopper::wgmma_commit();
    };
    // O += P V of key tile j in 16-key steps (one commit group)
    auto issue_pv = [&](int j) {
      const int st = j % ST;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int blk = 0; blk < NB; ++blk) {
          const uint64_t db = hopper::desc_sw128(
              v_s + (st * NB + blk) * kBlockBytes + kk * 16 * 128, 1024);
          hopper::wgmma_m64n64k16_rs<T>(o[blk], pa[kk], db);
        }
      hopper::wgmma_commit();
    };
    // online softmax of tile j on s, in log2 units: s becomes the
    // probabilities, m and l move on, and alpha rescales what O holds; the
    // mask only where a tile needs it (uniform across the warpgroup)
    auto softmax = [&](int j, float (&alpha)[2]) {
      const bool full = (j + 1) * kBN <= Sk &&
                        (!causal || (j + 1) * kBN - 1 <= r0 + off);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int jb = 0; jb < 16; ++jb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * jb + e];
          if (!full) {
            const int col = j * kBN + jb * 8 + 2 * t + (e & 1);
            const int row = row0 + (e >> 1) * 8;
            if (!(col < Sk && (!causal || col <= row + off))) x = kNegInf;
          }
          s[4 * jb + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float nm[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = mx[r];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const float m_new = fmaxf(m[r], v * sl2);
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
              hopper::fast_exp2(fmaf(s[4 * jb + e], sl2, nm[e >> 1]));
          s[4 * jb + e] = p;
          l[e >> 1] += p;
        }
    };
    // P to A fragments of T
    auto convert = [&]() { hopper::to_a_frags<kBN, T>(s, pa); };

    // Tile 0's S and softmax; then each step issues S of tile j + 1 and
    // O += P V of tile j together, runs tile j + 1's softmax while P V is in
    // flight, and rescales O once P V has landed.
    float alpha[2];
    hopper::mbar_wait(q_full, 0);
    hopper::mbar_wait(&k_full[0], 0);
    hopper::fence_regs(s);
    hopper::wgmma_fence();
    issue_qk(0);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    softmax(0, alpha);
    convert();
    // every step but the last issues two commit groups, so wait<1> is known
    // to retire S while P V stays in flight
    for (int j = 0; j + 1 < n_visit; ++j) {
      hopper::mbar_wait(&k_full[(j + 1) % ST], ((j + 1) / ST) & 1);
      hopper::mbar_wait(&v_full[j % ST], (j / ST) & 1);
      hopper::fence_regs(s);
#pragma unroll
      for (int blk = 0; blk < NB; ++blk) hopper::fence_regs(o[blk]);
      hopper::wgmma_fence();
      issue_qk(j + 1);
      hopper::wgmma_fence();
      issue_pv(j);
      hopper::wgmma_wait<1>();                 // S of tile j + 1 is in
      hopper::fence_regs(s);
      softmax(j + 1, alpha);
      hopper::wgmma_wait<0>();                 // P V of tile j is in
#pragma unroll
      for (int blk = 0; blk < NB; ++blk) hopper::fence_regs(o[blk]);
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
      convert();
    }
    {                                          // the last tile's P V
      const int j = n_visit - 1;
      hopper::mbar_wait(&v_full[j % ST], (j / ST) & 1);
#pragma unroll
      for (int blk = 0; blk < NB; ++blk) hopper::fence_regs(o[blk]);
      hopper::wgmma_fence();
      issue_pv(j);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int blk = 0; blk < NB; ++blk) hopper::fence_regs(o[blk]);
      if (lane == 0) hopper::mbar_arrive(&empty[j % ST]);
    }

    // epilogue: rows row0 and row0 + 8, straight from the registers
    float lt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = l[r];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      lt[r] = fmaxf(v, 1e-30f);
    }
    const size_t rs = (size_t)H * D;
    const size_t base = ((size_t)b * Sq * H + h) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row < Sq) {
        const float inv = 1.f / lt[r];
        T* dst = out + base + (size_t)row * rs + 2 * t;
#pragma unroll
        for (int blk = 0; blk < NB; ++blk)
#pragma unroll
          for (int jb = 0; jb < 8; ++jb)
            *reinterpret_cast<uint32_t*>(dst + blk * 64 + jb * 8) =
                hopper::pack2<T>(o[blk][4 * jb + 2 * r] * inv,
                                  o[blk][4 * jb + 2 * r + 1] * inv);
        if (t == 0) lse[(size_t)bh * Sq + row] = m[r] * kLn2 + logf(lt[r]);
      }
    }
  }
}

template <int D, typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int H, int Sq, int Sk, float scale,
                int causal, cudaStream_t st) {
  constexpr CUtensorMapDataType ty = hopper::tma_type<T>();
  CUtensorMap mq, mk, mv;
  cudaError_t e = hopper::bshd_map(&mq, q, B, Sq, H, D, kBM, ty);
  if (e == cudaSuccess) e = hopper::bshd_map(&mk, k, B, Sk, H, D, kBN, ty);
  if (e == cudaSuccess) e = hopper::bshd_map(&mv, v, B, Sk, H, D, kBN, ty);
  if (e != cudaSuccess) return e;
  auto kern = flash_fwd_sm90_kernel<D, T>;
  constexpr size_t smem = Cfg<D>::kSmem;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kBM - 1) / kBM, B * H);
  kern<<<grid, kThreads, smem, st>>>(mq, mk, mv, static_cast<T*>(out),
                                     static_cast<float*>(lse), H, Sq, Sk,
                                     scale, causal);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int H, int Sq, int Sk, int D, float scale, int causal,
           void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B * H > 65535 ||
      (causal && Sq > Sk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)fwd<64, T>(q, k, v, out, lse, B, H, Sq, Sk, scale, causal, st);
  if (D == 128)
    return (int)fwd<128, T>(q, k, v, out, lse, B, H, Sq, Sk, scale, causal,
                            st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a successful launch. Does not
// synchronise. q, out: contiguous [b, s_q, h, d] of the entry's type (bf16
// or fp16); k, v: [b, s_k, h, d]; lse: f32 [b*h, s_q].
int flash_fwd_sm90_launch(const void* q, const void* k, const void* v,
                          void* out, void* lse, int B, int H, int Sq, int Sk,
                          int D, float scale, int causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, lse, B, H, Sq, Sk, D, scale,
                               causal, stream);
}

int flash_fwd_sm90_fp16_launch(const void* q, const void* k, const void* v,
                               void* out, void* lse, int B, int H, int Sq,
                               int Sk, int D, float scale, int causal,
                               void* stream) {
  return launch<__half>(q, k, v, out, lse, B, H, Sq, Sk, D, scale, causal,
                        stream);
}

const char* flash_fwd_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
