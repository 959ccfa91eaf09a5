// Flash attention for Hopper (sm_90a) in f32: the forward, dQ and dK/dV
// kernels, CUDA C++ with a plain C entry per kernel. bf16 runs elsewhere:
// the forward in flash_fwd_sm90.cu, dQ and dK/dV in flash_bwd_sm90.cu (TMA
// and wgmma, which would round f32 operands to TF32); the entries here
// refuse bf16 with cudaErrorInvalidValue.
//
// Replaces the TPU kernels of paddlepaddle_tpu/ops/kernels/flash_attention.py
// for f32:
//   flash_fwd_kernel     <- _fwd_kernel :97  (pallas_call in _pallas_forward :229)
//   flash_bwd_dq_kernel  <- _dq_kernel  :139 (pallas_call in _pallas_backward :268)
//   flash_bwd_dkv_kernel <- _dkv_kernel :172 (pallas_call in _pallas_backward :277)
// Same function: q [b, s_q, h, d], k/v [b, s_k, h, d]; query i sees key j
// when j <= i + (s_k - s_q) (bottom-right causal rule) or always (full);
// logits in f32, masked with -1e30 (not -inf), online softmax with f32 running
// max, sum and accumulator, final division by max(l, 1e-30); the forward also
// writes the f32 log-sum-exp rows lse [b*h, s_q]. The backward recomputes
// p = exp(s - lse) blockwise, takes delta = rowsum(dO * O) [b*h, s_q] from the
// caller, and forms ds = p * (dp - delta) * scale, dq = ds K, dk = ds^T q,
// dv = p^T dO.
//
// Layout: the kernels read and write the [b, s, h, d] tensors in place (row
// stride h*d, d contiguous): the [b*h, s, d] view of the TPU kernels' contract
// is addressed through strides, never materialised by a transpose.
//
// Design (simple and correct first):
//   * The TPU grid (b*h, q-blocks) with an in-kernel loop over 512-wide blocks
//     is not carried over. One CTA of 4 warps owns 64 rows: query rows in the
//     forward and dQ kernels (one CTA per (b*h, q-tile)), key rows in the dK/dV
//     kernel (one CTA per (b*h, kv-tile)); each warp owns 16 of them. The CTA
//     loops over the other side's tiles (64 keys, or 32 queries in dK/dV to
//     keep two 16 x d accumulators in registers), stopping at the causal
//     limit, as the Pallas loops did. Every output row has one writer, so no
//     atomics are needed.
//   * The streamed tiles are double-buffered in shared memory with 16-byte
//     cp.async copies (rows past the end are zero-filled): tile j+1 is in
//     flight while tile j is computed. Rows are padded by 16 bytes so the
//     fragment loads below hit distinct banks.
//   * Products keep the m16n8k16 fragment layout of flash_tiles.cuh (shared
//     with flash_varlen.cu) and compute it with FMA in full f32.
//     Probabilities and ds leave the accumulator layout through a per-warp
//     staging tile in shared memory.
//   * The softmax runs in log2 units (exp2f, with scale * log2(e) in one
//     multiply; lse crosses the interface in natural log), and only the tiles
//     at the causal diagonal or the ragged end evaluate the mask.
//   * Causal tiles: the forward and dQ grids launch the last (heaviest) query
//     tiles first, the dK/dV grid the first (heaviest) key tiles first.
//
// Bound: f32 runs outside the tensor cores, so at any shape a training step
// would use, every kernel is bound by operations: 2, 3 and 4 causal products
// (U = 2 b h d x visible pairs) for forward, dQ and dK/dV, against the card's
// 67 TFLOP/s of f32 FMA. What the design does about it: causal tiles past the
// diagonal are skipped and device memory is read once per tile pair.
//
// Limits checked by the Python wrapper before launch: d in {64, 128}, f32,
// causal only with s_q <= s_k, b*h <= 65535, 16-byte aligned contiguous
// tensors.

#include "flash_tiles.cuh"

namespace {

// -------------------------------------------------------------------------
// forward: out and lse for one (b*h, 64-row query tile)

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Sq, int Sk, float scale,
                 int causal) {
  constexpr int BN = kFwdBN;
  constexpr int VEC = 16 / sizeof(T), LD = D + VEC, LDP = BN + VEC;
  constexpr int NS = BN / 8, NO = D / 8;
  const int n_qt = (Sq + BM - 1) / BM;
  const int qi = n_qt - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Sk - Sq;
  const size_t rs = (size_t)H * D;
  const size_t qbase = ((size_t)b * Sq * H + h) * D;
  const size_t kbase = ((size_t)b * Sk * H + h) * D;

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                  // [BM][LD]
  T* k_s = q_s + BM * LD;                               // [2][BN][LD]
  T* v_s = k_s + 2 * BN * LD;                           // [2][BN][LD]
  T* p_s = v_s + 2 * BN * LD + warp * 16 * LDP;         // this warp's [16][LDP]

  const int q0 = qi * BM;
  const int n_kv = (Sk + BN - 1) / BN;
  const int n_visit =
      causal ? min(n_kv, (min(q0 + BM, Sq) + off + BN - 1) / BN) : n_kv;

  load_rows<T, D, BM>(q_s, q + qbase, q0, Sq, rs);
  load_rows<T, D, BN>(k_s, k + kbase, 0, Sk, rs);
  load_rows<T, D, BN>(v_s, v + kbase, 0, Sk, rs);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;        // this thread's rows: row0, +8
  const float sl2 = scale * kLog2e;
  float o[NO][4];
  zero(o);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // m in log2 units

  for (int j = 0; j < n_visit; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_visit) {
      load_rows<T, D, BN>(k_s + (buf ^ 1) * BN * LD, k + kbase, (j + 1) * BN,
                          Sk, rs);
      load_rows<T, D, BN>(v_s + (buf ^ 1) * BN * LD, v + kbase, (j + 1) * BN,
                          Sk, rs);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kb = k_s + buf * BN * LD;
    const T* vb = v_s + buf * BN * LD;

    // a tile needs masking only at the causal diagonal or the ragged end;
    // the test is uniform across the CTA
    const bool full = (j + 1) * BN <= Sk &&
                      (!causal || (j + 1) * BN - 1 <= q0 + off);
    float s[NS][4];
    zero(s);
    warp_mma<T, NS, D, true>(q_s + warp * 16 * LD, LD, kb, LD, s);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int jj = 0; jj < NS; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[jj][e] * sl2;
        if (!full) {
          const int col = j * BN + jj * 8 + 2 * t + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (!(col < Sk && (!causal || col <= row + off))) x = kNegInf;
        }
        s[jj][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int jj = 0; jj < NS; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[jj][e] - m[e >> 1]);
        s[jj][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int jj = 0; jj < NO; ++jj) {
      o[jj][0] *= alpha[0];
      o[jj][1] *= alpha[0];
      o[jj][2] *= alpha[1];
      o[jj][3] *= alpha[1];
    }
    stage<T, NS>(p_s, LDP, s);
    __syncwarp();
    warp_mma<T, NO, BN, false>(p_s, LDP, vb, LD, o);
    __syncthreads();            // k/v buffer `buf` and p_s are free again
  }

  const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
  store_rows<T, NO>(out + qbase, rs, row0, Sq, o, 1.f / l0, 1.f / l1);
  if (t == 0) {
    if (row0 < Sq) lse[(size_t)bh * Sq + row0] = m[0] * kLn2 + logf(l0);
    if (row0 + 8 < Sq)
      lse[(size_t)bh * Sq + row0 + 8] = m[1] * kLn2 + logf(l1);
  }
}

// -------------------------------------------------------------------------
// dQ: one (b*h, 64-row query tile), looping over key tiles

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int H,
                    int Sq, int Sk, float scale, int causal) {
  constexpr int BN = kFwdBN;
  constexpr int VEC = 16 / sizeof(T), LD = D + VEC, LDP = BN + VEC;
  constexpr int NS = BN / 8, NO = D / 8;
  const int n_qt = (Sq + BM - 1) / BM;
  const int qi = n_qt - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Sk - Sq;
  const size_t rs = (size_t)H * D;
  const size_t qbase = ((size_t)b * Sq * H + h) * D;
  const size_t kbase = ((size_t)b * Sk * H + h) * D;

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                  // [BM][LD]
  T* do_s = q_s + BM * LD;                              // [BM][LD]
  T* k_s = do_s + BM * LD;                              // [2][BN][LD]
  T* v_s = k_s + 2 * BN * LD;                           // [2][BN][LD]
  T* ds_s = v_s + 2 * BN * LD + warp * 16 * LDP;        // this warp's [16][LDP]

  const int q0 = qi * BM;
  const int n_kv = (Sk + BN - 1) / BN;
  const int n_visit =
      causal ? min(n_kv, (min(q0 + BM, Sq) + off + BN - 1) / BN) : n_kv;

  load_rows<T, D, BM>(q_s, q + qbase, q0, Sq, rs);
  load_rows<T, D, BM>(do_s, dout + qbase, q0, Sq, rs);
  load_rows<T, D, BN>(k_s, k + kbase, 0, Sk, rs);
  load_rows<T, D, BN>(v_s, v + kbase, 0, Sk, rs);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;
  const float sl2 = scale * kLog2e;
  float lse_r[2], dl_r[2];                    // lse_r in log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    lse_r[r] = row < Sq ? lse[(size_t)bh * Sq + row] * kLog2e : 0.f;
    dl_r[r] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
  }
  float acc[NO][4];
  zero(acc);

  for (int j = 0; j < n_visit; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_visit) {
      load_rows<T, D, BN>(k_s + (buf ^ 1) * BN * LD, k + kbase, (j + 1) * BN,
                          Sk, rs);
      load_rows<T, D, BN>(v_s + (buf ^ 1) * BN * LD, v + kbase, (j + 1) * BN,
                          Sk, rs);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kb = k_s + buf * BN * LD;
    const T* vb = v_s + buf * BN * LD;

    const bool full = (j + 1) * BN <= Sk &&
                      (!causal || (j + 1) * BN - 1 <= q0 + off);
    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
    warp_mma<T, NS, D, true>(q_s + warp * 16 * LD, LD, kb, LD, s);
    warp_mma<T, NS, D, true>(do_s + warp * 16 * LD, LD, vb, LD, dp);
#pragma unroll
    for (int jj = 0; jj < NS; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[jj][e] * sl2 - lse_r[e >> 1]);
        if (!full) {
          const int col = j * BN + jj * 8 + 2 * t + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (!(col < Sk && (!causal || col <= row + off))) p = 0.f;
        }
        s[jj][e] = p * (dp[jj][e] - dl_r[e >> 1]) * scale;
      }
    stage<T, NS>(ds_s, LDP, s);
    __syncwarp();
    warp_mma<T, NO, BN, false>(ds_s, LDP, kb, LD, acc);
    __syncthreads();            // k/v buffer `buf` and ds_s are free again
  }

  store_rows<T, NO>(dq + qbase, rs, row0, Sq, acc, 1.f, 1.f);
}

// -------------------------------------------------------------------------
// dK/dV: one (b*h, 64-row key tile), looping over query tiles from the
// causal start max(k0 - off, 0)

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Sk, float scale,
                     int causal) {
  constexpr int BN = kDkvBN;
  constexpr int VEC = 16 / sizeof(T), LD = D + VEC, LDP = BN + VEC;
  constexpr int NS = BN / 8, NO = D / 8;
  const int kj = blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Sk - Sq;
  const size_t rs = (size_t)H * D;
  const size_t qbase = ((size_t)b * Sq * H + h) * D;
  const size_t kbase = ((size_t)b * Sk * H + h) * D;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                  // [BM][LD]
  T* v_s = k_s + BM * LD;                               // [BM][LD]
  T* q_s = v_s + BM * LD;                               // [2][BN][LD]
  T* do_s = q_s + 2 * BN * LD;                          // [2][BN][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BN * LD);  // [BN]
  float* dl_s = lse_s + BN;                                     // [BN]
  T* st_s = reinterpret_cast<T*>(dl_s + BN) + warp * 16 * LDP;  // [16][LDP]

  const int k0 = kj * BM;
  const int n_qt = (Sq + BN - 1) / BN;
  const int start = causal ? max(k0 - off, 0) / BN : 0;

  load_rows<T, D, BM>(k_s, k + kbase, k0, Sk, rs);
  load_rows<T, D, BM>(v_s, v + kbase, k0, Sk, rs);
  load_rows<T, D, BN>(q_s, q + qbase, start * BN, Sq, rs);
  load_rows<T, D, BN>(do_s, dout + qbase, start * BN, Sq, rs);
  cp_async_commit();

  const int key0 = k0 + warp * 16 + g;        // this thread's keys: key0, +8
  const float sl2 = scale * kLog2e;
  float dk_acc[NO][4], dv_acc[NO][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int i = start; i < n_qt; ++i) {
    const int buf = (i - start) & 1;
    const bool more = i + 1 < n_qt;
    if (more) {
      load_rows<T, D, BN>(q_s + (buf ^ 1) * BN * LD, q + qbase, (i + 1) * BN,
                          Sq, rs);
      load_rows<T, D, BN>(do_s + (buf ^ 1) * BN * LD, dout + qbase,
                          (i + 1) * BN, Sq, rs);
      cp_async_commit();
    }
    if (threadIdx.x < BN) {
      const int r = i * BN + threadIdx.x;
      lse_s[threadIdx.x] = r < Sq ? lse[(size_t)bh * Sq + r] * kLog2e : 0.f;
      dl_s[threadIdx.x] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.f;
    }
    if (more) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* qb = q_s + buf * BN * LD;
    const T* dob = do_s + buf * BN * LD;

    // p^T [16 keys x BN queries]; masking only at the causal diagonal or
    // the ragged end of the queries (uniform across the CTA)
    const bool full = (i + 1) * BN <= Sq &&
                      (!causal || i * BN + off >= k0 + BM - 1);
    float s[NS][4];
    zero(s);
    warp_mma<T, NS, D, true>(k_s + warp * 16 * LD, LD, qb, LD, s);
#pragma unroll
    for (int jj = 0; jj < NS; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = jj * 8 + 2 * t + (e & 1);
        float p = exp2f(s[jj][e] * sl2 - lse_s[cl]);
        if (!full) {
          const int col = i * BN + cl;
          const int key = key0 + (e >> 1) * 8;
          if (!(col < Sq && (!causal || col + off >= key))) p = 0.f;
        }
        s[jj][e] = p;
      }
    stage<T, NS>(st_s, LDP, s);
    __syncwarp();
    warp_mma<T, NO, BN, false>(st_s, LDP, dob, LD, dv_acc);   // dv += p^T dO

    float dp[NS][4];
    zero(dp);
    warp_mma<T, NS, D, true>(v_s + warp * 16 * LD, LD, dob, LD, dp);
#pragma unroll
    for (int jj = 0; jj < NS; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = jj * 8 + 2 * t + (e & 1);
        s[jj][e] = s[jj][e] * (dp[jj][e] - dl_s[cl]) * scale;
      }
    __syncwarp();               // every lane has read p before ds replaces it
    stage<T, NS>(st_s, LDP, s);
    __syncwarp();
    warp_mma<T, NO, BN, false>(st_s, LDP, qb, LD, dk_acc);    // dk += ds^T q
    __syncthreads();            // q/dO buffer `buf` and lse_s/dl_s are free
  }
  cp_async_wait<0>();           // nothing left in flight if the loop was empty

  store_rows<T, NO>(dk + kbase, rs, key0, Sk, dk_acc, 1.f, 1.f);
  store_rows<T, NO>(dv + kbase, rs, key0, Sk, dv_acc, 1.f, 1.f);
}

// -------------------------------------------------------------------------
// launches

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int H, int Sq, int Sk, float scale,
                int causal, cudaStream_t st) {
  auto kern = flash_fwd_kernel<T, D>;
  constexpr size_t smem = fwd_smem<T, D>();
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BM - 1) / BM, B * H);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<float*>(lse),
      H, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int H, int Sq, int Sk, float scale,
                   int causal, cudaStream_t st) {
  auto kern = flash_bwd_dq_kernel<T, D>;
  constexpr size_t smem = dq_smem<T, D>();
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BM - 1) / BM, B * H);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int H, int Sq, int Sk,
                    float scale, int causal, cudaStream_t st) {
  auto kern = flash_bwd_dkv_kernel<T, D>;
  constexpr size_t smem = dkv_smem<T, D>();
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sk + BM - 1) / BM, B * H);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Sq, int Sk, int causal) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B * H > 65535 ||
         (causal && Sq > Sk);
}

}  // namespace

// Each entry returns a cudaError_t code: 0 on a successful launch. None
// synchronises; a fault during the run shows at the caller's next sync.
// Tensors are contiguous f32 [b, s, h, d] (q, out, dout, dq: s = Sq; k, v, dk,
// dv: s = Sk); lse and delta are f32 [b*h, Sq].
extern "C" {

int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int B, int H, int Sq, int Sk, int D,
                     float scale, int causal, int is_bf16, void* stream) {
  if (bad_shape(B, H, Sq, Sk, causal)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)cudaErrorInvalidValue;   // bf16: *_sm90.cu
  if (D == 64) return (int)fwd<float, 64>(q, k, v, out, lse, B, H, Sq, Sk, scale, causal, st);
  if (D == 128) return (int)fwd<float, 128>(q, k, v, out, lse, B, H, Sq, Sk, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int H, int Sq, int Sk, int D,
                        float scale, int causal, int is_bf16, void* stream) {
  if (bad_shape(B, H, Sq, Sk, causal)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)cudaErrorInvalidValue;   // bf16: *_sm90.cu
  if (D == 64) return (int)bwd_dq<float, 64>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, scale, causal, st);
  if (D == 128) return (int)bwd_dq<float, 128>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int B, int H, int Sq, int Sk,
                         int D, float scale, int causal, int is_bf16,
                         void* stream) {
  if (bad_shape(B, H, Sq, Sk, causal)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)cudaErrorInvalidValue;   // bf16: *_sm90.cu
  if (D == 64) return (int)bwd_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, scale, causal, st);
  if (D == 128) return (int)bwd_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
