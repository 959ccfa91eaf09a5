// Packed varlen flash attention for Hopper (sm_90a): the f32 forward, dQ
// and dK/dV kernels and the bf16 dQ kernel, CUDA C++ with a plain C entry
// per kernel. The bf16 forward and dK/dV are varlen_fwd_sm90_kernel and
// varlen_bwd_dkv_sm90_kernel in flash_varlen_sm90.cu (TMA + wgmma); the
// forward and dK/dV entries here refuse bf16.
//
// Replaces the TPU kernels of paddlepaddle_tpu/ops/kernels/flash_varlen.py:
//   varlen_fwd_kernel     f32       <- _vfwd_kernel :123 (pallas_call in _varlen_pallas_fwd :233)
//   varlen_bwd_dq_kernel  f32, bf16 <- _vdq_kernel  :156 (pallas_call in _varlen_pallas_bwd :273)
//   varlen_bwd_dkv_kernel f32       <- _vdkv_kernel :184 (pallas_call in _varlen_pallas_bwd :284)
// Same function: q [tq, h, d] and k/v [tk, h, d] hold packed sequences whose
// bounds are the int32 prefix sums cu_q, cu_k [B + 1] (on the device). Query
// row i of segment s (cu_q[s] <= i < cu_q[s+1]) sees key j when
// cu_k[s] <= j < cu_k[s+1] and, if causal, j <= i + (cu_k[s+1] - cu_q[s+1]):
// the per-segment bottom-right rule pos_k <= pos_q + len_k - len_q. Rows at
// or past cu_q[B] (padding) and rows that see no key (a causal segment with
// len_q > len_k, a segment without keys) get out 0, lse -1e30 and gradients
// 0, as the TPU kernel gives them: a probability is zeroed where the mask is
// false, never taken from exp(-1e30 - (-1e30)) = 1. Otherwise the arithmetic
// is the dense kernels': f32 logits, online softmax in log2 units, division
// by max(l, 1e-30), lse [h, tq] f32 in natural log; the backward recomputes
// p = exp(s - lse) on visible pairs, takes delta = rowsum(dO * O) [h, tq]
// from the caller and forms ds = p * (dp - delta) * scale.
//
// Layout: packed [t, h, d] is flash_attention.cu's [b, s, h, d] at b = 1
// (row stride h*d, d contiguous), read and written in place.
//
// Design. The TPU grid loops every q block over all of seq_k and rebuilds
// the mask of every tile with an O(B) unrolled sweep over the segments. Not
// carried over. Here:
//   * A CTA (4 warps, 64 rows: query rows in the forward and dQ kernels, key
//     rows in dK/dV) first gives each of its rows the range [lo, hi) of the
//     other side that the row sees, from a binary search for the row's
//     segment in cu_q (cu_k; varlen_ranges.cuh): log2(B) loads a row, any
//     B, nothing unrolled.
//     Padding rows and rows that see nothing get an empty range.
//   * The CTA streams only the tiles of the union of its rows' ranges: the
//     keys of the segments its rows span, cut under causal masking at its
//     last row's bottom-right limit (dK/dV: the queries of its keys'
//     segments, from its first key's causal start). Tiles begin at the first
//     visible column, not at a multiple of the tile width.
//   * A tile inside the intersection of the rows' ranges needs no mask; only
//     a tile that straddles a segment boundary, the causal diagonal, a row
//     with an empty range or the end of the union tests its elements, with
//     two integer compares against the row's [lo, hi).
//   * Tiles, products and staging are flash_attention.cu's (flash_tiles.cuh):
//     FMA in full f32 for f32 (wgmma would round f32 to TF32), mma.sync
//     m16n8k16 with f32 accumulation and ldmatrix fragments for the bf16 dQ,
//     16-byte cp.async double buffering (64 keys a tile in the forward and
//     dQ kernels, 32 queries in dK/dV). Every output row has one writer, so
//     no atomics are needed.
//
// Bound: at a packed training batch of Llama-3-8B attention (t 8256, h 32,
// d 128, bf16, causal segments of 64-2048 tokens) the visible pairs take 4d
// (forward), 6d (dQ) and 8d (dK/dV) operations a pair against 989 TFLOP/s,
// about even with the bytes of q, k, v and o once over 3.35 TB/s in the
// forward. Skipping the tiles outside a CTA's segments is what keeps the
// work to the visible pairs: ~14x fewer tiles than a loop over all of t at
// that shape. Known limits of the bf16 dQ, for later work: mma.sync rather
// than wgmma, no TMA or warp specialisation, dS staged through shared
// memory, and no balancing of work across CTAs (a CTA's work follows its
// segments' lengths).
//
// Limits checked by the Python wrapper before launch: d in {64, 128}, f32
// or bf16 (the wrapper sends the bf16 forward and dK/dV to
// flash_varlen_sm90.cu), q, k and v with equal heads, h <= 65535,
// len(cu_q) == len(cu_k), tq, tk >= 1, 16-byte aligned contiguous tensors; any tq and tk (ragged
// last tiles are zero-filled and masked). Every range is clamped to
// [0, tq) x [0, tk), so malformed prefix sums cannot make a kernel read or
// write out of bounds.

#include "flash_tiles.cuh"
#include "varlen_ranges.cuh"

namespace {

// Each of the CTA's BM rows r0 + r gets its range into r_lo[r], r_hi[r];
// returns the union [x, y) and the intersection [z, w) of the ranges (an
// empty row makes the intersection empty). Ends with __syncthreads.
template <bool QUERY_ROWS>
__device__ __forceinline__ int4 row_ranges(int* r_lo, int* r_hi, int4* span,
                                           const int* __restrict__ cu_q,
                                           const int* __restrict__ cu_k,
                                           int nseg, int Tq, int Tk,
                                           int causal, int r0) {
  if (threadIdx.x < 32)
    varlen::row_spans<BM, QUERY_ROWS>(r_lo, r_hi, span, cu_q, cu_k, nseg, Tq,
                                      Tk, causal, r0);
  __syncthreads();
  return *span;
}

// -------------------------------------------------------------------------
// forward: out and lse for one (head, 64-row packed query tile)

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
varlen_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  float* __restrict__ lse, const int* __restrict__ cu_q,
                  const int* __restrict__ cu_k, int nseg, int H, int Tq,
                  int Tk, float scale, int causal) {
  constexpr int BN = kFwdBN;
  constexpr int VEC = 16 / sizeof(T), LD = D + VEC, LDP = BN + VEC;
  constexpr int NS = BN / 8, NO = D / 8;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)h * D;          // head h's columns of a row

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                  // [BM][LD]
  T* k_s = q_s + BM * LD;                               // [2][BN][LD]
  T* v_s = k_s + 2 * BN * LD;                           // [2][BN][LD]
  T* p_s = v_s + 2 * BN * LD + warp * 16 * LDP;         // this warp's [16][LDP]
  __shared__ int r_lo[BM], r_hi[BM];
  __shared__ int4 span_s;

  const int q0 = blockIdx.x * BM;
  load_rows<T, D, BM>(q_s, q + base, q0, Tq, rs);
  const int4 span = row_ranges<true>(r_lo, r_hi, &span_s, cu_q, cu_k, nseg,
                                     Tq, Tk, causal, q0);
  const int k_lo = span.x, k_hi = span.y;
  const int n_visit = k_lo < k_hi ? (k_hi - k_lo + BN - 1) / BN : 0;
  if (n_visit > 0) {
    load_rows<T, D, BN>(k_s, k + base, k_lo, k_hi, rs);
    load_rows<T, D, BN>(v_s, v + base, k_lo, k_hi, rs);
  }
  cp_async_commit();

  const int lr = warp * 16 + g;               // this thread's rows: lr, lr + 8
  const int row0 = q0 + lr;
  const int lo_r[2] = {r_lo[lr], r_lo[lr + 8]};
  const int hi_r[2] = {r_hi[lr], r_hi[lr + 8]};
  const float sl2 = scale * kLog2e;
  float o[NO][4];
  zero(o);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // m in log2 units

  for (int j = 0; j < n_visit; ++j) {
    const int buf = j & 1;
    const int c0 = k_lo + j * BN;
    if (j + 1 < n_visit) {
      load_rows<T, D, BN>(k_s + (buf ^ 1) * BN * LD, k + base, c0 + BN, k_hi,
                          rs);
      load_rows<T, D, BN>(v_s + (buf ^ 1) * BN * LD, v + base, c0 + BN, k_hi,
                          rs);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kb = k_s + buf * BN * LD;
    const T* vb = v_s + buf * BN * LD;

    // uniform across the CTA: every row sees every key of the tile
    const bool full = c0 >= span.z && c0 + BN <= span.w;
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
          const int col = c0 + jj * 8 + 2 * t + (e & 1);
          if (col < lo_r[e >> 1] || col >= hi_r[e >> 1]) x = kNegInf;
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
        float p = exp2f(s[jj][e] - m[e >> 1]);
        if (!full) {
          // a row with no visible key so far has m == -1e30: its masked
          // entries would give exp2(0) = 1
          const int col = c0 + jj * 8 + 2 * t + (e & 1);
          if (col < lo_r[e >> 1] || col >= hi_r[e >> 1]) p = 0.f;
        }
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
  cp_async_wait<0>();           // nothing left in flight if the loop was empty

  // a row that saw no key has l == 0 and o == 0: out 0, lse -1e30
  const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
  store_rows<T, NO>(out + base, rs, row0, Tq, o, 1.f / l0, 1.f / l1);
  if (t == 0) {
    float* lrow = lse + (size_t)h * Tq;
    if (row0 < Tq)
      lrow[row0] = l[0] > 0.f ? m[0] * kLn2 + logf(l0) : kNegInf;
    if (row0 + 8 < Tq)
      lrow[row0 + 8] = l[1] > 0.f ? m[1] * kLn2 + logf(l1) : kNegInf;
  }
}

// -------------------------------------------------------------------------
// dQ: one (head, 64-row packed query tile), over its visible key tiles

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
varlen_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     const int* __restrict__ cu_q,
                     const int* __restrict__ cu_k, int nseg, int H, int Tq,
                     int Tk, float scale, int causal) {
  constexpr int BN = kFwdBN;
  constexpr int VEC = 16 / sizeof(T), LD = D + VEC, LDP = BN + VEC;
  constexpr int NS = BN / 8, NO = D / 8;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)h * D;

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                  // [BM][LD]
  T* do_s = q_s + BM * LD;                              // [BM][LD]
  T* k_s = do_s + BM * LD;                              // [2][BN][LD]
  T* v_s = k_s + 2 * BN * LD;                           // [2][BN][LD]
  T* ds_s = v_s + 2 * BN * LD + warp * 16 * LDP;        // this warp's [16][LDP]
  __shared__ int r_lo[BM], r_hi[BM];
  __shared__ int4 span_s;

  const int q0 = blockIdx.x * BM;
  load_rows<T, D, BM>(q_s, q + base, q0, Tq, rs);
  load_rows<T, D, BM>(do_s, dout + base, q0, Tq, rs);
  const int4 span = row_ranges<true>(r_lo, r_hi, &span_s, cu_q, cu_k, nseg,
                                     Tq, Tk, causal, q0);
  const int k_lo = span.x, k_hi = span.y;
  const int n_visit = k_lo < k_hi ? (k_hi - k_lo + BN - 1) / BN : 0;
  if (n_visit > 0) {
    load_rows<T, D, BN>(k_s, k + base, k_lo, k_hi, rs);
    load_rows<T, D, BN>(v_s, v + base, k_lo, k_hi, rs);
  }
  cp_async_commit();

  const int lr = warp * 16 + g;
  const int row0 = q0 + lr;
  const int lo_r[2] = {r_lo[lr], r_lo[lr + 8]};
  const int hi_r[2] = {r_hi[lr], r_hi[lr + 8]};
  const float sl2 = scale * kLog2e;
  float lse_r[2], dl_r[2];                    // lse_r in log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    lse_r[r] = row < Tq ? lse[(size_t)h * Tq + row] * kLog2e : 0.f;
    dl_r[r] = row < Tq ? delta[(size_t)h * Tq + row] : 0.f;
  }
  float acc[NO][4];
  zero(acc);

  for (int j = 0; j < n_visit; ++j) {
    const int buf = j & 1;
    const int c0 = k_lo + j * BN;
    if (j + 1 < n_visit) {
      load_rows<T, D, BN>(k_s + (buf ^ 1) * BN * LD, k + base, c0 + BN, k_hi,
                          rs);
      load_rows<T, D, BN>(v_s + (buf ^ 1) * BN * LD, v + base, c0 + BN, k_hi,
                          rs);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kb = k_s + buf * BN * LD;
    const T* vb = v_s + buf * BN * LD;

    const bool full = c0 >= span.z && c0 + BN <= span.w;
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
          const int col = c0 + jj * 8 + 2 * t + (e & 1);
          if (col < lo_r[e >> 1] || col >= hi_r[e >> 1]) p = 0.f;
        }
        s[jj][e] = p * (dp[jj][e] - dl_r[e >> 1]) * scale;
      }
    stage<T, NS>(ds_s, LDP, s);
    __syncwarp();
    warp_mma<T, NO, BN, false>(ds_s, LDP, kb, LD, acc);
    __syncthreads();            // k/v buffer `buf` and ds_s are free again
  }
  cp_async_wait<0>();

  store_rows<T, NO>(dq + base, rs, row0, Tq, acc, 1.f, 1.f);
}

// -------------------------------------------------------------------------
// dK/dV: one (head, 64-row packed key tile), over the query tiles that see it

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
varlen_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, const int* __restrict__ cu_q,
                      const int* __restrict__ cu_k, int nseg, int H, int Tq,
                      int Tk, float scale, int causal) {
  constexpr int BN = kDkvBN;
  constexpr int VEC = 16 / sizeof(T), LD = D + VEC, LDP = BN + VEC;
  constexpr int NS = BN / 8, NO = D / 8;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)h * D;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                  // [BM][LD]
  T* v_s = k_s + BM * LD;                               // [BM][LD]
  T* q_s = v_s + BM * LD;                               // [2][BN][LD]
  T* do_s = q_s + 2 * BN * LD;                          // [2][BN][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BN * LD);  // [BN]
  float* dl_s = lse_s + BN;                                     // [BN]
  T* st_s = reinterpret_cast<T*>(dl_s + BN) + warp * 16 * LDP;  // [16][LDP]
  __shared__ int r_lo[BM], r_hi[BM];
  __shared__ int4 span_s;

  const int k0 = blockIdx.x * BM;
  load_rows<T, D, BM>(k_s, k + base, k0, Tk, rs);
  load_rows<T, D, BM>(v_s, v + base, k0, Tk, rs);
  const int4 span = row_ranges<false>(r_lo, r_hi, &span_s, cu_q, cu_k, nseg,
                                      Tq, Tk, causal, k0);
  const int q_lo = span.x, q_hi = span.y;
  const int n_visit = q_lo < q_hi ? (q_hi - q_lo + BN - 1) / BN : 0;
  if (n_visit > 0) {
    load_rows<T, D, BN>(q_s, q + base, q_lo, q_hi, rs);
    load_rows<T, D, BN>(do_s, dout + base, q_lo, q_hi, rs);
  }
  cp_async_commit();

  const int lk = warp * 16 + g;               // this thread's keys: lk, lk + 8
  const int key0 = k0 + lk;
  const int lo_r[2] = {r_lo[lk], r_lo[lk + 8]};
  const int hi_r[2] = {r_hi[lk], r_hi[lk + 8]};
  const float sl2 = scale * kLog2e;
  float dk_acc[NO][4], dv_acc[NO][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int i = 0; i < n_visit; ++i) {
    const int buf = i & 1;
    const int c0 = q_lo + i * BN;
    const bool more = i + 1 < n_visit;
    if (more) {
      load_rows<T, D, BN>(q_s + (buf ^ 1) * BN * LD, q + base, c0 + BN, q_hi,
                          rs);
      load_rows<T, D, BN>(do_s + (buf ^ 1) * BN * LD, dout + base, c0 + BN,
                          q_hi, rs);
      cp_async_commit();
    }
    if (threadIdx.x < BN) {
      const int r = c0 + threadIdx.x;
      lse_s[threadIdx.x] = r < q_hi ? lse[(size_t)h * Tq + r] * kLog2e : 0.f;
      dl_s[threadIdx.x] = r < q_hi ? delta[(size_t)h * Tq + r] : 0.f;
    }
    if (more) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* qb = q_s + buf * BN * LD;
    const T* dob = do_s + buf * BN * LD;

    // p^T [16 keys x BN queries]; uniform across the CTA: every key is seen
    // by every query of the tile
    const bool full = c0 >= span.z && c0 + BN <= span.w;
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
          const int col = c0 + cl;
          if (col < lo_r[e >> 1] || col >= hi_r[e >> 1]) p = 0.f;
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
  cp_async_wait<0>();

  store_rows<T, NO>(dk + base, rs, key0, Tk, dk_acc, 1.f, 1.f);
  store_rows<T, NO>(dv + base, rs, key0, Tk, dv_acc, 1.f, 1.f);
}

// -------------------------------------------------------------------------
// launches

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, const void* cu_q, const void* cu_k, int nseg,
                int H, int Tq, int Tk, float scale, int causal,
                cudaStream_t st) {
  auto kern = varlen_fwd_kernel<T, D>;
  constexpr size_t smem = fwd_smem<T, D>();
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Tq + BM - 1) / BM, H);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<float*>(lse),
      static_cast<const int*>(cu_q), static_cast<const int*>(cu_k), nseg, H,
      Tq, Tk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, const void* cu_q, const void* cu_k, int nseg,
                   int H, int Tq, int Tk, float scale, int causal,
                   cudaStream_t st) {
  auto kern = varlen_bwd_dq_kernel<T, D>;
  constexpr size_t smem = dq_smem<T, D>();
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Tq + BM - 1) / BM, H);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), static_cast<const int*>(cu_q),
      static_cast<const int*>(cu_k), nseg, H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, const void* cu_q, const void* cu_k,
                    int nseg, int H, int Tq, int Tk, float scale, int causal,
                    cudaStream_t st) {
  auto kern = varlen_bwd_dkv_kernel<T, D>;
  constexpr size_t smem = dkv_smem<T, D>();
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Tk + BM - 1) / BM, H);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<const int*>(cu_q),
      static_cast<const int*>(cu_k), nseg, H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

bool bad_shape(int nseg, int H, int Tq, int Tk) {
  return nseg < 0 || H <= 0 || H > 65535 || Tq <= 0 || Tk <= 0;
}

}  // namespace

// Each entry returns a cudaError_t code: 0 on a successful launch. None
// synchronises; a fault during the run shows at the caller's next sync.
// Tensors are contiguous packed [t, H, D] (q, out, dout, dq: t = Tq; k, v,
// dk, dv: t = Tk); lse and delta are f32 [H, Tq]; cu_q and cu_k are int32
// [nseg + 1] on the device.
extern "C" {

int varlen_fwd_launch(const void* q, const void* k, const void* v, void* out,
                      void* lse, const void* cu_q, const void* cu_k, int nseg,
                      int H, int Tq, int Tk, int D, float scale, int causal,
                      int is_bf16, void* stream) {
  // bf16 runs varlen_fwd_sm90_kernel (flash_varlen_sm90.cu)
  if (is_bf16 || bad_shape(nseg, H, Tq, Tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)fwd<float, 64>(q, k, v, out, lse, cu_q, cu_k, nseg, H, Tq, Tk, scale, causal, st);
  if (D == 128) return (int)fwd<float, 128>(q, k, v, out, lse, cu_q, cu_k, nseg, H, Tq, Tk, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

int varlen_bwd_dq_launch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, const void* cu_q, const void* cu_k,
                         int nseg, int H, int Tq, int Tk, int D, float scale,
                         int causal, int is_bf16, void* stream) {
  if (bad_shape(nseg, H, Tq, Tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64) return (int)bwd_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, cu_q, cu_k, nseg, H, Tq, Tk, scale, causal, st);
    if (D == 128) return (int)bwd_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, cu_q, cu_k, nseg, H, Tq, Tk, scale, causal, st);
  } else {
    if (D == 64) return (int)bwd_dq<float, 64>(q, k, v, dout, lse, delta, dq, cu_q, cu_k, nseg, H, Tq, Tk, scale, causal, st);
    if (D == 128) return (int)bwd_dq<float, 128>(q, k, v, dout, lse, delta, dq, cu_q, cu_k, nseg, H, Tq, Tk, scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

int varlen_bwd_dkv_launch(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv,
                          const void* cu_q, const void* cu_k, int nseg, int H,
                          int Tq, int Tk, int D, float scale, int causal,
                          int is_bf16, void* stream) {
  // bf16 runs varlen_bwd_dkv_sm90_kernel (flash_varlen_sm90.cu)
  if (is_bf16 || bad_shape(nseg, H, Tq, Tk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)bwd_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, cu_q, cu_k, nseg, H, Tq, Tk, scale, causal, st);
  if (D == 128) return (int)bwd_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, cu_q, cu_k, nseg, H, Tq, Tk, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

const char* varlen_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
