// Paged-attention decode for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the TPU kernel `_paged_attn_kernel` / `paged_attention`
// (paddlepaddle_tpu/ops/kernels/paged_attention.py:104 / :239), both of its
// variants: full-precision pools (kernel 1) and int8 pools (kernel 1q,
// `quantized=True`, :113-131). Same function: queries q [S, W, h, hd] attend
// each slot's KV through its page table, with pools [pages, ps, kvh, hd],
// page_table [S, P] int32 and lens [S] int32 (slot length before this step).
// In the int8 variant the pools hold int8 codes and k_scale / v_scale
// [pages, kvh] f32 carry one scale per (page, KV head); each element is
// dequantized as float(code) * scale BEFORE it enters q.k or p.v, as the TPU
// kernel does, so the kernel reads the same f32 values as the plain version
// (and as kernel 1 run over pre-dequantized f32 pools). Query w of slot s sees
// the keys at k_pos <= lens[s] + w (bottom-right causal rule); the softmax is
// online, with f32 running max, denominator and accumulator; the mask value
// is -1e30 and the final division uses max(l, 1e-30); the output is written
// in q's dtype. The step's own K/V are scattered into the pool by the caller
// before the launch.
//
// Design: the context is split (flash-decoding), and every warp works in
// every phase. One program for both variants, templated on the pool's
// element type KV beside q's type T and on a bucket RB >= rep * W of query
// rows.
//   * Grid (KV head g, slot s, split). The wrapper's host planner
//     (`split_plan` in paged_attention.py) picks n_split and the pages per
//     split from (S, kvh, P, SM count) alone, never from lens, so the grid
//     is the same for every step of an engine (a captured CUDA graph can
//     replay it). Split i covers logical pages [i*pps, (i+1)*pps); each CTA
//     clips that range to its slot's visible pages n_vis = min(P,
//     ceil((lens + W) / ps)) on the device. A CTA with no visible page
//     writes m = -1e30, l = 0, o = 0.
//   * One CTA (8 warps) serves the rep * W query rows of one KV head, so each
//     K/V page is read from device memory once per KV head (GQA contracted
//     against the unrepeated heads). Its pages stream through two page
//     buffers in shared memory with 16-byte cp.async copies issued by all
//     threads, one page ahead (a deeper ring fits fewer CTAs on an SM and
//     was slower); one __syncthreads a page both publishes the arrived page
//     and frees the other buffer. The split's first page-table entries are
//     read beside lens and each later one a page ahead, and under int8 a
//     page's two scales arrive with it (4-byte cp.async), so no copy waits
//     on a dependent read. A retired slot (zeroed row) reads the null page.
//   * Warps own keys: a page's keys go in chunks of 8 to the warps in turn
//     (chunk c to warp c % 8). A warp keeps its own online-softmax state (m,
//     l and o for every row) over its chunks, so no other barrier is needed
//     inside the loop. For q.k, lane (key l/4, part l%4) takes a quarter of
//     the key's hd as 4-element groups g = 4i + l%4 and sums its products in
//     ascending element order, then the 4 lanes of a key add theirs (two
//     shuffles); K rows are padded by 16 elements so the lanes' reads hit
//     distinct banks. The chunk's max and sum per row take three shuffles;
//     for p.v each lane owns hd/32 contiguous dims of every row and takes the
//     8 probabilities by shuffle. Every K and V element a CTA stages is read,
//     and under int8 converted to float(code) * scale, by exactly one lane
//     once (not once per query row); the page's scales are read once.
//   * At the end the 8 warps' states merge into the CTA's partial in a fixed
//     order (warp 0 to 7) through shared memory, and the CTA writes the
//     unnormalised f32 partial (o, m, l) of its split to scratch the wrapper
//     allocated. A second small kernel on the same stream merges the splits
//     of each (slot, row) in split order: m* = max m_i, l = sum l_i
//     e^(m_i - m*), out = sum o_i e^(m_i - m*) / max(l, 1e-30), in q's dtype.
//     Logits run in log2 units (q is pre-scaled by scale * log2(e); exp2f).
//     Both variants take the same splits, the same order of every sum and the
//     same merge, so 1q over int8 pools stays bit-equal to kernel 1 over the
//     same pools dequantized to f32.
//
// Bound: the kernel is memory-bound. Its least time is the bytes of the
// visible K and V rows (codes plus one scale per page and head under int8)
// plus q and out over the card's 3.35 TB/s (the f32 dot products are ~1
// operation per byte at W=1, ~4 under int8, far below the ridge). What the
// design does about it: every visible K/V byte is read once per KV head, the
// split puts 4 CTAs' worth of work per SM on the grid (S 8 x kvh 8 x 8 splits
// of 4 pages at the Llama-3-8B decode shape) so that enough pages are in
// flight, and three CTAs fit an SM at bf16. What limits it: the
// partials cost a second launch and 2 x n_split x rows x hd f32 of scratch
// traffic; a split whose pages lie past a short slot's end launches a CTA that
// only writes an empty partial; and at W = 1 half the CTAs of a uniform lens
// draw find no page, so the work per SM follows the lens.
//
// Limits checked by the Python wrapper before launch: hd in {64, 128},
// 1 <= W <= 4, rep * W <= 32, shared memory <= 227 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 32;                       // rep * W
constexpr int kStages = 2;                         // pages in the ring
constexpr int kChunk = 8;                          // keys a warp takes at once
constexpr int kKPad = 16;                          // K row padding, elements
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// 4 bytes through L1 (cp.async takes 4, 8 or 16 bytes with .ca)
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// N consecutive pool elements as f32, in order
template <int N>
__device__ __forceinline__ void load_f32(float (&dst)[N], const float* src) {
  static_assert(N % 2 == 0, "pairs");
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const float2 v = *reinterpret_cast<const float2*>(src + i);
    dst[i] = v.x; dst[i + 1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void load_f32(float (&dst)[N],
                                         const __nv_bfloat16* src) {
  static_assert(N % 2 == 0, "pairs");
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src + i));
    dst[i] = v.x; dst[i + 1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void load_f32(float (&dst)[N], const int8_t* src) {
  static_assert(N % 2 == 0, "pairs");
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const char2 v = *reinterpret_cast<const char2*>(src + i);
    dst[i] = static_cast<float>(v.x); dst[i + 1] = static_cast<float>(v.y);
  }
}

// query rows a CTA serves, rounded up to the template's bucket
__host__ __device__ constexpr int row_bucket(int rows) {
  return rows <= 4 ? 4 : rows <= 8 ? 8 : rows <= 16 ? 16 : 32;
}

// shared memory of one CTA, in bytes, for pool elements of kv_size bytes;
// the wrapper's smem_bytes() mirrors it
__host__ __device__ constexpr size_t smem_bytes(int kv_size, int hd, int ps,
                                                int rows) {
  return (size_t)kStages * ps * (2 * hd + kKPad) * kv_size  // K and V pages
         + (size_t)row_bucket(rows) * hd * sizeof(float)     // q, then o
         + (size_t)(kWarps + 1) * row_bucket(rows) * sizeof(float)   // m, l
         + (size_t)kStages * 2 * sizeof(float);       // the pages' scales
}

// KV == T: full-precision pools (kernel 1); KV == int8_t: int8 codes with
// per-(page, KV head) scales (kernel 1q). k_scale / v_scale are unused
// (null) in the first case. Writes split `blockIdx.z`'s partial:
// o_part [n_split, S, W, h, HD], m_part / l_part [n_split, S, W, h], f32, m in
// log2 units.
template <typename T, typename KV, int HD, int RB>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const KV* __restrict__ k_pool,
                  const KV* __restrict__ v_pool,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int32_t* __restrict__ page_table,
                  const int32_t* __restrict__ lens, float* __restrict__ o_part,
                  float* __restrict__ m_part, float* __restrict__ l_part,
                  int S, int W, int h, int kvh, int ps, int P, int pps,
                  float scale) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int VEC = 16 / sizeof(KV);       // elements per 16-byte copy
  constexpr int VPR = HD / VEC;              // 16-byte vectors per row
  constexpr int KROW = HD + kKPad;           // padded K row in shared memory
  constexpr int GPL = HD / 16;               // 4-element groups a lane takes
  constexpr int DPL = HD / 32;               // dims a lane owns in p.v
  const int g = blockIdx.x;
  const int s = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int kk = lane >> 2, part = lane & 3;
  const int rep = h / kvh;
  const int R = W * rep;

  extern __shared__ __align__(16) unsigned char smem[];
  KV* k_s = reinterpret_cast<KV*>(smem);                     // [kStages][ps][KROW]
  KV* v_s = k_s + kStages * ps * KROW;                       // [kStages][ps][HD]
  float* q_s = reinterpret_cast<float*>(v_s + kStages * ps * HD);  // [RB][HD]
  float* m_s = q_s + RB * HD;                                // [kWarps][RB]
  float* l_s = m_s + kWarps * RB;                            // [RB]
  float* sc_s = l_s + RB;                        // [kStages][2]: k, v scale

  // the split's first page-table entries do not depend on lens: they are
  // read beside it, so the first copies wait for one memory round trip less
  const int j0 = split * pps;
  const int32_t* pt_row = page_table + (size_t)s * P;
  int pid[kStages];
#pragma unroll
  for (int i = 0; i < kStages; ++i) pid[i] = j0 + i < P ? pt_row[j0 + i] : 0;
  const int len = max(lens[s], 0);
  const int n_vis = min(P, (len + W + ps - 1) / ps);
  const int j1 = min(j0 + pps, n_vis);
  const int n_pages = max(j1 - j0, 0);
  const size_t pos_stride = (size_t)kvh * HD;  // elements between positions

  // page `page` into ring buffer `buf`, with its two scales under int8
  auto load_page = [&](int page, int buf) {
    const size_t base = ((size_t)page * ps * kvh + g) * HD;
    if constexpr (kQuant) {
      if (tid == 0) {
        cp_async4(sc_s + 2 * buf, k_scale + (size_t)page * kvh + g);
        cp_async4(sc_s + 2 * buf + 1, v_scale + (size_t)page * kvh + g);
      }
    }
    KV* kd = k_s + buf * ps * KROW;
    KV* vd = v_s + buf * ps * HD;
    for (int i = tid; i < ps * VPR; i += kThreads) {
      const int t = i / VPR, c = i - (i / VPR) * VPR;
      cp_async16(kd + t * KROW + c * VEC,
                 k_pool + base + t * pos_stride + c * VEC);
      cp_async16(vd + t * HD + c * VEC,
                 v_pool + base + t * pos_stride + c * VEC);
    }
  };
  // the ring runs kStages - 1 pages ahead; a group is committed for every
  // page slot, loaded or not, so wait_group counts stay uniform
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_pages) load_page(pid[i], i);
    cp_async_commit();
  }
  int next = pid[kStages - 1];               // page of the next copy

  // q rows of this head group, pre-scaled into log2 units: row r = w * rep +
  // rr <-> head g * rep + rr; rows past R are zero
  const float ql2 = scale * kLog2e;
  for (int i = tid; i < RB * HD; i += kThreads) {
    const int r = i / HD, d = i - (i / HD) * HD;
    float x = 0.f;
    if (r < R) {
      const int w = r / rep, rr = r - (r / rep) * rep;
      x = to_f32(q[((size_t)(s * W + w) * h + g * rep + rr) * HD + d]) * ql2;
    }
    q_s[i] = x;
  }

  float m[RB], l[RB], o[RB][DPL];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[r][e] = 0.f;
  }
  const int n_chunks = (ps + kChunk - 1) / kChunk;

  for (int jj = 0; jj < n_pages; ++jj) {
    const int j = j0 + jj;
    cp_async_wait<kStages - 2>();
    __syncthreads();     // page jj visible to all; buffer (jj - 1) % kStages free
    if (jj + kStages - 1 < n_pages)
      load_page(next, (jj + kStages - 1) % kStages);
    cp_async_commit();
    // the entry after it, read now and used at the next page
    next = j + kStages < P ? pt_row[j + kStages] : 0;

    const KV* kb = k_s + (jj % kStages) * ps * KROW;
    const KV* vb = v_s + (jj % kStages) * ps * HD;
    // this page's scales for KV head g, staged with the page; 1.0 and
    // unused in the full-precision variant
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kQuant) {
      ksc = sc_s[2 * (jj % kStages)];
      vsc = sc_s[2 * (jj % kStages) + 1];
    }

    for (int c = warp; c < n_chunks; c += kWarps) {
      const int t0 = c * kChunk;
      const int pos0 = j * ps + t0;
      if (pos0 > len + W - 1) break;      // no row sees this chunk (warp-uniform)
      const int t = t0 + kk;
      const bool key_ok = t < ps;
      const int pos = pos0 + kk;

      // q.k: this lane's quarter of key t, in ascending element order
      float sc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) sc[r] = 0.f;
      if (key_ok) {
        const KV* krow = kb + t * KROW;
#pragma unroll
        for (int i = 0; i < GPL; ++i) {
          const int e0 = (4 * i + part) * 4;
          float kf[4];
          load_f32<4>(kf, krow + e0);
          if constexpr (kQuant) {
#pragma unroll
            for (int e = 0; e < 4; ++e) kf[e] = kf[e] * ksc;
          }
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float4 qv = *reinterpret_cast<const float4*>(
                q_s + r * HD + e0);
            sc[r] = fmaf(qv.x, kf[0], sc[r]);
            sc[r] = fmaf(qv.y, kf[1], sc[r]);
            sc[r] = fmaf(qv.z, kf[2], sc[r]);
            sc[r] = fmaf(qv.w, kf[3], sc[r]);
          }
        }
      }
      // the key's four lanes add their parts; then online softmax over the
      // chunk's 8 keys (lanes 4*kk .. 4*kk + 3 hold key kk)
      float p[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float x = sc[r];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        const bool vis = key_ok && r < R && pos <= len + r / rep;
        x = vis ? x : kNegInf;
        float mx = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m[r], mx);
        const float pr = vis ? exp2f(x - m_new) : 0.f;
        float sum = pr + __shfl_xor_sync(0xffffffffu, pr, 4);
        sum += __shfl_xor_sync(0xffffffffu, sum, 8);
        sum += __shfl_xor_sync(0xffffffffu, sum, 16);
        const float alpha = exp2f(m[r] - m_new);
        l[r] = l[r] * alpha + sum;
        m[r] = m_new;
#pragma unroll
        for (int e = 0; e < DPL; ++e) o[r][e] *= alpha;
        p[r] = pr;
      }
      // p.v: this lane's dims of every row, keys in ascending order
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (t0 + u < ps) {                  // warp-uniform
          float vf[DPL];
          load_f32<DPL>(vf, vb + (t0 + u) * HD + lane * DPL);
          if constexpr (kQuant) {
#pragma unroll
            for (int e = 0; e < DPL; ++e) vf[e] = vf[e] * vsc;
          }
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float pu = __shfl_sync(0xffffffffu, p[r], 4 * u);
#pragma unroll
            for (int e = 0; e < DPL; ++e) o[r][e] = fmaf(pu, vf[e], o[r][e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // merge the warps' states in warp order; q_s is reused for o
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RB; ++r) m_s[warp * RB + r] = m[r];
  }
  __syncthreads();                          // m_s written, q_s no longer read
  float f[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    float ms = m_s[r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) ms = fmaxf(ms, m_s[w * RB + r]);
    f[r] = exp2f(m[r] - ms);
  }
  float* acc = q_s;                         // [RB][HD]
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const float x = o[r][e] * f[r];
          float* a = acc + r * HD + lane * DPL + e;
          *a = w == 0 ? x : *a + x;
        }
        if (lane == 0) l_s[r] = w == 0 ? l[r] * f[r] : l_s[r] + l[r] * f[r];
      }
    }
    __syncthreads();
  }

  // the split's partial, rows r < R
  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i - (i / HD) * HD;
    const int w = r / rep, rr = r - (r / rep) * rep;
    const size_t row = ((size_t)(split * S + s) * W + w) * h + g * rep + rr;
    o_part[row * HD + d] = acc[i];
    if (d == 0) {
      float ms = m_s[r];
#pragma unroll
      for (int ww = 1; ww < kWarps; ++ww) ms = fmaxf(ms, m_s[ww * RB + r]);
      m_part[row] = ms;
      l_part[row] = l_s[r];
    }
  }
}

// out[row] = sum_i o_i 2^(m_i - m*) / max(sum_i l_i 2^(m_i - m*), 1e-30), the
// splits taken in order; one CTA of HD threads per (slot, w, head) row
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
paged_merge_kernel(const float* __restrict__ o_part,
                   const float* __restrict__ m_part,
                   const float* __restrict__ l_part, T* __restrict__ out,
                   int rows, int n_split) {
  const int row = blockIdx.x;
  const int d = threadIdx.x;
  float ms = kNegInf;
  for (int i = 0; i < n_split; ++i)
    ms = fmaxf(ms, m_part[(size_t)i * rows + row]);
  float l = 0.f, acc = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const size_t r = (size_t)i * rows + row;
    const float wgt = exp2f(m_part[r] - ms);
    l += l_part[r] * wgt;
    acc += o_part[r * HD + d] * wgt;
  }
  out[(size_t)row * HD + d] = from_f32<T>(acc / fmaxf(l, 1e-30f));
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *pt, *lens;
  void *out, *o_part, *m_part, *l_part;
  int S, W, h, kvh, ps, P, n_split, pps;
  float scale;
  cudaStream_t st;
};

template <typename T, typename KV, int HD, int RB>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes(sizeof(KV), HD, a.ps, a.W * (a.h / a.kvh));
  auto kern = paged_attn_kernel<T, KV, HD, RB>;
  // Function attributes are set once per instantiation (and again only for
  // a larger shared-memory size), not on every launch: the serving engine
  // captures its decode chunk as a CUDA graph, and its first launch of
  // every instantiation is eager, ahead of the capture.
  static size_t smem_set = 48 * 1024;
  static bool carveout_set = false;
  cudaError_t e;
  if (smem > smem_set) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  if (!carveout_set) {
    // the largest shared-memory carveout, so two bf16 CTAs fit on an SM
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    carveout_set = true;
  }
  dim3 grid(a.kvh, a.S, a.n_split);
  kern<<<grid, kThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int32_t*>(a.pt),
      static_cast<const int32_t*>(a.lens), static_cast<float*>(a.o_part),
      static_cast<float*>(a.m_part), static_cast<float*>(a.l_part), a.S, a.W,
      a.h, a.kvh, a.ps, a.P, a.pps, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int rows = a.S * a.W * a.h;
  paged_merge_kernel<T, HD><<<rows, HD, 0, a.st>>>(
      static_cast<const float*>(a.o_part), static_cast<const float*>(a.m_part),
      static_cast<const float*>(a.l_part), static_cast<T*>(a.out), rows,
      a.n_split);
  return cudaGetLastError();
}

template <typename T, typename KV, int HD>
cudaError_t dispatch_rows(const Args& a) {
  switch (row_bucket(a.W * (a.h / a.kvh))) {
    case 4: return launch<T, KV, HD, 4>(a);
    case 8: return launch<T, KV, HD, 8>(a);
    case 16: return launch<T, KV, HD, 16>(a);
    case 32: return launch<T, KV, HD, 32>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename KV>
cudaError_t dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 64: return dispatch_rows<T, KV, 64>(a);
    case 128: return dispatch_rows<T, KV, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when both launches (the split kernel and the
// merge) were accepted. Does not synchronise; a fault during the run shows at
// the caller's next sync. k_scale == v_scale == NULL: full-precision pools of
// q's type (kernel 1); both given: int8 pools with [pages, kvh] f32 scales
// (kernel 1q). o_part [n_split, S, W, h, hd], m_part / l_part
// [n_split, S, W, h] are f32 scratch the caller allocates; n_split *
// pages_per_split must cover P.
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const void* k_scale,
                           const void* v_scale, const void* page_table,
                           const void* lens, void* out, void* o_part,
                           void* m_part, void* l_part, int S, int W, int h,
                           int kvh, int hd, int ps, int P, int n_split,
                           int pages_per_split, float scale, int is_bf16,
                           void* stream) {
  if (S <= 0 || P <= 0 || ps <= 0 || kvh <= 0 || h % kvh != 0 || W < 1 ||
      W * (h / kvh) > kMaxRows || n_split < 1 || pages_per_split < 1 ||
      (long long)n_split * pages_per_split < P ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, k_scale, v_scale, page_table, lens, out,
               o_part, m_part, l_part, S, W, h, kvh, ps, P, n_split,
               pages_per_split, scale, static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  if (k_scale != nullptr)
    e = is_bf16 ? dispatch_hd<__nv_bfloat16, int8_t>(hd, a)
                : dispatch_hd<float, int8_t>(hd, a);
  else
    e = is_bf16 ? dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, a)
                : dispatch_hd<float, float>(hd, a);
  return (int)e;
}

// The CTA's dynamic shared memory, for the wrapper's mirror to be checked
// against.
long long paged_attention_smem_bytes(int kv_size, int hd, int ps, int rows) {
  return (long long)smem_bytes(kv_size, hd, ps, rows);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
