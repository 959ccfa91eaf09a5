// Paged-attention decode for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the TPU kernel `_paged_attn_kernel` / `paged_attention`
// (paddlepaddle_tpu/ops/kernels/paged_attention.py:104 / :175), both of its
// variants: full-precision pools (kernel 1) and int8 pools (kernel 1q,
// `quantized=True`, :113-131). Same function: queries q [S, W, h, hd] attend
// each slot's KV through its page table, with pools [pages, ps, kvh, hd],
// page_table [S, P] int32 and lens [S] int32 (slot length before this step).
// In the int8 variant the pools hold int8 codes and k_scale / v_scale
// [pages, kvh] f32 carry one scale per (page, KV head); each element is
// dequantized as float(code) * scale BEFORE it enters q.k or p.v, as the TPU
// kernel does, so the kernel reads the same f32 values as the plain version
// (and as kernel 1 run over pre-dequantized f32 pools). Query w of slot s sees the
// keys at k_pos <= lens[s] + w (bottom-right causal rule); the softmax is
// online, with f32 running max, denominator and accumulator; the mask value
// is -1e30 and the final division uses max(l, 1e-30); the output is written
// in q's dtype. The step's own K/V are scattered into the pool by the
// caller before the launch.
//
// Design (simple and correct first; one program for both variants,
// templated on the pool's element type KV beside q's type T):
//   * One CTA (8 warps) per (KV head g, slot s). It serves that head's
//     rep * W query rows, so each K/V page is read from device memory once
//     per KV head: GQA is contracted against the unrepeated KV heads.
//   * The CTA walks only the n_vis = min(P, ceil((lens + W) / ps)) logical
//     pages that hold a visible key, reading page_table[s, j] itself; the
//     TPU grid instead walked all P pages and redirected the invisible ones
//     to the null page 0. A retired slot (zeroed row) reads the null page.
//   * Pages are double-buffered in shared memory with 16-byte cp.async
//     copies: page j+1 is in flight while page j is computed. An int8 page
//     is staged as codes (16 a copy), a quarter of the f32 bytes and half
//     of the bf16 bytes; the CTA reads scale[page_table[s, j], g] once per
//     visible page (a zeroed row reads the null page's finite scale).
//   * Per page: one thread per (query row, key) computes the f32 dot
//     product over hd from the staged K row (rows padded by 16 bytes so the
//     lanes' 16-byte reads hit distinct banks); one warp per query row
//     updates the running max and denominator; then each thread owns one
//     dim of the accumulator for a group of rows and adds p * V from the
//     staged V page.
//
// Bound: the kernel is memory-bound. Its least time is the bytes of the
// visible K and V rows (codes plus one scale per page and head under int8)
// plus q and out over the card's 3.35 TB/s (the f32 dot products are ~1
// operation per byte at W=1, ~4 under int8, far below the ridge).
// What the design does about it: every visible K/V byte is read once per KV
// head, copies overlap compute, and nothing else is read or written. Known
// limit: a CTA walks its slot's pages in sequence, so the longest slot sets
// the kernel's time, and at 8 slots x 8 KV heads the grid fills 64 of 132
// SMs. Splitting long contexts across CTAs (flash-decoding) is later work,
// and so is factoring the int8 scale out of the dot product (faster, but it
// rounds differently from the plain version).
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
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
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
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// shared memory of one CTA, in bytes, for pool elements of kv_size bytes;
// the wrapper's smem_bytes() mirrors it
__host__ __device__ constexpr size_t smem_bytes(int kv_size, int hd, int ps,
                                                int rows) {
  return 2 * (size_t)ps * (hd + 16 / kv_size) * kv_size   // K, 2 pages
         + 2 * (size_t)ps * hd * kv_size                   // V, 2 pages
         + (size_t)rows * (hd + ps + 3) * sizeof(float);   // q, p, m/l/a
}

// KV == T: full-precision pools (kernel 1); KV == int8_t: int8 codes with
// per-(page, KV head) scales (kernel 1q). k_scale / v_scale are unused
// (null) in the first case.
template <typename T, typename KV, int HD, int W>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const KV* __restrict__ k_pool,
                  const KV* __restrict__ v_pool,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int32_t* __restrict__ page_table,
                  const int32_t* __restrict__ lens, T* __restrict__ out,
                  int h, int kvh, int ps, int P, float scale) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int VEC = 16 / sizeof(KV);       // elements per 16-byte copy
  constexpr int VPR = HD / VEC;              // 16-byte vectors per row
  constexpr int KROW = HD + VEC;             // padded K row in shared memory
  constexpr int TPD = kThreads / HD;         // row groups in the P.V phase
  constexpr int RPT = kMaxRows / TPD;        // rows per thread, P.V phase
  const int g = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rep = h / kvh;
  const int R = W * rep;

  extern __shared__ __align__(16) unsigned char smem[];
  KV* k_s = reinterpret_cast<KV*>(smem);                      // [2][ps][KROW]
  KV* v_s = k_s + 2 * ps * KROW;                              // [2][ps][HD]
  float* q_s = reinterpret_cast<float*>(v_s + 2 * ps * HD);   // [R][HD]
  float* p_s = q_s + R * HD;                                  // [R][ps]
  float* m_s = p_s + R * ps;                                  // [R]
  float* l_s = m_s + R;                                       // [R]
  float* a_s = l_s + R;                                       // [R]

  const int len = max(lens[s], 0);
  const int n_vis = min(P, (len + W + ps - 1) / ps);
  const size_t pos_stride = (size_t)kvh * HD;  // elements between positions

  auto load_page = [&](int j, int buf) {
    const size_t base = ((size_t)page_table[(size_t)s * P + j] * ps * kvh + g)
                        * HD;
    KV* kd = k_s + buf * ps * KROW;
    KV* vd = v_s + buf * ps * HD;
    for (int i = tid; i < ps * VPR; i += kThreads) {
      const int t = i / VPR, c = i - (i / VPR) * VPR;
      cp_async16(kd + t * KROW + c * VEC, k_pool + base + t * pos_stride + c * VEC);
      cp_async16(vd + t * HD + c * VEC, v_pool + base + t * pos_stride + c * VEC);
    }
    cp_async_commit();
  };
  load_page(0, 0);

  // q rows of this head group: row r = w * rep + rr <-> head g * rep + rr
  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int w = r / rep, rr = r % rep;
    q_s[i] = to_f32(q[((size_t)(s * W + w) * h + g * rep + rr) * HD + d]) *
             scale;
  }
  if (tid < R) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int d = tid % HD, rg = tid / HD;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_vis; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_vis) {
      load_page(j + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const KV* kb = k_s + buf * ps * KROW;
    const KV* vb = v_s + buf * ps * HD;
    // this page's scales for KV head g (one broadcast read each); 1.0 and
    // unused in the full-precision variant
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kQuant) {
      const size_t si = (size_t)page_table[(size_t)s * P + j] * kvh + g;
      ksc = k_scale[si];
      vsc = v_scale[si];
    }
    // an element as the plain version sees it: float(code) * scale under
    // int8, the value itself otherwise
    auto kval = [&](KV x) {
      if constexpr (kQuant) return to_f32(x) * ksc; else return to_f32(x);
    };
    auto vval = [&](KV x) {
      if constexpr (kQuant) return to_f32(x) * vsc; else return to_f32(x);
    };

    // scores: one thread per (row, key)
    for (int idx = tid; idx < R * ps; idx += kThreads) {
      const int r = idx / ps, t = idx - (idx / ps) * ps;
      const float4* q4 = reinterpret_cast<const float4*>(q_s + r * HD);
      const uint4* k4 = reinterpret_cast<const uint4*>(kb + t * KROW);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int c = 0; c < VPR; ++c) {
        const uint4 raw = k4[c];
        const KV* kv = reinterpret_cast<const KV*>(&raw);
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 qv = q4[(c * VEC + e) / 4];
          a0 += qv.x * kval(kv[e]);
          a1 += qv.y * kval(kv[e + 1]);
          a2 += qv.z * kval(kv[e + 2]);
          a3 += qv.w * kval(kv[e + 3]);
        }
      }
      p_s[idx] = (j * ps + t <= len + r / rep) ? (a0 + a1) + (a2 + a3)
                                                : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < R; r += kWarps) {
      float* pr = p_s + r * ps;
      float mx = kNegInf;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, pr[t]);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float p = expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // P.V: this thread owns dim d of rows rg, rg + TPD, ... The row test is
    // uniform across a warp, so rows past R cost one branch, not a loop.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + TPD * i;
      if (r < R) {
        const float* pr = p_s + r * ps;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int t = 0;
        for (; t + 4 <= ps; t += 4) {
          a0 += pr[t] * vval(vb[t * HD + d]);
          a1 += pr[t + 1] * vval(vb[(t + 1) * HD + d]);
          a2 += pr[t + 2] * vval(vb[(t + 2) * HD + d]);
          a3 += pr[t + 3] * vval(vb[(t + 3) * HD + d]);
        }
        for (; t < ps; ++t) a0 += pr[t] * vval(vb[t * HD + d]);
        acc[i] = acc[i] * a_s[r] + ((a0 + a1) + (a2 + a3));
      }
    }
    __syncthreads();  // buffer `buf` and p_s are free for the next page
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + TPD * i;
    if (r < R) {
      const int w = r / rep, rr = r % rep;
      out[((size_t)(s * W + w) * h + g * rep + rr) * HD + d] =
          from_f32<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename T, typename KV, int HD, int W>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* page_table, const void* lens, void* out, int S,
                   int h, int kvh, int ps, int P, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(sizeof(KV), HD, ps, W * (h / kvh));
  auto kern = paged_attn_kernel<T, KV, HD, W>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(kvh, S);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lens), static_cast<T*>(out), h, kvh, ps, P,
      scale);
  return cudaGetLastError();
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *pt, *lens;
  void* out;
  int S, h, kvh, ps, P;
  float scale;
  cudaStream_t st;
};

template <typename T, typename KV, int HD>
cudaError_t dispatch_w(int W, const Args& a) {
#define PA_LAUNCH(w)                                                         \
  launch<T, KV, HD, w>(a.q, a.k, a.v, a.ks, a.vs, a.pt, a.lens, a.out, a.S, \
                       a.h, a.kvh, a.ps, a.P, a.scale, a.st)
  switch (W) {
    case 1: return PA_LAUNCH(1);
    case 2: return PA_LAUNCH(2);
    case 3: return PA_LAUNCH(3);
    case 4: return PA_LAUNCH(4);
    default: return cudaErrorInvalidValue;
  }
#undef PA_LAUNCH
}

template <typename T, typename KV>
cudaError_t dispatch_hd(int hd, int W, const Args& a) {
  switch (hd) {
    case 64: return dispatch_w<T, KV, 64>(W, a);
    case 128: return dispatch_w<T, KV, 128>(W, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a successful launch. Does not
// synchronise; a fault during the run shows at the caller's next sync.
// k_scale == v_scale == NULL: full-precision pools of q's type (kernel 1);
// both given: int8 pools with [pages, kvh] f32 scales (kernel 1q).
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const void* k_scale,
                           const void* v_scale, const void* page_table,
                           const void* lens, void* out, int S, int W, int h,
                           int kvh, int hd, int ps, int P, float scale,
                           int is_bf16, void* stream) {
  if (S <= 0 || P <= 0 || ps <= 0 || kvh <= 0 || h % kvh != 0 ||
      W * (h / kvh) > kMaxRows || (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q,   k_pool, v_pool, k_scale, v_scale, page_table, lens, out,
               S,   h,      kvh,    ps,      P,       scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  if (k_scale != nullptr)
    e = is_bf16 ? dispatch_hd<__nv_bfloat16, int8_t>(hd, W, a)
                : dispatch_hd<float, int8_t>(hd, W, a);
  else
    e = is_bf16 ? dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, W, a)
                : dispatch_hd<float, float>(hd, W, a);
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
