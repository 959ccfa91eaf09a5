// Segment bookkeeping of the packed varlen attention kernels
// (flash_varlen.cu, flash_varlen_sm90.cu): which segment a packed row lies
// in, the range of the other side that a query row or a key row sees, and
// the union and intersection of those ranges over a CTA's rows. cu_q and
// cu_k are int32 prefix sums [nseg + 1] on the device; every range is
// clamped to [0, Tq) x [0, Tk), so malformed prefix sums cannot make a
// kernel read or write out of bounds.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace varlen {

constexpr int kEmptyLo = INT_MAX, kEmptyHi = INT_MIN;   // an empty range

// the s in [0, nseg) with cu[s] <= i < cu[s+1], for cu[0] <= i < cu[nseg]:
// the first segment whose end passes i (empty segments are passed over)
__device__ __forceinline__ int find_segment(const int* __restrict__ cu,
                                            int nseg, int i) {
  int lo = 0, hi = nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cu + mid + 1) > i) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// the keys query row i sees, [x, y), or an empty range
__device__ __forceinline__ int2 keys_of_query(const int* __restrict__ cu_q,
                                              const int* __restrict__ cu_k,
                                              int nseg, int Tq, int Tk,
                                              int causal, int i) {
  int2 r = make_int2(kEmptyLo, kEmptyHi);
  if (i < __ldg(cu_q) || i >= min(__ldg(cu_q + nseg), Tq)) return r;
  const int s = find_segment(cu_q, nseg, i);
  const int end_k = __ldg(cu_k + s + 1);
  const int lo = max(__ldg(cu_k + s), 0);
  int hi = min(end_k, Tk);
  if (causal) hi = min(hi, i + (end_k - __ldg(cu_q + s + 1)) + 1);
  if (lo < hi) r = make_int2(lo, hi);
  return r;
}

// the queries that see key j, [x, y), or an empty range
__device__ __forceinline__ int2 queries_of_key(const int* __restrict__ cu_q,
                                               const int* __restrict__ cu_k,
                                               int nseg, int Tq, int Tk,
                                               int causal, int j) {
  int2 r = make_int2(kEmptyLo, kEmptyHi);
  if (j < __ldg(cu_k) || j >= min(__ldg(cu_k + nseg), Tk)) return r;
  const int s = find_segment(cu_k, nseg, j);
  const int end_q = __ldg(cu_q + s + 1);
  int lo = max(__ldg(cu_q + s), 0);
  const int hi = min(end_q, Tq);
  if (causal) lo = max(lo, j - (__ldg(cu_k + s + 1) - end_q));
  if (lo < hi) r = make_int2(lo, hi);
  return r;
}

// the range row i sees: keys of a query row, or queries of a key row
template <bool QUERY_ROWS>
__device__ __forceinline__ int2 range_of_row(const int* __restrict__ cu_q,
                                             const int* __restrict__ cu_k,
                                             int nseg, int Tq, int Tk,
                                             int causal, int i) {
  return QUERY_ROWS ? keys_of_query(cu_q, cu_k, nseg, Tq, Tk, causal, i)
                    : queries_of_key(cu_q, cu_k, nseg, Tq, Tk, causal, i);
}

// One warp's pass over the ROWS rows r0 + r, lane l taking rows l, l + 32,
// ...: each row's range goes to r_lo[r], r_hi[r] when those are given, and
// *span = (x, y, z, w) holds the union [x, y) and the intersection [z, w) of
// the rows' ranges (a row with an empty range empties the intersection).
// Every lane of the warp calls it; the caller synchronises the CTA before
// reading the results.
template <int ROWS, bool QUERY_ROWS>
__device__ __forceinline__ void row_spans(int* r_lo, int* r_hi, int4* span,
                                          const int* __restrict__ cu_q,
                                          const int* __restrict__ cu_k,
                                          int nseg, int Tq, int Tk,
                                          int causal, int r0) {
  static_assert(ROWS % 32 == 0, "whole warps of rows");
  const int lane = threadIdx.x & 31;
  int u_lo = kEmptyLo, u_hi = kEmptyHi, i_lo = INT_MIN, i_hi = INT_MAX;
#pragma unroll
  for (int i = 0; i < ROWS / 32; ++i) {
    const int r = i * 32 + lane;
    const int2 a = range_of_row<QUERY_ROWS>(cu_q, cu_k, nseg, Tq, Tk, causal,
                                            r0 + r);
    if (r_lo != nullptr) {
      r_lo[r] = a.x;
      r_hi[r] = a.y;
    }
    u_lo = min(u_lo, a.x);
    u_hi = max(u_hi, a.y);
    i_lo = max(i_lo, a.x);
    i_hi = min(i_hi, a.y);
  }
  u_lo = __reduce_min_sync(0xffffffffu, u_lo);
  u_hi = __reduce_max_sync(0xffffffffu, u_hi);
  i_lo = __reduce_max_sync(0xffffffffu, i_lo);
  i_hi = __reduce_min_sync(0xffffffffu, i_hi);
  if (lane == 0) *span = make_int4(u_lo, u_hi, i_lo, i_hi);
}

}  // namespace varlen
