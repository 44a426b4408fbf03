// Where the attention kernels find KV column c of (slot b, KV head h): a
// template parameter of every attention body, so that the dense cache and
// the paged pool run the same arithmetic in the same order and differ only
// in the address of a K/V row.
//
//   DenseCols  cache [B, Hkv, S, hd]: column c is row (b*Hkv + h)*S + c.
//   PagedCols  pool [n_pages, Hkv, page, hd] through tables [B, n_lp]:
//              column c is row (pid*Hkv + h)*page + c % page, with
//              pid = tables[b, c / page] clamped into [0, n_pages).
//
// A CTA calls `rows(b, h, Hkv, lo, hi, base)` once, before its column
// loop, with the range [lo, hi) of columns it may read; every thread of
// the CTA must make the call. The paged mapper stages the row base of each
// page that the range touches in the shared-memory array `base` behind
// one CTA barrier, so no K/V load in the loop waits on a page-table read:
// the table is read once per page per CTA. The dense mapper does nothing.
// The launch sizes `base` with the mapper's `stage_pages`: the pages of
// the longest range a CTA can have, which is the whole table row, or
// under a sliding window the window and the `reach` its later rows (and
// any rounding of the range's start down to a tile) add, whatever the
// cache.
#pragma once

#include <cuda_runtime.h>

namespace kv {

// Entries of `base` a CTA needs for a range of at most `cols` columns
// starting anywhere (one more page than the range fills when unaligned),
// and never more than the table row holds.
inline int max_pages(int cols, int page, int n_lp) {
  const int n = (cols + page - 1) / page + 1;
  return n < n_lp ? n : n_lp;
}

struct DenseCols {
  int S;
  struct Rows {
    long long base;
    __device__ __forceinline__ long long operator()(int c) const {
      return base + c;
    }
  };
  __device__ __forceinline__ int n_cols() const { return S; }
  __device__ __forceinline__ Rows rows(int b, int h, int Hkv, int, int,
                                       long long*) const {
    return {(long long)(b * Hkv + h) * S};
  }
  int stage_pages(int, int) const { return 0; }   // stages nothing
};

struct PagedCols {
  const int* __restrict__ tables;
  int n_lp, page, n_pages;
  struct Rows {
    const long long* base;   // row base of pages p0, p0 + 1, ...
    unsigned p0, page;
    __device__ __forceinline__ long long operator()(int c) const {
      const unsigned u = static_cast<unsigned>(c);
      return base[u / page - p0] + u % page;
    }
  };
  __device__ __forceinline__ int n_cols() const { return n_lp * page; }
  __device__ __forceinline__ Rows rows(int b, int h, int Hkv, int lo, int hi,
                                       long long* base) const {
    const int p0 = lo / page;
    const int n = hi > lo ? (hi - 1) / page - p0 + 1 : 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int pid = tables[(long long)b * n_lp + p0 + i];
      pid = min(max(pid, 0), n_pages - 1);
      base[i] = ((long long)pid * Hkv + h) * page;
    }
    __syncthreads();
    return {base, static_cast<unsigned>(p0), static_cast<unsigned>(page)};
  }
  // entries of `base` for a CTA's range under `window` (0: the row)
  int stage_pages(int window, int reach) const {
    return window > 0 ? max_pages(window + reach, page, n_lp) : n_lp;
  }
};

}  // namespace kv
