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
// A CTA reads the range [lo, hi) of columns. When every CTA's range of a
// launch fits one staging (the launch asks `cut`: no), the kernel is the
// instance that stages once and runs one pass; else the instance that
// walks its range in segments:
//
//   for (s_lo = lo; s_lo < hi; s_lo = s_hi) {
//     s_hi = cols.seg_end(s_lo, hi, origin, step);
//     rows = cols.rows(b, h, Hkv, s_lo, s_hi, base);   // every thread
//     ... the loop's steps over [s_lo, s_hi), addresses from rows(c) ...
//     barrier before the next `rows` if s_hi < hi
//   }
//
// The paged mapper's `rows` stages the row base of each page the range
// (or segment) touches in the shared-memory array `base` behind one CTA
// barrier, so no K/V load in the loop waits on a page-table read: the
// table is read once per page per CTA. `base` holds `stage` entries (8
// bytes each), a number the wrapper picks (kernels/build.py's
// STAGE_PAGES at most, fewer for a short row or a sliding window's span)
// and the launch sizes `base` by: it is the one source of that size. A
// range that touches more pages is cut on the loop's own grid of steps
// (origin + k * step columns), each piece touching at most `stage`
// pages. Every step of the loop then lies in one segment and the columns
// are visited in the same order with the same arithmetic as in one pass:
// the bits are those of the dense mapper, which never cuts and stages
// nothing.
#pragma once

#include <cuda_runtime.h>

namespace kv {

// the most columns one step of an attention body's column loop spans (its
// tiles and decode steps); a segment must hold one
constexpr int MAX_STEP = 64;

struct DenseCols {
  int S;
  static constexpr int stage = 0;                  // stages nothing
  static constexpr bool can_cut = false;
  struct Rows {
    long long base;
    __device__ __forceinline__ long long operator()(int c) const {
      return base + c;
    }
  };
  __device__ __forceinline__ int n_cols() const { return S; }
  __device__ __forceinline__ int seg_end(int, int hi, int, int) const {
    return hi;                                      // never cuts
  }
  __device__ __forceinline__ Rows rows(int b, int h, int Hkv, int, int,
                                       long long*) const {
    return {(long long)(b * Hkv + h) * S};
  }
};

struct PagedCols {
  const int* __restrict__ tables;
  int n_lp, page, n_pages;
  int stage;               // entries of `base` one staging holds
  static constexpr bool can_cut = true;
  struct Rows {
    const long long* base;   // row base of pages p0, p0 + 1, ...
    unsigned p0, page;
    __device__ __forceinline__ long long operator()(int c) const {
      const unsigned u = static_cast<unsigned>(c);
      return base[u / page - p0] + u % page;
    }
  };
  __device__ __forceinline__ int n_cols() const { return n_lp * page; }
  // A range of at most `span` columns may touch more pages than one
  // staging holds (else: the whole row is staged, or such a range, which
  // touches at most span / page + 2 pages, fits).
  bool cut(long long span) const {
    return stage < n_lp && (long long)(stage - 1) * page < span;
  }
  // The end of the segment that starts at column lo of [lo, hi): hi if
  // [lo, hi) touches at most `stage` pages; else the last column on the
  // grid origin + k * step (origin <= lo) at or before the first column
  // past `stage` pages from lo's page. That is more than lo, since
  // stage - 1 whole pages lie between, at least a step (`valid`).
  __device__ __forceinline__ int seg_end(int lo, int hi, int origin,
                                         int step) const {
    const int p0 = lo / page;
    if ((hi - 1) / page - p0 < stage) return hi;
    const long long e = (long long)(p0 + stage) * page;
    return origin + (int)((e - origin) / step) * step;
  }
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
  // a staging holds a page, and a row it does not hold whole is cut into
  // segments of at least one step each
  bool valid() const {
    return page >= 1 && n_pages >= 1 && stage >= 1 &&
           (stage >= n_lp || (long long)(stage - 1) * page >= MAX_STEP);
  }
};

}  // namespace kv
