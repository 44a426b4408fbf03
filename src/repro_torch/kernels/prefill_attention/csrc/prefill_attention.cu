// Causal chunk-prefill GQA attention for sm_90a: C prompt tokens per slot,
// starting at cache position start[b], against the slot's KV (which
// already holds the chunk's own columns), dense cache or paged pool.
//
//   prefill_attention       replaces repro/kernels/prefill_attention/
//                           kernel.py:prefill_attention (`_prefill_kernel`)
//   paged_prefill_attention replaces repro/kernels/prefill_attention/
//                           kernel.py:paged_prefill_attention
//                           (`_paged_prefill_kernel`)
//
// One CTA per (slot b, KV head h, block of 16 of the C*G query rows). Row
// r sits at position start[b] + r / G and attends columns
// (qpos - window, qpos]; the loop covers the block's union of those spans
// and stops at the block's last causal column, so nothing past the chunk
// is read. Bound by the bytes of the K/V span (see flash_tile.cuh).
#include "flash_tile.cuh"

template <typename T, int HD>
__global__ void __launch_bounds__(flash::THREADS)
    prefill_kernel(const void* q, const void* k, const void* v, float* out,
                   const int* start, int Hkv, int G, int C, int S,
                   int window, float scale) {
  flash::attend_rows<T, HD>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, flash::DenseCols{S}, Hkv, G, C,
      start[blockIdx.x], window, scale);
}

template <typename T, int HD>
__global__ void __launch_bounds__(flash::THREADS)
    paged_prefill_kernel(const void* q, const void* k, const void* v,
                         float* out, const int* tables, const int* start,
                         int Hkv, int G, int C, int n_pages, int page,
                         int n_lp, int window, float scale) {
  flash::attend_rows<T, HD>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out,
      flash::PagedCols{tables, n_lp, page, n_pages}, Hkv, G, C,
      start[blockIdx.x], window, scale);
}

extern "C" int prefill_attention(const void* q, const void* k,
                                 const void* v, float* out, const int* start,
                                 int B, int Hkv, int G, int C, int S, int hd,
                                 int window, float scale, int dtype,
                                 void* stream) {
  const dim3 grid(B, Hkv, (C * G + flash::ROWS - 1) / flash::ROWS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(prefill_kernel, grid, st, q, k, v, out, start, Hkv, G, C, S,
                 window, scale);
  return (int)cudaGetLastError();
}

extern "C" int paged_prefill_attention(const void* q, const void* k_pool,
                                       const void* v_pool, float* out,
                                       const int* tables, const int* start,
                                       int B, int Hkv, int G, int C,
                                       int n_pages, int page, int n_lp,
                                       int hd, int window, float scale,
                                       int dtype, void* stream) {
  const dim3 grid(B, Hkv, (C * G + flash::ROWS - 1) / flash::ROWS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(paged_prefill_kernel, grid, st, q, k_pool, v_pool, out,
                 tables, start, Hkv, G, C, n_pages, page, n_lp, window,
                 scale);
  return (int)cudaGetLastError();
}
