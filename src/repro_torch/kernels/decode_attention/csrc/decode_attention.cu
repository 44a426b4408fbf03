// GQA flash-decode for sm_90a: one new query token per slot against the
// slot's KV prefix, dense cache or paged pool.
//
//   decode_attention       replaces repro/kernels/decode_attention/kernel.py
//                          :decode_attention (`_decode_kernel`)
//   paged_decode_attention replaces repro/kernels/decode_attention/kernel.py
//                          :paged_decode_attention (`_paged_decode_kernel`)
//
// One CTA per (slot b, KV head h) (and per 16 head-group rows when G > 16):
// at the serving shape, B*Hkv = 8*16 = 128 CTAs, about one wave on 132 SMs.
// Row g of the CTA is query head h*G + g at position length[b] - 1, so it
// attends columns [length - window, length); the loop reads exactly those
// columns, page by page through the slot's own table row in the paged
// case, and stops at ceil(length / TILE) tiles. Bound by the bytes of the
// K/V prefix (see flash_tile.cuh).
#include "flash_tile.cuh"

template <typename T, int HD>
__global__ void __launch_bounds__(flash::THREADS)
    decode_kernel(const void* q, const void* k, const void* v, float* out,
                  const int* lengths, int Hkv, int G, int S, int window,
                  float scale) {
  flash::attend_rows<T, HD>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, flash::DenseCols{S}, Hkv, G, 1,
      lengths[blockIdx.x] - 1, window, scale);
}

template <typename T, int HD>
__global__ void __launch_bounds__(flash::THREADS)
    paged_decode_kernel(const void* q, const void* k, const void* v,
                        float* out, const int* tables, const int* lengths,
                        int Hkv, int G, int n_pages, int page, int n_lp,
                        int window, float scale) {
  flash::attend_rows<T, HD>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out,
      flash::PagedCols{tables, n_lp, page, n_pages}, Hkv, G, 1,
      lengths[blockIdx.x] - 1, window, scale);
}

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                float* out, const int* lengths, int B,
                                int Hkv, int G, int S, int hd, int window,
                                float scale, int dtype, void* stream) {
  const dim3 grid(B, Hkv, (G + flash::ROWS - 1) / flash::ROWS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(decode_kernel, grid, st, q, k, v, out, lengths, Hkv, G, S,
                 window, scale);
  return (int)cudaGetLastError();
}

extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, float* out,
                                      const int* tables, const int* lengths,
                                      int B, int Hkv, int G, int n_pages,
                                      int page, int n_lp, int hd, int window,
                                      float scale, int dtype, void* stream) {
  const dim3 grid(B, Hkv, (G + flash::ROWS - 1) / flash::ROWS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(paged_decode_kernel, grid, st, q, k_pool, v_pool, out,
                 tables, lengths, Hkv, G, n_pages, page, n_lp, window,
                 scale);
  return (int)cudaGetLastError();
}
