// Conv1D(valid) + bias + ReLU + MaxPool1D(2) for sm_90a: the paper model's
// user-side partition after the embedding gather.
//
//   conv_pool (K3) replaces repro/kernels/conv_pool/kernel.py:conv_pool
//             (`_conv_pool_kernel`)
//
// out[b, p, f] = max over t in {2p, 2p+1} of
//                relu(bias[f] + sum_k sum_e x[b, t+k, e] * w[k, e, f]),
// x [B, T, E], w [K, E, F], bias [F] -> out [B, (T-K+1)//2, F], all f32. A
// last conv position without a partner (T-K+1 odd) is dropped, as the
// stride-2 pool drops it.
//
// What bounds it: at the SL eval slice (B 2048, T 30, E 8, K 3, F 32) the
// call reads 1.97 MB of x and writes 3.67 MB, 1.7 us at 3.35 TB/s; its
// 88 MFLOP (48 per conv output) take 1.3 us at the f32 rate outside the
// tensor cores, so the bytes bind. F = 32 and E = 8 are far too small for
// wgmma, so the arithmetic is plain FMA. Design: one CTA of 256 threads
// takes ROWS batch rows; it copies their x rows (T*E floats each, one
// contiguous span), all of w and the bias into shared memory with
// coalesced loads, then each thread computes one (row, pooled position,
// filter) output at a time: the two conv positions' K*E FMAs each (per
// tap a dot over e, the taps summed in order), bias, ReLU, max. Filters
// are the fastest index, so a warp reads 32 neighbouring w words (no bank
// conflict), broadcasts one x word, and stores 128 contiguous bytes. The
// TPU kernel's padding (E to 8, F to 128, B to its block) is TPU layout
// and is not carried over. Built without --use_fast_math.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
conv_pool_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int B, int T, int E, int K, int F, int P, int rows) {
  extern __shared__ float smem[];
  float* sw = smem;                     // [K, E, F]
  float* sb = sw + K * E * F;           // [F]
  float* sx = sb + F;                   // [rows, T, E]
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, B - row0);
  for (int i = threadIdx.x; i < K * E * F; i += THREADS) sw[i] = w[i];
  for (int i = threadIdx.x; i < F; i += THREADS) sb[i] = bias[i];
  const float* xb = x + (size_t)row0 * T * E;
  for (int i = threadIdx.x; i < nrows * T * E; i += THREADS) sx[i] = xb[i];
  __syncthreads();

  const int n_out = nrows * P * F;
  float* ob = out + (size_t)row0 * P * F;
  for (int o = threadIdx.x; o < n_out; o += THREADS) {
    const int f = o % F;
    const int rp = o / F;
    const int p = rp % P;
    const int r = rp / P;
    const float* x0 = sx + (r * T + 2 * p) * E;   // conv position 2p
    float acc0 = 0.f, acc1 = 0.f;
    for (int k = 0; k < K; ++k) {
      const float* wk = sw + k * E * F + f;
      const float* xa = x0 + k * E;               // position 2p + k
      const float* xc = xa + E;                   // position 2p + 1 + k
      float s0 = 0.f, s1 = 0.f;
      for (int e = 0; e < E; ++e) {
        const float we = wk[e * F];
        s0 = fmaf(xa[e], we, s0);
        s1 = fmaf(xc[e], we, s1);
      }
      acc0 += s0;
      acc1 += s1;
    }
    const float v0 = fmaxf(acc0 + sb[f], 0.f);
    const float v1 = fmaxf(acc1 + sb[f], 0.f);
    ob[o] = fmaxf(v0, v1);
  }
}

}  // namespace

extern "C" int conv_pool(const void* x, const void* w, const void* bias,
                         void* out, int B, int T, int E, int K, int F,
                         int rows, void* stream) {
  const int P = (T - K + 1) / 2;
  const size_t smem =
      sizeof(float) * ((size_t)K * E * F + F + (size_t)rows * T * E);
  const int grid = (B + rows - 1) / rows;
  conv_pool_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, (float*)out, B,
      T, E, K, F, P, rows);
  return (int)cudaGetLastError();
}
