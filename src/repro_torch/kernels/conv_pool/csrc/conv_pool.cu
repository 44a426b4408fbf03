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
// call reads 1.97 MB of x and writes 3.67 MB, 1.68 us at 3.35 TB/s; its
// 88 MFLOP (48 per conv output) take 1.37 us at the f32 rate outside the
// tensor cores, so the bytes bind. At the two-party uplink batch (B 512)
// the bound is 0.42 us, below the cost of one launch. F = 32 and E = 8 are
// far too small for wgmma, so the arithmetic is plain FMA.
//
// Design. A warp owns one (row, group of 32 filters, span of pooled
// positions); lane l computes filter 32g + l (lanes past F idle). Each lane
// holds its filter's K x E weight column and its bias in registers, loaded
// once. The span's x positions are contiguous in the row: the warp copies
// them into its slice of shared memory in one coalesced pass (one 16-byte
// load per lane at the paper's shapes), so the row costs one memory round
// trip and not one per position. The warp then walks the positions in
// order: each is read once, as E/4 broadcast 16-byte shared-memory loads
// (every lane reads the same address), and feeds the K conv outputs it
// touches from registers: output t receives tap k from x[t+k], so the taps
// arrive in order k = 0, 1, ... and each output keeps the summation order
// of the kernel it replaced (per tap a dot over e from 0, the taps summed
// in order, then the bias), so it gives that kernel's bits. K running sums
// rotate as the walk moves on. ReLU and the pool max are taken in
// registers, and a warp stores 128 contiguous bytes per (row, pooled
// position). The launch geometry (span length, CTAs of 4 warps) comes from
// the shapes (ops.py: conv_geometry): the uplink batch (B 512) gets 640
// CTAs, spans of 3 pooled positions, 19 warps per SM; the eval slice 1,024
// CTAs, spans of 7. E and K are template parameters (E in {4, 8, 16}, K in
// 1..5), so the weight column and the x registers are indexed at compile
// time; at E 8, K 3 a lane holds 24 weights, 16 x words and 3 sums (56
// registers, no spills; 128 at E 16, K 5). The
// TPU kernel's padding (E to 8, F to 128, B to its block) is TPU layout
// and is not carried over. Built without --use_fast_math.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;                 // warps per CTA (ops.py: WARPS)
constexpr int THREADS = 32 * WARPS;

template <int E>
__device__ __forceinline__ void load_pos(float (&v)[E], const float4* q) {
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const float4 a = q[i];
    v[4 * i] = a.x;
    v[4 * i + 1] = a.y;
    v[4 * i + 2] = a.z;
    v[4 * i + 3] = a.w;
  }
}

// One x position into the K running sums: acc[j] is conv output
// (position - K + 1 + j), which takes tap K-1-j from this position. On
// return the finished output (acc[0]) is given back and the sums rotate.
template <int E, int K>
__device__ __forceinline__ float step(float (&acc)[K], float (&xv)[E],
                                      float (&wr)[K][E]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) s = fmaf(xv[e], wr[K - 1 - j][e], s);
    acc[j] += s;
  }
  const float done = acc[0];
#pragma unroll
  for (int j = 0; j + 1 < K; ++j) acc[j] = acc[j + 1];
  acc[K - 1] = 0.f;
  return done;
}

// Positions a warp stages for a span of `span` pooled positions.
__host__ __device__ constexpr int staged(int span, int K) {
  return 2 * span + K - 1;
}

template <int E, int K>
__global__ void __launch_bounds__(THREADS)
conv_pool_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int B, int T, int F, int P, int span, int n_spans,
                 int n_groups) {
  extern __shared__ float4 sx[];           // [WARPS][staged(span, K) * E/4]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * WARPS + warp;
  // units in (row, group, span) order: the warps of a CTA share a row
  const int j = unit % n_spans;
  const int rg = unit / n_spans;
  const int g = rg % n_groups;
  const int b = rg / n_groups;
  if (b >= B) return;
  const int f = 32 * g + lane;
  const bool live = f < F;
  const int p0 = j * span;
  const int p1 = min(P, p0 + span);

  // the span's x positions [2*p0, 2*p1 + K - 1), contiguous in the row,
  // one coalesced pass into this warp's slice of shared memory
  float4* xs = sx + warp * (staged(span, K) * E / 4);
  const float4* src =
      reinterpret_cast<const float4*>(x + ((size_t)b * T + 2 * p0) * E);
  const int n4 = staged(p1 - p0, K) * E / 4;
  // not unrolled: one pass per lane at the paper's shapes, and unrolled
  // copies make ptxas spill in the K = 1 instances
#pragma unroll 1
  for (int i = lane; i < n4; i += 32) xs[i] = __ldg(src + i);

  float wr[K][E];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      wr[k][e] = live ? __ldg(w + (k * E + e) * F + f) : 0.f;
    }
  }
  const float bf = live ? __ldg(bias + f) : 0.f;
  __syncwarp();

  float acc[K];
#pragma unroll
  for (int i = 0; i < K; ++i) acc[i] = 0.f;
  // the first K-1 positions only start sums (outputs before 2*p0)
#pragma unroll
  for (int i = 0; i + 1 < K; ++i) {
    float xv[E];
    load_pos<E>(xv, xs + i * (E / 4));
    step<E, K>(acc, xv, wr);
  }
  // pooled position p completes at positions 2p+K-1 and 2p+K; every lane
  // reads the same 16-byte words (a broadcast)
  float* ob = out + ((size_t)b * P + p0) * F + f;
  const float4* xp = xs + (K - 1) * (E / 4);
  for (int p = p0; p < p1; ++p, xp += E / 2, ob += F) {
    float xa[E], xc[E];
    load_pos<E>(xa, xp);
    load_pos<E>(xc, xp + E / 4);
    const float c0 = step<E, K>(acc, xa, wr);
    const float c1 = step<E, K>(acc, xc, wr);
    const float v0 = fmaxf(c0 + bf, 0.f);
    const float v1 = fmaxf(c1 + bf, 0.f);
    if (live) *ob = fmaxf(v0, v1);
  }
}

template <int E, int K>
int launch(const float* x, const float* w, const float* bias, float* out,
           int B, int T, int F, int P, int span, int n_spans, int n_groups,
           int ctas, cudaStream_t st) {
  const size_t smem = sizeof(float) * WARPS * staged(span, K) * E;
  conv_pool_kernel<E, K><<<ctas, THREADS, smem, st>>>(
      x, w, bias, out, B, T, F, P, span, n_spans, n_groups);
  return (int)cudaGetLastError();
}

template <int E>
int launch_k(int K, const float* x, const float* w, const float* bias,
             float* out, int B, int T, int F, int P, int span, int n_spans,
             int n_groups, int ctas, cudaStream_t st) {
  switch (K) {
    case 1: return launch<E, 1>(x, w, bias, out, B, T, F, P, span, n_spans,
                                n_groups, ctas, st);
    case 2: return launch<E, 2>(x, w, bias, out, B, T, F, P, span, n_spans,
                                n_groups, ctas, st);
    case 3: return launch<E, 3>(x, w, bias, out, B, T, F, P, span, n_spans,
                                n_groups, ctas, st);
    case 4: return launch<E, 4>(x, w, bias, out, B, T, F, P, span, n_spans,
                                n_groups, ctas, st);
    case 5: return launch<E, 5>(x, w, bias, out, B, T, F, P, span, n_spans,
                                n_groups, ctas, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// span, n_spans, n_groups and ctas come from ops.py's conv_geometry, which
// also rejects every (E, K) without an instance here.
extern "C" int conv_pool(const void* x, const void* w, const void* bias,
                         void* out, int B, int T, int E, int K, int F,
                         int span, int n_spans, int n_groups, int ctas,
                         void* stream) {
  const int P = (T - K + 1) / 2;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  const float* bf = (const float*)bias;
  float* of = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (E) {
    case 4: return launch_k<4>(K, xf, wf, bf, of, B, T, F, P, span, n_spans,
                               n_groups, ctas, st);
    case 8: return launch_k<8>(K, xf, wf, bf, of, B, T, F, P, span, n_spans,
                               n_groups, ctas, st);
    case 16: return launch_k<16>(K, xf, wf, bf, of, B, T, F, P, span,
                                 n_spans, n_groups, ctas, st);
  }
  return (int)cudaErrorInvalidValue;
}
