// The packed wire for sm_90a: b-bit symmetric quantize -> BPSK/Rayleigh
// bit-flip channel -> dequantize, one pass over device memory.
//
//   packed_wire        (K1) replaces repro/kernels/quant_channel/kernel.py
//                      :packed_wire_2d (`_packed_kernel` -> `_wire_tile`)
//   packed_wire_mean   (K2) replaces kernel.py:packed_wire_mean_2d
//                      (`_packed_mean_kernel`)
//   quant_channel      (K5) replaces kernel.py:quant_channel_2d
//                      (`_qc_kernel`)
//   packed_wire_philox (K6) replaces kernel.py:packed_wire_2d with
//                      rng_mode="tpu" (`_packed_kernel_tpu_rng`)
//
// Each element: q = clip(rint(x / scale), -qm, qm); code = q + qm in the
// wire's code width; code ^= the low `bits` planes of the flip mask, plane
// b set iff fmix32(rand ^ (b+1)*GOLDEN) < uint32(p * 2^32); q_hat =
// clip(code - qm, -qm, qm); out = q_hat * scale. The arithmetic is the
// plain version's bit for bit: IEEE division and products with explicit
// round-to-nearest intrinsics (no FMA contraction; the build does not use
// --use_fast_math), rintf (half to even, as jnp.round), the threshold as
// the float32 product truncated to uint32.
//
// Per element K1 reads the float (4 B) and its 32-bit rand word (4 B) and
// writes the float (4 B), plus two floats per row. The integer work binds,
// not the bytes: chip_smoke.py counts 10 * bits + 9 operations per element
// (10 per bit plane: the folded constant's XOR, the rest of fmix32, the
// compare, the shift and OR into the mask; 2 per word for fmix32's first
// xor-shift, taken once as in (1) below), 0.31 us at Q8 for the SL leg's
// [224, 256] and 1.47 us for the FL upload's [1080, 256], at 64 lanes per
// SM per clock.
//
// Design (redesigned for Hopper). (1) fmix32's first step, x ^= x >> 16, is
// linear over XOR: pre(r ^ c) = pre(r) ^ pre(c) with pre(v) = v ^ (v >> 16).
// So pre(rand) is taken once per word and each plane XORs in its folded
// constant pre((b+1) * GOLDEN), a compile-time immediate of the unrolled
// plane loop: 2 of fmix32's 8 operations leave the per-plane work, bit for
// bit. The compare with the threshold and the mask stay as they were.
// The plane loop runs outside the 4 words of a vector, so a thread has 4
// independent hash chains per plane. (2) No division: a 2-D grid gives each
// thread its row (x: ry rows per CTA) and its column vector (y: tiles of tx
// vectors), so the row's scale and p are direct loads. (3) The CTA shape
// comes from the buffer (ops.py: wire_geometry): rows per CTA fall until the
// grid covers every SM, so the SL leg's 14,336 vectors spread over 224 CTAs
// instead of 56. Each thread moves one 16-byte vector of floats and one of
// rand words (4 elements), the finest grain that keeps 16-byte loads. K1
// and K6 take 29 registers, K2 39, K5 30, none spills. The
// TPU's sequential grid and VMEM tiles have no counterpart to carry: K2's
// user axis (the Pallas grid's innermost, accumulating dimension) becomes
// a loop inside the thread, in ascending user order, and K5's per-tile
// amax becomes a block reduction in one CTA per 128 x 512 tile. K2, K5 and
// K6 share the element body and the 2-D indexing (K5 keeps its tiles).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr int MAX_BITS = 31;

// fmix32's first xor-shift
__host__ __device__ constexpr uint32_t pre(uint32_t v) {
  return v ^ (v >> 16);
}

// the rest of fmix32, on a word that has had its first xor-shift
__device__ __forceinline__ uint32_t fmix32_rest(uint32_t x) {
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t threshold(float p) {
  return __float2uint_rz(__fmul_rn(p, 4294967296.0f));
}

// The flip masks of N words: plane b of word i is set iff
// fmix32(rand[i] ^ (b+1)*GOLDEN) < thresh, for b < bits.
template <int N>
__device__ __forceinline__ void flip_masks(uint32_t (&m)[N],
                                           const uint32_t (&rand)[N],
                                           int bits, uint32_t thresh) {
  uint32_t r[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r[i] = pre(rand[i]);
    m[i] = 0u;
  }
#pragma unroll
  for (int b = 0; b < MAX_BITS; ++b) {
    if (b >= bits) break;
    const uint32_t salt = pre((uint32_t)(b + 1) * GOLDEN);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      m[i] |= (fmix32_rest(r[i] ^ salt) < thresh ? 1u : 0u) << b;
    }
  }
}

// One element of the wire after its mask is known; Code is the on-wire
// codeword container (uint32_t for the float32 wire, uint8_t for int8 and
// int4: a nibble XOR never carries across the nibble boundary, so the
// byte-packed int4 layout gives the same values as one codeword per byte).
template <typename Code>
__device__ __forceinline__ float wire_elem(float x, uint32_t flips,
                                           float scale, int qm) {
  const float fqm = (float)qm;
  float r = rintf(__fdiv_rn(x, scale));
  r = fminf(fmaxf(r, -fqm), fqm);
  Code code = (Code)((int)r + qm);
  code ^= (Code)flips;
  // the code as int32 minus qm, wrapping as JAX's int32 subtraction does
  // (at 31 bits a flipped code of the negative clip lies below
  // -2^31 + qm); in uint32 the wrap is defined
  int q_hat = (int)((uint32_t)code - (uint32_t)qm);
  q_hat = min(max(q_hat, -qm), qm);
  return __fmul_rn((float)q_hat, scale);
}

template <typename Code>
__device__ __forceinline__ float4 wire_vec(float4 x, uint4 rnd, float scale,
                                           uint32_t thresh, int bits,
                                           int qm) {
  const uint32_t words[4] = {rnd.x, rnd.y, rnd.z, rnd.w};
  uint32_t m[4];
  flip_masks<4>(m, words, bits, thresh);
  return make_float4(wire_elem<Code>(x.x, m[0], scale, qm),
                     wire_elem<Code>(x.y, m[1], scale, qm),
                     wire_elem<Code>(x.z, m[2], scale, qm),
                     wire_elem<Code>(x.w, m[3], scale, qm));
}

// The thread's place in the [rows, vec_cols] grid of 16-byte vectors:
// blockIdx.x * ry + threadIdx.y is its row, blockIdx.y * tx + threadIdx.x
// its column vector (block (tx, ry), grid (ceil(rows / ry),
// ceil(vec_cols / tx))). False past the buffer's edge.
__device__ __forceinline__ bool place(int rows, int vec_cols, int& row,
                                      size_t& v) {
  row = blockIdx.x * blockDim.y + threadIdx.y;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  v = (size_t)row * vec_cols + cv;
  return row < rows && cv < vec_cols;
}

constexpr int MAX_THREADS = 256;

// K1: one thread per 4 elements of the [rows, cols] buffer.
template <typename Code>
__global__ void __launch_bounds__(MAX_THREADS)
    packed_wire_kernel(const float4* __restrict__ buf,
                       const uint4* __restrict__ rand,
                       const float* __restrict__ scale,
                       const float* __restrict__ p, float4* __restrict__ out,
                       int rows, int vec_cols, int bits) {
  int row;
  size_t v;
  if (!place(rows, vec_cols, row, v)) return;
  const int qm = (1 << (bits - 1)) - 1;
  out[v] = wire_vec<Code>(buf[v], rand[v], scale[row], threshold(p[row]),
                          bits, qm);
}

// Philox4x32-10 (Salmon et al., SC'11): the 4 words of counter c under
// key k, as the plain version `ref.philox4x32_10` computes them.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// K6: K1 with each thread's 4 rand words drawn in the kernel, counter
// (vector index, 0, 0, 0) under key (seed, 0): no rand buffer is read.
template <typename Code>
__global__ void __launch_bounds__(MAX_THREADS)
    packed_wire_philox_kernel(const float4* __restrict__ buf,
                              const float* __restrict__ scale,
                              const float* __restrict__ p,
                              float4* __restrict__ out, int rows,
                              int vec_cols, int bits, uint32_t seed) {
  int row;
  size_t v;
  if (!place(rows, vec_cols, row, v)) return;
  const int qm = (1 << (bits - 1)) - 1;
  const uint4 rnd = philox4x32_10(
      make_uint4((uint32_t)v, (uint32_t)(v >> 32), 0u, 0u),
      make_uint2(seed, 0u));
  out[v] = wire_vec<Code>(buf[v], rnd, scale[row], threshold(p[row]), bits,
                          qm);
}

// K2: one thread per 4 elements of the [rows, cols] OUTPUT; users are
// stacked along the input rows and summed in ascending order, each
// product w * y rounded to float32 before its add (the JAX package's
// ordered sum), with no atomics.
template <typename Code>
__global__ void __launch_bounds__(MAX_THREADS)
    packed_wire_mean_kernel(const float4* __restrict__ buf,
                            const uint4* __restrict__ rand,
                            const float* __restrict__ scale,
                            const float* __restrict__ p,
                            const float* __restrict__ w,
                            float4* __restrict__ out, int rows, int vec_cols,
                            int n_users, int bits) {
  int row;
  size_t v;
  if (!place(rows, vec_cols, row, v)) return;
  const int qm = (1 << (bits - 1)) - 1;
  const size_t n_vec = (size_t)rows * vec_cols;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int u = 0; u < n_users; ++u) {
    const size_t r = (size_t)u * rows + row;
    const size_t i = (size_t)u * n_vec + v;
    const float4 y = wire_vec<Code>(buf[i], rand[i], scale[r],
                                    threshold(p[r]), bits, qm);
    const float wu = w[r];
    acc.x = __fadd_rn(acc.x, __fmul_rn(wu, y.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(wu, y.y));
    acc.z = __fadd_rn(acc.z, __fmul_rn(wu, y.z));
    acc.w = __fadd_rn(acc.w, __fmul_rn(wu, y.w));
  }
  out[v] = acc;
}

// K5: one CTA per (bm x bn) tile: the tile's amax by a block reduction
// (max is exact in any order), scale = max(amax, 1e-12) * (1 / qm), then the
// wire math with the scalar p on every element of the tile.
constexpr int QC_THREADS = 1024;

__global__ void __launch_bounds__(QC_THREADS)
    quant_channel_kernel(const float* __restrict__ x,
                         const uint32_t* __restrict__ rand,
                         const float* __restrict__ p,
                         float* __restrict__ out, int N, int bm, int bn,
                         int bits) {
  __shared__ float warp_max[QC_THREADS / 32];
  const long long r0 = (long long)blockIdx.y * bm;
  const long long c0 = (long long)blockIdx.x * bn;
  const int n = bm * bn;
  float m = 0.f;
  for (int t = threadIdx.x; t < n; t += QC_THREADS) {
    m = fmaxf(m, fabsf(x[(r0 + t / bn) * N + c0 + t % bn]));
  }
  for (int o = 16; o > 0; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = warp_max[threadIdx.x];
    for (int o = 16; o > 0; o >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
    }
    if (threadIdx.x == 0) warp_max[0] = m;
  }
  __syncthreads();
  const int qm = (1 << (bits - 1)) - 1;
  // amax times the float32 reciprocal of qm: the compiled JAX kernel's
  // rewrite of its division by the constant qm (the last ulp differs)
  const float scale = __fmul_rn(fmaxf(warp_max[0], 1e-12f),
                                __frcp_rn((float)qm));
  const uint32_t thresh = threshold(p[0]);
  for (int t = threadIdx.x; t < n; t += QC_THREADS) {
    const long long i = (r0 + t / bn) * N + c0 + t % bn;
    const uint32_t word[1] = {rand[i]};
    uint32_t flips[1];
    flip_masks<1>(flips, word, bits, thresh);
    out[i] = wire_elem<uint32_t>(x[i], flips[0], scale, qm);
  }
}

}  // namespace

// The grids of K1, K2 and K6: (ceil(rows / ry), ceil(cols / 4 / tx)) CTAs
// of (tx, ry) threads, tx * ry <= 256 (ops.py: wire_geometry). code_bytes:
// 4 for the float32 wire's uint32 codewords, 1 for int8/int4.
extern "C" int packed_wire(const void* buf, const void* rand,
                           const float* scale, const float* p, void* out,
                           int rows, int cols, int tx, int ry, int bits,
                           int code_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vc = cols / 4;
  if (rows == 0 || vc == 0) return 0;
  const dim3 grid((rows + ry - 1) / ry, (vc + tx - 1) / tx), block(tx, ry);
  if (code_bytes == 1) {
    packed_wire_kernel<uint8_t><<<grid, block, 0, st>>>(
        static_cast<const float4*>(buf), static_cast<const uint4*>(rand),
        scale, p, static_cast<float4*>(out), rows, vc, bits);
  } else {
    packed_wire_kernel<uint32_t><<<grid, block, 0, st>>>(
        static_cast<const float4*>(buf), static_cast<const uint4*>(rand),
        scale, p, static_cast<float4*>(out), rows, vc, bits);
  }
  return (int)cudaGetLastError();
}

extern "C" int packed_wire_philox(const void* buf, const float* scale,
                                  const float* p, void* out, int rows,
                                  int cols, int tx, int ry, int bits,
                                  int code_bytes, unsigned int seed,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vc = cols / 4;
  if (rows == 0 || vc == 0) return 0;
  const dim3 grid((rows + ry - 1) / ry, (vc + tx - 1) / tx), block(tx, ry);
  if (code_bytes == 1) {
    packed_wire_philox_kernel<uint8_t><<<grid, block, 0, st>>>(
        static_cast<const float4*>(buf), scale, p, static_cast<float4*>(out),
        rows, vc, bits, seed);
  } else {
    packed_wire_philox_kernel<uint32_t><<<grid, block, 0, st>>>(
        static_cast<const float4*>(buf), scale, p, static_cast<float4*>(out),
        rows, vc, bits, seed);
  }
  return (int)cudaGetLastError();
}

extern "C" int packed_wire_mean(const void* buf, const void* rand,
                                const float* scale, const float* p,
                                const float* w, void* out, int rows,
                                int cols, int tx, int ry, int n_users,
                                int bits, int code_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vc = cols / 4;
  if (rows == 0 || vc == 0) return 0;
  const dim3 grid((rows + ry - 1) / ry, (vc + tx - 1) / tx), block(tx, ry);
  if (code_bytes == 1) {
    packed_wire_mean_kernel<uint8_t><<<grid, block, 0, st>>>(
        static_cast<const float4*>(buf), static_cast<const uint4*>(rand),
        scale, p, w, static_cast<float4*>(out), rows, vc, n_users, bits);
  } else {
    packed_wire_mean_kernel<uint32_t><<<grid, block, 0, st>>>(
        static_cast<const float4*>(buf), static_cast<const uint4*>(rand),
        scale, p, w, static_cast<float4*>(out), rows, vc, n_users, bits);
  }
  return (int)cudaGetLastError();
}

extern "C" int quant_channel(const float* x, const uint32_t* rand,
                             const float* p, float* out, int M, int N, int bm,
                             int bn, int bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / bn, M / bm);
  quant_channel_kernel<<<grid, QC_THREADS, 0, st>>>(x, rand, p, out, N, bm,
                                                    bn, bits);
  return (int)cudaGetLastError();
}
