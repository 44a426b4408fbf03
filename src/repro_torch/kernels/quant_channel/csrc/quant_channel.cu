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
// and K6 take 29 registers, K2 39, none spills. The TPU's sequential grid
// and VMEM tiles have no counterpart to carry: K2's user axis (the Pallas
// grid's innermost, accumulating dimension) becomes a loop inside the
// thread, in ascending user order. K2 and K6 share K1's element body and
// 2-D indexing.
//
// K5 keeps its tiles (min(128, M) x min(512, N), one amax scale each), but
// a tile is no longer one CTA: it is one thread-block cluster of C CTAs on
// neighbouring SMs (ops.py: qc_geometry; C up to the non-portable 16), so
// the model's [256, 512] runs on 32 SMs instead of 2. Each CTA takes a contiguous slice of the tile's rows,
// walks it with K1's 2-D indexing (a thread's column vector and row, steps
// of the CTA's width and height, no division per element) and loads its x
// and rand words once, as 16-byte vectors where the tile's width is a
// multiple of 4 (one word at a time otherwise), into registers. The CTA's
// amax (warp shuffles, then shared memory) is published in its shared
// memory; after a cluster barrier one warp reads the C - 1 peers' maxima
// through distributed shared memory and takes the tile's. Max is exact in
// any order, so the scale has the one-CTA kernel's bits. The elements then
// run K1's body (4 independent hash chains a plane) on the registers, and
// `out` is written once. A second cluster barrier, arrived at after the
// peers' maxima are read and waited for before exit, keeps each CTA's
// shared memory alive while a peer may read it. K5 takes 61 registers (128
// in its one-word instance), none spills. At the model's [256, 512] its 32
// CTAs leave 100 SMs idle: each CTA's 4,096 elements of integer work and
// its chain of load, reductions, cluster barriers and store bind it, not
// the bytes.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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

// K5: one cluster of CTAs per (bm x bn) tile. VEC (4 or 1) is the
// elements of one load; a thread holds QC_WORDS elements, `rows` rows of
// the tile a CTA (the last CTA of a cluster may hold fewer).
constexpr int QC_MAX_THREADS = 512;
constexpr int QC_WORDS = 16;
constexpr int QC_TX = 128;              // column loads across a CTA, at most

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int VEC>
__global__ void __launch_bounds__(QC_MAX_THREADS)
    quant_channel_kernel(const float* __restrict__ x,
                         const uint32_t* __restrict__ rand,
                         const float* __restrict__ p,
                         float* __restrict__ out, int N, int bm, int bn,
                         int rows, int bits) {
  constexpr int ITEMS = QC_WORDS / VEC;
  __shared__ float warp_max[QC_MAX_THREADS / 32];
  __shared__ float cta_max, tile_max;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / C, tiles_n = N / bn;
  const int ti = tile / tiles_n, tj = tile - ti * tiles_n;
  const int vc = bn / VEC;
  const int tx = min(vc, QC_TX), ry = blockDim.x / tx;
  const int ty = threadIdx.x / tx, cx = threadIdx.x - ty * tx;
  const int row0 = rank * rows + ty, row1 = min(bm, (rank + 1) * rows);
  const float* xt = x + (size_t)ti * bm * N + (size_t)tj * bn;
  const uint32_t* rt = rand + (size_t)ti * bm * N + (size_t)tj * bn;
  float* ot = out + (size_t)ti * bm * N + (size_t)tj * bn;

  // the thread's items: column load cv of row r, cv stepping by tx, then
  // r by ry; `ok` falls to false once and stays there
  float xv[QC_WORDS];
  uint32_t rv[QC_WORDS];
  bool ok[ITEMS];
  float m = 0.f;
  {
    int r = row0, cv = cx;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      ok[k] = ty < ry && r < row1;
      const size_t i = (size_t)r * N + (size_t)cv * VEC;
      if constexpr (VEC == 4) {
        const float4 a = ok[k] ? *reinterpret_cast<const float4*>(xt + i)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        const uint4 b = ok[k] ? *reinterpret_cast<const uint4*>(rt + i)
                              : make_uint4(0u, 0u, 0u, 0u);
        xv[4 * k] = a.x;
        xv[4 * k + 1] = a.y;
        xv[4 * k + 2] = a.z;
        xv[4 * k + 3] = a.w;
        rv[4 * k] = b.x;
        rv[4 * k + 1] = b.y;
        rv[4 * k + 2] = b.z;
        rv[4 * k + 3] = b.w;
      } else {
        xv[k] = ok[k] ? xt[i] : 0.f;
        rv[k] = ok[k] ? rt[i] : 0u;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) m = fmaxf(m, fabsf(xv[VEC * k + e]));
      cv += tx;
      if (cv >= vc) {
        cv = cx;
        r += ry;
      }
    }
  }

  // the CTA's amax, published in its shared memory
  for (int o = 16; o > 0; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < (blockDim.x >> 5) ? warp_max[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
    }
    if (threadIdx.x == 0) cta_max = m;
  }
  cluster_arrive();
  cluster_wait();
  // the tile's amax from every CTA of the cluster (distributed shared
  // memory); then the second barrier's arrival: this CTA reads no peer
  // after it
  if (threadIdx.x < 32) {
    m = threadIdx.x < C ? *cluster.map_shared_rank(&cta_max, threadIdx.x)
                        : 0.f;
    for (int o = 16; o > 0; o >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
    }
    if (threadIdx.x == 0) tile_max = m;
  }
  cluster_arrive();
  __syncthreads();
  const int qm = (1 << (bits - 1)) - 1;
  // amax times the float32 reciprocal of qm: the compiled JAX kernel's
  // rewrite of its division by the constant qm (the last ulp differs)
  const float scale = __fmul_rn(fmaxf(tile_max, 1e-12f),
                                __frcp_rn((float)qm));
  const uint32_t thresh = threshold(p[0]);
#pragma unroll
  for (int g = 0; g < QC_WORDS / 4; ++g) {
    if (ok[4 * g / VEC]) {
      const uint32_t words[4] = {rv[4 * g], rv[4 * g + 1], rv[4 * g + 2],
                                 rv[4 * g + 3]};
      uint32_t mk[4];
      flip_masks<4>(mk, words, bits, thresh);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xv[4 * g + e] = wire_elem<uint32_t>(xv[4 * g + e], mk[e], scale, qm);
      }
    }
  }
  {
    int r = row0, cv = cx;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (ok[k]) {
        const size_t i = (size_t)r * N + (size_t)cv * VEC;
        if constexpr (VEC == 4) {
          *reinterpret_cast<float4*>(ot + i) = make_float4(
              xv[4 * k], xv[4 * k + 1], xv[4 * k + 2], xv[4 * k + 3]);
        } else {
          ot[i] = xv[k];
        }
      }
      cv += tx;
      if (cv >= vc) {
        cv = cx;
        r += ry;
      }
    }
  }
  cluster_wait();
}

template <int VEC>
int launch_quant_channel(const float* x, const uint32_t* rand,
                         const float* p, float* out, int N, int bm, int bn,
                         int n_tiles, int cluster, int rows, int threads,
                         int bits, cudaStream_t st) {
  auto kern = quant_channel_kernel<VEC>;
  // a cluster beyond the portable 8 needs the attribute, which is set per
  // device: set it before each such launch (a host call, no stream work)
  if (cluster > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, x, rand, p, out, N,
                                           bm, bn, rows, bits);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
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

// K5: (M / bm) * (N / bn) clusters of `cluster` CTAs of `threads` threads,
// `rows` tile rows a CTA, `vec` elements a load (ops.py: qc_geometry).
extern "C" int quant_channel(const float* x, const uint32_t* rand,
                             const float* p, float* out, int M, int N, int bm,
                             int bn, int cluster, int rows, int threads,
                             int vec, int bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (M / bm) * (N / bn);
  if (threads < 32 || threads > QC_MAX_THREADS || threads % 32 ||
      cluster < 1 || cluster > 16 || (vec != 1 && vec != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  return vec == 4
             ? launch_quant_channel<4>(x, rand, p, out, N, bm, bn, n_tiles,
                                       cluster, rows, threads, bits, st)
             : launch_quant_channel<1>(x, rand, p, out, N, bm, bn, n_tiles,
                                       cluster, rows, threads, bits, st);
}
