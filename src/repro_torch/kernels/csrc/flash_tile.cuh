// Shared body of the paged serving attention kernels (paged decode, paged
// chunk prefill) and of f32 dense chunk prefill: a block of query rows of
// one (slot b, KV head h) attends its causal span of KV columns with an
// online softmax. Dense decode (split-KV) and bf16 dense prefill (tensor
// cores) have their own bodies in decode_attention.cu and
// prefill_attention.cu.
//
// Replaces the TPU kernels' per-grid-step body (`_decode_kernel`,
// `_paged_decode_kernel` in repro/kernels/decode_attention/kernel.py and
// `_prefill_kernel`, `_paged_prefill_kernel` in
// repro/kernels/prefill_attention/kernel.py). What it computes is theirs:
//   s = (q . k) * scale accumulated in f32; masked to NEG_INF outside
//   kpos <= qpos (and kpos > qpos - window); running (m, l, acc) in f32;
//   p = exp(s - m_new); l += sum(p) in f32; acc += round_to_V_dtype(p) . V;
//   out = acc / max(l, 1e-30), written as f32.
// Query row r of a block is chunk position c = r / G, head-group member
// g = r % G, at global position qpos0 + c; q and out are [B, C, H, hd]
// with H = Hkv * G, so the kernel reads the model's own layout (no
// transposes or TPU padding around the call).
//
// Design on the H100. The TPU walks KV blocks as a sequential grid axis
// and carries (m, l, acc) in VMEM scratch; here one CTA (128 threads) per
// (b, h, block of ROWS query rows) loops over its KV span itself, keeping
// m and l in shared memory and acc in registers. The loop starts at the
// window's first column and stops at the block's last causal column, so
// only the valid prefix is read: columns past a slot's length (placeholder
// pages, stale cache) are never touched. A row with no valid column at all
// (an inactive decode slot, length 0) gets 0, where the TPU kernel averages
// V uniformly; callers discard those rows.
//
// What bounds it: bytes. Each K/V element is used by at most C*G query
// rows (1 at decode), far below the ~295 operations per byte at which the
// H100's bf16 tensor cores, not HBM, would be the limit, so the least time
// is the K/V prefix over 3.35 TB/s. The design reads every K/V element of
// the span once per CTA, coalesced, into shared memory, and does the
// arithmetic on CUDA cores in f32. It does not split the KV span across
// SMs or use the tensor cores, as the dense bodies do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int THREADS = 128;   // one CTA: 4 warps
constexpr int ROWS = 16;       // query rows per CTA
constexpr int TILE = 32;       // KV columns per loop step (one per lane)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// p rounded to V's dtype before p . V, as the TPU kernels do.
template <typename T> __device__ __forceinline__ float round_as(float x);
template <> __device__ __forceinline__ float round_as<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Dense cache [B, Hkv, S, hd]: logical column c of (b, h) is row
// (b*Hkv + h)*S + c.
struct DenseCols {
  int S;
  __device__ __forceinline__ long long row(int b, int h, int Hkv,
                                           int c) const {
    return (long long)(b * Hkv + h) * S + c;
  }
  __device__ __forceinline__ int n_cols() const { return S; }
};

// Paged pool [n_pages, Hkv, page, hd] through tables [B, n_lp]: logical
// column c of (b, h) is pool page tables[b, c / page] (clamped into the
// pool), offset c % page. The CTA reads its own table entries.
struct PagedCols {
  const int* __restrict__ tables;
  int n_lp, page, n_pages;
  __device__ __forceinline__ long long row(int b, int h, int Hkv,
                                           int c) const {
    int pid = tables[(long long)b * n_lp + c / page];
    pid = min(max(pid, 0), n_pages - 1);
    return ((long long)pid * Hkv + h) * page + c % page;
  }
  __device__ __forceinline__ int n_cols() const { return n_lp * page; }
};

// One CTA: query rows [blockIdx.z*ROWS, +ROWS) of (b, h) = (blockIdx.x,
// blockIdx.y); R = C*G rows in all.
template <typename T, int HD, typename Cols>
__device__ __forceinline__ void attend_rows(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, float* __restrict__ out, const Cols cols,
    int Hkv, int G, int C, int qpos0, int window, float scale) {
  static_assert(THREADS % HD == 0 || HD % THREADS == 0, "HD vs THREADS");
  constexpr int PER = ROWS * HD / THREADS;  // accumulators per thread
  constexpr int RSTEP = THREADS / HD;       // row stride between them
  __shared__ float qs[ROWS][HD];
  __shared__ float ks[TILE][HD + 1];        // +1: conflict-free q.k
  __shared__ float vs[TILE][HD];
  __shared__ float ps[ROWS][TILE];
  __shared__ float m_s[ROWS], l_s[ROWS], corr_s[ROWS];

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = Hkv * G, R = C * G, r0 = blockIdx.z * ROWS;

  for (int i = tid; i < ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, rr = r0 + r;
    float x = 0.f;
    if (rr < R) {
      const int c = rr / G, g = rr % G;
      x = to_f(q[(((long long)b * C + c) * H + h * G + g) * HD + d]);
    }
    qs[r][d] = x;
  }
  if (tid < ROWS) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // KV span of this block of rows: [lo, hi)
  const int rlast = min(r0 + ROWS, R) - 1;
  const int qlo = qpos0 + r0 / G, qhi = qpos0 + rlast / G;
  const int hi = min(qhi + 1, cols.n_cols());
  int lo = window > 0 ? max(qlo - window + 1, 0) : 0;
  lo = (lo / TILE) * TILE;

  const int d_own = tid % HD, r_own = tid / HD;
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int c0 = lo; c0 < hi; c0 += TILE) {
    for (int i = tid; i < TILE * HD; i += THREADS) {
      const int j = i / HD, d = i % HD, c = c0 + j;
      float kx = 0.f, vx = 0.f;
      if (c < hi) {
        const long long off = cols.row(b, h, Hkv, c) * HD + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();

    // scores: a warp holds one row and its 32 lanes the tile's columns
    for (int i = tid; i < ROWS * TILE; i += THREADS) {
      const int r = i / TILE, j = i % TILE, c = c0 + j, rr = r0 + r;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s += qs[r][d] * ks[j][d];
      s *= scale;
      const int qp = qpos0 + rr / G;
      const bool ok = rr < R && c < hi && c <= qp &&
                      (window <= 0 || c > qp - window);
      ps[r][j] = ok ? s : NEG_INF;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < ROWS; r += THREADS / 32) {
      const float s = ps[r][lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[r][lane] = round_as<T>(p);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . V; a thread owns column d_own of PER rows
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int r = r_own + i * RSTEP;
      float a = acc[i] * corr_s[r];
#pragma unroll 8
      for (int j = 0; j < TILE; ++j) a += ps[r][j] * vs[j][d_own];
      acc[i] = a;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = r_own + i * RSTEP, rr = r0 + r;
    if (rr < R) {
      const int c = rr / G, g = rr % G;
      out[(((long long)b * C + c) * H + h * G + g) * HD + d_own] =
          acc[i] / fmaxf(l_s[r], 1e-30f);
    }
  }
}

}  // namespace flash

// Instantiates `KERNEL<T, 64>` for the dtype and launches it; dtype 0 =
// float32, 1 = bfloat16. Head dim 64 is the only one the port's configs
// use; other values return cudaErrorInvalidValue (the Python wrappers
// reject them first).
#define FLASH_DISPATCH(KERNEL, GRID, STREAM, ...)                          \
  do {                                                                     \
    if (dtype == 0 && hd == 64)                                            \
      KERNEL<float, 64><<<GRID, flash::THREADS, 0, STREAM>>>(__VA_ARGS__); \
    else if (dtype == 1 && hd == 64)                                       \
      KERNEL<__nv_bfloat16, 64><<<GRID, flash::THREADS, 0, STREAM>>>(      \
          __VA_ARGS__);                                                    \
    else                                                                   \
      return (int)cudaErrorInvalidValue;                                   \
  } while (0)
