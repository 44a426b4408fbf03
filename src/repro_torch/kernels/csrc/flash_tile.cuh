// f32 chunk prefill, dense cache or paged pool: the CUDA-core body that
// prefill_attention.cu dispatches float32 inputs to (the bf16 kernels run
// on the tensor cores; TF32 mma would break the f32 tolerance of 2e-4).
// It is not on the serving path, which runs bf16. A block of query rows
// of one (slot b, KV head h) attends its causal span of KV columns with an
// online softmax; where column c lives is the template parameter `Cols`
// (kv_cols.cuh), so the dense and the paged instance give the same bits
// on the same data.
//
// Replaces, for f32, the TPU kernels' per-grid-step body (`_prefill_kernel`,
// `_paged_prefill_kernel` in repro/kernels/prefill_attention/kernel.py).
// What it computes is theirs:
//   s = (q . k) * scale accumulated in f32; masked to NEG_INF outside
//   kpos <= qpos (and kpos > qpos - window); running (m, l, acc) in f32;
//   p = exp(s - m_new); l += sum(p); acc += p . V;
//   out = acc / max(l, 1e-30), written as f32.
// Query row r of a block is chunk position c = r / G, head-group member
// g = r % G, at global position start[b] + c; q and out are [B, C, H, hd]
// with H = Hkv * G, the model's own layout.
//
// Design. One CTA (128 threads) per (b, h, block of ROWS query rows)
// loops over its KV span in TILE-column tiles, keeping m and l in shared
// memory and acc in registers, with four CTA barriers a tile; paged, the
// span's page bases are staged in segments (kv_cols.cuh). The loop
// starts at the window's first column and stops at the block's last
// causal column, so only the valid prefix is read. A row with no valid
// column gets 0. What bounds it is bytes, as for the bf16 kernels; this
// body reads its span once per CTA into shared memory and does the
// arithmetic on CUDA cores, and is not tuned further. A thread owns the
// accumulators tid, tid + THREADS, ... of the block's ROWS x HD outputs.
// At head dims 64 and 128 a tile is 32 columns, one a lane in the
// softmax; at 160 it is 16 (the 32-column tile's K, V and Q would take
// 53 KB of static shared memory, above the 48 KB a static array may
// have), lanes 16-31 of the softmax idle.
#pragma once

#include <cuda_runtime.h>

#include "kv_cols.cuh"

namespace flash {

constexpr int THREADS = 128;   // one CTA: 4 warps
constexpr int ROWS = 16;       // query rows per CTA
constexpr float NEG_INF = -1e30f;

// KV columns a loop step at head dim HD
template <int HD>
__host__ __device__ constexpr int tile_cols() {
  return HD > 128 ? 16 : 32;
}

// One CTA: query rows [blockIdx.z*ROWS, +ROWS) of (b, h) = (blockIdx.x,
// blockIdx.y); R = C*G rows in all.
// ptxas gives the paged instance at HD 64 64 registers and a 4-byte
// spill. A bound of 4 CTAs an SM removes the spill (96 registers), but an
// SM then holds 5 CTAs instead of 8, and a launch of one wave takes two
// (1.38x at 4 x 256 rows, 16 KV heads, window 8,192 on an H100)
template <int HD, typename Cols, bool CUT>
__global__ void __launch_bounds__(THREADS)
    prefill_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       const int* __restrict__ start, const Cols cols,
                       int Hkv, int G, int C, int window, float scale) {
  constexpr int TILE = tile_cols<HD>();
  static_assert(ROWS * HD % THREADS == 0, "HD vs THREADS");
  constexpr int PER = ROWS * HD / THREADS;  // accumulators per thread
  __shared__ float qs[ROWS][HD];
  __shared__ float ks[TILE][HD + 1];        // +1: conflict-free q.k
  __shared__ float vs[TILE][HD];
  __shared__ float ps[ROWS][TILE];
  __shared__ float m_s[ROWS], l_s[ROWS], corr_s[ROWS];
  extern __shared__ long long page_base[];  // paged: the span's pages

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = Hkv * G, R = C * G, r0 = blockIdx.z * ROWS;
  const int qpos0 = start[b];

  for (int i = tid; i < ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, rr = r0 + r;
    float x = 0.f;
    if (rr < R) {
      const int c = rr / G, g = rr % G;
      x = q[(((long long)b * C + c) * H + h * G + g) * HD + d];
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

  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  __syncthreads();

  // the span in one pass, or (CUT) in segments of at most `stage` pages
  // cut on the tile grid; a tile's last barrier orders its reads of the
  // page bases before the next staging
  for (int s_lo = lo; s_lo < hi;) {
    const int s_hi = CUT ? cols.seg_end(s_lo, hi, 0, TILE) : hi;
    const auto rows = cols.rows(b, h, Hkv, s_lo, s_hi, page_base);
    for (int c0 = s_lo; c0 < s_hi; c0 += TILE) {
      for (int i = tid; i < TILE * HD; i += THREADS) {
        const int j = i / HD, d = i % HD, c = c0 + j;
        float kx = 0.f, vx = 0.f;
        if (c < hi) {
          const long long off = rows(c) * HD + d;
          kx = k[off];
          vx = v[off];
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
        const float s = lane < TILE ? ps[r][lane] : NEG_INF;
        float mx = s;
#pragma unroll
        for (int o = 16; o; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        const float p = lane < TILE ? expf(s - m_new) : 0.f;
        float sum = p;
#pragma unroll
        for (int o = 16; o; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane < TILE) ps[r][lane] = p;
        __syncwarp();
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          corr_s[r] = corr;
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * corr + p . V; accumulator i is output tid + i * THREADS
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int r = (tid + i * THREADS) / HD, d = (tid + i * THREADS) % HD;
        float a = acc[i] * corr_s[r];
#pragma unroll 8
        for (int j = 0; j < TILE; ++j) a += ps[r][j] * vs[j][d];
        acc[i] = a;
      }
      __syncthreads();
    }
    s_lo = s_hi;
  }

#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = (tid + i * THREADS) / HD, d = (tid + i * THREADS) % HD;
    const int rr = r0 + r;
    if (rr < R) {
      const int c = rr / G, g = rr % G;
      out[(((long long)b * C + c) * H + h * G + g) * HD + d] =
          acc[i] / fmaxf(l_s[r], 1e-30f);
    }
  }
}

// Launches the f32 body at head dim HD (64, 128 or 160: at 128 its static
// shared memory is 43,328 bytes and a thread keeps 16 accumulators, at
// 160 (16-column tiles) 32,000 bytes and 20 accumulators), with the
// mapper's `stage` page bases in dynamic shared memory (a CTA's rows sit
// at most ROWS - 1 positions past its first and its range starts on a
// tile, so its span under a window is at most window + ROWS - 1 + TILE -
// 1 columns).
template <int HD, typename Cols, bool CUT>
int launch_prefill_as(const float* q, const float* k, const float* v,
                      float* out, const int* start, const Cols cols, int B,
                      int Hkv, int G, int C, int window, float scale,
                      cudaStream_t st) {
  const int smem = cols.stage * (int)sizeof(long long);
  if (smem > 0) {
    const cudaError_t attr = cudaFuncSetAttribute(
        prefill_f32_kernel<HD, Cols, CUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  const dim3 grid(B, Hkv, (C * G + ROWS - 1) / ROWS);
  prefill_f32_kernel<HD, Cols, CUT><<<grid, THREADS, smem, st>>>(
      q, k, v, out, start, cols, Hkv, G, C, window, scale);
  return (int)cudaGetLastError();
}

template <int HD, typename Cols>
int launch_prefill(const float* q, const float* k, const float* v,
                   float* out, const int* start, const Cols cols, int B,
                   int Hkv, int G, int C, int window, float scale,
                   cudaStream_t st) {
  static_assert(tile_cols<HD>() <= kv::MAX_STEP, "tile vs segment");
  if constexpr (Cols::can_cut) {
    const long long span = window > 0
        ? window + ROWS - 1 + tile_cols<HD>() - 1
        : (long long)cols.n_lp * cols.page;
    if (cols.cut(span))
      return launch_prefill_as<HD, Cols, true>(q, k, v, out, start, cols, B,
                                               Hkv, G, C, window, scale, st);
  }
  return launch_prefill_as<HD, Cols, false>(q, k, v, out, start, cols, B,
                                            Hkv, G, C, window, scale, st);
}

}  // namespace flash
