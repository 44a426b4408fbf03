// GQA flash-decode for sm_90a: one new query token per slot against the
// slot's KV prefix, dense cache or paged pool.
//
//   decode_attention       replaces repro/kernels/decode_attention/kernel.py
//                          :decode_attention (`_decode_kernel`)
//   paged_decode_attention replaces repro/kernels/decode_attention/kernel.py
//                          :paged_decode_attention (`_paged_decode_kernel`)
//
// Both run one body, split-KV ("flash-decoding"), templated on where
// column c of (slot b, KV head h) lives (kv_cols.cuh): the dense cache or
// the paged pool through the slot's page table. The arithmetic and its
// order are the same in both, and the split count depends on neither
// layout's column count, so on the same data the paged kernel gives the
// dense kernel's bits. What bounds it is the bytes
// of the K/V prefix: each K/V element meets G query rows (1 at the serving
// shape), far below the ~295 operations per byte at which the tensor cores
// would be the limit. So the design is about keeping bytes in flight on
// every SM:
//   - grid (B, Hkv * n_gblk, n_split): the valid span of row b, [len - win,
//     len) clipped to [0, S) (S = n_lp * page when paged), is cut into
//     n_split equal contiguous ranges, one per CTA (a range may be empty). The wrapper picks n_split from
//     the batch and head shapes alone, so nothing is read back to the host. n_gblk
//     blocks of GB head-group rows cover G.
//   - no CTA-wide barrier in the column loop. The GB query rows live in
//     registers. Each warp walks its own columns with 16-byte loads: a
//     column's head dim is HD / VEC 16-byte chunks (VEC = 8 bf16 or 4
//     f32), held by LPC lanes with NCH chunks each, so a warp load covers
//     CPW = 32 / LPC neighbouring columns, and U loads of K and of V per
//     lane are issued before any of them is used. At HD 64 and 128 a lane
//     holds one chunk (LPC 8 / 16 in bf16, 16 / 32 in f32: 512 contiguous
//     bytes a warp load). At HD 160 a column is 20 bf16 or 40 f32 chunks,
//     which no power of two of lanes divides: one column per warp load,
//     LPC 20 lanes holding one bf16 chunk or two f32 chunks (chunk j of a
//     lane at j * LPC + its lane, so each load instruction of the warp
//     reads one contiguous span), and lanes 20-31 idle. That wastes 12
//     lanes of issue, not bytes: each K/V byte is still read once. The
//     head dim is a template parameter, built for 64, 128 and 160; a
//     lane's registers do not grow with it, its column group does. q.k is
//     reduced by shuffles inside each LPC-lane group (over the whole warp
//     when CPW is 1, the idle lanes adding zeros); each group keeps its own
//     online softmax (m, l) and f32 acc.
//   - the groups merge by shuffles, the warps once through shared memory,
//     both in a fixed order. With n_split = 1 the CTA writes the output;
//     otherwise it writes an unnormalised partial (acc, m, l) to a
//     workspace [B, H, n_split, HD + 2] f32, and a second small launch
//     merges the partials in split order 0..n_split-1.
//   - paged: before the loop the CTA stages the row base of each page of
//     its split's range in shared memory (one table read per page, one
//     barrier); the loop's loads then wait on no table read. The wrapper
//     picks how many a CTA stages at a time (`ops.stage_pages`: the
//     split's pages, at most 2,048, 16 KiB beside the merge buffer); a
//     range of more pages (one split of a row past 32,768 columns at page
//     16) is staged in segments cut on the loop's grid of steps from the
//     range's start, so each lane meets its columns in the same order as
//     in one pass.
// No float atomics anywhere: the same inputs give the same bits. What it
// computes is the Pallas kernel's: s = (q . k) * scale in f32; running
// (m, l, acc) in f32; p = exp(s - m); l sums the unrounded p; p rounded to
// V's dtype before p . V; out = acc / max(l, 1e-30) in f32. A row with no
// valid column (an idle slot, length 0) returns 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kv_cols.cuh"

namespace gqa {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_INF = -1e30f;

// p rounded to V's dtype before p . V, as the TPU kernels do
template <typename T> __device__ __forceinline__ float round_as(float x);
template <> __device__ __forceinline__ float round_as<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// 16 bytes of T as floats (8 bf16 or 4 f32) into x[at ..]
template <typename T, int N>
__device__ __forceinline__ void unpack16(const uint4& r, float (&x)[N],
                                         int at) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[at + 2 * i] = __uint_as_float(w[i] << 16);
      x[at + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[at + i] = __uint_as_float(w[i]);
  }
}

// One CTA: head-group rows [g0, g0 + GB) of (slot b, KV head h), columns
// of split blockIdx.z.
template <typename T, int HD, int GB, typename Cols, bool CUT>
__global__ void __launch_bounds__(THREADS)
    split_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ ws, const int* __restrict__ lengths,
                        const Cols cols, int Hkv, int G, int n_split,
                        int window, float scale) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int CHUNKS = HD / VEC;      // 16-byte chunks of a column
  constexpr int NCH = (CHUNKS + 31) / 32;   // chunks per lane
  constexpr int LPC = CHUNKS / NCH;     // lanes per column
  constexpr int CPW = 32 / LPC;         // columns per warp load
  // lanes a q.k sum spans: the column's group, the whole warp when one
  // column fills it (at HD 160, 20 lanes and 12 idle ones)
  constexpr int LPW = CPW == 1 ? 32 : LPC;
  constexpr int E = NCH * VEC;          // elements a lane holds
  // loads in flight per lane, K and V: 4 for one head-group row at head
  // dim 64 (the MHA serving shape); at 128 four spill in bf16 (ptxas: 8
  // bytes at 72 registers), and two keep a warp's 2 KB of K and V in flight
  constexpr int U = GB == 1 && HD == 64 ? 4 : 2;
  constexpr int STEP = WARPS * CPW * U; // columns per CTA iteration
  static_assert(HD % VEC == 0 && CHUNKS % NCH == 0, "head dim vs chunks");
  static_assert(CPW == 1 || 32 % LPC == 0, "head dim vs warp");

  __shared__ float sm_acc[WARPS][GB][HD];
  __shared__ float sm_m[WARPS][GB], sm_l[WARPS][GB];
  extern __shared__ long long page_base[];   // paged: this split's pages

  const int n_gblk = (G + GB - 1) / GB;
  const int b = blockIdx.x, h = blockIdx.y / n_gblk;
  const int g0 = (blockIdx.y % n_gblk) * GB, split = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // lanes past the last column group (at HD 160, 20-31) load nothing
  const int slot = lane / LPC, d0 = (lane % LPC) * VEC;
  const bool live = slot < CPW;
  const int H = Hkv * G;

  // valid span of the row, then this split's share of it
  const int len = lengths[b];
  const int hi = min(len, cols.n_cols());
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int span = max(hi - lo, 0);
  const int chunk = (span + n_split - 1) / n_split;
  const int c_lo = lo + split * chunk;
  const int c_hi = min(c_lo + chunk, hi);

  float qv[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (live && g0 + g < G) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            q + ((long long)b * H + h * G + g0 + g) * HD + d0
            + j * LPC * VEC));
        unpack16<T>(raw, qv[g], j * VEC);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qv[g][j * VEC + e] = 0.f;
      }
    }
  }

  float m[GB], l[GB], acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  // the split's range in one pass, or (CUT) in segments of at most
  // `stage` pages cut on the grid of STEP columns from c_lo
  static_assert(STEP <= kv::MAX_STEP, "step vs segment");
  for (int s_lo = c_lo; s_lo < c_hi;) {
    const int s_hi = CUT ? cols.seg_end(s_lo, c_hi, c_lo, STEP) : c_hi;
    const auto rows = cols.rows(b, h, Hkv, s_lo, s_hi, page_base);
    for (int base = s_lo; base < s_hi; base += STEP) {
      uint4 kr[U][NCH], vr[U][NCH];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = base + (u * WARPS + warp) * CPW + slot;
        ok[u] = live && c < s_hi;
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          kr[u][j] = vr[u][j] = make_uint4(0, 0, 0, 0);
          if (ok[u]) {
            const long long off = rows(c) * HD + d0 + j * LPC * VEC;
            kr[u][j] = __ldg(reinterpret_cast<const uint4*>(k + off));
            vr[u][j] = __ldg(reinterpret_cast<const uint4*>(v + off));
          }
        }
      }
      float s[U][GB];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kx[E];
#pragma unroll
        for (int j = 0; j < NCH; ++j)
          unpack16<T>(kr[u][j], kx, j * VEC);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) part += qv[g][e] * kx[e];
#pragma unroll
          for (int o = 1; o < LPW; o <<= 1)
            part += __shfl_xor_sync(0xffffffffu, part, o);
          s[u][g] = part * scale;
        }
      }
      float vx[U][E];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < NCH; ++j)
          unpack16<T>(vr[u][j], vx[u], j * VEC);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float m_new = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (ok[u]) m_new = fmaxf(m_new, s[u][g]);
        const float corr = expf(m[g] - m_new);
        float p[U], psum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[u] = ok[u] ? expf(s[u][g] - m_new) : 0.f;
          psum += p[u];
        }
        l[g] = l[g] * corr + psum;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float a = acc[g][e] * corr;
#pragma unroll
          for (int u = 0; u < U; ++u) a += round_as<T>(p[u]) * vx[u][e];
          acc[g][e] = a;
        }
        m[g] = m_new;
      }
    }
    s_lo = s_hi;
    if (CUT && s_lo < c_hi) __syncthreads();   // every warp past its loads
  }

  // merge the CPW lane groups of the warp (butterfly over the slot bits;
  // none when one group spans the warp)
#pragma unroll
  for (int o = LPW; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mx = fmaxf(m[g], mo);
      const float ca = expf(m[g] - mx), cb = expf(mo - mx);
      l[g] = l[g] * ca + lo_ * cb;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * ca + ao * cb;
      }
      m[g] = mx;
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int j = 0; j < NCH; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          sm_acc[warp][g][d0 + j * LPC * VEC + e] = acc[g][j * VEC + e];
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps in order 0..WARPS-1; one thread per (row, dim)
  for (int i = threadIdx.x; i < GB * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    if (g0 + g >= G) continue;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * c;
      a += sm_acc[w][g][d] * c;
    }
    const long long row = (long long)b * H + h * G + g0 + g;
    if (n_split == 1) {
      out[row * HD + d] = a / fmaxf(lsum, 1e-30f);
    } else {
      float* p = ws + (row * n_split + split) * (HD + 2);
      p[d] = a;
      if (d == 0) {
        p[HD] = mx;
        p[HD + 1] = lsum;
      }
    }
  }
}

// out[row, d] from the n_split partials of `row`, in split order.
template <int HD>
__global__ void __launch_bounds__(256)
    merge_splits_kernel(const float* __restrict__ ws, float* __restrict__ out,
                        int rows, int n_split) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * HD) return;
  const int row = i / HD, d = i % HD;
  const float* p = ws + (long long)row * n_split * (HD + 2);
  float mx = NEG_INF;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, p[s * (HD + 2) + HD]);
  float lsum = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* ps = p + s * (HD + 2);
    const float c = expf(ps[HD] - mx);
    lsum += ps[HD + 1] * c;
    a += ps[d] * c;
  }
  out[i] = a / fmaxf(lsum, 1e-30f);
}

// Static shared memory of split_decode_kernel<T, HD, GB, *>: sm_acc, sm_m
// and sm_l.
template <int HD, int GB>
constexpr int static_smem() {
  return (int)sizeof(float) * WARPS * GB * (HD + 2);
}

template <typename T, int HD, int GB, typename Cols, bool CUT>
int launch_split_as(const void* q, const void* k, const void* v,
                    float* out, float* ws, const int* lengths,
                    const Cols cols, int B, int Hkv, int G, int n_split,
                    int window, float scale, cudaStream_t st) {
  const dim3 grid(B, Hkv * ((G + GB - 1) / GB), n_split);
  const int smem = cols.stage * (int)sizeof(long long);
  // past the 48 KiB every launch may take, the kernel must opt in (a
  // staging of 2,048 pages, 16 KiB, stays below it)
  if (smem + static_smem<HD, GB>() > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        split_decode_kernel<T, HD, GB, Cols, CUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  split_decode_kernel<T, HD, GB, Cols, CUT>
      <<<grid, THREADS, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), out, ws, lengths, cols, Hkv, G, n_split,
          window, scale);
  if (n_split > 1) {
    const int rows = B * Hkv * G;
    merge_splits_kernel<HD><<<(rows * HD + 255) / 256, 256, 0, st>>>(
        ws, out, rows, n_split);
  }
  return (int)cudaGetLastError();
}

// The instance that cuts a split's range into segments only where one
// split's share of the valid span (the row, or at most the window) may
// touch more pages than one staging holds.
template <typename T, int HD, int GB, typename Cols>
int launch_split(const void* q, const void* k, const void* v, float* out,
                 float* ws, const int* lengths, const Cols cols, int B,
                 int Hkv, int G, int n_split, int window, float scale,
                 cudaStream_t st) {
  if constexpr (Cols::can_cut) {
    const long long row = (long long)cols.n_lp * cols.page;
    const long long valid = window > 0 && window < row ? window : row;
    const long long span = (valid + n_split - 1) / n_split;
    if (cols.cut(span))
      return launch_split_as<T, HD, GB, Cols, true>(
          q, k, v, out, ws, lengths, cols, B, Hkv, G, n_split, window, scale,
          st);
  }
  return launch_split_as<T, HD, GB, Cols, false>(
      q, k, v, out, ws, lengths, cols, B, Hkv, G, n_split, window, scale, st);
}

template <typename T, int HD, typename Cols>
int dispatch_gb(int gb, const void* q, const void* k, const void* v,
                float* out, float* ws, const int* lengths, const Cols cols,
                int B, int Hkv, int G, int n_split, int window, float scale,
                cudaStream_t st) {
#define GQA_SPLIT(GBV)                                                      \
  launch_split<T, HD, GBV, Cols>(q, k, v, out, ws, lengths, cols, B, Hkv,  \
                                 G, n_split, window, scale, st)
  if (gb == 1) return GQA_SPLIT(1);
  if (gb == 2) return GQA_SPLIT(2);
  if (gb == 4) return GQA_SPLIT(4);
#undef GQA_SPLIT
  return (int)cudaErrorInvalidValue;
}

// the head dims the kernels are built for (build.HEAD_DIMS): at 64 a bf16
// column takes 8 lanes and an f32 one 16, at 128 16 and 32, at 160 20
// lanes in both (one and two chunks a lane); a CTA's shared merge buffer
// sm_acc is WARPS * GB * HD floats, 10 KiB at 160
template <typename T, typename Cols>
int dispatch_hd(int hd, int gb, const void* q, const void* k, const void* v,
                float* out, float* ws, const int* lengths, const Cols cols,
                int B, int Hkv, int G, int n_split, int window, float scale,
                cudaStream_t st) {
  if (hd == 64)
    return dispatch_gb<T, 64>(gb, q, k, v, out, ws, lengths, cols,
                              B, Hkv, G, n_split, window, scale, st);
  if (hd == 128)
    return dispatch_gb<T, 128>(gb, q, k, v, out, ws, lengths, cols,
                               B, Hkv, G, n_split, window, scale, st);
  if (hd == 160)
    return dispatch_gb<T, 160>(gb, q, k, v, out, ws, lengths, cols,
                               B, Hkv, G, n_split, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

template <typename Cols>
int dispatch(int dtype, int gb, const void* q, const void* k, const void* v,
             float* out, float* ws, const int* lengths, const Cols cols,
             int B, int Hkv, int G, int hd, int n_split, int window,
             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || G < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_hd<float>(hd, gb, q, k, v, out, ws, lengths, cols,
                              B, Hkv, G, n_split, window, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, gb, q, k, v, out, ws, lengths,
                                      cols, B, Hkv, G, n_split, window,
                                      scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace gqa

// gb (1, 2 or 4 head-group rows per CTA) and n_split come from the
// wrapper (`ops.decode_splits`). `ws` holds B * Hkv * G * n_split *
// (hd + 2) floats when n_split > 1 and is not read otherwise. Two
// launches when n_split > 1 (partials, merge).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                float* out, float* ws, const int* lengths,
                                int B, int Hkv, int G, int S, int hd, int gb,
                                int n_split, int window, float scale,
                                int dtype, void* stream) {
  return gqa::dispatch(dtype, gb, q, k, v, out, ws, lengths, kv::DenseCols{S},
                       B, Hkv, G, hd, n_split, window, scale, stream);
}

// The same kernel over the paged pool; n_split, gb and `stage` (the page
// bases a CTA stages at a time, `ops.stage_pages`) from the wrapper, with
// S = n_lp * page.
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, float* out,
                                      float* ws, const int* tables,
                                      const int* lengths, int B, int Hkv,
                                      int G, int n_pages, int page, int n_lp,
                                      int stage, int hd, int gb, int n_split,
                                      int window, float scale, int dtype,
                                      void* stream) {
  const kv::PagedCols cols{tables, n_lp, page, n_pages, stage};
  if (!cols.valid()) return (int)cudaErrorInvalidValue;
  return gqa::dispatch(dtype, gb, q, k_pool, v_pool, out, ws, lengths, cols,
                       B, Hkv, G, hd, n_split, window, scale, stream);
}
