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
// In bf16 both run one body on the tensor cores, templated on where column
// c of (slot b, KV head h) lives (kv_cols.cuh): the dense cache or the
// paged pool through the slot's page table. Only the cp.async stage's
// addresses differ, so on the same data (n_lp * page = S) the paged kernel
// gives the dense kernel's bits. The body uses mma.sync.m16n8k16 (bf16 in,
// f32 accumulate), which is what the Pallas kernel's dots compute
// (`preferred_element_type=jnp.float32`). Rows are the C*G (chunk
// position, head-group member) pairs of (slot b, KV head h): row r sits at
// position start[b] + r / G and attends columns (qpos - window, qpos],
// clipped to [0, S) (S = n_lp * page when paged). Why mma.sync and not
// wgmma: wgmma works on 64-row tiles, and the serving shape has C*G = 32
// rows per (slot, head), so half of such a tile would idle.
//
// Design. One CTA of 4 warps per (b, h, block of 16 * WR rows); paged, it
// stages the row base of each page of its span in shared memory (one
// table read per page, one barrier), `stage` pages at a time: the
// wrapper's number (ops.stage_pages), at most 2,048 (16 KiB beside the
// tiles), fewer for a shorter row or under a sliding window, whose span
// is the window and 63 columns more (517 pages of 16 at window 8,192).
// A launch whose spans fit one staging runs the instance that stages
// once and makes one pass. Else (a table row past 2,048 pages without a
// window) the CUT instance runs a span segment by segment, cut on the
// tile grid: all four warps stage a segment, each runs those
// of its tiles that lie in it, its cp.async ring drains at the segment's
// end, and a barrier precedes the next staging; the online softmax
// carries across, so the tiles, their order and their arithmetic are
// those of one pass (the dense kernel's bits). WR warps each own
// 16 rows, and the KS = 4 / WR warps of one row group take every KS-th
// tile of the group's span (64 columns at head dim 64, 32 at 128: a tile
// is 8 KiB either way; 16 at 160), so the CTA keeps its 4 warps busy even
// at 16 rows. The head dim is a template parameter, built for 64, 128
// and 160; a warp holds HD / 4 registers of Q fragments and HD / 2 of O
// accumulators (40 and 80 at 160). A warp's Q fragments stay in registers
// for the whole loop. Each warp stages its own K/V tiles in bf16 in
// shared memory with cp.async (16 bytes a lane), double-buffered, laid
// out so that ldmatrix (and ldmatrix.trans for V) is free of bank
// conflicts: at HD 64 and 128 the rows are XOR-swizzled in 16-byte
// chunks; a 160-wide row is 20 chunks, past which the XOR would write, so
// at 160 each row is padded to 21 chunks instead (336 bytes: 8
// consecutive rows then start in 8 different 16-byte bank groups).
// Columns outside the group's span are zero-filled, never read. So the
// column loop has no CTA-wide barrier. Each tile:
//   S = Q.K^T by mma; scale; mask from qpos; row max and sum in registers
//   (quad shuffles); P converted to bf16 (this is the reference's
//   p.astype(v.dtype)); O += P.V by mma.
// Tiles wholly past the group's last causal column are never visited. At
// the end the KS partial (m, l, O) of a row group merge through shared
// memory in warp order, and out = O / max(l, 1e-30) is written in f32. No
// atomics: the same inputs give the same bits. A row with no valid column
// returns 0.
//
// f32 inputs, dense and paged (not on the serving path; the checks run
// them at the JAX tolerance of 2e-4, which TF32 mma would break), are
// dispatched, by dtype, to the CUDA-core body of flash_tile.cuh, which is
// templated on the same column mappers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_tile.cuh"
#include "kv_cols.cuh"

namespace gqa {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

// The tile geometry of head dim HD (built for 64, 128 and 160). At HD 64
// and 128 a tile is 8 KiB of bf16 whatever the head dim (64 x 64 or 32 x
// 128: 64 x 128 would need 256 KB, above the 227 KB a CTA may have), rows
// XOR-swizzled in place. At 160 a tile is 16 columns, each row padded
// from 20 to 21 16-byte chunks (PITCH 168 elements): a 16-column tile
// keeps the warp's S and P fragments at 8 and 4 registers beside its 40 Q
// and 80 O registers. A row is CH 16-byte chunks; WARP_SMEM holds a
// warp's 2 stages of K and V, SMEM the CTA's four warps (128 KB at 64 and
// 128, 84 KB at 160).
template <int HD>
struct Tile {
  static_assert((HD % 32 == 0 && HD <= 128) || HD == 160, "head dim");
  static constexpr bool PADDED = HD == 160;
  static constexpr int COLS = PADDED ? 16 : 8192 / (2 * HD);
  static constexpr int PITCH = PADDED ? HD + 8 : HD;   // elements a row
  static constexpr int ELEMS = COLS * PITCH;
  static constexpr int CH = HD / 8;
  static constexpr int WARP_SMEM = 2 * 2 * ELEMS * 2;
  static constexpr int SMEM = WARPS * WARP_SMEM;
  // element offset of (row, 16-byte chunk ch): unpadded, the XOR touches
  // the low 3 bits of ch only, so it stays inside the row's CH chunks
  // (8 or 16), and the 8 rows an ldmatrix reads hit 8 different 16-byte
  // bank groups (a row is 128 or 256 bytes, a whole number of bank
  // cycles); padded, a row of 21 chunks moves each next row by 5 bank
  // groups mod 8, which also gives 8 rows 8 groups
  static __device__ __forceinline__ int off(int row, int ch) {
    if constexpr (PADDED) return row * PITCH + (ch << 3);
    return row * HD + ((ch ^ (row & 7)) << 3);
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b for one m16n8k16 tile
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

template <int HD, int WR, typename Cols, bool CUT>
__global__ void __launch_bounds__(THREADS, 1)
    prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       float* __restrict__ out, const int* __restrict__ start,
                       const Cols cols, int Hkv, int G, int C, int window,
                       float scale) {
  constexpr int KS = WARPS / WR;
  using TL = Tile<HD>;
  constexpr int TILE = TL::COLS, TILE_ELEMS = TL::ELEMS, CH = TL::CH;
  constexpr int NB = TILE / 8;      // 8-column blocks of S = Q.K^T a tile
  constexpr int KD = TILE / 16;     // 16-column depth steps of P.V a tile
  constexpr int QK = HD / 16;       // 16-dim depth steps of Q.K^T
  constexpr int OB = HD / 8;        // 8-dim blocks of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int b = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp % WR, ks = warp / WR;
  const int gid = lane >> 2, tig = lane & 3;
  const int H = Hkv * G, R = C * G;
  const int r0 = blockIdx.z * 16 * WR + wr * 16;  // first row of the warp
  const int st = start[b];
  const int S = cols.n_cols();

  // Q fragments of rows r0 + gid and r0 + gid + 8, straight from global
  unsigned qf[QK][4];
  long long qrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + gid + 8 * i;
    qrow[i] = r < R ? ((long long)b * C + r / G) * H + h * G + r % G : -1;
  }
#pragma unroll
  for (int kk = 0; kk < QK; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // a0..a3: (row i, col half)
      const int i = j & 1, half = j >> 1;
      unsigned x = 0;
      if (qrow[i] >= 0)
        x = __ldg(reinterpret_cast<const unsigned*>(
            q + qrow[i] * HD + 16 * kk + 8 * half + 2 * tig));
      qf[kk][j] = x;
    }
  }

  // span of the warp's rows, in columns and in tiles
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qp[i] = st + (r0 + gid + 8 * i) / G;
  const int r_last = min(r0 + 15, R - 1);
  const int hi = r0 < R ? min(st + r_last / G + 1, S) : 0;
  const int lo = window > 0 ? max(st + r0 / G - window + 1, 0) : 0;
  const int t_lo = lo / TILE;
  const int t_hi = hi > lo ? (hi + TILE - 1) / TILE : t_lo;
  const int n_my = t_hi - t_lo > ks ? (t_hi - t_lo - ks + KS - 1) / KS : 0;

  __nv_bfloat16* wbuf = smem + warp * (TL::WARP_SMEM / 2);

  // the CTA's span (the union of its warps'), staged by the mapper
  const int rc0 = blockIdx.z * 16 * WR;
  const int rc_last = min(rc0 + 16 * WR - 1, R - 1);
  const int cta_hi = min(st + rc_last / G + 1, S);
  const int cta_lo = window > 0 ? max(st + rc0 / G - window + 1, 0) : 0;
  long long* page_base = reinterpret_cast<long long*>(smem_raw + TL::SMEM);
  // the warp's tiles t_lo + ks + j * KS (j < n_my) below tile x
  auto tiles_below = [&](int x) {
    const int d = x - t_lo - ks;
    return d <= 0 ? 0 : min((d + KS - 1) / KS, n_my);
  };

  float o[OB][4];
#pragma unroll
  for (int n = 0; n < OB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {flash::NEG_INF, flash::NEG_INF}, l[2] = {0.f, 0.f};

  // One staging and one pass over the warp's tiles, j over [0, n_my);
  // or (CUT) segments of at most `stage` pages cut on the tile grid,
  // every warp meeting every segment's barriers, each running its tiles
  // j0 <= j < j1 in the segment.
  for (int s_lo = cta_lo; s_lo < cta_hi;) {
    const int s_hi = CUT ? cols.seg_end(s_lo, cta_hi, 0, TILE) : cta_hi;
    const auto rows = cols.rows(b, h, Hkv, s_lo, s_hi, page_base);
    const int j0 = CUT ? tiles_below(s_lo / TILE) : 0;
    const int j1 = CUT ? tiles_below((s_hi + TILE - 1) / TILE) : n_my;
    // stage tile t of K and V into buffer `stage` (zero outside [lo, hi))
    auto load_tile = [&](int t, int stage) {
      __nv_bfloat16* ks_ = wbuf + stage * 2 * TILE_ELEMS;
      __nv_bfloat16* vs_ = ks_ + TILE_ELEMS;
#pragma unroll
      for (int it = 0; it < TILE * CH / 32; ++it) {
        const int i = it * 32 + lane, row = i / CH, ch = i % CH;
        const int c = t * TILE + row;
        const bool in = c >= lo && c < hi;
        const long long off = in ? rows(c) * HD + ch * 8 : 0;
        cp_async16(smem_u32(ks_ + TL::off(row, ch)), k + off, in ? 16 : 0);
        cp_async16(smem_u32(vs_ + TL::off(row, ch)), v + off, in ? 16 : 0);
      }
    };
    if (j0 < j1) load_tile(t_lo + ks + j0 * KS, j0 & 1);
    cp_async_commit();
    for (int j = j0; j < j1; ++j) {
      const int t = t_lo + ks + j * KS;
      if (j + 1 < j1) load_tile(t + KS, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait1();
      __syncwarp();
      const __nv_bfloat16* ks_ = wbuf + (j & 1) * 2 * TILE_ELEMS;
      const __nv_bfloat16* vs_ = ks_ + TILE_ELEMS;

      // S = Q . K^T: NB column blocks of 8, QK depth steps of 16
      float s[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int kp = 0; kp < QK / 2; ++kp) {
          unsigned bk[4];
          const int row = 8 * n + (lane & 7), ch = 4 * kp + (lane >> 3);
          ldsm_x4(smem_u32(ks_ + TL::off(row, ch)), bk);
          mma16816(s[n], qf[2 * kp], bk[0], bk[1]);
          mma16816(s[n], qf[2 * kp + 1], bk[2], bk[3]);
        }
      }

      // scale, mask, online softmax for rows gid (e 0, 1) and gid + 8 (e 2, 3)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i2 = e >> 1, c = t * TILE + 8 * n + 2 * tig + (e & 1);
          const bool ok = qrow[i2] >= 0 && c < S && c <= qp[i2] &&
                          (window <= 0 || c > qp[i2] - window);
          const float x = s[n][e] * scale;
          s[n][e] = ok ? x : -INFINITY;
          if (ok) mx[i2] = fmaxf(mx[i2], x);
        }
      }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 1));
        mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 2));
        corr[i2] = expf(m[i2] - mx[i2]);
        m[i2] = mx[i2];
      }
      unsigned pa[KD][4];  // P as the A operand of KD depth steps of 16
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i2 = e >> 1;
          p[e] = s[n][e] == -INFINITY ? 0.f : expf(s[n][e] - m[i2]);
          rs[i2] += p[e];
        }
        pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        rs[i2] += __shfl_xor_sync(0xffffffffu, rs[i2], 1);
        rs[i2] += __shfl_xor_sync(0xffffffffu, rs[i2], 2);
        l[i2] = l[i2] * corr[i2] + rs[i2];
      }
#pragma unroll
      for (int n = 0; n < OB; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }

      // O += P . V: KD depth steps of 16 columns, OB blocks of 8 dims
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int dp = 0; dp < OB / 2; ++dp) {
          unsigned bv[4];
          const int row = 16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7);
          const int ch = 2 * dp + (lane >> 4);
          ldsm_x4_t(smem_u32(vs_ + TL::off(row, ch)), bv);
          mma16816(o[2 * dp], pa[kk], bv[0], bv[1]);
          mma16816(o[2 * dp + 1], pa[kk], bv[2], bv[3]);
        }
      }
      __syncwarp();
    }
    cp_async_wait0();       // the ring drains at the segment's end
    s_lo = s_hi;
    if (CUT && s_lo < cta_hi) __syncthreads();   // every warp past its loads
  }

  // merge the KS warps of each row group in warp order, then write
  float* red = reinterpret_cast<float*>(smem_raw);   // reuses the stages
  constexpr int PART = 16 * HD + 32;                  // floats per warp
  static_assert(WARPS * PART * 4 <= TL::SMEM, "merge buffer vs stages");
  if (KS > 1) {
    __syncthreads();
    float* mine = red + warp * PART;
#pragma unroll
    for (int n = 0; n < OB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[(gid + 8 * (e >> 1)) * HD + 8 * n + 2 * tig + (e & 1)] = o[n][e];
    if (tig == 0) {
      mine[16 * HD + gid] = m[0];
      mine[16 * HD + gid + 8] = m[1];
      mine[16 * HD + 16 + gid] = l[0];
      mine[16 * HD + 16 + gid + 8] = l[1];
    }
    __syncthreads();
    if (ks != 0) return;
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int r = gid + 8 * i2;
      float mm = flash::NEG_INF;
#pragma unroll
      for (int s2 = 0; s2 < KS; ++s2)
        mm = fmaxf(mm, red[(wr + s2 * WR) * PART + 16 * HD + r]);
      float ll = 0.f, c[KS];
#pragma unroll
      for (int s2 = 0; s2 < KS; ++s2) {
        const float* p = red + (wr + s2 * WR) * PART;
        c[s2] = expf(p[16 * HD + r] - mm);
        ll += p[16 * HD + 16 + r] * c[s2];
      }
      l[i2] = ll;
#pragma unroll
      for (int n = 0; n < OB; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * n + 2 * tig + e;
          float a = 0.f;
#pragma unroll
          for (int s2 = 0; s2 < KS; ++s2)
            a += red[(wr + s2 * WR) * PART + r * HD + d] * c[s2];
          o[n][2 * i2 + e] = a;
        }
    }
  }
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    if (qrow[i2] < 0) continue;
    const float inv = 1.f / fmaxf(l[i2], 1e-30f);
    float* dst = out + qrow[i2] * HD;
#pragma unroll
    for (int n = 0; n < OB; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n + 2 * tig) =
          make_float2(o[n][2 * i2] * inv, o[n][2 * i2 + 1] * inv);
  }
}

// Shared memory: the tiles' stages and, paged, the `stage` page bases
// the wrapper picks.
template <int HD, int WR, typename Cols, bool CUT>
int launch_mma_as(const void* q, const void* k, const void* v, float* out,
                  const int* start, const Cols cols, int B, int Hkv, int G,
                  int C, int window, float scale, cudaStream_t st) {
  const int smem = Tile<HD>::SMEM + cols.stage * (int)sizeof(long long);
  const cudaError_t attr = cudaFuncSetAttribute(
      prefill_mma_kernel<HD, WR, Cols, CUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B, Hkv, (C * G + 16 * WR - 1) / (16 * WR));
  prefill_mma_kernel<HD, WR, Cols, CUT><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), out, start, cols, Hkv, G, C,
      window, scale);
  return (int)cudaGetLastError();
}

// The instance that cuts spans into segments only where a CTA's span
// may touch more pages than one staging holds: the whole row, or under
// a window the window + 63 columns (a CTA's at most 16 * WARPS rows sit
// at most 63 positions past its first).
template <int HD, int WR, typename Cols>
int launch_mma(const void* q, const void* k, const void* v, float* out,
               const int* start, const Cols cols, int B, int Hkv, int G,
               int C, int window, float scale, cudaStream_t st) {
  static_assert(Tile<HD>::COLS <= kv::MAX_STEP, "tile vs segment");
  if constexpr (Cols::can_cut) {
    const long long span = window > 0 ? window + 16 * WARPS - 1
                                      : (long long)cols.n_lp * cols.page;
    if (cols.cut(span))
      return launch_mma_as<HD, WR, Cols, true>(q, k, v, out, start, cols, B,
                                               Hkv, G, C, window, scale, st);
  }
  return launch_mma_as<HD, WR, Cols, false>(q, k, v, out, start, cols, B,
                                            Hkv, G, C, window, scale, st);
}

// bf16: the tensor-core kernel, with WR = the row warps a CTA needs (1, 2
// or 4 groups of 16 of the C*G rows); f32: the CUDA-core body.
template <int HD, typename Cols>
int dispatch_hd(const void* q, const void* k, const void* v, float* out,
                const int* start, const Cols cols, int B, int Hkv, int G,
                int C, int window, float scale, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    const int groups = (C * G + 15) / 16;
#define GQA_MMA(WRV)                                                        \
  launch_mma<HD, WRV>(q, k, v, out, start, cols, B, Hkv, G, C, window,     \
                      scale, st)
    if (groups <= 1) return GQA_MMA(1);
    if (groups == 2) return GQA_MMA(2);
    return GQA_MMA(4);
#undef GQA_MMA
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return flash::launch_prefill<HD>(static_cast<const float*>(q),
                                   static_cast<const float*>(k),
                                   static_cast<const float*>(v), out, start,
                                   cols, B, Hkv, G, C, window, scale, st);
}

// the head dims the kernels are built for (build.HEAD_DIMS)
template <typename Cols>
int dispatch(const void* q, const void* k, const void* v, float* out,
             const int* start, const Cols cols, int B, int Hkv, int G,
             int C, int hd, int window, float scale, int dtype,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return dispatch_hd<64>(q, k, v, out, start, cols, B, Hkv, G, C, window,
                           scale, dtype, st);
  if (hd == 128)
    return dispatch_hd<128>(q, k, v, out, start, cols, B, Hkv, G, C, window,
                            scale, dtype, st);
  if (hd == 160)
    return dispatch_hd<160>(q, k, v, out, start, cols, B, Hkv, G, C, window,
                            scale, dtype, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace gqa

extern "C" int prefill_attention(const void* q, const void* k,
                                 const void* v, float* out, const int* start,
                                 int B, int Hkv, int G, int C, int S, int hd,
                                 int window, float scale, int dtype,
                                 void* stream) {
  return gqa::dispatch(q, k, v, out, start, kv::DenseCols{S}, B, Hkv, G, C,
                       hd, window, scale, dtype, stream);
}

// The same kernels over the paged pool; a CTA stages the pages of its
// span `stage` at a time (the wrapper's `ops.stage_pages`), so a table
// row of any length launches.
extern "C" int paged_prefill_attention(const void* q, const void* k_pool,
                                       const void* v_pool, float* out,
                                       const int* tables, const int* start,
                                       int B, int Hkv, int G, int C,
                                       int n_pages, int page, int n_lp,
                                       int stage, int hd, int window,
                                       float scale, int dtype,
                                       void* stream) {
  const kv::PagedCols cols{tables, n_lp, page, n_pages, stage};
  if (!cols.valid()) return (int)cudaErrorInvalidValue;
  return gqa::dispatch(q, k_pool, v_pool, out, start, cols, B, Hkv, G, C,
                       hd, window, scale, dtype, stream);
}
