// Pieces the rel-pos attention's tensor-core kernels share (bf16, sm_90a):
// rel_attention_fwd.cu and rel_attention_bwd.cu.
//
// Widths are padded with zeros: the head width dh to dhp = round16(dh), each
// half of the rel width to hdp = round8(hd), so the rel width is d2p = 2 hdp
// (a multiple of 16) and the augmented width [qu | A] . [k | keytab] is
// DA = dhp + d2p. The wrapper hands over delta (H, dhp), W (H, dhp, d2p) and
// the tables (N or Nk, d2p) in bf16 in that padded layout ([P | Q], [sin |
// cos] and [cos | sin] halves of hdp each), contiguous; padded columns are
// zero, so they add exact zeros to every product.
//
// Shared tiles are bf16 with rows padded by 8 elements: every row stride is
// an odd multiple of 16 bytes, so the 8 rows an ldmatrix reads fall in
// distinct bank groups.

#pragma once

#include "mma_sm90.cuh"

namespace rtc {

using tc::bf16;

constexpr int THREADS = 128;   // four warps
constexpr int BQ = 64;         // query rows a block owns (forward, prep, query side)
constexpr int KC = 64;         // rel features a streamed chunk (32 of each half where paired)
constexpr int LDC = KC + 8;    // row stride of a chunk, elements

__host__ __device__ constexpr int round8(int x) { return (x + 7) & ~7; }

// The position tables and folded weights of one (padded) layout.
struct RelTab {
  const bf16* delta;    // (H, dhp)
  const bf16* w;        // (H, dhp, d2p)
  const bf16* rowtab;   // (N, d2p)  [sin | cos]
  const bf16* keytab;   // (Nk, d2p) [cos | sin]
  int dhp, hdp;
};

// Loads rows [row0, row0 + ROWS) of a (nrows, width) bf16 matrix (row stride
// ld_g, copies of `bytes`) into shared [ROWS][lds], columns [0, 8 * ngr),
// zero past nrows and width; all THREADS threads, ROWS * 2 == THREADS or
// ROWS == THREADS / 4. MAXGR bounds ngr (compile-time trip count).
template <int ROWS, int MAXGR>
__device__ __forceinline__ void load_rows(bf16* dst, int lds, const bf16* src, int64_t ld_g,
                                          int row0, int nrows, int width, int ngr, int bytes) {
  constexpr int TPR = THREADS / ROWS;   // threads a row
  static_assert(THREADS % ROWS == 0, "whole rows");
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const bool row_ok = row0 + r < nrows;
  const bf16* s = src + (row_ok ? (row0 + r) * ld_g : 0);
  bf16* d = dst + r * lds;
#pragma unroll
  for (int it = 0; it < (MAXGR + TPR - 1) / TPR; ++it) {
    const int gq = part + it * TPR;
    if (gq < ngr) {
      const int n = row_ok ? width - 8 * gq : 0;
      tc::copy8(d + 8 * gq, n > 0 ? s + 8 * gq : src, n, bytes);
    }
  }
}

// As load_rows with a runtime trip count, for copies made once a block.
template <int ROWS>
__device__ __forceinline__ void load_rows_rt(bf16* dst, int lds, const bf16* src, int64_t ld_g,
                                             int row0, int nrows, int width, int ngr, int bytes) {
  for (int i = threadIdx.x; i < ROWS * ngr; i += THREADS) {
    const int r = i / ngr, gq = i - r * ngr;
    const int n = row0 + r < nrows ? width - 8 * gq : 0;
    tc::copy8(dst + r * lds + 8 * gq, n > 0 ? src + (row0 + r) * ld_g + 8 * gq : src, n, bytes);
  }
}

// Rows [row0, row0 + ROWS) of a padded bf16 table (nrows, 2 hdp), columns of
// rel chunk j0 paired as stage_w pairs them, into shared [ROWS][lds]; zero
// past nrows and hdp; row stride lds. 16-byte cp.async.
template <int ROWS>
__device__ __forceinline__ void load_pairs(bf16* dst, int lds, const bf16* tab, int row0,
                                           int nrows, int hdp, int j0) {
  constexpr int TPR = THREADS / ROWS;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const bool row_ok = row0 + r < nrows;
  const bf16* s = tab + (row_ok ? static_cast<int64_t>(row0 + r) * 2 * hdp : 0);
#pragma unroll
  for (int it = 0; it < 8 / TPR; ++it) {
    const int gq = part + it * TPR, j = j0 + 8 * (gq & 3);
    const bool ok = row_ok && j < hdp;
    tc::cp_async16(dst + r * lds + 8 * gq, ok ? s + (gq < 4 ? 0 : hdp) + j : tab, ok);
  }
}

// The W columns of rel chunk j0 for W rows [row0, row0 + rows) into shared
// ws [rows][LDC]: local columns [0, 32) are P columns [j0, j0 + 32), [32, 64)
// the Q columns [hdp + j0, ...); zero past hdp and past row dhp. 16-byte
// cp.async (W is padded and contiguous); the caller commits and waits.
__device__ __forceinline__ void stage_w_rows(bf16* ws, const bf16* wh, int row0, int rows,
                                             int dhp, int hdp, int j0) {
  const int d2p = 2 * hdp;
  for (int i = threadIdx.x; i < rows * 8; i += THREADS) {
    const int r = i >> 3, gq = i & 7;
    const int j = j0 + 8 * (gq & 3);
    const bool ok = j < hdp && row0 + r < dhp;
    tc::cp_async16(ws + r * LDC + 8 * gq,
                   ok ? wh + static_cast<int64_t>(row0 + r) * d2p + (gq < 4 ? 0 : hdp) + j : wh,
                   ok);
  }
}

// All dhp rows of W (form_a's and the query side's W chunk).
__device__ __forceinline__ void stage_w(bf16* ws, const bf16* wh, int dhp, int hdp, int j0) {
  stage_w_rows(ws, wh, 0, dhp, dhp, hdp, j0);
}

// qv = bf16(qu + delta_h) of the block's 64 rows (qu in qa, columns [0, dhp),
// visible to every thread) into shared qv [64][ldq]: the TPU kernel's qv,
// rounded to the input type as the JAX package rounds qu + delta.
__device__ __forceinline__ void form_qv(bf16* qv, int ldq, const bf16* qa, int lda,
                                        const bf16* dl, int dhp) {
  const int half = dhp >> 1;
  for (int i = threadIdx.x; i < BQ * half; i += THREADS) {
    const int r = i / half, d = 2 * (i - r * half);
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qa + r * lda + d));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dl + d));
    *reinterpret_cast<__nv_bfloat162*>(qv + r * ldq + d) = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
  }
}

// The A rows of the query tile [q0, q0 + 64): [P | Q] = qv W_h on mma.sync
// (fp32 accumulators), rotated by the row table in fp32, rounded to bf16
// (the TPU kernel's a.astype(keytab.dtype)) and written into qa columns
// [dhp, dhp + d2p). qu must be in qa and visible to all threads; qv and ws
// are free shared regions ([64][dhp + 8] and [dhp][LDC]). Each warp forms and
// writes its own 16 rows; rows past N get A = 0. Leaves qv = bf16(qu +
// delta) in qv; ends at a barrier.
template <int DMAX>
__device__ void form_a(bf16* qa, int lda, bf16* qv, bf16* ws, const RelTab& rt, int n, int q0,
                       int h) {
  const int dhp = rt.dhp, hdp = rt.hdp, d2p = 2 * hdp, ldq = dhp + 8, nd = dhp >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const bf16* wh = rt.w + static_cast<int64_t>(h) * dhp * d2p;
  form_qv(qv, ldq, qa, lda, rt.delta + h * dhp, dhp);
  const uint32_t qv_a = tc::smem_addr(qv + (warp * 16 + (lane & 15)) * ldq + ((lane >> 4) << 3));
  const uint32_t w_bt = tc::bt_lane<LDC>(ws, lane);
  for (int j0 = 0; j0 < hdp; j0 += 32) {
    __syncthreads();   // qv written; the previous chunk's readers are done with ws
    stage_w(ws, wh, dhp, hdp, j0);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk < nd) {
        uint32_t a[4];
        tc::ldsm_x4(a, qv_a + kk * 32);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, w_bt + tc::blk<LDC>(kk, np));
          tc::mma_bf16(acc[2 * np], a, bf[0], bf[1]);
          tc::mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
        }
      }
    }
    // the rotation: n-tile j holds P columns j0 + 8j + 2c (+1), n-tile 4 + j
    // the Q columns of the same j
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = warp * 16 + g + 8 * hr, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = j0 + 8 * j + 2 * c;
        if (j0 + 8 * j >= hdp) continue;
        float2 sn = make_float2(0.f, 0.f), cs = sn;
        if (qi < n) {
          const bf16* rr = rt.rowtab + static_cast<int64_t>(qi) * d2p;
          sn = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rr + col));
          cs = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rr + hdp + col));
        }
        const float p0 = acc[j][2 * hr], p1 = acc[j][2 * hr + 1];
        const float s0 = acc[4 + j][2 * hr], s1 = acc[4 + j][2 * hr + 1];
        *reinterpret_cast<__nv_bfloat162*>(qa + r * lda + dhp + col) =
            __floats2bfloat162_rn(sn.x * p0 + cs.x * s0, sn.y * p1 + cs.y * s1);
        *reinterpret_cast<__nv_bfloat162*>(qa + r * lda + dhp + hdp + col) =
            __floats2bfloat162_rn(sn.x * s0 - cs.x * p0, sn.y * s1 - cs.y * p1);
      }
    }
  }
  __syncthreads();
}

// The scale, key bias and ragged key edge of a warp's 16 x 64 score tile
// (keys [k0, k0 + 64) in the accumulators' layout: s[j] holds keys k0 + 8j
// + 2c (+1) of rows g and g + 8), then the online softmax step: the rows'
// running max m and this lane's part of their sums l (the four lanes of a
// quad share a row; the quad is summed at the end), the scores turned into
// probabilities, the output accumulators o rescaled. Key k0 must be valid
// in the first tile, so the max is finite.
template <int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m)[2], float (&l)[2],
                                             float (&o)[NO][4], const float* bias, int k0, int nk,
                                             float scale, int c) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kj = k0 + j * 8 + 2 * c + e;
      const bool ok = kj < nk;
      const float kb = ok && bias ? bias[kj] : 0.f;
      s[j][e] = ok ? s[j][e] * scale + kb : -INFINITY;
      s[j][2 + e] = ok ? s[j][2 + e] * scale + kb : -INFINITY;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hr], mx);
    const float alpha = __expf(m[hr] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][2 * hr] = __expf(s[j][2 * hr] - m_new);
      s[j][2 * hr + 1] = __expf(s[j][2 * hr + 1] - m_new);
      sum += s[j][2 * hr] + s[j][2 * hr + 1];
    }
    l[hr] = l[hr] * alpha + sum;
    m[hr] = m_new;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][2 * hr] *= alpha;
      o[j][2 * hr + 1] *= alpha;
    }
  }
}

// ------------------------------------------------ the wide route
//
// The kernels above hold a block's [qu | A] rows whole in shared memory and
// size O's (and dk's, dv's, dqu's) registers for the padded head (DMAX <=
// 144), so they take a padded head up to 144 and the rel widths whose tiles
// fit in 227 KB (tc_fits in the kernel files). Past either limit the wide
// route takes over, in which no tile depends on dh or D:
//   * prep_wide_kernel writes the A rows (B, H, N, d2p) in bf16 to device
//     memory (rounded where form_a rounds them), a block per (64 rows, head,
//     batch x chunk of 32 paired rel columns), streaming qv and W over the
//     head in chunks of 64; the backward's also writes Di;
//   * the forward, the key side and the query side stream every product
//     over the augmented width in chunks of 64 columns ([qu | A] from qu and
//     the A rows, [k | keytab] from k and the table), and split O, dk, dv
//     and dqu into column groups of at most WIDE_DMAX (wide_gw), a grid
//     dimension: each group's blocks compute the same scores with the same
//     instructions in the same order, so every group normalises by the same
//     P; one group writes the LSE, dS^T and dbias.
// So shared memory is bounded by WIDE_DMAX alone, at any head and rel width.

constexpr int WIDE_DMAX = 128;   // widest column group of the wide route's outputs

// the column group of the wide route at padded head width dhp: the fewest
// groups of at most WIDE_DMAX columns, of equal width rounded up to 16
__host__ __device__ inline int wide_gw(int dhp) {
  const int groups = (dhp + WIDE_DMAX - 1) / WIDE_DMAX;
  return ((dhp + groups - 1) / groups + 15) / 16 * 16;
}
// the column group width the registers are sized for
__host__ __device__ inline int wide_dmax(int gw) { return gw <= 64 ? 64 : WIDE_DMAX; }
// the prep pass's shared memory: a qv chunk and a W chunk
__host__ __device__ inline size_t wide_prep_smem() {
  return static_cast<size_t>(BQ * LDC + KC * LDC) * sizeof(tc::bf16);
}

struct PrepWide {
  const bf16* qu;
  const bf16* o;        // the backward's O and dO, for Di; null in the forward
  const bf16* dout;
  RelTab rt;
  bf16* atab;           // (B, H, N, d2p): the A rows
  float* di;            // (B, H, N), or null
  int n, dh;
  int64_t qu_sb, qu_sh, qu_sn;
  int64_t o_sb, o_sh, o_sn;
  int64_t do_sb, do_sh, do_sn;
  int qu_bytes;
};

// One block per (64 query rows, head, batch x rel chunk of 32 paired
// columns): [P | Q] of the chunk = bf16(qu + delta_h) W_h on mma.sync, over
// the head in chunks of 64 (qv formed chunk by chunk as form_qv forms it),
// then the rotation as form_a's, rounded to bf16 and written as the rows'
// A columns [j0, j0 + 32) and [hdp + j0, ...). Rows past N are not written.
// The first chunk's blocks also write Di = rowsum(dO * O) when di is given.
__global__ void __launch_bounds__(THREADS) prep_wide_kernel(PrepWide p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qv = reinterpret_cast<bf16*>(smem_raw);   // [64][LDC]: a chunk of qu, then qv
  bf16* ws = qv + BQ * LDC;                       // [64][LDC]: W rows of the chunk
  const int dhp = p.rt.dhp, hdp = p.rt.hdp, d2p = 2 * hdp, nrc = (hdp + 31) / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z / nrc;
  const int j0 = (blockIdx.z % nrc) * 32;
  const int64_t bh = static_cast<int64_t>(b) * gridDim.y + h;
  const bf16* qp = p.qu + b * p.qu_sb + h * p.qu_sh;
  const bf16* wh = p.rt.w + static_cast<int64_t>(h) * dhp * d2p;
  const bf16* dl = p.rt.delta + h * dhp;
  const uint32_t qv_a = tc::a_lane<LDC>(qv + warp * 16 * LDC, lane);
  const uint32_t w_bt = tc::bt_lane<LDC>(ws, lane);

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int d0 = 0; d0 < dhp; d0 += 64) {
    __syncthreads();   // the previous chunk's products are done with qv and ws
    load_rows<BQ, 8>(qv, LDC, qp + d0, p.qu_sn, q0, p.n, p.dh - d0, 8, p.qu_bytes);
    stage_w_rows(ws, wh, d0, 64, dhp, hdp, j0);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < BQ * 32; i += THREADS) {   // qv = bf16(qu + delta), in place
      const int r = i >> 5, d = 2 * (i & 31);
      if (d0 + d < dhp) {
        bf16* x = qv + r * LDC + d;
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
        const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dl + d0 + d));
        *reinterpret_cast<__nv_bfloat162*>(x) = __floats2bfloat162_rn(a.x + y.x, a.y + y.y);
      }
    }
    __syncthreads();
    const int ksteps = min(64, dhp - d0) >> 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < ksteps) {
        uint32_t a[4];
        tc::ldsm_x4(a, qv_a + kk * 32);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, w_bt + tc::blk<LDC>(kk, np));
          tc::mma_bf16(acc[2 * np], a, bf[0], bf[1]);
          tc::mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
        }
      }
    }
  }
  // the rotation (n-tile j: P columns j0 + 8j + 2c (+1), n-tile 4 + j: Q)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + warp * 16 + g + 8 * hr;
    if (qi >= p.n) continue;
    const bf16* rr = p.rt.rowtab + static_cast<int64_t>(qi) * d2p;
    bf16* ar = p.atab + (bh * p.n + qi) * d2p;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + 8 * j + 2 * c;
      if (j0 + 8 * j >= hdp) continue;
      const float2 sn = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rr + col));
      const float2 cs = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rr + hdp + col));
      const float p0 = acc[j][2 * hr], p1 = acc[j][2 * hr + 1];
      const float s0 = acc[4 + j][2 * hr], s1 = acc[4 + j][2 * hr + 1];
      *reinterpret_cast<__nv_bfloat162*>(ar + col) =
          __floats2bfloat162_rn(sn.x * p0 + cs.x * s0, sn.y * p1 + cs.y * s1);
      *reinterpret_cast<__nv_bfloat162*>(ar + hdp + col) =
          __floats2bfloat162_rn(sn.x * s0 - cs.x * p0, sn.y * s1 - cs.y * p1);
    }
  }
  if (p.di != nullptr && j0 == 0) {   // Di, a warp a row
    const bf16* op = p.o + b * p.o_sb + h * p.o_sh;
    const bf16* dop = p.dout + b * p.do_sb + h * p.do_sh;
    for (int r = warp; r < BQ && q0 + r < p.n; r += THREADS / 32) {
      const int64_t qi = q0 + r;
      float s = 0.f;
      for (int d = lane; d < p.dh; d += 32) {
        s = fmaf(__bfloat162float(dop[qi * p.do_sn + d]), __bfloat162float(op[qi * p.o_sn + d]), s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) p.di[bh * p.n + qi] = s;
    }
  }
}

// The prep pass, on the given stream.
inline cudaError_t launch_prep_wide(const PrepWide& p, int batch, int heads, cudaStream_t stream) {
  const dim3 grid((p.n + BQ - 1) / BQ, heads, batch * ((p.rt.hdp + 31) / 32));
  prep_wide_kernel<<<grid, THREADS, wide_prep_smem(), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace rtc
