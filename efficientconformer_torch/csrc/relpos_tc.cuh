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

// The W columns of rel chunk j0 for all dhp rows into shared ws [dhp][LDC]:
// local columns [0, 32) are P columns [j0, j0 + 32), [32, 64) the Q columns
// [hdp + j0, ...); zero past hdp. 16-byte cp.async (W is padded and
// contiguous); the caller commits and waits.
__device__ __forceinline__ void stage_w(bf16* ws, const bf16* wh, int dhp, int hdp, int j0) {
  const int d2p = 2 * hdp;
  for (int i = threadIdx.x; i < dhp * 8; i += THREADS) {
    const int r = i >> 3, gq = i & 7;
    const int j = j0 + 8 * (gq & 3);
    const bool ok = j < hdp;
    tc::cp_async16(ws + r * LDC + 8 * gq, ok ? wh + r * d2p + (gq < 4 ? 0 : hdp) + j : wh, ok);
  }
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

}  // namespace rtc
