// Fused factorized relative-position attention, backward pass, for sm_90a.
//
// Replaces the TPU kernel efficientconformer_tpu/ops/pallas_rel_attention.py:
// _bwd_kernel (launched by _bwd_rule). With the forward's quantities
//
//     qv = qu + delta_h,  [P|Q] = qv W_h,  A = [sin*P + cos*Q | sin*Q - cos*P]
//     S  = (qu k^T + A keytab^T) * scale + key bias,  P = exp(S - LSE)
//
// and dO, it computes
//
//     Di  = rowsum(dO * O)              (= rowsum(P * dP) in exact arithmetic)
//     dP  = dO V^T,  dS = P * (dP - Di)
//     dv  = P^T dO,  dk = scale dS^T qu,  dbias_hb = column sums of dS
//     dA  = scale dS keytab,  dpq = [sin*dA_e - cos*dA_o | cos*dA_e + sin*dA_o]
//     dqu = scale dS k + dpq W_h^T,  dW = sum_b qv^T dpq,  ddelta = sum_b,n dpq W_h^T
//
// The plain PyTorch version is reference_relpos_attention_bwd in
// ops/rel_attention.py.
//
// What bounds it on the H100: at the flagship's training shapes (b32 x
// 16 s: N = 267/401/201 rows, head widths 90/42/60, rel widths
// 120/168/240) the products, 2 B H N (N (6 dh + 2 D) + 3 dh D) = 11-26 GFLOP
// a shape, outweigh the bytes: 0.054 ms over the three shapes on the bf16
// tensor cores. What sets the pace is the instructions around the products
// and the recomputation a split backward needs (PERF.md).
//
// The TPU kernel holds a whole (b, h) block in VMEM and carries the dW /
// ddelta sums across a sequential batch grid axis. Hopper blocks run in
// parallel and in no order, so the work is split into passes, as
// FlashAttention-2 splits its backward; dW and ddelta are written as one
// partial per (query tile, batch, head), the fp32 route's dW one per (batch,
// head), and summed by the wrapper in a fixed order: no atomics, the gradients are the same from run to run. Rows past N
// and keys past Nk get P = 0 from the kernels themselves. Two routes, chosen
// by the inputs' type:
//
//   * bf16, three tensor-core passes (relpos_tc.cuh; every product on
//     mma.sync, bf16 in, fp32 accumulators; widths zero-padded to 16, rel
//     halves to 8):
//     - relpos_bwd_prep_tc_kernel, one block per (64 query rows, head,
//       batch): A for its rows as the forward forms it, written with the qu
//       rows as [qu | A] (bf16, 16-byte aligned rows), the dO rows padded to
//       dhp, and Di = rowsum(dO * O) in fp32, so that the other passes copy
//       whole 16-byte pieces whatever the head strides;
//     - relpos_bwd_k_tc_kernel, one block per (64 keys, head, batch), each
//       warp 16 keys, streaming query tiles of 32 rows (a content step with
//       qu, dO, the LSE and Di, then the A rows in chunks of 64 columns):
//       S^T = [k | keytab][qu | A]^T and dP^T = v dO^T, P^T and dS^T in
//       fp32, dv += bf16(P^T) dO and dk += bf16(dS^T) qu in registers, the
//       dbias column sums of dS in fp32, and dS^T written once in bf16 (the
//       TPU kernel's ds.astype(k.dtype));
//     - relpos_bwd_q_tc_kernel, one block per (64 query rows, head, batch),
//       each warp 16 rows, reading dS from the key side tile by tile (64
//       keys): dqu = scale dS k; then per chunk of 32 paired rel columns
//       dA = scale dS keytab, the rotation to dpq in fp32, dpq rounded to
//       bf16, dqu += dpq W^T, the block's dW partial qv^T dpq and the column
//       sums of dpq, whose product with W^T is the ddelta partial.
//     Streaming the rel features in chunks keeps every width within one
//     block's shared memory (the widest shipped shape, D 720, takes 155,136
//     bytes); dS^T costs a round trip through device memory (B H Nk N bf16,
//     51 MB at the flagship's stage 2) and is read once per rel chunk.
//   * fp32, five passes of fp32 FMAs from shared memory (relpos_fma.cuh;
//     TF32 products would miss the fp32 checks), each product a
//     rfma::tile_product: 64 x 64 tiles, a 4 x 4 piece a thread, contracted
//     in double-buffered chunks of 32, so no width is held whole:
//     - rfma::prep_kernel, one block per (64 query rows, head, batch): the A
//       rows (B, H, N, 2hd) and Di = rowsum(dO * O);
//     - relpos_bwd_k_kernel<J>, one block per (64 keys, head, batch x head
//       column group of at most 128): per query tile S^T = [k | keytab]
//       [qu | A]^T and dP^T = v dO^T, P^T and dS^T, dv += P^T dO and dk +=
//       dS^T qu over the group's columns in registers (J <= 8 a thread); the
//       first group writes dS^T (B, H, Nk, N) fp32 and the dbias sums. A
//       head wider than 128 costs its groups a recomputation of the scores;
//     - relpos_bwd_da_kernel, one block per (64 query rows, 64 columns, batch
//       x head): scale dS k into dqu, and scale dS keytab (32 paired columns
//       of each half a block) rotated into dpq, written over the A rows;
//     - relpos_bwd_dq_kernel: dqu += dpq W^T and the ddelta partials, the
//       column sums of dpq W^T over each query tile;
//     - relpos_bwd_dw_kernel: dW = qv^T dpq over each (batch, head)'s rows.
//     Takes head widths up to 256 at any rel width: the largest pass, the
//     prep's, needs 119,040 bytes of shared memory at dh 256 (relpos_fma.cuh).
//     dS^T and dpq cost round trips through device memory (B H Nk N and
//     B H N 2hd fp32: 10.3 and 9.3 MB at EfficientConformer Large's stages 2
//     and 3, b2 x 16 s).
//
// Inputs: qu, k, v, o, dO (fp32 or bf16) with arbitrary batch/head/row
// strides and unit feature stride; lse (B, H, N) fp32; the fp32 route takes
// delta, w (H, dh, 2hd), wt = w^T per head, rowtab and keytab in fp32, the
// bf16 route delta, w, rowtab and keytab in bf16 at the padded widths, all
// contiguous; bias is fp32 (B or 1, Nk) with batch stride bias_sb. Outputs:
// dqu, dk, dv in the input type (strided); ddelta_part (B * ceil(N/64), H,
// dh) and dw_part fp32, (B, H, dh, 2hd) on the fp32 route and (B *
// ceil(N/64), H, dhp, 2hdp), at the padded widths, on the bf16 route; di
// (B, H, N) fp32 and the route's scratch (see ecf_relpos_attention_bwd); dbias (B, H, Nk) fp32, or null when not
// wanted. The kernels allocate nothing and do not synchronise; each pass
// reads what the one before it wrote, in stream order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "relpos_fma.cuh"
#include "relpos_tc.cuh"

namespace {

using rfma::BK;
using rfma::BQ;
using rfma::LDS;
using rfma::LDV;
using rfma::MAX_SMEM;
using rfma::NTHREADS;
using rfma::TILE_FLOATS;

struct Params {
  const float* qu;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;     // (B, H, N)
  const float* delta;   // (H, dh)
  const float* w;       // (H, dh, d2)
  const float* wt;      // (H, d2, dh)
  const float* rowtab;  // (N, d2)  [sin | cos]
  const float* keytab;  // (Nk, d2) [cos | sin]
  const float* bias;    // (B or 1, Nk) or null
  float* dqu;
  float* dk;
  float* dv;
  float* dw_part;       // (B, H, dh, d2)
  float* ddelta_part;   // (B * ceil(N / 64), H, dh)
  float* di;            // (B, H, N)
  float* atab;          // (B, H, N, d2): the A rows from the prep pass, then dpq
  float* ds;            // (B, H, Nk, N): dS^T from the key side
  float* dbias;         // (B, H, Nk) or null
  int heads, n, nk, dh, d2;
  int64_t qu_sb, qu_sh, qu_sn;
  int64_t k_sb, k_sh, k_sn;
  int64_t v_sb, v_sh, v_sn;
  int64_t o_sb, o_sh, o_sn;
  int64_t do_sb, do_sh, do_sn;
  int64_t dqu_sb, dqu_sh, dqu_sn;
  int64_t dk_sb, dk_sh, dk_sn;
  int64_t dv_sb, dv_sh, dv_sn;
  int64_t bias_sb;
  float scale;
};

// The key side splits the head width into column groups of at most 128
// (each group's blocks recompute the scores), so that dk and dv of a block's
// 64 keys stay within 4 x 2 x 8 registers a thread: the group width, a
// multiple of 16, and the head-width columns a thread owns (JD).
__host__ __device__ inline int k_groups(int dh) { return (dh + 127) / 128; }
__host__ __device__ inline int k_group_width(int dh) {
  const int g = k_groups(dh);
  return ((dh + g - 1) / g + 15) / 16 * 16;
}
__host__ __device__ inline int jd_for(int gw) {
  return gw <= 32 ? 2 : gw <= 64 ? 4 : gw <= 96 ? 6 : 8;
}
// the key side's shared memory: tile_product's chunks (P and dS reuse them
// between products), the group's dO and qu columns, LSE, Di and key bias
__host__ __device__ inline size_t k_smem_floats(int dh) {
  return TILE_FLOATS + 2 * static_cast<size_t>(16 * jd_for(k_group_width(dh))) * LDS + 3 * BQ;
}

// ------------------------------------------------------------ key side

// One block per (64 keys, head, batch x column group), looping over query
// tiles of 64 rows, transposed (rows are keys): S^T = [k | keytab] [qu | A]^T
// and dP^T = v dO^T (tile_product), P^T and dS^T; dv += P^T dO and dk += dS^T
// qu over the group's columns in registers; the first group also writes dS^T
// (fp32, for the query side) and the dbias column sums of dS.
template <int JD>
__global__ void __launch_bounds__(NTHREADS) relpos_bwd_k_kernel(Params p, int gw) {
  extern __shared__ __align__(16) float smem[];
  constexpr int GWP = 16 * JD;            // padded group width (zero rows past it)
  const int dh = p.dh, d2 = p.d2, da = dh + d2;
  float* buf = smem;                      // tile_product's chunks
  float* pT = smem;                       // BQ x LDV: P, then dS, row-major
  float* doT = smem + TILE_FLOATS;        // GWP x LDS: dO^T of the tile, the group's columns
  float* quT = doT + GWP * LDS;           // GWP x LDS: qu^T alike
  float* lse_s = quT + GWP * LDS;
  float* di_s = lse_s + BQ;
  float* bias_s = di_s + BQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BK, h = blockIdx.y;
  const int groups = (dh + gw - 1) / gw;
  const int b = blockIdx.z / groups, grp = blockIdx.z % groups;
  const int c0 = grp * gw, cw = min(gw, dh - c0);   // the group's columns [c0, c0 + cw)
  const int64_t bh = static_cast<int64_t>(b) * p.heads + h;
  const float* qu = p.qu + b * p.qu_sb + h * p.qu_sh;
  const float* kp = p.k + b * p.k_sb + h * p.k_sh;
  const float* vp = p.v + b * p.v_sb + h * p.v_sh;
  const float* dop = p.dout + b * p.do_sb + h * p.do_sh;
  const float* ap = p.atab + bh * p.n * d2;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;
  if (tid < BK) bias_s[tid] = (bias && k0 + tid < p.nk) ? bias[k0 + tid] : 0.f;

  float dk[4][JD], dv[4][JD], db[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    db[i] = 0.f;
#pragma unroll
    for (int j = 0; j < JD; ++j) dk[i][j] = dv[i][j] = 0.f;
  }
  // [k | keytab] and v of key k0 + c
  auto ka = [&](int f, int c) {
    const int kj = k0 + c;
    if (kj >= p.nk) return 0.f;
    return f < dh ? kp[kj * p.k_sn + f] : p.keytab[static_cast<int64_t>(kj) * d2 + f - dh];
  };
  auto vk = [&](int d, int c) {
    const int kj = k0 + c;
    return kj < p.nk ? vp[kj * p.v_sn + d] : 0.f;
  };

  for (int q0 = 0; q0 < p.n; q0 += BQ) {
    // the tile's LSE, Di and the group's columns of dO and qu (their previous
    // readers finished at the loop's last barrier)
    if (tid < BQ) {
      const int qi = q0 + tid;
      lse_s[tid] = qi < p.n ? p.lse[bh * p.n + qi] : 0.f;
      di_s[tid] = qi < p.n ? p.di[bh * p.n + qi] : 0.f;
    }
    for (int r = warp; r < BQ; r += NTHREADS / 32) {
      const int qi = q0 + r;
      const bool ok = qi < p.n;
      for (int lc = lane; lc < GWP; lc += 32) {
        const bool in = ok && lc < cw;
        doT[lc * LDS + r] = in ? dop[qi * p.do_sn + c0 + lc] : 0.f;
        quT[lc * LDS + r] = in ? qu[qi * p.qu_sn + c0 + lc] : 0.f;
      }
    }
    // [qu | A] and dO of query row q0 + r
    auto qa = [&](int f, int r) {
      const int qi = q0 + r;
      if (qi >= p.n) return 0.f;
      return f < dh ? qu[qi * p.qu_sn + f] : ap[static_cast<int64_t>(qi) * d2 + f - dh];
    };
    auto dq = [&](int d, int r) {
      const int qi = q0 + r;
      return qi < p.n ? dop[qi * p.do_sn + d] : 0.f;
    };
    // s[i][cc] and dp[i][cc] are key 4 ty + i, row tx + 16 cc
    float s[4][4], dp[4][4];
    rfma::zero(s);
    rfma::zero(dp);
    rfma::tile_product<true, true>(s, da, buf, ka, qa);
    rfma::tile_product<true, true>(dp, dh, buf, vk, dq);

    // P (kept in s) and dS (in dp); zero past N and Nk
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ty * 4 + i;
      const bool kvalid = k0 + c < p.nk;
      const float kb = bias_s[c];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int r = tx + 16 * cc;
        const float pr = (kvalid && q0 + r < p.n) ? expf(s[i][cc] * p.scale + kb - lse_s[r]) : 0.f;
        s[i][cc] = pr;
        dp[i][cc] = pr * (dp[i][cc] - di_s[r]);
        db[i] += dp[i][cc];
      }
    }
    if (grp == 0) {   // dS^T for the query side: 16 neighbouring rows a half-warp
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k0 + ty * 4 + i;
        if (kj >= p.nk) continue;
        float* dsrow = p.ds + (bh * p.nk + kj) * p.n;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int qi = q0 + tx + 16 * cc;
          if (qi < p.n) dsrow[qi] = dp[i][cc];
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      *reinterpret_cast<float4*>(pT + (tx + 16 * cc) * LDV + ty * 4) =
          make_float4(s[0][cc], s[1][cc], s[2][cc], s[3][cc]);
    }
    __syncthreads();
    // dv += P^T dO
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      const float4 g = *reinterpret_cast<const float4*>(pT + r * LDV + ty * 4);
      const float* ocol = doT + tx * LDS + r;
#pragma unroll
      for (int j = 0; j < JD; ++j) {
        const float ov = ocol[16 * j * LDS];
        dv[0][j] = fmaf(g.x, ov, dv[0][j]);
        dv[1][j] = fmaf(g.y, ov, dv[1][j]);
        dv[2][j] = fmaf(g.z, ov, dv[2][j]);
        dv[3][j] = fmaf(g.w, ov, dv[3][j]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      *reinterpret_cast<float4*>(pT + (tx + 16 * cc) * LDV + ty * 4) =
          make_float4(dp[0][cc], dp[1][cc], dp[2][cc], dp[3][cc]);
    }
    __syncthreads();
    // dk += dS^T qu (scaled at the end)
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      const float4 g = *reinterpret_cast<const float4*>(pT + r * LDV + ty * 4);
      const float* qcol = quT + tx * LDS + r;
#pragma unroll
      for (int j = 0; j < JD; ++j) {
        const float qv = qcol[16 * j * LDS];
        dk[0][j] = fmaf(g.x, qv, dk[0][j]);
        dk[1][j] = fmaf(g.y, qv, dk[1][j]);
        dk[2][j] = fmaf(g.z, qv, dk[2][j]);
        dk[3][j] = fmaf(g.w, qv, dk[3][j]);
      }
    }
    __syncthreads();
  }

  // dk, dv of the group's columns, and the dbias column sums
  float* dkp = p.dk + b * p.dk_sb + h * p.dk_sh;
  float* dvp = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    float colsum = db[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) colsum += __shfl_xor_sync(0xffffffffu, colsum, off);
    if (kj >= p.nk) continue;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int lc = tx + 16 * j;
      if (lc < cw) {
        dkp[kj * p.dk_sn + c0 + lc] = dk[i][j] * p.scale;
        dvp[kj * p.dv_sn + c0 + lc] = dv[i][j];
      }
    }
    if (tx == 0 && grp == 0 && p.dbias) p.dbias[bh * p.nk + kj] = colsum;
  }
}

// ---------------------------------------------------------- query side

// One block per (64 query rows, column tile, batch x head), over the keys:
// d[qu | A] = scale dS [k | keytab] (tile_product of dS^T's rows and the key
// features). A content tile (64 of the head's columns) writes dqu's first
// term; a rel tile (32 paired columns of each half) rotates its dA into dpq
// and writes dpq over the A rows (which the key side has finished reading).
__global__ void __launch_bounds__(NTHREADS) relpos_bwd_da_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int dh = p.dh, d2 = p.d2, hd = d2 / 2;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ, t = blockIdx.y;
  const int64_t bh = blockIdx.z;
  const int b = blockIdx.z / p.heads, h = blockIdx.z % p.heads;
  const int nct = (dh + 63) / 64;   // content tiles
  const float* dsp = p.ds + bh * p.nk * p.n;
  auto dsl = [&](int kj, int r) {
    const int qi = q0 + r;
    return qi < p.n ? dsp[static_cast<int64_t>(kj) * p.n + qi] : 0.f;
  };
  float acc[4][4];
  rfma::zero(acc);
  if (t < nct) {
    const int c0 = 64 * t;
    const float* kp = p.k + b * p.k_sb + h * p.k_sh;
    auto kc = [&](int kj, int lc) {
      const int c = c0 + lc;
      return c < dh ? kp[kj * p.k_sn + c] : 0.f;
    };
    rfma::tile_product<false, false>(acc, p.nk, smem, dsl, kc);
    float* dq = p.dqu + b * p.dqu_sb + h * p.dqu_sh;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      if (qi >= p.n) continue;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = c0 + tx + 16 * cc;
        if (c < dh) dq[qi * p.dqu_sn + c] = acc[i][cc] * p.scale;
      }
    }
    return;
  }
  // local column lc < 32: even column j0 + lc; lc >= 32: odd column j0 + lc - 32
  const int j0 = 32 * (t - nct);
  auto tcol = [&](int kj, int lc) {
    const int j = j0 + (lc & 31);
    if (j >= hd) return 0.f;
    return p.keytab[static_cast<int64_t>(kj) * d2 + (lc < 32 ? j : hd + j)];
  };
  rfma::tile_product<false, false>(acc, p.nk, smem, dsl, tcol);
  // columns cc and cc + 2 of a thread are the two halves of column j
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.n) continue;
    float* g = p.atab + (bh * p.n + qi) * d2;
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      const int j = j0 + 16 * pp + tx;
      if (j >= hd) continue;
      const float e = acc[i][pp] * p.scale, od = acc[i][2 + pp] * p.scale;
      const float sn = p.rowtab[static_cast<int64_t>(qi) * d2 + j];
      const float cs = p.rowtab[static_cast<int64_t>(qi) * d2 + hd + j];
      g[j] = sn * e - cs * od;
      g[hd + j] = cs * e + sn * od;
    }
  }
}

// One block per (64 query rows, 64 head columns, batch x head): dqu += dpq
// W^T, and the block's ddelta partial, the column sums of dpq W^T over its
// rows (rows past N have none).
__global__ void __launch_bounds__(NTHREADS) relpos_bwd_dq_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int dh = p.dh, d2 = p.d2;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qt = blockIdx.x, q0 = qt * BQ, c0 = 64 * blockIdx.y;
  const int64_t bh = blockIdx.z;
  const int b = blockIdx.z / p.heads, h = blockIdx.z % p.heads;
  const float* gp = p.atab + bh * p.n * d2;
  const float* wt = p.wt + static_cast<int64_t>(h) * d2 * dh;
  auto g = [&](int f, int r) {
    const int qi = q0 + r;
    return qi < p.n ? gp[static_cast<int64_t>(qi) * d2 + f] : 0.f;
  };
  auto wl = [&](int f, int lc) {
    const int d = c0 + lc;
    return d < dh ? wt[f * dh + d] : 0.f;
  };
  float acc[4][4];
  rfma::zero(acc);
  rfma::tile_product<true, false>(acc, d2, smem, g, wl);
  float* dq = p.dqu + b * p.dqu_sb + h * p.dqu_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.n) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int d = c0 + tx + 16 * cc;
      if (d < dh) dq[qi * p.dqu_sn + d] += acc[i][cc];
    }
  }
  float* red = smem;   // 16 x 64: each row group's column sums (tile_product is done)
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    red[ty * 64 + tx + 16 * cc] = acc[0][cc] + acc[1][cc] + acc[2][cc] + acc[3][cc];
  }
  __syncthreads();
  if (tid < 64 && c0 + tid < dh) {
    float sum = 0.f;
    for (int y = 0; y < 16; ++y) sum += red[y * 64 + tid];
    p.ddelta_part[((static_cast<int64_t>(b) * gridDim.x + qt) * p.heads + h) * dh + c0 + tid] = sum;
  }
}

// One block per (64 head columns, 64 rel columns, batch x head): this batch
// and head's dW = qv^T dpq over all N rows, qv = qu + delta.
__global__ void __launch_bounds__(NTHREADS) relpos_bwd_dw_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int dh = p.dh, d2 = p.d2;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int d0 = 64 * blockIdx.x, f0 = 64 * blockIdx.y;
  const int64_t bh = blockIdx.z;
  const int b = blockIdx.z / p.heads, h = blockIdx.z % p.heads;
  const float* qu = p.qu + b * p.qu_sb + h * p.qu_sh;
  const float* dl = p.delta + h * dh;
  const float* gp = p.atab + bh * p.n * d2;
  auto qv = [&](int qi, int r) {
    const int d = d0 + r;
    return d < dh ? qu[qi * p.qu_sn + d] + dl[d] : 0.f;
  };
  auto g = [&](int qi, int lc) {
    const int f = f0 + lc;
    return f < d2 ? gp[static_cast<int64_t>(qi) * d2 + f] : 0.f;
  };
  float acc[4][4];
  rfma::zero(acc);
  rfma::tile_product<false, false>(acc, p.n, smem, qv, g);
  float* dwp = p.dw_part + bh * dh * d2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + ty * 4 + i;
    if (d >= dh) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int f = f0 + tx + 16 * cc;
      if (f < d2) dwp[static_cast<int64_t>(d) * d2 + f] = acc[i][cc];
    }
  }
}

// ------------------------------------------------ bf16: the tensor cores

constexpr int TC_BK = 64;   // keys a block (key side) or a streamed tile (query side)
constexpr int TC_TQ = 32;   // query rows a streamed tile of the key side

struct TcParams {
  const tc::bf16* qu;
  const tc::bf16* k;
  const tc::bf16* v;
  const tc::bf16* o;
  const tc::bf16* dout;
  const float* lse;     // (B, H, N)
  rtc::RelTab rt;       // padded bf16 delta, W and tables
  const float* bias;    // (B or 1, Nk) or null
  tc::bf16* dqu;
  tc::bf16* dk;
  tc::bf16* dv;
  float* dw_part;       // (B * ceil(N/64), H, dhp, d2p)
  float* ddelta_part;   // (B * ceil(N/64), H, dhp)
  float* di;            // (B, H, N)
  tc::bf16* qa;         // (B, H, np, dhp + d2p): [qu | A] rows, from the prep pass
  tc::bf16* dop;        // (B, H, np, dhp): dO rows, padded, from the prep pass
  tc::bf16* dst;        // (B, H, nkp, np): dS^T, from the key side to the query side
  float* dbias;         // (B, H, Nk) or null
  int n, nk, dh, np, nkp;   // np, nkp: N and Nk rounded up to 64
  int64_t qu_sb, qu_sh, qu_sn;
  int64_t k_sb, k_sh, k_sn;
  int64_t v_sb, v_sh, v_sn;
  int64_t o_sb, o_sh, o_sn;
  int64_t do_sb, do_sh, do_sn;
  int64_t dqu_sb, dqu_sh, dqu_sn;
  int64_t dk_sb, dk_sh, dk_sn;
  int64_t dv_sb, dv_sh, dv_sn;
  int64_t bias_sb;
  float scale;
  int qu_bytes, k_bytes, v_bytes, o_bytes, do_bytes, dqu_bytes, dk_bytes, dv_bytes;
};

__host__ __device__ inline size_t smax(size_t a, size_t b) { return a > b ? a : b; }

// bytes of shared memory of each pass at padded widths dhp, d2p
__host__ __device__ inline size_t tc_prep_smem(int dhp, int d2p) {
  const size_t lda = dhp + d2p + 8, ldt = dhp + 8;
  return (rtc::BQ * lda + smax(rtc::BQ * ldt + dhp * rtc::LDC, 2 * rtc::BQ * ldt)) * 2;
}
__host__ __device__ inline size_t tc_k_smem(int dhp, int d2p) {
  const size_t lda = dhp + d2p + 8, ldt = dhp + 8;
  return (TC_BK * lda + TC_BK * ldt + 2 * 2 * TC_TQ * ldt + 2 * TC_TQ * rtc::LDC) * 2 +
         2 * 2 * TC_TQ * sizeof(float);
}
__host__ __device__ inline size_t tc_q_smem(int dhp, int d2p) {
  const size_t ldt = dhp + 8, ldx = (dhp > 64 ? dhp : 64) + 8;
  return (rtc::BQ * ldt + 2 * TC_BK * (rtc::LDC + ldx) + dhp * rtc::LDC + rtc::BQ * rtc::LDC) *
             2 + d2p * sizeof(float);
}

// Pass 1, one block per (64 query rows, head, batch): the A rows (as the
// forward forms them), written with the qu rows as [qu | A] for the other
// passes; Di = rowsum(dO * O) in fp32; the dO rows padded to dhp.
template <int DMAX>
__global__ void __launch_bounds__(rtc::THREADS) relpos_bwd_prep_tc_kernel(TcParams p) {
  using tc::bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dhp = p.rt.dhp, d2p = 2 * p.rt.hdp, da = dhp + d2p;
  const int lda = da + 8, ldt = dhp + 8, ngr = dhp >> 3;
  bf16* qa = reinterpret_cast<bf16*>(smem_raw);   // [64][lda]
  bf16* region = qa + rtc::BQ * lda;              // O and dO rows, then form_a's scratch
  bf16* ot = region;
  bf16* dot = region + rtc::BQ * ldt;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * rtc::BQ, h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * gridDim.y + h;

  rtc::load_rows<rtc::BQ, DMAX / 8>(qa, lda, p.qu + b * p.qu_sb + h * p.qu_sh, p.qu_sn, q0, p.n,
                                    p.dh, ngr, p.qu_bytes);
  rtc::load_rows<rtc::BQ, DMAX / 8>(ot, ldt, p.o + b * p.o_sb + h * p.o_sh, p.o_sn, q0, p.n, p.dh,
                                    ngr, p.o_bytes);
  rtc::load_rows<rtc::BQ, DMAX / 8>(dot, ldt, p.dout + b * p.do_sb + h * p.do_sh, p.do_sn, q0,
                                    p.n, p.dh, ngr, p.do_bytes);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  {   // Di, two threads a row
    const int r = tid >> 1;
    float acc = 0.f;
    for (int d = 2 * (tid & 1); d < dhp; d += 4) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dot + r * ldt + d));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ot + r * ldt + d));
      acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0 && q0 + r < p.n) p.di[bh * p.n + q0 + r] = acc;
  }
  tc::store_rows_rt(p.dop + bh * p.np * dhp, dhp, dot, ldt, rtc::BQ, q0, p.n, dhp, 16, tid,
                    rtc::THREADS);
  __syncthreads();   // form_a's scratch overwrites O and dO
  rtc::form_a<DMAX>(qa, lda, region, region + rtc::BQ * ldt, p.rt, p.n, q0, h);
  tc::store_rows_rt(p.qa + bh * p.np * da, da, qa, lda, rtc::BQ, q0, p.n, da, 16, tid,
                    rtc::THREADS);
}

// Pass 2, one block per (64 keys, head, batch), each warp 16 keys, looping
// over query tiles of 32 rows, transposed (rows are keys): S^T = [k | keytab]
// [qu | A]^T and dP^T = v dO^T, P^T and dS^T in fp32; dv += bf16(P^T) dO and
// dk += bf16(dS^T) qu in registers, the dbias column sums of dS in fp32; dS^T
// written in bf16 for pass 3. A query tile is a content step (its qu and dO
// rows, LSE and Di) and nrel steps of A chunks.
template <int DMAX>
__global__ void __launch_bounds__(rtc::THREADS) relpos_bwd_k_tc_kernel(TcParams p) {
  using tc::bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dhp = p.rt.dhp, d2p = 2 * p.rt.hdp, da = dhp + d2p;
  const int lda = da + 8, ldt = dhp + 8, nd = dhp >> 4, ngr = dhp >> 3;
  bf16* ka = reinterpret_cast<bf16*>(smem_raw);   // [64][lda]: [k | keytab] of the keys
  bf16* vb = ka + TC_BK * lda;                    // [64][ldt]: v of the keys
  bf16* tiles = vb + TC_BK * ldt;                 // [2][qu [32][ldt], dO [32][ldt]]
  bf16* ch = tiles + 2 * 2 * TC_TQ * ldt;         // [2][32][LDC]: A chunks
  float* ls = reinterpret_cast<float*>(ch + 2 * TC_TQ * rtc::LDC);   // [2][32] LSE
  float* dis = ls + 2 * TC_TQ;                                        // [2][32] Di

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int k0 = blockIdx.x * TC_BK, h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * gridDim.y + h;
  const bf16* qa_g = p.qa + bh * p.np * da;
  const bf16* do_g = p.dop + bh * p.np * dhp;
  const float* lse = p.lse + bh * p.n;
  const float* di = p.di + bh * p.n;

  // 1. the block's keys: [k | keytab] and v
  rtc::load_rows_rt<TC_BK>(ka, lda, p.k + b * p.k_sb + h * p.k_sh, p.k_sn, k0, p.nk, p.dh, ngr,
                           p.k_bytes);
  rtc::load_rows_rt<TC_BK>(ka + dhp, lda, p.rt.keytab, d2p, k0, p.nk, d2p, d2p >> 3, 16);
  rtc::load_rows_rt<TC_BK>(vb, ldt, p.v + b * p.v_sb + h * p.v_sh, p.v_sn, k0, p.nk, p.dh, ngr,
                           p.v_bytes);
  float kbias[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kj = k0 + warp * 16 + g + 8 * hr;
    kbias[hr] = p.bias && kj < p.nk ? p.bias[b * p.bias_sb + kj] : 0.f;
  }

  const int nrel = (d2p + rtc::KC - 1) / rtc::KC, nsteps = 1 + nrel;
  const int total = (p.n + TC_TQ - 1) / TC_TQ * nsteps;
  auto load_step = [&](int st) {
    const int t = st / nsteps, f = st - t * nsteps, r0 = t * TC_TQ;
    if (f == 0) {
      bf16* qt = tiles + (t & 1) * 2 * TC_TQ * ldt;
      rtc::load_rows<TC_TQ, DMAX / 8>(qt, ldt, qa_g, da, r0, p.n, dhp, ngr, 16);
      rtc::load_rows<TC_TQ, DMAX / 8>(qt + TC_TQ * ldt, ldt, do_g, dhp, r0, p.n, dhp, ngr, 16);
      const int i = tid & (TC_TQ - 1);
      const bool ok = r0 + i < p.n;
      if (tid < TC_TQ) {
        tc::cp_async4(ls + (t & 1) * TC_TQ + i, ok ? lse + r0 + i : lse, ok);
      } else if (tid < 2 * TC_TQ) {
        tc::cp_async4(dis + (t & 1) * TC_TQ + i, ok ? di + r0 + i : di, ok);
      }
    } else {
      const int c0 = (f - 1) * rtc::KC;
      rtc::load_rows<TC_TQ, rtc::KC / 8>(ch + (st & 1) * TC_TQ * rtc::LDC, rtc::LDC,
                                         qa_g + dhp + c0, da, r0, p.n, d2p - c0, rtc::KC / 8, 16);
    }
  };

  float dk[DMAX / 8][4], dv[DMAX / 8][4], db[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }
  float s[4][4], dp[4][4];
  const uint32_t ka_a = tc::smem_addr(ka + (warp * 16 + (lane & 15)) * lda + ((lane >> 4) << 3));
  const uint32_t vb_a = tc::smem_addr(vb + (warp * 16 + (lane & 15)) * ldt + ((lane >> 4) << 3));
  const uint32_t t_b = tc::smem_addr(tiles + ((lane & 7) + ((lane >> 4) << 3)) * ldt +
                                     (((lane >> 3) & 1) << 3));
  const uint32_t t_bt = tc::smem_addr(tiles + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ldt +
                                      ((lane >> 4) << 3));
  const uint32_t ch_b = tc::b_lane<rtc::LDC>(ch, lane);
  const uint32_t tile_bytes = 2 * TC_TQ * ldt * 2, do_off = TC_TQ * ldt * 2, blk_row = 16 * ldt * 2;
  constexpr uint32_t CH_BYTES = TC_TQ * rtc::LDC * 2;

  load_step(0);
  tc::cp_async_commit();
  for (int st = 0; st < total; ++st) {
    tc::cp_async_wait<0>();
    __syncthreads();   // step st landed for every thread (the block's keys too, at st = 0)
    if (st + 1 < total) load_step(st + 1);
    tc::cp_async_commit();
    const int t = st / nsteps, f = st - t * nsteps;
    const uint32_t tb = t_b + (t & 1) * tile_bytes;
    if (f == 0) {   // S^T = k qu^T, dP^T = v dO^T
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        if (kk < nd) {
          uint32_t a[4], bf[4];
          tc::ldsm_x4(a, ka_a + kk * 32);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            tc::ldsm_x4(bf, tb + np * blk_row + kk * 32);
            tc::mma_bf16(s[2 * np], a, bf[0], bf[1]);
            tc::mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
          }
          tc::ldsm_x4(a, vb_a + kk * 32);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            tc::ldsm_x4(bf, tb + do_off + np * blk_row + kk * 32);
            tc::mma_bf16(dp[2 * np], a, bf[0], bf[1]);
            tc::mma_bf16(dp[2 * np + 1], a, bf[2], bf[3]);
          }
        }
      }
    } else {        // S^T += keytab A^T over this chunk's features
      const int c0 = (f - 1) * rtc::KC, ksteps = (d2p - c0) >> 4;
      const uint32_t cb = ch_b + (st & 1) * CH_BYTES, ab = ka_a + (dhp + c0) * 2;
#pragma unroll
      for (int kk = 0; kk < rtc::KC / 16; ++kk) {
        if (kk < ksteps) {
          uint32_t a[4], bf[4];
          tc::ldsm_x4(a, ab + kk * 32);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            tc::ldsm_x4(bf, cb + tc::blk<rtc::LDC>(np, kk));
            tc::mma_bf16(s[2 * np], a, bf[0], bf[1]);
            tc::mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
          }
        }
      }
    }
    if (f != nsteps - 1) continue;

    // P^T (in s) and dS^T (in dp); zero past N and Nk; dS^T out in bf16
    const int r0 = t * TC_TQ;
    const float* lt = ls + (t & 1) * TC_TQ;
    const float* dt = dis + (t & 1) * TC_TQ;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1, key = warp * 16 + g + 8 * hr, row = j * 8 + 2 * c + (e & 1);
        const bool ok = k0 + key < p.nk && r0 + row < p.n;
        const float pr = ok ? __expf(s[j][e] * p.scale + kbias[hr] - lt[row]) : 0.f;
        s[j][e] = pr;
        dp[j][e] = pr * (dp[j][e] - dt[row]);
        db[hr] += dp[j][e];
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int key = warp * 16 + g + 8 * hr;
        *reinterpret_cast<__nv_bfloat162*>(p.dst + (bh * p.nkp + k0 + key) * p.np + r0 + j * 8 +
                                           2 * c) =
            __floats2bfloat162_rn(dp[j][2 * hr], dp[j][2 * hr + 1]);
      }
    }
    // dv += P^T dO and dk += dS^T qu, P^T and dS^T as bf16 A fragments
    const uint32_t tbt = t_bt + (t & 1) * tile_bytes;
#pragma unroll
    for (int kk = 0; kk < TC_TQ / 16; ++kk) {
      uint32_t a[4], bf[4];
      tc::acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < DMAX / 16; ++n2) {
        if (n2 < nd) {
          tc::ldsm_x4_t(bf, tbt + do_off + kk * blk_row + n2 * 32);
          tc::mma_bf16(dv[2 * n2], a, bf[0], bf[1]);
          tc::mma_bf16(dv[2 * n2 + 1], a, bf[2], bf[3]);
        }
      }
      tc::acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < DMAX / 16; ++n2) {
        if (n2 < nd) {
          tc::ldsm_x4_t(bf, tbt + kk * blk_row + n2 * 32);
          tc::mma_bf16(dk[2 * n2], a, bf[0], bf[1]);
          tc::mma_bf16(dk[2 * n2 + 1], a, bf[2], bf[3]);
        }
      }
    }
  }

  // 3. dk (scaled) and dv through the warp's own rows of ka and vb; the
  //    dbias column sums over the quad
  bf16* kst = ka + warp * 16 * lda;
  bf16* vst = vb + warp * 16 * ldt;
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    if (j < 2 * nd) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int col = j * 8 + 2 * c, row = g + 8 * hr;
        *reinterpret_cast<__nv_bfloat162*>(kst + row * lda + col) =
            __floats2bfloat162_rn(dk[j][2 * hr] * p.scale, dk[j][2 * hr + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(vst + row * ldt + col) =
            __floats2bfloat162_rn(dv[j][2 * hr], dv[j][2 * hr + 1]);
      }
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float sum = db[hr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int kj = k0 + warp * 16 + g + 8 * hr;
    if (c == 0 && kj < p.nk && p.dbias) p.dbias[bh * p.nk + kj] = sum;
  }
  __syncwarp();
  tc::store_rows_rt(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sn, kst, lda, 16, k0 + warp * 16, p.nk,
                    p.dh, p.dk_bytes, lane, 32);
  tc::store_rows_rt(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sn, vst, ldt, 16, k0 + warp * 16, p.nk,
                    p.dh, p.dv_bytes, lane, 32);
}

// Pass 3, one block per (64 query rows, head, batch), each warp 16 rows,
// reading dS from pass 2 tile by tile (64 keys), once for the content part
// and once per rel chunk: dqu = scale dS k; per chunk of 32 paired rel
// columns dA = scale dS keytab, through the rotation to dpq (fp32, then
// bf16 as the TPU kernel rounds it), dqu += dpq W^T, the block's dW partial
// qv^T dpq and the column sums of dpq; then ddelta's partial (sum of dpq)
// W^T. No atomics: the wrapper sums the partials in a fixed order.
template <int DMAX>
__global__ void __launch_bounds__(rtc::THREADS) relpos_bwd_q_tc_kernel(TcParams p) {
  using tc::bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dhp = p.rt.dhp, hdp = p.rt.hdp, d2p = 2 * hdp, da = dhp + d2p;
  const int ldt = dhp + 8, ldx = (dhp > 64 ? dhp : 64) + 8, nd = dhp >> 4, ngr = dhp >> 3;
  constexpr int LDC = rtc::LDC;
  bf16* qvs = reinterpret_cast<bf16*>(smem_raw);   // [64][ldt]: qv of the rows
  bf16* ring = qvs + rtc::BQ * ldt;                // [2][dS^T [64][LDC], x [64][ldx]]
  bf16* ws = ring + 2 * TC_BK * (LDC + ldx);       // [dhp][LDC]: a W chunk
  bf16* dpqs = ws + dhp * LDC;                     // [64][LDC]: a dpq chunk
  float* dcol = reinterpret_cast<float*>(dpqs + rtc::BQ * LDC);   // [d2p]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int q0 = blockIdx.x * rtc::BQ, h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int64_t bh = static_cast<int64_t>(b) * heads + h;
  const int64_t part = static_cast<int64_t>(b) * gridDim.x + blockIdx.x;
  const bf16* kp = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* ds_g = p.dst + bh * p.nkp * p.np + q0;
  const bf16* wh = p.rt.w + static_cast<int64_t>(h) * dhp * d2p;

  // 1. qv = bf16(qu + delta) of the rows (qu from pass 1's [qu | A] rows)
  rtc::load_rows<rtc::BQ, DMAX / 8>(qvs, ldt, p.qa + bh * p.np * da, da, q0, p.n, dhp, ngr, 16);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  rtc::form_qv(qvs, ldt, qvs, ldt, p.rt.delta + h * dhp, dhp);

  // 2. over (pass, key tile): pass 0 streams (dS tile, k tile), pass 1 + i
  //    (dS tile, keytab chunk i)
  const int nchunk = (hdp + 31) / 32, nkt = p.nkp / TC_BK, total = (1 + nchunk) * nkt;
  const uint32_t stage_bytes = TC_BK * (LDC + ldx) * 2;
  auto load_step = [&](int st) {
    const int pass = st / nkt, t = st - pass * nkt, k0 = t * TC_BK;
    bf16* dsb = ring + (st & 1) * TC_BK * (LDC + ldx);
    bf16* xb = dsb + TC_BK * LDC;
    rtc::load_rows<TC_BK, 8>(dsb, LDC, ds_g, p.np, k0, p.nkp, p.n - q0, 8, 16);
    if (pass == 0) {
      rtc::load_rows<TC_BK, DMAX / 8>(xb, ldx, kp, p.k_sn, k0, p.nk, p.dh, ngr, p.k_bytes);
    } else {
      rtc::load_pairs<TC_BK>(xb, ldx, p.rt.keytab, k0, p.nk, hdp, (pass - 1) * 32);
    }
  };

  float dq[DMAX / 8][4], acc[8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  // dS rows of the warp as A fragments from the key-major dS^T tile
  // (ldmatrix.trans at tc::b_lane's addresses), x as B through .trans
  const uint32_t ds_at = tc::b_lane<LDC>(ring, lane) + warp * 32;
  const uint32_t x_bt = tc::smem_addr(ring + TC_BK * LDC +
                                      ((lane & 7) + (((lane >> 3) & 1) << 3)) * ldx +
                                      ((lane >> 4) << 3));
  const uint32_t xblk = 16 * ldx * 2;
  const uint32_t dpq_a = tc::a_lane<LDC>(dpqs + warp * 16 * LDC, lane);
  const uint32_t ws_b = tc::b_lane<LDC>(ws, lane), dpq_bt = tc::bt_lane<LDC>(dpqs, lane);
  const uint32_t qv_at = tc::smem_addr(qvs + ((lane & 7) + ((lane >> 4) << 3)) * ldt +
                                       (((lane >> 3) & 1) << 3));
  for (int i = tid; i < d2p; i += rtc::THREADS) dcol[i] = 0.f;

  load_step(0);
  tc::cp_async_commit();
  for (int st = 0; st < total; ++st) {
    tc::cp_async_wait<0>();
    __syncthreads();
    if (st + 1 < total) load_step(st + 1);
    tc::cp_async_commit();
    const int pass = st / nkt, t = st - pass * nkt;
    const uint32_t sb = (st & 1) * stage_bytes;
    if (pass == 0) {   // dq += dS k
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        uint32_t a[4];
        tc::ldsm_x4_t(a, ds_at + sb + tc::blk<LDC>(kk, 0));
#pragma unroll
        for (int n2 = 0; n2 < DMAX / 16; ++n2) {
          if (n2 < nd) {
            uint32_t bf[4];
            tc::ldsm_x4_t(bf, x_bt + sb + kk * xblk + n2 * 32);
            tc::mma_bf16(dq[2 * n2], a, bf[0], bf[1]);
            tc::mma_bf16(dq[2 * n2 + 1], a, bf[2], bf[3]);
          }
        }
      }
      if (t == nkt - 1) {
#pragma unroll
        for (int j = 0; j < DMAX / 8; ++j) {
          dq[j][0] *= p.scale; dq[j][1] *= p.scale; dq[j][2] *= p.scale; dq[j][3] *= p.scale;
        }
      }
      continue;
    }
    // dA += dS keytab over this chunk's 32 + 32 columns
    if (t == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t a[4];
      tc::ldsm_x4_t(a, ds_at + sb + tc::blk<LDC>(kk, 0));
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t bf[4];
        tc::ldsm_x4_t(bf, x_bt + sb + kk * xblk + n2 * 32);
        tc::mma_bf16(acc[2 * n2], a, bf[0], bf[1]);
        tc::mma_bf16(acc[2 * n2 + 1], a, bf[2], bf[3]);
      }
    }
    if (t != nkt - 1) continue;

    // the chunk's epilogue: dpq = rotation of scale dA, rounded to bf16
    const int j0 = (pass - 1) * 32;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = warp * 16 + g + 8 * hr, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = j0 + 8 * j + 2 * c;
        float2 sn = make_float2(0.f, 0.f), cs = sn;
        if (qi < p.n && j0 + 8 * j < hdp) {
          const bf16* rr = p.rt.rowtab + static_cast<int64_t>(qi) * d2p;
          sn = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rr + col));
          cs = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rr + hdp + col));
        }
        const float e0 = acc[j][2 * hr] * p.scale, e1 = acc[j][2 * hr + 1] * p.scale;
        const float o0 = acc[4 + j][2 * hr] * p.scale, o1 = acc[4 + j][2 * hr + 1] * p.scale;
        *reinterpret_cast<__nv_bfloat162*>(dpqs + r * LDC + 8 * j + 2 * c) =
            __floats2bfloat162_rn(sn.x * e0 - cs.x * o0, sn.y * e1 - cs.y * o1);
        *reinterpret_cast<__nv_bfloat162*>(dpqs + r * LDC + 32 + 8 * j + 2 * c) =
            __floats2bfloat162_rn(cs.x * e0 + sn.x * o0, cs.y * e1 + sn.y * o1);
      }
    }
    rtc::stage_w(ws, wh, dhp, hdp, j0);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();   // dpq of every row and the W chunk in place
    // dq += dpq W^T (the warp's rows)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      tc::ldsm_x4(a, dpq_a + kk * 32);
#pragma unroll
      for (int n2 = 0; n2 < DMAX / 16; ++n2) {
        if (n2 < nd) {
          uint32_t bf[4];
          tc::ldsm_x4(bf, ws_b + tc::blk<LDC>(n2, kk));
          tc::mma_bf16(dq[2 * n2], a, bf[0], bf[1]);
          tc::mma_bf16(dq[2 * n2 + 1], a, bf[2], bf[3]);
        }
      }
    }
    // the block's dW partial qv^T dpq over this chunk, 16 qv features a warp
    for (int mi = warp; mi < nd; mi += 4) {
      float w2[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) w2[j][0] = w2[j][1] = w2[j][2] = w2[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        tc::ldsm_x4_t(a, qv_at + (kk * 16 * ldt + mi * 16) * 2);
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, dpq_bt + tc::blk<LDC>(kk, n2));
          tc::mma_bf16(w2[2 * n2], a, bf[0], bf[1]);
          tc::mma_bf16(w2[2 * n2 + 1], a, bf[2], bf[3]);
        }
      }
      float* dwp = p.dw_part + ((part * heads + h) * dhp + mi * 16) * d2p;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int lc = 8 * j + 2 * c, jj = j0 + (lc & 31);
        if (jj >= hdp) continue;
        const int f = (lc < 32 ? 0 : hdp) + jj;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          *reinterpret_cast<float2*>(dwp + (g + 8 * hr) * d2p + f) =
              make_float2(w2[j][2 * hr], w2[j][2 * hr + 1]);
        }
      }
    }
    if (tid < 64) {   // the chunk's column sums of dpq
      const int jj = j0 + (tid & 31);
      if (jj < hdp) {
        float sum = 0.f;
        for (int r = 0; r < rtc::BQ; ++r) sum += __bfloat162float(dpqs[r * LDC + tid]);
        dcol[(tid < 32 ? 0 : hdp) + jj] = sum;
      }
    }
  }

  // 3. ddelta's partial, (sum of dpq) W^T; dqu through the warp's own rows
  //    of qv
  __syncthreads();
  for (int d = tid; d < dhp; d += rtc::THREADS) {
    float sum = 0.f;
    for (int f = 0; f < d2p; ++f) sum = fmaf(dcol[f], __bfloat162float(wh[d * d2p + f]), sum);
    p.ddelta_part[(part * heads + h) * dhp + d] = sum;
  }
  bf16* stage = qvs + warp * 16 * ldt;
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    if (j < 2 * nd) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8 * hr) * ldt + j * 8 + 2 * c) =
            __floats2bfloat162_rn(dq[j][2 * hr], dq[j][2 * hr + 1]);
      }
    }
  }
  __syncwarp();
  tc::store_rows_rt(p.dqu + b * p.dqu_sb + h * p.dqu_sh, p.dqu_sn, stage, ldt, 16,
                    q0 + warp * 16, p.n, p.dh, p.dqu_bytes, lane, 32);
}

// ---------------------------------------------------------------- launch

cudaError_t prepare(const void* fn, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int JD>
cudaError_t launch_k(const Params& p, int batch, int heads, cudaStream_t stream) {
  const size_t bytes = k_smem_floats(p.dh) * sizeof(float);
  cudaError_t err = prepare(reinterpret_cast<const void*>(&relpos_bwd_k_kernel<JD>), bytes);
  if (err != cudaSuccess) return err;
  const int gw = k_group_width(p.dh);
  const dim3 grid((p.nk + BK - 1) / BK, heads, batch * ((p.dh + gw - 1) / gw));
  relpos_bwd_k_kernel<JD><<<grid, NTHREADS, bytes, stream>>>(p, gw);
  return cudaGetLastError();
}

cudaError_t launch_tile(const void* fn, dim3 grid, const Params& p, cudaStream_t stream) {
  const size_t bytes = TILE_FLOATS * sizeof(float);
  cudaError_t err = prepare(fn, bytes);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<Params*>(&p)};
  return cudaLaunchKernel(fn, grid, dim3(NTHREADS), args, bytes, stream);
}

// the fp32 route's largest pass, in floats
inline size_t fma_smem_floats(int dh) {
  return smax(rfma::prep_smem_floats(dh), smax(k_smem_floats(dh), TILE_FLOATS));
}

// Five passes in stream order, each reading what the ones before it wrote:
// prep (A rows, Di), key side (dk, dv, dbias, dS^T), dA (dqu's first term,
// dpq over the A rows), dqu += dpq W^T with the ddelta partials, dW partials.
cudaError_t launch_fp32(const Params& p, int batch, int heads, cudaStream_t stream) {
  if (p.dh > rfma::MAX_DH || fma_smem_floats(p.dh) * sizeof(float) > MAX_SMEM) {
    return cudaErrorInvalidValue;
  }
  const rfma::PrepParams pp{p.qu, p.o, p.dout, p.delta, p.w, p.rowtab, p.atab, p.di,
                            p.n, p.dh, p.d2, p.qu_sb, p.qu_sh, p.qu_sn,
                            p.o_sb, p.o_sh, p.o_sn, p.do_sb, p.do_sh, p.do_sn};
  cudaError_t err = rfma::launch_prep(pp, batch, heads, stream);
  if (err != cudaSuccess) return err;
  switch (jd_for(k_group_width(p.dh))) {
    case 2: err = launch_k<2>(p, batch, heads, stream); break;
    case 4: err = launch_k<4>(p, batch, heads, stream); break;
    case 6: err = launch_k<6>(p, batch, heads, stream); break;
    default: err = launch_k<8>(p, batch, heads, stream); break;
  }
  if (err != cudaSuccess) return err;
  const int qtiles = (p.n + BQ - 1) / BQ, ctiles = (p.dh + 63) / 64;
  const int rtiles = (p.d2 / 2 + 31) / 32, bh = batch * heads;
  err = launch_tile(reinterpret_cast<const void*>(&relpos_bwd_da_kernel),
                    dim3(qtiles, ctiles + rtiles, bh), p, stream);
  if (err != cudaSuccess) return err;
  err = launch_tile(reinterpret_cast<const void*>(&relpos_bwd_dq_kernel),
                    dim3(qtiles, ctiles, bh), p, stream);
  if (err != cudaSuccess) return err;
  return launch_tile(reinterpret_cast<const void*>(&relpos_bwd_dw_kernel),
                     dim3(ctiles, (p.d2 + 63) / 64, bh), p, stream);
}

// the bf16 route's padded widths, and the padded head width its registers
// are sized for
inline int tc_dhp(int dh) { return tc::round16(dh); }
inline int tc_d2p(int d2) { return 2 * rtc::round8(d2 / 2); }
inline int tc_dmax(int dhp) { return dhp <= 64 ? 64 : dhp <= 96 ? 96 : 144; }
inline size_t tc_smem(int dhp, int d2p) {
  return smax(tc_prep_smem(dhp, d2p), smax(tc_k_smem(dhp, d2p), tc_q_smem(dhp, d2p)));
}

template <int DMAX>
cudaError_t launch_tc_d(const TcParams& p, int batch, int heads, cudaStream_t stream) {
  const int dhp = p.rt.dhp, d2p = 2 * p.rt.hdp;
  const dim3 qgrid((p.n + rtc::BQ - 1) / rtc::BQ, heads, batch);
  const dim3 kgrid((p.nk + TC_BK - 1) / TC_BK, heads, batch);
  // in stream order: prep writes [qu | A], dO and Di for the key side, which
  // writes dS^T for the query side
  size_t bytes = tc_prep_smem(dhp, d2p);
  cudaError_t err = prepare(reinterpret_cast<const void*>(&relpos_bwd_prep_tc_kernel<DMAX>), bytes);
  if (err != cudaSuccess) return err;
  relpos_bwd_prep_tc_kernel<DMAX><<<qgrid, rtc::THREADS, bytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bytes = tc_k_smem(dhp, d2p);
  if ((err = prepare(reinterpret_cast<const void*>(&relpos_bwd_k_tc_kernel<DMAX>), bytes)) !=
      cudaSuccess) {
    return err;
  }
  relpos_bwd_k_tc_kernel<DMAX><<<kgrid, rtc::THREADS, bytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bytes = tc_q_smem(dhp, d2p);
  if ((err = prepare(reinterpret_cast<const void*>(&relpos_bwd_q_tc_kernel<DMAX>), bytes)) !=
      cudaSuccess) {
    return err;
  }
  relpos_bwd_q_tc_kernel<DMAX><<<qgrid, rtc::THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const TcParams& p, int batch, int heads, cudaStream_t stream) {
  if (p.rt.dhp > 144 || tc_smem(p.rt.dhp, 2 * p.rt.hdp) > MAX_SMEM) return cudaErrorInvalidValue;
  switch (tc_dmax(p.rt.dhp)) {
    case 64: return launch_tc_d<64>(p, batch, heads, stream);
    case 96: return launch_tc_d<96>(p, batch, heads, stream);
    default: return launch_tc_d<144>(p, batch, heads, stream);
  }
}

}  // namespace

extern "C" {

// Shared memory the largest pass of the route for `dtype` (0 float32: the
// FMA kernels, 1 bfloat16: the tensor-core kernels) needs per block at head
// width dh and rel width d2, in bytes.
size_t ecf_relpos_attention_bwd_smem(int dtype, int dh, int d2) {
  if (dtype == 1) return tc_smem(tc_dhp(dh), tc_d2p(d2));
  return fma_smem_floats(dh) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16 for qu, k, v, o, dO and the token
// gradients. float32 takes delta, w, wt, rowtab and keytab in fp32 at widths
// dh and d2, dw_part (B, H, dh, d2), two fp32 scratch buffers, atab (B, H, N,
// d2) for the A rows and then dpq and ds (B, H, Nk, N) for dS^T, and no
// qa_do; bfloat16
// takes delta, w, rowtab and keytab in bf16, padded as relpos_tc.cuh
// describes (d2 the padded rel width; wt unused), dw_part and ddelta_part at
// the padded widths, and three bf16 scratch buffers: atab (B, H, np, dhp +
// d2) for the [qu | A] rows, qa_do (B, H, np, dhp) for the padded dO rows
// and ds (B, H, nkp, np) for dS^T, np and nkp being N and Nk rounded up to
// 64. Returns a cudaError_t.
int ecf_relpos_attention_bwd(
    int dtype, const void* qu, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, const void* delta, const void* w, const void* wt,
    const void* rowtab, const void* keytab, const float* bias, void* dqu, void* dk,
    void* dv, float* dw_part, float* ddelta_part, float* di, void* atab, void* qa_do, void* ds,
    float* dbias, int batch,
    int heads, int n, int nk, int dh, int d2, int64_t qu_sb, int64_t qu_sh, int64_t qu_sn,
    int64_t k_sb, int64_t k_sh, int64_t k_sn, int64_t v_sb, int64_t v_sh, int64_t v_sn,
    int64_t o_sb, int64_t o_sh, int64_t o_sn, int64_t do_sb, int64_t do_sh, int64_t do_sn,
    int64_t dqu_sb, int64_t dqu_sh, int64_t dqu_sn, int64_t dk_sb, int64_t dk_sh,
    int64_t dk_sn, int64_t dv_sb, int64_t dv_sh, int64_t dv_sn, int64_t bias_sb, float scale,
    void* stream) {
  if (n <= 0 || nk <= 0 || dh <= 0 || d2 <= 0 || d2 % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (atab == nullptr || ds == nullptr || wt == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto f = [](const void* x) { return static_cast<const float*>(x); };
    Params p{f(qu), f(k), f(v), f(o), f(dout), lse, f(delta), f(w), f(wt), f(rowtab), f(keytab),
             bias, static_cast<float*>(dqu), static_cast<float*>(dk), static_cast<float*>(dv),
             dw_part, ddelta_part, di, static_cast<float*>(atab), static_cast<float*>(ds), dbias,
             heads, n, nk, dh, d2,
             qu_sb, qu_sh, qu_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn,
             do_sb, do_sh, do_sn, dqu_sb, dqu_sh, dqu_sn, dk_sb, dk_sh, dk_sn,
             dv_sb, dv_sh, dv_sn, bias_sb, scale};
    return static_cast<int>(launch_fp32(p, batch, heads, s));
  }
  if (dtype != 1 || d2 % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  using tc::bf16;
  TcParams p{static_cast<const bf16*>(qu), static_cast<const bf16*>(k),
             static_cast<const bf16*>(v), static_cast<const bf16*>(o),
             static_cast<const bf16*>(dout), lse,
             {static_cast<const bf16*>(delta), static_cast<const bf16*>(w),
              static_cast<const bf16*>(rowtab), static_cast<const bf16*>(keytab), tc_dhp(dh),
              d2 / 2},
             bias, static_cast<bf16*>(dqu), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
             dw_part, ddelta_part, di, static_cast<bf16*>(atab), static_cast<bf16*>(qa_do),
             static_cast<bf16*>(ds), dbias, n, nk, dh, (n + 63) / 64 * 64, (nk + 63) / 64 * 64,
             qu_sb, qu_sh, qu_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn,
             do_sb, do_sh, do_sn, dqu_sb, dqu_sh, dqu_sn, dk_sb, dk_sh, dk_sn,
             dv_sb, dv_sh, dv_sn, bias_sb, scale,
             tc::copy_bytes(qu, qu_sb, qu_sh, qu_sn, dh), tc::copy_bytes(k, k_sb, k_sh, k_sn, dh),
             tc::copy_bytes(v, v_sb, v_sh, v_sn, dh), tc::copy_bytes(o, o_sb, o_sh, o_sn, dh),
             tc::copy_bytes(dout, do_sb, do_sh, do_sn, dh),
             tc::copy_bytes(dqu, dqu_sb, dqu_sh, dqu_sn, dh),
             tc::copy_bytes(dk, dk_sb, dk_sh, dk_sn, dh),
             tc::copy_bytes(dv, dv_sb, dv_sh, dv_sn, dh)};
  return static_cast<int>(launch_bf16(p, batch, heads, s));
}

const char* ecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
