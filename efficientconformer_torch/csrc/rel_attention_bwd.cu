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
// partial per (query tile, batch, head) and summed by the wrapper in a fixed
// order: no atomics, the gradients are the same from run to run. Rows past N
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
//   * fp32, relpos_bwd_{q,k}_kernel<float, J>: fp32 FMAs from shared memory
//     (TF32 products would miss the fp32 checks). The query-side pass forms
//     A, writes it and Di for the key side, and accumulates d[qu | A] in
//     registers; the key-side pass reads the A rows, recomputes the scores,
//     P and dS, and accumulates dv, dk and the dbias sums. Each thread owns
//     a 4 x 4 tile of scores; tiles read four rows at a time have a row
//     stride of 68 floats, tiles read one word at a time 65. It takes head
//     widths up to 128 and dh + 2hd up to 416 (214,896 bytes in the
//     query-side pass at the flagship's widest stage).
//
// Inputs: qu, k, v, o, dO (fp32 or bf16) with arbitrary batch/head/row
// strides and unit feature stride; lse (B, H, N) fp32; the fp32 route takes
// delta, w (H, dh, 2hd), wt = w^T per head, rowtab and keytab in fp32, the
// bf16 route delta, w, rowtab and keytab in bf16 at the padded widths, all
// contiguous; bias is fp32 (B or 1, Nk) with batch stride bias_sb. Outputs:
// dqu, dk, dv in the input type (strided); dw_part (B * ceil(N/64), H, dh,
// 2hd) and ddelta_part (B * ceil(N/64), H, dh) fp32, at the padded widths on
// the bf16 route; di (B, H, N) fp32 and the route's scratch (see
// ecf_relpos_attention_bwd); dbias (B, H, Nk) fp32, or null when not
// wanted. The kernels allocate nothing and do not synchronise; each pass
// reads what the one before it wrote, in stream order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "relpos_tc.cuh"

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 256;   // a 16 x 16 grid of threads, each a 4 x 4 tile
constexpr int LDV = 68;         // row stride of tiles read four rows at a time
constexpr int LDS = 65;         // row stride of tiles read one word at a time
constexpr size_t MAX_SMEM = 232448;  // 227 KB a block may use on sm_90

static_assert(NTHREADS == 16 * 16 && BQ == 4 * 16 && BK == 4 * 16, "thread grid");

// the FMA kernels' element type is float (bf16 takes the tensor cores)
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Params {
  const void* qu;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;     // (B, H, N)
  const float* delta;   // (H, dh)
  const float* w;       // (H, dh, d2)
  const float* wt;      // (H, d2, dh)
  const float* rowtab;  // (N, d2)  [sin | cos]
  const float* keytab;  // (Nk, d2) [cos | sin]
  const float* bias;    // (B or 1, Nk) or null
  void* dqu;
  void* dk;
  void* dv;
  float* dw_part;       // (B * tiles, H, dh, d2)
  float* ddelta_part;   // (B * tiles, H, dh)
  float* di;            // (B, H, N)
  float* atab;          // (B, H, N, d2): the A rows, from the query side to the key side
  float* dbias;         // (B, H, Nk) or null
  int n, nk, dh, d2;
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

// augmented-feature columns per thread in the query-side pass: da <= 16 * ja
__host__ __device__ inline int ja_for(int da) {
  return da <= 64 ? 4 : da <= 128 ? 8 : da <= 224 ? 14 : da <= 320 ? 20 : 26;
}
// head-width columns per thread in the key-side pass: dh <= 16 * jd
__host__ __device__ inline int jd_for(int dh) {
  return dh <= 32 ? 2 : dh <= 64 ? 4 : dh <= 96 ? 6 : 8;
}
__host__ __device__ inline size_t zmax(size_t a, size_t b) { return a > b ? a : b; }
// regions start at multiples of 4 floats, so float4 loads stay aligned
__host__ __device__ inline size_t r4(size_t floats) { return (floats + 3) & ~static_cast<size_t>(3); }

// the key-tile region of the query-side pass: [k | keytab]^T (16*ja rows of
// LDS), later dpq^T (d2 rows of LDV)
__host__ __device__ inline size_t q_key_region(int dh, int d2) {
  return zmax(static_cast<size_t>(16 * ja_for(dh + d2)) * LDS, static_cast<size_t>(d2) * LDV);
}

__host__ __device__ inline size_t q_smem_floats(int dh, int d2) {
  const size_t da = dh + d2;
  return da * LDV + dh * LDV + q_key_region(dh, d2) + r4(dh * LDS) + BK * LDV + 3 * BQ;
}

__host__ __device__ inline size_t k_smem_floats(int dh, int d2) {
  const size_t da = dh + d2, dhp = 16 * jd_for(dh);
  return da * LDV + dh * LDV + r4(zmax(da, dhp) * LDS) + dhp * LDS + BQ * LDV + 3 * BQ;
}

// The A rows of the query tile [q0, q0 + BQ): [P | Q] = (qu + delta) W_h,
// rotated by the row table, written after qu in qa (feature-major, row
// stride LDV). qu must be in qa and visible to all threads; ws is a free
// region of at least 32 x 128 floats. A register-tiled product: thread
// (ty, tx) forms rows tx + 16 i (i < 4) of columns ty + 16 m (m < 4) of both
// halves, 64 columns of each at a time, with W staged through ws 32 rows at
// a time, so each shared-memory load feeds 4 to 8 FMAs.
constexpr int WCHUNK = 32;
static_assert(WCHUNK * 128 <= BK * LDV, "the staged W chunk fits the dS tile's region");
__device__ __forceinline__ void build_a(float* qa, float* ws, const Params& p, int q0, int h) {
  const int dh = p.dh, d2 = p.d2, hd = d2 / 2;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* wh = p.w + static_cast<int64_t>(h) * dh * d2;
  const float* dl = p.delta + h * dh;
  for (int j0 = 0; j0 < hd; j0 += 64) {
    float pacc[4][4], qacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) pacc[i][m] = qacc[i][m] = 0.f;
    for (int d0 = 0; d0 < dh; d0 += WCHUNK) {
      const int dc = min(WCHUNK, dh - d0);
      __syncthreads();   // the previous chunk's readers are done
      for (int i = threadIdx.x; i < dc * 128; i += NTHREADS) {
        const int row = i / 128, c = i % 128;
        const int j = j0 + (c & 63);
        ws[i] = j < hd ? wh[(d0 + row) * d2 + (c < 64 ? j : hd + j)] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < dc; ++dd) {
        const int d = d0 + dd;
        const float dv = dl[d];
        float x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = qa[d * LDV + tx + 16 * i] + dv;
        const float* wrow = ws + dd * 128 + ty;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float wp = wrow[16 * m], wq = wrow[64 + 16 * m];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pacc[i][m] = fmaf(x[i], wp, pacc[i][m]);
            qacc[i][m] = fmaf(x[i], wq, qacc[i][m]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tx + 16 * i;
      const int qi = q0 + r;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = j0 + ty + 16 * m;
        if (j >= hd) continue;
        float a_even = 0.f, a_odd = 0.f;
        if (qi < p.n) {
          const float sn = p.rowtab[static_cast<int64_t>(qi) * d2 + j];
          const float cs = p.rowtab[static_cast<int64_t>(qi) * d2 + hd + j];
          a_even = sn * pacc[i][m] + cs * qacc[i][m];
          a_odd = sn * qacc[i][m] - cs * pacc[i][m];
        }
        qa[(dh + j) * LDV + r] = a_even;
        qa[(dh + hd + j) * LDV + r] = a_odd;
      }
    }
  }
}

// ------------------------------------------------------------ query side

template <typename T, int JA>
__global__ void __launch_bounds__(NTHREADS) relpos_bwd_q_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DAP = 16 * JA;      // padded augmented width (zero rows past da)
  const int dh = p.dh, d2 = p.d2, hd = d2 / 2, da = dh + d2;
  float* qaT = smem;                           // da x LDV: [qu | A]^T of the rows
  float* doT = qaT + da * LDV;                 // dh x LDV: dO^T of the rows
  float* kaT = doT + dh * LDV;                 // DAP x LDS: [k | keytab]^T of a key tile
  float* dpqT = kaT;                           // d2 x LDV: dA^T, then dpq^T (after the loop)
  float* vT = kaT + q_key_region(dh, d2);      // dh x LDS: V^T of the key tile
  float* dsT = vT + r4(dh * LDS);              // BK x LDV: dS of the tile, key-major
  float* lse_s = dsT + BK * LDV;
  float* di_s = lse_s + BQ;
  float* bias_s = di_s + BQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int qt = blockIdx.x, q0 = qt * BQ;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int64_t bh = static_cast<int64_t>(b) * heads + h;
  const T* qu = static_cast<const T*>(p.qu) + b * p.qu_sb + h * p.qu_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* op = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;

  // 1. qu and dO of the rows, feature-major (zero past N), and the LSE; a
  //    warp per row, a lane per feature
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BQ; r += NTHREADS / 32) {
    const int qi = q0 + r;
    const bool ok = qi < p.n;
    for (int d = lane; d < dh; d += 32) {
      qaT[d * LDV + r] = ok ? to_f32(qu[qi * p.qu_sn + d]) : 0.f;
      doT[d * LDV + r] = ok ? to_f32(dop[qi * p.do_sn + d]) : 0.f;
    }
  }
  if (tid < BQ) lse_s[tid] = q0 + tid < p.n ? p.lse[bh * p.n + q0 + tid] : 0.f;
  __syncthreads();

  // 2. the A rows, and Di = rowsum(dO * O) with four threads per row
  build_a(qaT, dsT, p, q0, h);
  {
    const int r = tid / 4, part = tid % 4;
    const int qi = q0 + r;
    float acc = 0.f;
    if (qi < p.n) {
      for (int d = part; d < dh; d += 4) {
        acc = fmaf(doT[d * LDV + r], to_f32(op[qi * p.o_sn + d]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      di_s[r] = acc;
      if (qi < p.n) p.di[bh * p.n + qi] = acc;
    }
  }
  __syncthreads();
  // the A rows for the key-side pass (a warp per row, a lane per feature)
  for (int r = warp; r < BQ && q0 + r < p.n; r += NTHREADS / 32) {
    float* arow = p.atab + (bh * p.n + q0 + r) * d2;
    for (int j = lane; j < d2; j += 32) arow[j] = qaT[(dh + j) * LDV + r];
  }

  // 3. over the key tiles: d[qu | A] += dS [k | keytab], in registers
  float acc[4][JA];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JA; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.nk; k0 += BK) {
    // the previous tile's readers finished at the loop's last barrier
    for (int c = warp; c < BK; c += NTHREADS / 32) {
      const int kj = k0 + c;
      const bool ok = kj < p.nk;
      for (int f = lane; f < DAP; f += 32) {
        float val = 0.f;
        if (ok && f < da) {
          val = f < dh ? to_f32(kp[kj * p.k_sn + f])
                       : p.keytab[static_cast<int64_t>(kj) * d2 + (f - dh)];
        }
        kaT[f * LDS + c] = val;
      }
      for (int d = lane; d < dh; d += 32) vT[d * LDS + c] = ok ? to_f32(vp[kj * p.v_sn + d]) : 0.f;
    }
    if (tid < BK) bias_s[tid] = (bias && k0 + tid < p.nk) ? bias[k0 + tid] : 0.f;
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[i][cc] = dp[i][cc] = 0.f;
#pragma unroll 4
    for (int f = 0; f < da; ++f) {
      const float4 a = *reinterpret_cast<const float4*>(qaT + f * LDV + ty * 4);
      const float* krow = kaT + f * LDS + tx;
      const float b0 = krow[0], b1 = krow[16], b2 = krow[32], b3 = krow[48];
      s[0][0] = fmaf(a.x, b0, s[0][0]); s[0][1] = fmaf(a.x, b1, s[0][1]);
      s[0][2] = fmaf(a.x, b2, s[0][2]); s[0][3] = fmaf(a.x, b3, s[0][3]);
      s[1][0] = fmaf(a.y, b0, s[1][0]); s[1][1] = fmaf(a.y, b1, s[1][1]);
      s[1][2] = fmaf(a.y, b2, s[1][2]); s[1][3] = fmaf(a.y, b3, s[1][3]);
      s[2][0] = fmaf(a.z, b0, s[2][0]); s[2][1] = fmaf(a.z, b1, s[2][1]);
      s[2][2] = fmaf(a.z, b2, s[2][2]); s[2][3] = fmaf(a.z, b3, s[2][3]);
      s[3][0] = fmaf(a.w, b0, s[3][0]); s[3][1] = fmaf(a.w, b1, s[3][1]);
      s[3][2] = fmaf(a.w, b2, s[3][2]); s[3][3] = fmaf(a.w, b3, s[3][3]);
    }
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(doT + d * LDV + ty * 4);
      const float* vrow = vT + d * LDS + tx;
      const float b0 = vrow[0], b1 = vrow[16], b2 = vrow[32], b3 = vrow[48];
      dp[0][0] = fmaf(a.x, b0, dp[0][0]); dp[0][1] = fmaf(a.x, b1, dp[0][1]);
      dp[0][2] = fmaf(a.x, b2, dp[0][2]); dp[0][3] = fmaf(a.x, b3, dp[0][3]);
      dp[1][0] = fmaf(a.y, b0, dp[1][0]); dp[1][1] = fmaf(a.y, b1, dp[1][1]);
      dp[1][2] = fmaf(a.y, b2, dp[1][2]); dp[1][3] = fmaf(a.y, b3, dp[1][3]);
      dp[2][0] = fmaf(a.z, b0, dp[2][0]); dp[2][1] = fmaf(a.z, b1, dp[2][1]);
      dp[2][2] = fmaf(a.z, b2, dp[2][2]); dp[2][3] = fmaf(a.z, b3, dp[2][3]);
      dp[3][0] = fmaf(a.w, b0, dp[3][0]); dp[3][1] = fmaf(a.w, b1, dp[3][1]);
      dp[3][2] = fmaf(a.w, b2, dp[3][2]); dp[3][3] = fmaf(a.w, b3, dp[3][3]);
    }

    // dS = P (dP - Di), P recomputed from the LSE; zero past N and Nk
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int c = tx + 16 * cc;
      const bool kvalid = k0 + c < p.nk;
      const float kb = bias_s[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const float pr = (kvalid && q0 + r < p.n) ? expf(s[i][cc] * p.scale + kb - lse_s[r]) : 0.f;
        s[i][cc] = pr * (dp[i][cc] - di_s[r]);
      }
      *reinterpret_cast<float4*>(dsT + c * LDV + ty * 4) =
          make_float4(s[0][cc], s[1][cc], s[2][cc], s[3][cc]);
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      const float4 g = *reinterpret_cast<const float4*>(dsT + c * LDV + ty * 4);
      const float* kcol = kaT + tx * LDS + c;
#pragma unroll
      for (int j = 0; j < JA; ++j) {
        const float kv = kcol[16 * j * LDS];
        acc[0][j] = fmaf(g.x, kv, acc[0][j]);
        acc[1][j] = fmaf(g.y, kv, acc[1][j]);
        acc[2][j] = fmaf(g.z, kv, acc[2][j]);
        acc[3][j] = fmaf(g.w, kv, acc[3][j]);
      }
    }
    __syncthreads();
  }

  // 4. scale; dA to shared memory (feature-major), then through the rotation
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JA; ++j) acc[i][j] *= p.scale;
#pragma unroll
  for (int j = 0; j < JA; ++j) {
    const int f = tx + 16 * j;
    if (f >= dh && f < da) {
      *reinterpret_cast<float4*>(dpqT + (f - dh) * LDV + ty * 4) =
          make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    }
  }
  __syncthreads();
  for (int i = tid; i < BQ * hd; i += NTHREADS) {
    const int r = i % BQ, j = i / BQ;
    const int qi = q0 + r;
    float sn = 0.f, cs = 0.f;
    if (qi < p.n) {
      sn = p.rowtab[static_cast<int64_t>(qi) * d2 + j];
      cs = p.rowtab[static_cast<int64_t>(qi) * d2 + hd + j];
    }
    const float e = dpqT[j * LDV + r], od = dpqT[(hd + j) * LDV + r];
    dpqT[j * LDV + r] = sn * e - cs * od;
    dpqT[(hd + j) * LDV + r] = cs * e + sn * od;
  }
  __syncthreads();

  // 5. dqu = scale dS k + dpq W^T, for the thread's rows and qu columns,
  //    with W^T staged through the dS tile's region, fc rows at a time
  const float* wt = p.wt + static_cast<int64_t>(h) * d2 * dh;
  float* ws = dsT;
  const int fc = min(d2, BK * LDV / dh);
  for (int f0 = 0; f0 < d2; f0 += fc) {
    const int nf = min(fc, d2 - f0);
    __syncthreads();   // the previous chunk's readers are done
    for (int i = tid; i < nf * dh; i += NTHREADS) ws[i] = wt[f0 * dh + i];
    __syncthreads();
#pragma unroll 2
    for (int ff = 0; ff < nf; ++ff) {
      const float4 g = *reinterpret_cast<const float4*>(dpqT + (f0 + ff) * LDV + ty * 4);
#pragma unroll
      for (int j = 0; j < JA; ++j) {
        if (16 * j < dh) {
          const int d = tx + 16 * j;
          const float wv = d < dh ? ws[ff * dh + d] : 0.f;
          acc[0][j] = fmaf(g.x, wv, acc[0][j]);
          acc[1][j] = fmaf(g.y, wv, acc[1][j]);
          acc[2][j] = fmaf(g.z, wv, acc[2][j]);
          acc[3][j] = fmaf(g.w, wv, acc[3][j]);
        }
      }
    }
  }
  T* dq = static_cast<T*>(p.dqu) + b * p.dqu_sb + h * p.dqu_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.n) continue;
#pragma unroll
    for (int j = 0; j < JA; ++j) {
      const int d = tx + 16 * j;
      if (d < dh) dq[qi * p.dqu_sn + d] = from_f32<T>(acc[i][j]);
    }
  }

  // 6. this block's partial dW = qv^T dpq (rows past N have dpq = 0)
  const int64_t part = (static_cast<int64_t>(b) * gridDim.x + qt) * heads + h;
  float* dwp = p.dw_part + part * dh * d2;
  const float* dl = p.delta + h * dh;
  for (int o = tid; o < dh * d2; o += NTHREADS) {
    const int d = o / d2, f = o - d * d2;
    const float dlv = dl[d];
    float sum = 0.f;
#pragma unroll 4
    for (int r = 0; r < BQ; r += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(qaT + d * LDV + r);
      const float4 g4 = *reinterpret_cast<const float4*>(dpqT + f * LDV + r);
      sum = fmaf(q4.x + dlv, g4.x, sum);
      sum = fmaf(q4.y + dlv, g4.y, sum);
      sum = fmaf(q4.z + dlv, g4.z, sum);
      sum = fmaf(q4.w + dlv, g4.w, sum);
    }
    dwp[o] = sum;
  }

  // 7. and its partial ddelta = (sum over rows of dpq) W^T
  float* colsum = dsT;
  __syncthreads();       // the staged W^T's readers are done
  for (int f = tid; f < d2; f += NTHREADS) {
    float sum = 0.f;
    for (int r = 0; r < BQ; ++r) sum += dpqT[f * LDV + r];
    colsum[f] = sum;
  }
  __syncthreads();
  for (int d = tid; d < dh; d += NTHREADS) {
    float sum = 0.f;
    for (int f = 0; f < d2; ++f) sum = fmaf(colsum[f], wt[f * dh + d], sum);
    p.ddelta_part[part * dh + d] = sum;
  }
}

// -------------------------------------------------------------- key side

template <typename T, int JD>
__global__ void __launch_bounds__(NTHREADS) relpos_bwd_k_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DHP = 16 * JD;      // padded head width (zero rows past dh)
  const int dh = p.dh, d2 = p.d2, da = dh + d2;
  const int qap = da > DHP ? da : DHP;
  float* kaT = smem;                 // da x LDV: [k | keytab]^T of the block's keys
  float* vT = kaT + da * LDV;        // dh x LDV: V^T of the keys
  float* qaT = vT + dh * LDV;        // qap x LDS: [qu | A]^T of a query tile
  float* doT = qaT + r4(qap * LDS);  // DHP x LDS: dO^T of the query tile
  float* pT = doT + DHP * LDS;       // BQ x LDV: P, then dS, of the tile, row-major
  float* lse_s = pT + BQ * LDV;
  float* di_s = lse_s + BQ;
  float* bias_s = di_s + BQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int64_t bh = static_cast<int64_t>(b) * heads + h;
  const T* qu = static_cast<const T*>(p.qu) + b * p.qu_sb + h * p.qu_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;

  // 1. the block's keys, V and key bias (a warp per key, a lane per
  //    feature); the padding rows of the query tiles
  const int warp = tid / 32, lane = tid % 32;
  for (int c = warp; c < BK; c += NTHREADS / 32) {
    const int kj = k0 + c;
    const bool ok = kj < p.nk;
    for (int f = lane; f < da; f += 32) {
      float val = 0.f;
      if (ok) {
        val = f < dh ? to_f32(kp[kj * p.k_sn + f])
                     : p.keytab[static_cast<int64_t>(kj) * d2 + (f - dh)];
      }
      kaT[f * LDV + c] = val;
    }
    for (int d = lane; d < dh; d += 32) vT[d * LDV + c] = ok ? to_f32(vp[kj * p.v_sn + d]) : 0.f;
  }
  if (tid < BK) bias_s[tid] = (bias && k0 + tid < p.nk) ? bias[k0 + tid] : 0.f;
  for (int i = tid; i < (DHP - dh) * BQ; i += NTHREADS) doT[(dh + i / BQ) * LDS + i % BQ] = 0.f;
  for (int i = tid; i < (qap - da) * BQ; i += NTHREADS) qaT[(da + i / BQ) * LDS + i % BQ] = 0.f;

  float dk[4][JD], dv[4][JD], db[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    db[i] = 0.f;
#pragma unroll
    for (int j = 0; j < JD; ++j) dk[i][j] = dv[i][j] = 0.f;
  }

  // 2. over the query tiles
  for (int q0 = 0; q0 < p.n; q0 += BQ) {
    // the previous tile's readers finished at the loop's last barrier
    for (int r = warp; r < BQ; r += NTHREADS / 32) {
      const int qi = q0 + r;
      const bool ok = qi < p.n;
      for (int d = lane; d < dh; d += 32) {
        qaT[d * LDS + r] = ok ? to_f32(qu[qi * p.qu_sn + d]) : 0.f;
        doT[d * LDS + r] = ok ? to_f32(dop[qi * p.do_sn + d]) : 0.f;
      }
      const float* arow = p.atab + (bh * p.n + qi) * d2;
      for (int j = lane; j < d2; j += 32) qaT[(dh + j) * LDS + r] = ok ? arow[j] : 0.f;
    }
    if (tid < BQ) {
      const int qi = q0 + tid;
      lse_s[tid] = qi < p.n ? p.lse[bh * p.n + qi] : 0.f;
      di_s[tid] = qi < p.n ? p.di[bh * p.n + qi] : 0.f;
    }
    __syncthreads();

    // scores and dP, transposed: s[i][cc] is key ty*4+i, row tx+16cc
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[i][cc] = dp[i][cc] = 0.f;
#pragma unroll 4
    for (int f = 0; f < da; ++f) {
      const float4 a = *reinterpret_cast<const float4*>(kaT + f * LDV + ty * 4);
      const float* qrow = qaT + f * LDS + tx;
      const float b0 = qrow[0], b1 = qrow[16], b2 = qrow[32], b3 = qrow[48];
      s[0][0] = fmaf(a.x, b0, s[0][0]); s[0][1] = fmaf(a.x, b1, s[0][1]);
      s[0][2] = fmaf(a.x, b2, s[0][2]); s[0][3] = fmaf(a.x, b3, s[0][3]);
      s[1][0] = fmaf(a.y, b0, s[1][0]); s[1][1] = fmaf(a.y, b1, s[1][1]);
      s[1][2] = fmaf(a.y, b2, s[1][2]); s[1][3] = fmaf(a.y, b3, s[1][3]);
      s[2][0] = fmaf(a.z, b0, s[2][0]); s[2][1] = fmaf(a.z, b1, s[2][1]);
      s[2][2] = fmaf(a.z, b2, s[2][2]); s[2][3] = fmaf(a.z, b3, s[2][3]);
      s[3][0] = fmaf(a.w, b0, s[3][0]); s[3][1] = fmaf(a.w, b1, s[3][1]);
      s[3][2] = fmaf(a.w, b2, s[3][2]); s[3][3] = fmaf(a.w, b3, s[3][3]);
    }
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(vT + d * LDV + ty * 4);
      const float* orow = doT + d * LDS + tx;
      const float b0 = orow[0], b1 = orow[16], b2 = orow[32], b3 = orow[48];
      dp[0][0] = fmaf(a.x, b0, dp[0][0]); dp[0][1] = fmaf(a.x, b1, dp[0][1]);
      dp[0][2] = fmaf(a.x, b2, dp[0][2]); dp[0][3] = fmaf(a.x, b3, dp[0][3]);
      dp[1][0] = fmaf(a.y, b0, dp[1][0]); dp[1][1] = fmaf(a.y, b1, dp[1][1]);
      dp[1][2] = fmaf(a.y, b2, dp[1][2]); dp[1][3] = fmaf(a.y, b3, dp[1][3]);
      dp[2][0] = fmaf(a.z, b0, dp[2][0]); dp[2][1] = fmaf(a.z, b1, dp[2][1]);
      dp[2][2] = fmaf(a.z, b2, dp[2][2]); dp[2][3] = fmaf(a.z, b3, dp[2][3]);
      dp[3][0] = fmaf(a.w, b0, dp[3][0]); dp[3][1] = fmaf(a.w, b1, dp[3][1]);
      dp[3][2] = fmaf(a.w, b2, dp[3][2]); dp[3][3] = fmaf(a.w, b3, dp[3][3]);
    }

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
      const float* qcol = qaT + tx * LDS + r;
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

  // 3. write dk, dv (input type) and the dbias column sums (fp32)
  T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    float colsum = db[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) colsum += __shfl_xor_sync(0xffffffffu, colsum, off);
    if (kj >= p.nk) continue;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int d = tx + 16 * j;
      if (d < dh) {
        dkp[kj * p.dk_sn + d] = from_f32<T>(dk[i][j] * p.scale);
        dvp[kj * p.dv_sn + d] = from_f32<T>(dv[i][j]);
      }
    }
    if (tx == 0 && p.dbias) p.dbias[bh * p.nk + kj] = colsum;
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

template <int JA>
cudaError_t launch_q(const Params& p, int batch, int heads, cudaStream_t stream) {
  const size_t bytes = q_smem_floats(p.dh, p.d2) * sizeof(float);
  cudaError_t err = prepare(reinterpret_cast<const void*>(&relpos_bwd_q_kernel<float, JA>), bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + BQ - 1) / BQ, heads, batch);
  relpos_bwd_q_kernel<float, JA><<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int JD>
cudaError_t launch_k(const Params& p, int batch, int heads, cudaStream_t stream) {
  const size_t bytes = k_smem_floats(p.dh, p.d2) * sizeof(float);
  cudaError_t err = prepare(reinterpret_cast<const void*>(&relpos_bwd_k_kernel<float, JD>), bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.nk + BK - 1) / BK, heads, batch);
  relpos_bwd_k_kernel<float, JD><<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_fp32(const Params& p, int batch, int heads, cudaStream_t stream) {
  const int da = p.dh + p.d2;
  if (p.dh > 128 || da > 16 * 26 || q_smem_floats(p.dh, p.d2) * sizeof(float) > MAX_SMEM ||
      k_smem_floats(p.dh, p.d2) * sizeof(float) > MAX_SMEM) {
    return cudaErrorInvalidValue;
  }
  // the key-side pass reads the Di that the query-side pass writes: same
  // stream, so in order
  cudaError_t err;
  switch (ja_for(da)) {
    case 4: err = launch_q<4>(p, batch, heads, stream); break;
    case 8: err = launch_q<8>(p, batch, heads, stream); break;
    case 14: err = launch_q<14>(p, batch, heads, stream); break;
    case 20: err = launch_q<20>(p, batch, heads, stream); break;
    default: err = launch_q<26>(p, batch, heads, stream); break;
  }
  if (err != cudaSuccess) return err;
  switch (jd_for(p.dh)) {
    case 2: return launch_k<2>(p, batch, heads, stream);
    case 4: return launch_k<4>(p, batch, heads, stream);
    case 6: return launch_k<6>(p, batch, heads, stream);
    default: return launch_k<8>(p, batch, heads, stream);
  }
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
  return zmax(q_smem_floats(dh, d2), k_smem_floats(dh, d2)) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16 for qu, k, v, o, dO and the token
// gradients. float32 takes delta, w, wt, rowtab and keytab in fp32 at widths
// dh and d2, atab as its fp32 scratch of A rows, and no qa_do or ds; bfloat16
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
    Params p{qu, k, v, o, dout, lse, static_cast<const float*>(delta),
             static_cast<const float*>(w), static_cast<const float*>(wt),
             static_cast<const float*>(rowtab), static_cast<const float*>(keytab), bias, dqu, dk,
             dv, dw_part, ddelta_part, di, static_cast<float*>(atab), dbias, n, nk, dh, d2,
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
