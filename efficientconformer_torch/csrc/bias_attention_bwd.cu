// Attention with an additive bias, backward pass, for sm_90a.
//
// Replaces the TPU kernels efficientconformer_tpu/ops/pallas_attention.py:
// _bwd_dq_kernel (:412) and _bwd_dkv_kernel (:446), launched by
// _flash_backward (:486), which the JAX package runs for a key-mask bias; for
// a full bias it computes dbias in XLA (_fused_bwd :137-164), which this
// kernel also gives. With the forward's S = q k^T * scale + bias, its LSE
// and O, and dO, it computes
//
//     P  = exp(S - LSE),  Di = rowsum(dO * O)   (= rowsum(P * dP) exactly)
//     dP = dO v^T,        dS = P * (dP - Di)
//     dq = scale dS k,    dk = scale dS^T q,    dv = P^T dO
//
// with S - LSE taken in fp64, as the forward keeps the LSE (in fp32 it would
// lose log(Nk) on a row whose keys all carry the -1e9 mask), and, when the
// bias requires a gradient, dS itself in fp32 into a (B, H, Nq, Nk) buffer,
// which the wrapper sums over the bias's broadcast axes. The plain PyTorch
// version is reference_bias_attention_bwd in ops/bias_attention.py.
//
// What bounds it on the H100: at the LM-Transformer's training shape (B 64,
// H 12, N 101, dh 64) it reads q, k, v, O and dO in bf16 (49.6 MB), the fp32
// bias and the fp64 LSE (31.9 MB), and writes dq, dk, dv in bf16 and dS in
// fp32 (29.8 + 31.3 MB): 142.7 MB, 0.0426 ms at 3.35 TB/s. The products are
// 2 x 64 x 12 x 101 x 101 x 320 = 5.0 GFLOP (8.1 padded to 128 rows and keys
// in one pass, 11 in two passes that recompute S and dP), 0.005-0.011 ms on
// the bf16 tensor cores. The bound is the bytes; dS alone is a fifth of them.
//
// No (N, Nk) tensor other than the requested dS reaches device memory, no
// atomics are used, and each output element is written by exactly one
// block, so the gradients are the same from run to run. Rows past Nq and
// keys past Nk get P = 0 from the kernels themselves. Three kernels, chosen
// by the inputs' type and size, never by a failure:
//
//   * bf16 with Nq, Nk <= 128 and dqk, dv <= 64 (the LM: N 101, dh 64),
//     bias_bwd_fused_tc_kernel: one block of eight warps per (head, batch)
//     holds all of q, k, v and dO in shared memory (114 KB, two blocks an
//     SM), so each product is formed once: 5 per tile pair, against 7 in
//     two passes that recompute S and dP, and the bias is read once. For
//     each chunk of 32 keys, each warp forms S and dP for 16 query rows, P
//     and dS, writes dS out and adds dS k to its dq; after a barrier each
//     warp forms a 16-key x 16-feature slab of dv = P^T dO and dk = dS^T q
//     over all query rows, complete, and writes it.
//   * other bf16 sizes, two passes as FlashAttention-2 splits its backward:
//     bias_bwd_q_tc_kernel, one block per (64 query rows, head, batch),
//     looping over key tiles: Di for its rows (written out for the other
//     pass), S and dP, dS (written out when asked for), dq += dS k in
//     registers; bias_bwd_k_tc_kernel, one block per (64 keys, head,
//     batch), looping over query tiles: it recomputes S^T and dP^T, forms
//     P^T and dS^T, and accumulates dv += P^T dO and dk += dS^T q. Its bias
//     tile is staged through shared memory with coalesced reads, since it
//     walks the bias by columns.
//   * fp32, the two passes bias_bwd_{q,k}_kernel<float, J>: fp32 FMAs from
//     shared memory (TF32 products would miss the fp32 checks, 1e-4, by an
//     order). Each thread owns a 4 x 4 tile of scores: one 16-byte and four
//     4-byte shared-memory loads per 16 FMAs. Tiles read four rows at a
//     time have a row stride of 68 floats (16-byte aligned), tiles read one
//     word at a time 65 (odd, so a half-warp's 16 neighbouring columns fall
//     in distinct banks).
//
// The tensor-core kernels run every product on mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate). q, k, v, O and dO stay bf16 in shared memory (rows
// padded by 8 elements for conflict-free ldmatrix), copied with 16-byte
// cp.async where every row is 16-byte aligned (the LM's rows are 1,536
// bytes apart) and element by element otherwise, zero-padded to a width of
// 16; the two passes double-buffer their streamed tiles. The fp32 bias comes
// in with 4-byte cp.async, a warp on 32 consecutive keys of a row (its rows
// are 404 bytes apart at Nk 101, so no wider copy is aligned). P and dS
// enter the products as bf16 fragments straight from the accumulators (the
// TPU kernels' own rounding: p.astype(do.dtype), ds.astype(k.dtype)); the dS
// written out stays fp32, from the fp32 P and dP, staged through shared
// memory so that each warp writes whole 128-byte runs of a row
// (fragment-layout stores would straddle the rows' sectors), and so are dq,
// dk and dv, written in 16-byte pieces. Measured on the H100 at the LM's
// shape (PERF.md): the one-pass kernel takes about 0.10 ms, the two passes
// 0.15 ms; the products' instruction overhead and latency, not the bytes,
// set the pace.
//
// Inputs: q, k, v, O, dO of type T (float for the FMA kernels, bf16 for the
// tensor-core ones) with arbitrary batch/head/row strides and unit feature
// stride; LSE (B, H, Nq) fp64; bias fp32 or bf16 with unit key stride and
// (batch, head, row) strides that are 0 along broadcast axes, or null.
// Outputs: dq, dk, dv of type T (strided); Di (B, H, Nq) fp32 scratch; dS
// (B, H, Nq, Nk) fp32, or null when not wanted. The kernels allocate nothing
// and do not synchronise; a key-side pass reads the Di its query-side pass
// wrote, in stream order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 256;   // a 16 x 16 grid of threads, each a 4 x 4 tile
constexpr int LDV = 68;         // row stride of tiles read four rows at a time
constexpr int LDS = 65;         // row stride of tiles read one word at a time
constexpr int MAX_WIDTH = 128;
constexpr size_t MAX_SMEM = 232448;  // 227 KB a block may use on sm_90

static_assert(NTHREADS == 16 * 16 && BQ == 4 * 16 && BK == 4 * 16, "thread grid");

// the FMA kernels' element type is float (bf16 takes the tensor cores)
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;     // fp32 or bf16, or null
  const void* o;
  const void* dout;
  const double* lse;    // (B, H, Nq)
  void* dq;
  void* dk;
  void* dv;
  float* di;            // (B, H, Nq)
  float* ds;            // (B, H, Nq, Nk) or null
  int nq, nk, dqk, dvw, bias_bf16;
  int64_t q_sb, q_sh, q_sn;
  int64_t k_sb, k_sh, k_sn;
  int64_t v_sb, v_sh, v_sn;
  int64_t o_sb, o_sh, o_sn;
  int64_t do_sb, do_sh, do_sn;
  int64_t dq_sb, dq_sh, dq_sn;
  int64_t dk_sb, dk_sh, dk_sn;
  int64_t dv_sb, dv_sh, dv_sn;
  int64_t bias_sb, bias_sh, bias_sn;
  float scale;
  bool q_vec, k_vec, v_vec, o_vec, do_vec, dq_vec, dk_vec, dv_vec;  // tc::vec16 of each
};

__device__ __forceinline__ float load_bias(const Params& p, int64_t off) {
  return p.bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[off])
                     : static_cast<const float*>(p.bias)[off];
}

// feature columns per thread: d <= 16 * j
__host__ __device__ inline int jmax_for(int d) {
  return d <= 32 ? 2 : d <= 64 ? 4 : d <= 96 ? 6 : 8;
}
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
// regions start at multiples of 4 floats, so float4 loads stay aligned
__host__ __device__ inline size_t r4(size_t floats) { return (floats + 3) & ~static_cast<size_t>(3); }

__host__ __device__ inline size_t q_smem_floats(int dqk, int dvw) {
  const size_t dqp = 16 * jmax_for(dqk);
  return static_cast<size_t>(dqk) * LDV + static_cast<size_t>(dvw) * LDV + r4(dqp * LDS) +
         r4(static_cast<size_t>(dvw) * LDS) + BK * LDV + 3 * BQ;
}

__host__ __device__ inline size_t k_smem_floats(int dqk, int dvw) {
  const size_t dp = 16 * jmax_for(imax(dqk, dvw));
  return static_cast<size_t>(dqk) * LDV + static_cast<size_t>(dvw) * LDV + 2 * r4(dp * LDS) +
         r4(static_cast<size_t>(BQ) * LDS) + BQ * LDV + 3 * BQ;
}

// ------------------------------------------------------------ query side

template <typename T, int JQ>
__global__ void __launch_bounds__(NTHREADS) bias_bwd_q_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DQP = 16 * JQ;      // padded dqk (zero rows past dqk)
  const int dqk = p.dqk, dvw = p.dvw;
  float* qT = smem;                              // dqk x LDV: q^T of the rows
  float* doT = qT + dqk * LDV;                   // dvw x LDV: dO^T of the rows
  float* kT = doT + dvw * LDV;                   // DQP x LDS: k^T of a key tile
  float* vT = kT + r4(static_cast<size_t>(DQP) * LDS);     // dvw x LDS: V^T of the tile
  float* dsT = vT + r4(static_cast<size_t>(dvw) * LDS);    // BK x LDV: dS of the tile, key-major
  double* lse_s = reinterpret_cast<double*>(dsT + BK * LDV);  // 8-byte aligned: offsets are 4k
  float* di_s = reinterpret_cast<float*>(lse_s + BQ);

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int64_t bh = static_cast<int64_t>(b) * heads + h;
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* op = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t bias_bh = b * p.bias_sb + h * p.bias_sh;

  // 1. q and dO of the rows, feature-major (zero past Nq), and the LSE; a
  //    warp per row, a lane per feature
  for (int r = warp; r < BQ; r += NTHREADS / 32) {
    const int qi = q0 + r;
    const bool ok = qi < p.nq;
    for (int d = lane; d < dqk; d += 32) qT[d * LDV + r] = ok ? to_f32(qp[qi * p.q_sn + d]) : 0.f;
    for (int d = lane; d < dvw; d += 32) {
      doT[d * LDV + r] = ok ? to_f32(dop[qi * p.do_sn + d]) : 0.f;
    }
  }
  if (tid < BQ) lse_s[tid] = q0 + tid < p.nq ? p.lse[bh * p.nq + q0 + tid] : 0.0;
  __syncthreads();

  // 2. Di = rowsum(dO * O), four threads per row
  {
    const int r = tid / 4, part = tid % 4;
    const int qi = q0 + r;
    float acc = 0.f;
    if (qi < p.nq) {
      for (int d = part; d < dvw; d += 4) {
        acc = fmaf(doT[d * LDV + r], to_f32(op[qi * p.o_sn + d]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      di_s[r] = acc;
      if (qi < p.nq) p.di[bh * p.nq + qi] = acc;
    }
  }

  // 3. over the key tiles: dq += dS k, in registers
  float acc[4][JQ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JQ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.nk; k0 += BK) {
    // the previous tile's readers finished at the loop's last barrier
    for (int c = warp; c < BK; c += NTHREADS / 32) {
      const int kj = k0 + c;
      const bool ok = kj < p.nk;
      for (int f = lane; f < DQP; f += 32) {
        kT[f * LDS + c] = (ok && f < dqk) ? to_f32(kp[kj * p.k_sn + f]) : 0.f;
      }
      for (int d = lane; d < dvw; d += 32) vT[d * LDS + c] = ok ? to_f32(vp[kj * p.v_sn + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[i][cc] = dp[i][cc] = 0.f;
#pragma unroll 4
    for (int f = 0; f < dqk; ++f) {
      const float4 a = *reinterpret_cast<const float4*>(qT + f * LDV + ty * 4);
      const float* krow = kT + f * LDS + tx;
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
    for (int d = 0; d < dvw; ++d) {
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

    // dS = P (dP - Di), P recomputed from the LSE; zero past Nq and Nk. The
    // bias is read straight from device memory: 16 neighbouring threads read
    // 16 neighbouring keys of a row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qi = q0 + r;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int kj = k0 + tx + 16 * cc;
        float g = 0.f;
        if (qi < p.nq && kj < p.nk) {
          const float bv = p.bias ? load_bias(p, bias_bh + qi * p.bias_sn + kj) : 0.f;
          const float pr = expf(static_cast<float>(
              static_cast<double>(s[i][cc] * p.scale + bv) - lse_s[r]));
          g = pr * (dp[i][cc] - di_s[r]);
          if (p.ds) p.ds[(bh * p.nq + qi) * p.nk + kj] = g;
        }
        s[i][cc] = g;
      }
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      *reinterpret_cast<float4*>(dsT + (tx + 16 * cc) * LDV + ty * 4) =
          make_float4(s[0][cc], s[1][cc], s[2][cc], s[3][cc]);
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      const float4 g = *reinterpret_cast<const float4*>(dsT + c * LDV + ty * 4);
      const float* kcol = kT + tx * LDS + c;
#pragma unroll
      for (int j = 0; j < JQ; ++j) {
        const float kv = kcol[16 * j * LDS];
        acc[0][j] = fmaf(g.x, kv, acc[0][j]);
        acc[1][j] = fmaf(g.y, kv, acc[1][j]);
        acc[2][j] = fmaf(g.z, kv, acc[2][j]);
        acc[3][j] = fmaf(g.w, kv, acc[3][j]);
      }
    }
    __syncthreads();
  }

  // 4. write dq = scale dS k (input type)
  T* dq = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.nq) continue;
#pragma unroll
    for (int j = 0; j < JQ; ++j) {
      const int d = tx + 16 * j;
      if (d < dqk) dq[qi * p.dq_sn + d] = from_f32<T>(acc[i][j] * p.scale);
    }
  }
}

// -------------------------------------------------------------- key side

template <typename T, int JD>
__global__ void __launch_bounds__(NTHREADS) bias_bwd_k_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DP = 16 * JD;       // padded max(dqk, dv) (zero rows past each)
  const int dqk = p.dqk, dvw = p.dvw;
  float* kT = smem;                              // dqk x LDV: k^T of the block's keys
  float* vT = kT + dqk * LDV;                    // dvw x LDV: V^T of the keys
  float* qT = vT + dvw * LDV;                    // DP x LDS: q^T of a query tile
  float* doT = qT + r4(static_cast<size_t>(DP) * LDS);     // DP x LDS: dO^T of the tile
  float* bias_s = doT + r4(static_cast<size_t>(DP) * LDS); // BQ x LDS: the bias tile, row-major
  float* pT = bias_s + r4(static_cast<size_t>(BQ) * LDS);  // BQ x LDV: P, then dS, row-major
  double* lse_s = reinterpret_cast<double*>(pT + BQ * LDV);   // 8-byte aligned: offsets are 4k
  float* di_s = reinterpret_cast<float*>(lse_s + BQ);

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int64_t bh = static_cast<int64_t>(b) * heads + h;
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t bias_bh = b * p.bias_sb + h * p.bias_sh;

  // 1. the block's keys and values (a warp per key, a lane per feature); the
  //    padding rows of the query tiles
  for (int c = warp; c < BK; c += NTHREADS / 32) {
    const int kj = k0 + c;
    const bool ok = kj < p.nk;
    for (int f = lane; f < dqk; f += 32) kT[f * LDV + c] = ok ? to_f32(kp[kj * p.k_sn + f]) : 0.f;
    for (int d = lane; d < dvw; d += 32) vT[d * LDV + c] = ok ? to_f32(vp[kj * p.v_sn + d]) : 0.f;
  }
  for (int i = tid; i < (DP - dqk) * BQ; i += NTHREADS) qT[(dqk + i / BQ) * LDS + i % BQ] = 0.f;
  for (int i = tid; i < (DP - dvw) * BQ; i += NTHREADS) doT[(dvw + i / BQ) * LDS + i % BQ] = 0.f;

  float dk[4][JD], dv[4][JD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) dk[i][j] = dv[i][j] = 0.f;

  // 2. over the query tiles
  for (int q0 = 0; q0 < p.nq; q0 += BQ) {
    // the previous tile's readers finished at the loop's last barrier
    for (int r = warp; r < BQ; r += NTHREADS / 32) {
      const int qi = q0 + r;
      const bool ok = qi < p.nq;
      for (int d = lane; d < dqk; d += 32) qT[d * LDS + r] = ok ? to_f32(qp[qi * p.q_sn + d]) : 0.f;
      for (int d = lane; d < dvw; d += 32) {
        doT[d * LDS + r] = ok ? to_f32(dop[qi * p.do_sn + d]) : 0.f;
      }
    }
    // the bias tile, a warp per row, lanes along the keys (coalesced)
    for (int i = tid; i < BQ * BK; i += NTHREADS) {
      const int r = i / BK, c = i % BK;
      const int qi = q0 + r, kj = k0 + c;
      bias_s[r * LDS + c] = (p.bias && qi < p.nq && kj < p.nk)
                                ? load_bias(p, bias_bh + qi * p.bias_sn + kj) : 0.f;
    }
    if (tid < BQ) {
      const int qi = q0 + tid;
      lse_s[tid] = qi < p.nq ? p.lse[bh * p.nq + qi] : 0.0;
      di_s[tid] = qi < p.nq ? p.di[bh * p.nq + qi] : 0.f;
    }
    __syncthreads();

    // scores and dP, transposed: s[i][cc] is key ty*4+i, row tx+16cc
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[i][cc] = dp[i][cc] = 0.f;
#pragma unroll 4
    for (int f = 0; f < dqk; ++f) {
      const float4 a = *reinterpret_cast<const float4*>(kT + f * LDV + ty * 4);
      const float* qrow = qT + f * LDS + tx;
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
    for (int d = 0; d < dvw; ++d) {
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

    // P (kept in s) and dS (in dp); zero past Nq and Nk
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ty * 4 + i;
      const bool kvalid = k0 + c < p.nk;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int r = tx + 16 * cc;
        const float pr = (kvalid && q0 + r < p.nq)
                             ? expf(static_cast<float>(static_cast<double>(
                                   s[i][cc] * p.scale + bias_s[r * LDS + c]) - lse_s[r]))
                             : 0.f;
        s[i][cc] = pr;
        dp[i][cc] = pr * (dp[i][cc] - di_s[r]);
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
    // dk += dS^T q (scaled at the end)
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      const float4 g = *reinterpret_cast<const float4*>(pT + r * LDV + ty * 4);
      const float* qcol = qT + tx * LDS + r;
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

  // 3. write dk and dv (input type)
  T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj >= p.nk) continue;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int d = tx + 16 * j;
      if (d < dqk) dkp[kj * p.dk_sn + d] = from_f32<T>(dk[i][j] * p.scale);
      if (d < dvw) dvp[kj * p.dv_sn + d] = from_f32<T>(dv[i][j]);
    }
  }
}

// ------------------------------------------------ bf16: the tensor cores

constexpr int TC_THREADS = 128;        // four warps, 16 rows (or keys) each
constexpr int TC_BLOCK = 64;           // query rows (query side) or keys (key side) a block owns
constexpr int TC_TILE = 32;            // keys (query side) or query rows (key side) a tile streams
constexpr int TC_STAGES = 2;           // streamed tiles in the ring of shared-memory stages
constexpr int TC_LDQ = TC_TILE + 8;    // query side's bias / dS tile [64 rows][32 keys], floats:
                                       // a half-warp's 8-byte fragment accesses hit 32 banks
constexpr int TC_LDK = TC_BLOCK + 4;   // key side's bias tile [32 rows][64 keys], floats: a
                                       // warp's transposed fragment reads hit 32 banks

// bytes of shared memory at padded width dmax. Query side: q and dO of the
// rows, the stages of (k, v) tiles (O sits in the last until Di is formed)
// and of the fp32 bias tile. Key side: k and v of the keys, the stages of
// (q, dO) tiles, of the fp32 bias tile, of the LSE (fp64) and of Di.
__host__ __device__ constexpr size_t tc_q_smem_bytes(int dmax) {
  return (2 + TC_STAGES) * static_cast<size_t>(TC_BLOCK) * (dmax + 8) * sizeof(__nv_bfloat16) +
         TC_STAGES * static_cast<size_t>(TC_BLOCK) * TC_LDQ * sizeof(float);
}
__host__ __device__ constexpr size_t tc_k_smem_bytes(int dmax) {
  return (2 + TC_STAGES) * static_cast<size_t>(TC_BLOCK) * (dmax + 8) * sizeof(__nv_bfloat16) +
         TC_STAGES * static_cast<size_t>(TC_TILE) *
             (TC_LDK * sizeof(float) + sizeof(double) + sizeof(float));
}

// DMAX: the padded head width the registers are sized for (64 or 128); the
// loops over features stop at the real widths rounded up to 16.
template <int DMAX>
__global__ void __launch_bounds__(TC_THREADS) bias_bwd_q_tc_kernel(Params p) {
  using tc::bf16;
  constexpr int LD = DMAX + 8, NT = TC_TILE / 8, DK = DMAX / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);       // [64][LD]
  bf16* dos = qs + TC_BLOCK * LD;                      // [64][LD]
  bf16* kv = dos + TC_BLOCK * LD;                      // [TC_STAGES][k [32][LD], v [32][LD]]
  float* bs = reinterpret_cast<float*>(kv + TC_STAGES * TC_BLOCK * LD);  // [TC_STAGES][64][TC_LDQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int q0 = blockIdx.x * TC_BLOCK;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int64_t bh = static_cast<int64_t>(b) * heads + h;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* op = static_cast<const bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const bf16* dop = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t bias_bh = b * p.bias_sb + h * p.bias_sh;
  const int kq = tc::round16(p.dqk) >> 4, kv_steps = tc::round16(p.dvw) >> 4;
  const int ntiles = (p.nk + TC_TILE - 1) / TC_TILE;

  auto load_keys = [&](int t) {
    const int buf = t % TC_STAGES;
    bf16* st = kv + buf * 2 * TC_TILE * LD;
    tc::load_tile<TC_TILE, LD, DMAX, TC_THREADS>(st, kp, p.k_sn, t * TC_TILE, p.nk, p.dqk, p.k_vec);
    tc::load_tile<TC_TILE, LD, DMAX, TC_THREADS>(st + TC_TILE * LD, vp, p.v_sn, t * TC_TILE, p.nk,
                                           p.dvw, p.v_vec);
    if (p.bias) {
      tc::load_bias_tile<TC_BLOCK, TC_TILE, TC_LDQ, TC_THREADS>(
          bs + buf * TC_BLOCK * TC_LDQ, p.bias, p.bias_bf16, bias_bh, p.bias_sn, q0,
          t * TC_TILE, p.nq, p.nk);
    }
  };

  // 1. q, dO and O of the rows (O in the last stage, free until the loop
  //    starts), then the key tiles up to one short of the ring
  bf16* os = kv + (TC_STAGES - 1) * 2 * TC_TILE * LD;
  tc::load_tile<TC_BLOCK, LD, DMAX, TC_THREADS>(qs, qp, p.q_sn, q0, p.nq, p.dqk, p.q_vec);
  tc::load_tile<TC_BLOCK, LD, DMAX, TC_THREADS>(dos, dop, p.do_sn, q0, p.nq, p.dvw, p.do_vec);
  tc::load_tile<TC_BLOCK, LD, DMAX, TC_THREADS>(os, op, p.o_sn, q0, p.nq, p.dvw, p.o_vec);
  tc::cp_async_commit();
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < ntiles) load_keys(st);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<TC_STAGES - 1>();
  __syncthreads();

  // 2. Di = rowsum(dO * O), two lanes a row of the warp's 16 (written out for
  //    the key side); this thread's rows are r0 and r0 + 8, with their LSE
  const int r0 = warp * 16 + g;
  float di[2];
  double lse[2];
  {
    const int rr = warp * 16 + (lane >> 1);
    const __nv_bfloat162* do_row = reinterpret_cast<const __nv_bfloat162*>(dos + rr * LD);
    const __nv_bfloat162* o_row = reinterpret_cast<const __nv_bfloat162*>(os + rr * LD);
    float acc = 0.f;
    for (int col = 2 * (lane & 1); col < tc::round16(p.dvw); col += 4) {
      const float2 a = __bfloat1622float2(do_row[col / 2]);
      const float2 o = __bfloat1622float2(o_row[col / 2]);
      acc = fmaf(a.x, o.x, fmaf(a.y, o.y, acc));
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0 && q0 + rr < p.nq) p.di[bh * p.nq + q0 + rr] = acc;
    di[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
    di[1] = __shfl_sync(0xffffffffu, acc, 2 * (g + 8));
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = q0 + r0 + 8 * hr;
      lse[hr] = qi < p.nq ? p.lse[bh * p.nq + qi] : 0.0;
    }
  }

  // 3. over the key tiles: dq += dS k, in registers
  float dq[2 * DK][4];
#pragma unroll
  for (int j = 0; j < 2 * DK; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  // this lane's ldmatrix addresses: the warp's q and dO rows, the first
  // stage's k and v
  constexpr uint32_t STAGE = 2 * TC_TILE * LD * 2;   // bytes of a (k, v) stage
  const uint32_t q_a = tc::a_lane<LD>(qs + warp * 16 * LD, lane);
  const uint32_t do_a = tc::a_lane<LD>(dos + warp * 16 * LD, lane);
  const uint32_t k_b = tc::b_lane<LD>(kv, lane), k_bt = tc::bt_lane<LD>(kv, lane);
  const uint32_t v_b = tc::b_lane<LD>(kv + TC_TILE * LD, lane);

  for (int t = 0; t < ntiles; ++t) {
    tc::cp_async_wait<TC_STAGES - 2>();
    __syncthreads();   // tile t landed for every thread; tile t - 1's stage (O's, at t = 0) is free
    if (t + TC_STAGES - 1 < ntiles) load_keys(t + TC_STAGES - 1);
    tc::cp_async_commit();
    const int buf = t % TC_STAGES;
    const uint32_t st = buf * STAGE;
    float* bt = bs + buf * TC_BLOCK * TC_LDQ;

    // S = q k^T and dP = dO v^T, 16 rows x 32 keys a warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      if (kk < kq) {
        uint32_t a[4];
        tc::ldsm_x4(a, q_a + tc::blk<LD>(0, kk));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          tc::ldsm_x4(bf, k_b + st + tc::blk<LD>(np, kk));
          tc::mma_bf16(s[2 * np], a, bf[0], bf[1]);
          tc::mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
        }
      }
      if (kk < kv_steps) {
        uint32_t a[4];
        tc::ldsm_x4(a, do_a + tc::blk<LD>(0, kk));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          tc::ldsm_x4(bf, v_b + st + tc::blk<LD>(np, kk));
          tc::mma_bf16(dp[2 * np], a, bf[0], bf[1]);
          tc::mma_bf16(dp[2 * np + 1], a, bf[2], bf[3]);
        }
      }
    }

    // dS = P (dP - Di), P from the LSE with S - LSE in fp64; zero past Nq
    // and Nk. dS (fp32) replaces the bias in the tile the thread read it from.
    const int k0 = t * TC_TILE;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + 8 * hr, col = j * 8 + 2 * c;
        float* slot = bt + row * TC_LDQ + col;
        const float2 bv = p.bias ? *reinterpret_cast<const float2*>(slot) : make_float2(0.f, 0.f);
        const bool row_ok = q0 + row < p.nq;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * hr + e] * p.scale + (e ? bv.y : bv.x);
          const float pr = row_ok && k0 + col + e < p.nk
                               ? __expf(static_cast<float>(static_cast<double>(x) - lse[hr]))
                               : 0.f;
          s[j][2 * hr + e] = pr * (dp[j][2 * hr + e] - di[hr]);
        }
        if (p.ds) *reinterpret_cast<float2*>(slot) = make_float2(s[j][2 * hr], s[j][2 * hr + 1]);
      }
    }
    if (p.ds) {   // the warp's 16 rows, a lane a key: whole 128-byte runs
      __syncwarp();
#pragma unroll 4
      for (int rr = 0; rr < 16; ++rr) {
        const int row = warp * 16 + rr, qi = q0 + row, kj = k0 + lane;
        if (qi < p.nq && kj < p.nk) p.ds[(bh * p.nq + qi) * p.nk + kj] = bt[row * TC_LDQ + lane];
      }
    }

    // dq += dS k, dS as bf16 A fragments straight from the registers
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
      tc::acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < DK; ++n2) {
        if (n2 < kq) {
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, k_bt + st + tc::blk<LD>(kk, n2));
          tc::mma_bf16(dq[2 * n2], a, bf[0], bf[1]);
          tc::mma_bf16(dq[2 * n2 + 1], a, bf[2], bf[3]);
        }
      }
    }
  }

  // 4. dq = scale dS k through the warp's own rows of the q tile
  bf16* stage = qs + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < 2 * DK; ++j) {
    if (j < 2 * kq) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8 * hr) * LD + j * 8 + 2 * c) =
            __floats2bfloat162_rn(dq[j][2 * hr] * p.scale, dq[j][2 * hr + 1] * p.scale);
      }
    }
  }
  __syncwarp();
  tc::store_rows<LD>(static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh, p.dq_sn, stage, 16,
                     q0 + warp * 16, p.nq, p.dqk, p.dq_vec, lane, 32);
}

template <int DMAX>
__global__ void __launch_bounds__(TC_THREADS) bias_bwd_k_tc_kernel(Params p) {
  using tc::bf16;
  constexpr int LD = DMAX + 8, NT = TC_TILE / 8, DK = DMAX / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);        // [64][LD]
  bf16* vs = ks + TC_BLOCK * LD;                        // [64][LD]
  bf16* qd = vs + TC_BLOCK * LD;                        // [TC_STAGES][q [32][LD], dO [32][LD]]
  float* bs = reinterpret_cast<float*>(qd + TC_STAGES * TC_BLOCK * LD);   // [TC_STAGES][32][TC_LDK]
  double* lse_s = reinterpret_cast<double*>(bs + TC_STAGES * TC_TILE * TC_LDK);  // [TC_STAGES][32]
  float* di_s = reinterpret_cast<float*>(lse_s + TC_STAGES * TC_TILE);            // [TC_STAGES][32]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int k0 = blockIdx.x * TC_BLOCK;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int64_t bh = static_cast<int64_t>(b) * heads + h;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dop = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t bias_bh = b * p.bias_sb + h * p.bias_sh;
  const int kq = tc::round16(p.dqk) >> 4, kv_steps = tc::round16(p.dvw) >> 4;
  const int ntiles = (p.nq + TC_TILE - 1) / TC_TILE;

  auto load_rows = [&](int t) {
    const int buf = t % TC_STAGES, r0 = t * TC_TILE;
    bf16* st = qd + buf * 2 * TC_TILE * LD;
    tc::load_tile<TC_TILE, LD, DMAX, TC_THREADS>(st, qp, p.q_sn, r0, p.nq, p.dqk, p.q_vec);
    tc::load_tile<TC_TILE, LD, DMAX, TC_THREADS>(st + TC_TILE * LD, dop, p.do_sn, r0, p.nq, p.dvw,
                                           p.do_vec);
    if (p.bias) {
      tc::load_bias_tile<TC_TILE, TC_BLOCK, TC_LDK, TC_THREADS>(
          bs + buf * TC_TILE * TC_LDK, p.bias, p.bias_bf16, bias_bh, p.bias_sn, r0, k0, p.nq,
          p.nk);
    }
    if (tid < TC_TILE) {
      const bool ok = r0 + tid < p.nq;
      tc::cp_async8(lse_s + buf * TC_TILE + tid, ok ? p.lse + bh * p.nq + r0 + tid : p.lse, ok);
    } else if (tid < 2 * TC_TILE) {
      const int i = tid - TC_TILE;
      const bool ok = r0 + i < p.nq;
      tc::cp_async4(di_s + buf * TC_TILE + i, ok ? p.di + bh * p.nq + r0 + i : p.di, ok);
    }
  };

  // 1. the block's keys and values, with query tile 0; then the next tiles
  //    up to one short of the ring
  tc::load_tile<TC_BLOCK, LD, DMAX, TC_THREADS>(ks, kp, p.k_sn, k0, p.nk, p.dqk, p.k_vec);
  tc::load_tile<TC_BLOCK, LD, DMAX, TC_THREADS>(vs, vp, p.v_sn, k0, p.nk, p.dvw, p.v_vec);
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < ntiles) load_rows(st);
    tc::cp_async_commit();
  }

  float dk[2 * DK][4], dv[2 * DK][4];
#pragma unroll
  for (int j = 0; j < 2 * DK; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }
  const int c0 = warp * 16 + g;   // this thread's keys c0 and c0 + 8 of the block
  // this lane's ldmatrix addresses: the warp's k and v rows, the first
  // stage's q and dO
  constexpr uint32_t STAGE = 2 * TC_TILE * LD * 2;   // bytes of a (q, dO) stage
  const uint32_t k_a = tc::a_lane<LD>(ks + warp * 16 * LD, lane);
  const uint32_t v_a = tc::a_lane<LD>(vs + warp * 16 * LD, lane);
  const uint32_t q_b = tc::b_lane<LD>(qd, lane), q_bt = tc::bt_lane<LD>(qd, lane);
  const uint32_t do_b = tc::b_lane<LD>(qd + TC_TILE * LD, lane);
  const uint32_t do_bt = tc::bt_lane<LD>(qd + TC_TILE * LD, lane);

  // 2. over the query tiles, transposed: rows are keys, columns query rows
  for (int t = 0; t < ntiles; ++t) {
    tc::cp_async_wait<TC_STAGES - 2>();
    __syncthreads();   // tile t landed for every thread; tile t - 1's stage is free
    if (t + TC_STAGES - 1 < ntiles) load_rows(t + TC_STAGES - 1);
    tc::cp_async_commit();
    const int buf = t % TC_STAGES;
    const uint32_t st = buf * STAGE;
    const float* bt = bs + buf * TC_TILE * TC_LDK;
    const double* ls = lse_s + buf * TC_TILE;
    const float* dis = di_s + buf * TC_TILE;

    // S^T = k q^T and dP^T = v dO^T, 16 keys x 32 rows a warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      if (kk < kq) {
        uint32_t a[4];
        tc::ldsm_x4(a, k_a + tc::blk<LD>(0, kk));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          tc::ldsm_x4(bf, q_b + st + tc::blk<LD>(np, kk));
          tc::mma_bf16(s[2 * np], a, bf[0], bf[1]);
          tc::mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
        }
      }
      if (kk < kv_steps) {
        uint32_t a[4];
        tc::ldsm_x4(a, v_a + tc::blk<LD>(0, kk));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          tc::ldsm_x4(bf, do_b + st + tc::blk<LD>(np, kk));
          tc::mma_bf16(dp[2 * np], a, bf[0], bf[1]);
          tc::mma_bf16(dp[2 * np + 1], a, bf[2], bf[3]);
        }
      }
    }

    // P^T (in s) and dS^T (in dp); zero past Nq and Nk
    const int r0 = t * TC_TILE;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + 8 * (e >> 1), row = j * 8 + 2 * c + (e & 1);
        const float x = s[j][e] * p.scale + (p.bias ? bt[row * TC_LDK + key] : 0.f);
        const float pr = k0 + key < p.nk && r0 + row < p.nq
                             ? __expf(static_cast<float>(static_cast<double>(x) - ls[row]))
                             : 0.f;
        s[j][e] = pr;
        dp[j][e] = pr * (dp[j][e] - dis[row]);
      }
    }

    // dv += P^T dO and dk += dS^T q, P^T and dS^T as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
      tc::acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < DK; ++n2) {
        if (n2 < kv_steps) {
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, do_bt + st + tc::blk<LD>(kk, n2));
          tc::mma_bf16(dv[2 * n2], a, bf[0], bf[1]);
          tc::mma_bf16(dv[2 * n2 + 1], a, bf[2], bf[3]);
        }
      }
      tc::acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < DK; ++n2) {
        if (n2 < kq) {
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, q_bt + st + tc::blk<LD>(kk, n2));
          tc::mma_bf16(dk[2 * n2], a, bf[0], bf[1]);
          tc::mma_bf16(dk[2 * n2 + 1], a, bf[2], bf[3]);
        }
      }
    }
  }

  // 3. dk (scaled) and dv through the warp's own rows of the k and v tiles
  bf16* kst = ks + warp * 16 * LD;
  bf16* vst = vs + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < 2 * DK; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int off = (g + 8 * hr) * LD + j * 8 + 2 * c;
      if (j < 2 * kq) {
        *reinterpret_cast<__nv_bfloat162*>(kst + off) =
            __floats2bfloat162_rn(dk[j][2 * hr] * p.scale, dk[j][2 * hr + 1] * p.scale);
      }
      if (j < 2 * kv_steps) {
        *reinterpret_cast<__nv_bfloat162*>(vst + off) =
            __floats2bfloat162_rn(dv[j][2 * hr], dv[j][2 * hr + 1]);
      }
    }
  }
  __syncwarp();
  tc::store_rows<LD>(static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh, p.dk_sn, kst, 16,
                     k0 + warp * 16, p.nk, p.dqk, p.dk_vec, lane, 32);
  tc::store_rows<LD>(static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh, p.dv_sn, vst, 16,
                     k0 + warp * 16, p.nk, p.dvw, p.dv_vec, lane, 32);
}

// --------------------- bf16, Nq, Nk <= 128 and widths <= 64: one pass

constexpr int FU_THREADS = 256;      // eight warps
constexpr int FU_N = 128;            // the most query rows and keys a block takes
constexpr int FU_D = 64;             // the widest dqk and dv it takes
constexpr int FU_LD = FU_D + 8;      // bf16 row stride of the resident tiles
constexpr int FU_KC = 32;            // keys a chunk
constexpr int FU_LDC = FU_KC + 8;    // bf16 row stride of the P and dS chunks (80 bytes:
                                     // conflict-free ldmatrix)
constexpr int FU_LDS = FU_KC + 4;    // fp32 row stride of a warp's dS staging

// q, k, v, dO and O resident ([128][72] bf16 each; O's rows become the
// warps' dS staging once Di is formed), the P and dS chunks, the LSE and Di
constexpr size_t FU_SMEM = 5 * static_cast<size_t>(FU_N) * FU_LD * sizeof(__nv_bfloat16) +
                           2 * static_cast<size_t>(FU_N) * FU_LDC * sizeof(__nv_bfloat16) +
                           FU_N * (sizeof(double) + sizeof(float));
static_assert(8 * 16 * FU_LDS * sizeof(float) == FU_N * FU_LD * sizeof(__nv_bfloat16),
              "a warp's dS staging is exactly its 16 rows of the O tile");

__host__ __device__ inline bool fused_applies(const Params& p) {
  return p.nq <= FU_N && p.nk <= FU_N && p.dqk <= FU_D && p.dvw <= FU_D;
}

// One block per (head, batch) holds all of q, k, v and dO, so each product
// is formed once (5 a tile pair, against 7 in the two passes) and the bias
// is read once. For each chunk of 32 keys: each warp forms S and dP for its
// 16 query rows, then P, dS (written out through its staging rows) and
// dq += dS k, and leaves P and dS in bf16 in shared memory; after a barrier
// each warp forms dv = P^T dO and dk = dS^T q for a 16-key x 16-feature
// slab of the chunk, complete, and writes it. dq is written at the end.
// Every output is written by this block alone, in a fixed order.
__global__ void __launch_bounds__(FU_THREADS, 2) bias_bwd_fused_tc_kernel(Params p) {
  using tc::bf16;
  constexpr int LD = FU_LD, NT = FU_KC / 8, DK = FU_D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [128][LD]
  bf16* ks = qs + FU_N * LD;
  bf16* vs = ks + FU_N * LD;
  bf16* dos = vs + FU_N * LD;
  bf16* os = dos + FU_N * LD;                      // O, then the warps' dS staging
  bf16* ps = os + FU_N * LD;                       // [128][FU_LDC]: P of the chunk
  bf16* dss = ps + FU_N * FU_LDC;                  // [128][FU_LDC]: dS of the chunk
  double* lse_s = reinterpret_cast<double*>(dss + FU_N * FU_LDC);
  float* di_s = reinterpret_cast<float*>(lse_s + FU_N);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, heads = gridDim.x;
  const int64_t bh = static_cast<int64_t>(b) * heads + h;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* op = static_cast<const bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const bf16* dop = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int kq = tc::round16(p.dqk) >> 4, kv_steps = tc::round16(p.dvw) >> 4;

  // 1. everything resident at once
  tc::load_tile<FU_N, LD, FU_D, FU_THREADS>(qs, qp, p.q_sn, 0, p.nq, p.dqk, p.q_vec);
  tc::load_tile<FU_N, LD, FU_D, FU_THREADS>(ks, kp, p.k_sn, 0, p.nk, p.dqk, p.k_vec);
  tc::load_tile<FU_N, LD, FU_D, FU_THREADS>(vs, vp, p.v_sn, 0, p.nk, p.dvw, p.v_vec);
  tc::load_tile<FU_N, LD, FU_D, FU_THREADS>(dos, dop, p.do_sn, 0, p.nq, p.dvw, p.do_vec);
  tc::load_tile<FU_N, LD, FU_D, FU_THREADS>(os, op, p.o_sn, 0, p.nq, p.dvw, p.o_vec);
  if (tid < FU_N) {
    const bool ok = tid < p.nq;
    tc::cp_async8(lse_s + tid, ok ? p.lse + bh * p.nq + tid : p.lse, ok);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  // 2. Di = rowsum(dO * O) for the warp's 16 rows, two lanes a row; this
  //    thread's rows r0 and r0 + 8 with their Di and LSE
  const int r0 = warp * 16 + g;
  float di[2];
  double lse[2];
  {
    const int rr = warp * 16 + (lane >> 1);
    const __nv_bfloat162* do_row = reinterpret_cast<const __nv_bfloat162*>(dos + rr * LD);
    const __nv_bfloat162* o_row = reinterpret_cast<const __nv_bfloat162*>(os + rr * LD);
    float acc = 0.f;
    for (int col = 2 * (lane & 1); col < tc::round16(p.dvw); col += 4) {
      const float2 a = __bfloat1622float2(do_row[col / 2]);
      const float2 o = __bfloat1622float2(o_row[col / 2]);
      acc = fmaf(a.x, o.x, fmaf(a.y, o.y, acc));
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    di[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
    di[1] = __shfl_sync(0xffffffffu, acc, 2 * (g + 8));
    lse[0] = lse_s[r0];
    lse[1] = lse_s[r0 + 8];
  }
  __syncwarp();   // the warp's O rows become its dS staging
  float* stage = reinterpret_cast<float*>(os) + warp * 16 * FU_LDS;

  // this lane's ldmatrix addresses
  const uint32_t q_a = tc::a_lane<LD>(qs + warp * 16 * LD, lane);
  const uint32_t do_a = tc::a_lane<LD>(dos + warp * 16 * LD, lane);
  const uint32_t k_b = tc::b_lane<LD>(ks, lane), k_bt = tc::bt_lane<LD>(ks, lane);
  const uint32_t v_b = tc::b_lane<LD>(vs, lane);
  const uint32_t q_bt = tc::bt_lane<LD>(qs, lane), do_bt = tc::bt_lane<LD>(dos, lane);
  // P^T and dS^T as A fragments: the chunks stored [row][key], transposed
  const uint32_t p_at = tc::b_lane<FU_LDC>(ps, lane), ds_at = tc::b_lane<FU_LDC>(dss, lane);
  const int slab_k = (warp & 1) * 16, slab_f = (warp >> 1) * 16;   // the warp's dk / dv slab
  const int qsteps = (p.nq + 15) >> 4;
  const int64_t bias_bh = b * p.bias_sb + h * p.bias_sh;

  float dq[2 * DK][4];
#pragma unroll
  for (int j = 0; j < 2 * DK; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int k0 = 0; k0 < p.nk; k0 += FU_KC) {
    // 3. the bias of the warp's rows and the chunk's keys into its staging
    //    rows (4-byte copies, a lane a key: whole 128-byte runs; in flight
    //    during the products), then S and dP
    if (p.bias) {
      const int kj = k0 + lane;
      const int64_t off = bias_bh + static_cast<int64_t>(warp * 16) * p.bias_sn + kj;
#pragma unroll 4
      for (int rr = 0; rr < 16; ++rr) {
        const bool ok = warp * 16 + rr < p.nq && kj < p.nk;
        const int64_t o = off + rr * p.bias_sn;
        if (p.bias_bf16) {
          stage[rr * FU_LDS + lane] =
              ok ? __bfloat162float(static_cast<const bf16*>(p.bias)[o]) : 0.f;
        } else {
          tc::cp_async4(stage + rr * FU_LDS + lane,
                        ok ? static_cast<const float*>(p.bias) + o : p.bias, ok);
        }
      }
      tc::cp_async_commit();
    }
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      if (kk < kq) {
        uint32_t a[4];
        tc::ldsm_x4(a, q_a + tc::blk<LD>(0, kk));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          tc::ldsm_x4(bf, k_b + tc::blk<LD>(k0 / 16 + np, kk));
          tc::mma_bf16(s[2 * np], a, bf[0], bf[1]);
          tc::mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
        }
      }
      if (kk < kv_steps) {
        uint32_t a[4];
        tc::ldsm_x4(a, do_a + tc::blk<LD>(0, kk));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          tc::ldsm_x4(bf, v_b + tc::blk<LD>(k0 / 16 + np, kk));
          tc::mma_bf16(dp[2 * np], a, bf[0], bf[1]);
          tc::mma_bf16(dp[2 * np + 1], a, bf[2], bf[3]);
        }
      }
    }

    // 4. P and dS (zero past Nq and Nk, S - LSE in fp64); both into the
    //    chunk tiles as bf16, dS in fp32 into the warp's staging over the
    //    bias it replaces (each lane writes where it read)
    if (p.bias) {
      tc::cp_async_wait<0>();
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + 8 * hr, col = j * 8 + 2 * c;
        const float2 bv = p.bias ? *reinterpret_cast<const float2*>(stage + (g + 8 * hr) * FU_LDS + col)
                                 : make_float2(0.f, 0.f);
        float pr[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = row < p.nq && k0 + col + e < p.nk;
          const float x = s[j][2 * hr + e] * p.scale + (e ? bv.y : bv.x);
          pr[e] = ok ? __expf(static_cast<float>(static_cast<double>(x) - lse[hr])) : 0.f;
          ds[e] = pr[e] * (dp[j][2 * hr + e] - di[hr]);
          s[j][2 * hr + e] = ds[e];
        }
        *reinterpret_cast<uint32_t*>(ps + row * FU_LDC + col) = tc::pack_bf16(pr[0], pr[1]);
        *reinterpret_cast<uint32_t*>(dss + row * FU_LDC + col) = tc::pack_bf16(ds[0], ds[1]);
        if (p.ds) {
          *reinterpret_cast<float2*>(stage + (g + 8 * hr) * FU_LDS + col) = make_float2(ds[0], ds[1]);
        }
      }
    }
    if (p.ds) {   // the warp's 16 rows, a lane a key: whole 128-byte runs
      __syncwarp();
#pragma unroll 4
      for (int rr = 0; rr < 16; ++rr) {
        const int qi = warp * 16 + rr, kj = k0 + lane;
        if (qi < p.nq && kj < p.nk) p.ds[(bh * p.nq + qi) * p.nk + kj] = stage[rr * FU_LDS + lane];
      }
      __syncwarp();
    }

    // 5. dq += dS k
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
      tc::acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < DK; ++n2) {
        if (n2 < kq) {
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, k_bt + tc::blk<LD>(k0 / 16 + kk, n2));
          tc::mma_bf16(dq[2 * n2], a, bf[0], bf[1]);
          tc::mma_bf16(dq[2 * n2 + 1], a, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();   // the chunk's P and dS are complete

    // 6. the warp's slab of the chunk: dv = P^T dO and dk = dS^T q over all
    //    query rows, complete
    const int key0 = k0 + slab_k;
    if (key0 < p.nk) {
      float dv[2][4] = {}, dk[2][4] = {};
      const bool do_v = slab_f < p.dvw, do_k = slab_f < p.dqk;
      for (int qs16 = 0; qs16 < qsteps; ++qs16) {
        uint32_t a[4], bf[4];
        if (do_v) {
          tc::ldsm_x4_t(a, p_at + tc::blk<FU_LDC>(qs16, slab_k / 16));
          tc::ldsm_x4_t(bf, do_bt + tc::blk<LD>(qs16, slab_f / 16));
          tc::mma_bf16(dv[0], a, bf[0], bf[1]);
          tc::mma_bf16(dv[1], a, bf[2], bf[3]);
        }
        if (do_k) {
          tc::ldsm_x4_t(a, ds_at + tc::blk<FU_LDC>(qs16, slab_k / 16));
          tc::ldsm_x4_t(bf, q_bt + tc::blk<LD>(qs16, slab_f / 16));
          tc::mma_bf16(dk[0], a, bf[0], bf[1]);
          tc::mma_bf16(dk[1], a, bf[2], bf[3]);
        }
      }
      // through the warp's staging rows (free since step 4): dk in columns
      // 0-15, dv in 16-31; then a 16-byte piece a lane
      bf16* st16 = reinterpret_cast<bf16*>(stage);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          bf16* row = st16 + (g + 8 * hr) * FU_LD + j * 8 + 2 * c;
          *reinterpret_cast<__nv_bfloat162*>(row) =
              __floats2bfloat162_rn(dk[j][2 * hr] * p.scale, dk[j][2 * hr + 1] * p.scale);
          *reinterpret_cast<__nv_bfloat162*>(row + 16) =
              __floats2bfloat162_rn(dv[j][2 * hr], dv[j][2 * hr + 1]);
        }
      }
      __syncwarp();
      const int kj = key0 + (lane >> 1), f = slab_f + (lane & 1) * 8;
      const bf16* src = st16 + (lane >> 1) * FU_LD + (lane & 1) * 8;
      if (kj < p.nk) {
        bf16* dkp = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh + kj * p.dk_sn + f;
        bf16* dvp = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh + kj * p.dv_sn + f;
        if (p.dk_vec && f + 8 <= p.dqk) {
          *reinterpret_cast<uint4*>(dkp) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && f + e < p.dqk; ++e) dkp[e] = src[e];
        }
        if (p.dv_vec && f + 8 <= p.dvw) {
          *reinterpret_cast<uint4*>(dvp) = *reinterpret_cast<const uint4*>(src + 16);
        } else {
          for (int e = 0; e < 8 && f + e < p.dvw; ++e) dvp[e] = src[16 + e];
        }
      }
    }
    __syncthreads();   // before the next chunk's P and dS
  }

  // 7. dq = scale dS k through the warp's own rows of the q tile (read last
  //    by the slabs of step 6, before the barrier above)
  bf16* qst = qs + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < 2 * DK; ++j) {
    if (j < 2 * kq) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        *reinterpret_cast<__nv_bfloat162*>(qst + (g + 8 * hr) * LD + j * 8 + 2 * c) =
            __floats2bfloat162_rn(dq[j][2 * hr] * p.scale, dq[j][2 * hr + 1] * p.scale);
      }
    }
  }
  __syncwarp();
  tc::store_rows<LD>(static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh, p.dq_sn, qst, 16,
                     warp * 16, p.nq, p.dqk, p.dq_vec, lane, 32);
}

// ---------------------------------------------------------------- launch

cudaError_t prepare(const void* fn, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int JQ>
cudaError_t launch_q(const Params& p, int batch, int heads, cudaStream_t stream) {
  const size_t bytes = q_smem_floats(p.dqk, p.dvw) * sizeof(float);
  cudaError_t err = prepare(reinterpret_cast<const void*>(&bias_bwd_q_kernel<float, JQ>), bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.nq + BQ - 1) / BQ, heads, batch);
  bias_bwd_q_kernel<float, JQ><<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int JD>
cudaError_t launch_k(const Params& p, int batch, int heads, cudaStream_t stream) {
  const size_t bytes = k_smem_floats(p.dqk, p.dvw) * sizeof(float);
  cudaError_t err = prepare(reinterpret_cast<const void*>(&bias_bwd_k_kernel<float, JD>), bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.nk + BK - 1) / BK, heads, batch);
  bias_bwd_k_kernel<float, JD><<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_fp32(const Params& p, int batch, int heads, cudaStream_t stream) {
  if (p.dqk > MAX_WIDTH || p.dvw > MAX_WIDTH ||
      q_smem_floats(p.dqk, p.dvw) * sizeof(float) > MAX_SMEM ||
      k_smem_floats(p.dqk, p.dvw) * sizeof(float) > MAX_SMEM) {
    return cudaErrorInvalidValue;
  }
  // the key-side pass reads the Di that the query-side pass writes: same
  // stream, so in order
  cudaError_t err;
  switch (jmax_for(p.dqk)) {
    case 2: err = launch_q<2>(p, batch, heads, stream); break;
    case 4: err = launch_q<4>(p, batch, heads, stream); break;
    case 6: err = launch_q<6>(p, batch, heads, stream); break;
    default: err = launch_q<8>(p, batch, heads, stream); break;
  }
  if (err != cudaSuccess) return err;
  switch (jmax_for(imax(p.dqk, p.dvw))) {
    case 2: return launch_k<2>(p, batch, heads, stream);
    case 4: return launch_k<4>(p, batch, heads, stream);
    case 6: return launch_k<6>(p, batch, heads, stream);
    default: return launch_k<8>(p, batch, heads, stream);
  }
}

// the padded width the tensor-core kernels' registers are sized for
inline int tc_dmax(int dqk, int dvw) {
  return imax(tc::round16(dqk), tc::round16(dvw)) <= 64 ? 64 : 128;
}

template <int DMAX>
cudaError_t launch_tc_d(const Params& p, int batch, int heads, cudaStream_t stream) {
  const size_t qb = tc_q_smem_bytes(DMAX), kb = tc_k_smem_bytes(DMAX);
  cudaError_t err = prepare(reinterpret_cast<const void*>(&bias_bwd_q_tc_kernel<DMAX>), qb);
  if (err != cudaSuccess) return err;
  bias_bwd_q_tc_kernel<DMAX>
      <<<dim3((p.nq + TC_BLOCK - 1) / TC_BLOCK, heads, batch), TC_THREADS, qb, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the key-side pass reads the Di the query-side pass writes: same stream
  err = prepare(reinterpret_cast<const void*>(&bias_bwd_k_tc_kernel<DMAX>), kb);
  if (err != cudaSuccess) return err;
  bias_bwd_k_tc_kernel<DMAX>
      <<<dim3((p.nk + TC_BLOCK - 1) / TC_BLOCK, heads, batch), TC_THREADS, kb, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_fused(const Params& p, int batch, int heads, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(&bias_bwd_fused_tc_kernel);
  cudaError_t err = prepare(fn, FU_SMEM);
  if (err != cudaSuccess) return err;
  bias_bwd_fused_tc_kernel<<<dim3(heads, batch), FU_THREADS, FU_SMEM, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const Params& p, int batch, int heads, cudaStream_t stream) {
  if (fused_applies(p)) return launch_fused(p, batch, heads, stream);
  const int dmax = tc_dmax(p.dqk, p.dvw);
  if (p.dqk > MAX_WIDTH || p.dvw > MAX_WIDTH || tc_q_smem_bytes(dmax) > MAX_SMEM ||
      tc_k_smem_bytes(dmax) > MAX_SMEM) {
    return cudaErrorInvalidValue;
  }
  return dmax == 64 ? launch_tc_d<64>(p, batch, heads, stream)
                    : launch_tc_d<128>(p, batch, heads, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 for q, k, v, O, dO and the gradients;
// bias_bf16: the bias's type. Returns a cudaError_t.
int ecf_bias_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* bias, const void* o,
    const void* dout, const double* lse, void* dq, void* dk, void* dv, float* di, float* ds,
    int batch, int heads, int nq, int nk, int dqk, int dvw, int bias_bf16,
    int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn,
    int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t o_sb, int64_t o_sh, int64_t o_sn,
    int64_t do_sb, int64_t do_sh, int64_t do_sn, int64_t dq_sb, int64_t dq_sh, int64_t dq_sn,
    int64_t dk_sb, int64_t dk_sh, int64_t dk_sn, int64_t dv_sb, int64_t dv_sh, int64_t dv_sn,
    int64_t bias_sb, int64_t bias_sh, int64_t bias_sn, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || nq <= 0 || nk <= 0 || dqk <= 0 || dvw <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q, k, v, bias, o, dout, lse, dq, dk, dv, di, ds, nq, nk, dqk, dvw, bias_bf16,
           q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn,
           do_sb, do_sh, do_sn, dq_sb, dq_sh, dq_sn, dk_sb, dk_sh, dk_sn, dv_sb, dv_sh, dv_sn,
           bias_sb, bias_sh, bias_sn, scale,
           tc::vec16(q, q_sb, q_sh, q_sn, dqk), tc::vec16(k, k_sb, k_sh, k_sn, dqk),
           tc::vec16(v, v_sb, v_sh, v_sn, dvw), tc::vec16(o, o_sb, o_sh, o_sn, dvw),
           tc::vec16(dout, do_sb, do_sh, do_sn, dvw), tc::vec16(dq, dq_sb, dq_sh, dq_sn, dqk),
           tc::vec16(dk, dk_sb, dk_sh, dk_sn, dqk), tc::vec16(dv, dv_sb, dv_sh, dv_sn, dvw)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_fp32(p, batch, heads, s));
  if (dtype == 1) return static_cast<int>(launch_bf16(p, batch, heads, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory a block of each backward kernel on the route for
// `dtype` takes at these sizes, in bytes: the query side's (or the one-pass
// kernel's) in the low 32 bits, the key side's in the high (0 for the one
// pass). ptxas reports none: it is sized at launch.
long long ecf_bias_attention_bwd_smem(int dtype, int nq, int nk, int dqk, int dvw) {
  Params p{};
  p.nq = nq, p.nk = nk, p.dqk = dqk, p.dvw = dvw;
  if (dtype == 1 && fused_applies(p)) return static_cast<long long>(FU_SMEM);
  const size_t q = dtype == 1 ? tc_q_smem_bytes(tc_dmax(dqk, dvw))
                              : q_smem_floats(dqk, dvw) * sizeof(float);
  const size_t k = dtype == 1 ? tc_k_smem_bytes(tc_dmax(dqk, dvw))
                              : k_smem_floats(dqk, dvw) * sizeof(float);
  return static_cast<long long>(q) | (static_cast<long long>(k) << 32);
}

const char* ecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
