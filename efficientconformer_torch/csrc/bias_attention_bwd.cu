// Attention with an additive bias, backward pass, for sm_90a.
//
// Replaces the TPU kernels efficientconformer_tpu/ops/pallas_attention.py:
// _bwd_dq_kernel and _bwd_dkv_kernel (launched by _flash_backward, which the
// JAX package runs for a key-mask bias; for a full bias it computes dbias in
// XLA, _fused_bwd). With the forward's S = q k^T * scale + bias, its LSE and
// O, and dO, it computes
//
//     P  = exp(S - LSE),  Di = rowsum(dO * O)   (= rowsum(P * dP) exactly)
//     dP = dO v^T,        dS = P * (dP - Di)
//     dq = scale dS k,    dk = scale dS^T q,    dv = P^T dO
//
// with S - LSE taken in fp64, as the forward keeps the LSE (in fp32 it would
// lose log(Nk) on a row whose keys all carry the -1e9 mask), and, when the
// bias requires a gradient, dS itself into a (B, H, Nq, Nk) buffer, which
// the wrapper sums over the bias's broadcast axes. The plain
// PyTorch version is reference_bias_attention_bwd in ops/bias_attention.py.
//
// What bounds it on the H100: at the LM-Transformer's training shape (B 64,
// H 12, N <= 101, dh 64) it reads q, k, v, O and dO in bf16 (about 50 MB),
// the fp32 bias and LSE (31 MB), and writes dq, dk, dv in bf16 and dS in fp32
// (30 + 31 MB): about 0.045 ms at 3.35 TB/s, against some 10 GFLOP of
// products, 0.010 ms on the bf16 tensor cores. The bound is the bytes.
//
// What the design does about it. The TPU kernels tile (Nq, Nk) and carry
// their sums along a sequential grid axis. Here the work is split into two
// passes, as FlashAttention-2 splits its backward, and no (N, Nk) tensor
// other than the requested dS reaches device memory:
//
//   * query-side pass, one block per (64 query rows, head, batch), looping
//     over key tiles: Di for its rows (written out for the other pass), the
//     scores and dP, dS (written out when asked for), and dq += dS k in
//     registers;
//   * key-side pass, one block per (64 keys, head, batch), looping over query
//     tiles: it recomputes the scores, P and dS and accumulates dv and dk in
//     registers. The bias tile is staged through shared memory with
//     coalesced reads, since this pass walks it by columns.
//
// Each output element is written by exactly one block, with no atomics, so
// the gradients are the same from run to run. Each thread owns a 4 x 4 tile
// of scores: one 16-byte and four 4-byte shared-memory loads per 16 fp32
// FMAs. Tiles read four rows at a time have a row stride of 68 floats
// (16-byte aligned), tiles read one word at a time 65 (odd, so a half-warp's
// 16 neighbouring columns fall in distinct banks). Rows past Nq and keys past
// Nk get P = 0 from the kernel itself. Tensor cores (mma/wgmma) are later
// work.
//
// Inputs: q, k, v, O, dO of type T (float or bf16) with arbitrary
// batch/head/row strides and unit feature stride; LSE (B, H, Nq) fp64; bias
// fp32 or bf16 with unit key stride and (batch, head, row) strides that are 0
// along broadcast axes, or null. Outputs: dq, dk, dv of type T (strided); Di
// (B, H, Nq) fp32 scratch; dS (B, H, Nq, Nk) fp32, or null when not wanted.
// The kernels allocate nothing and do not synchronise; the key-side pass
// reads the Di the query-side pass wrote, in stream order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 256;   // a 16 x 16 grid of threads, each a 4 x 4 tile
constexpr int LDV = 68;         // row stride of tiles read four rows at a time
constexpr int LDS = 65;         // row stride of tiles read one word at a time
constexpr int MAX_WIDTH = 128;
constexpr size_t MAX_SMEM = 232448;  // 227 KB a block may use on sm_90

static_assert(NTHREADS == 16 * 16 && BQ == 4 * 16 && BK == 4 * 16, "thread grid");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
__host__ __device__ inline size_t zmax(size_t a, size_t b) { return a > b ? a : b; }
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

// ---------------------------------------------------------------- launch

cudaError_t prepare(const void* fn, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int JQ>
cudaError_t launch_q(const Params& p, int batch, int heads, cudaStream_t stream) {
  const size_t bytes = q_smem_floats(p.dqk, p.dvw) * sizeof(float);
  cudaError_t err = prepare(reinterpret_cast<const void*>(&bias_bwd_q_kernel<T, JQ>), bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.nq + BQ - 1) / BQ, heads, batch);
  bias_bwd_q_kernel<T, JQ><<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int JD>
cudaError_t launch_k(const Params& p, int batch, int heads, cudaStream_t stream) {
  const size_t bytes = k_smem_floats(p.dqk, p.dvw) * sizeof(float);
  cudaError_t err = prepare(reinterpret_cast<const void*>(&bias_bwd_k_kernel<T, JD>), bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.nk + BK - 1) / BK, heads, batch);
  bias_bwd_k_kernel<T, JD><<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  if (p.dqk > MAX_WIDTH || p.dvw > MAX_WIDTH ||
      q_smem_floats(p.dqk, p.dvw) * sizeof(float) > MAX_SMEM ||
      k_smem_floats(p.dqk, p.dvw) * sizeof(float) > MAX_SMEM) {
    return cudaErrorInvalidValue;
  }
  // the key-side pass reads the Di that the query-side pass writes: same
  // stream, so in order
  cudaError_t err;
  switch (jmax_for(p.dqk)) {
    case 2: err = launch_q<T, 2>(p, batch, heads, stream); break;
    case 4: err = launch_q<T, 4>(p, batch, heads, stream); break;
    case 6: err = launch_q<T, 6>(p, batch, heads, stream); break;
    default: err = launch_q<T, 8>(p, batch, heads, stream); break;
  }
  if (err != cudaSuccess) return err;
  switch (jmax_for(imax(p.dqk, p.dvw))) {
    case 2: return launch_k<T, 2>(p, batch, heads, stream);
    case 4: return launch_k<T, 4>(p, batch, heads, stream);
    case 6: return launch_k<T, 6>(p, batch, heads, stream);
    default: return launch_k<T, 8>(p, batch, heads, stream);
  }
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
           bias_sb, bias_sh, bias_sn, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(p, batch, heads, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(p, batch, heads, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
