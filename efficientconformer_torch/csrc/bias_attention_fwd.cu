// Attention with an additive bias, forward pass, for sm_90a.
//
// Replaces the TPU kernels efficientconformer_tpu/ops/pallas_attention.py:
// _kernel (:55, launched by _fused_forward :171, the whole (b, h) block in
// VMEM) and _flash_kernel (:272, launched by _flash_forward :318, keys tiled
// with an online softmax). One key-tiled kernel covers both. Per (batch,
// head) it computes
//
//     S   = q k^T * scale + bias
//     O   = softmax(S) v,  LSE = logsumexp(S)          (fp32 softmax)
//
// and writes O in the input type and the row log-sum-exp in fp64 (an fp32
// LSE near -1e9, a fully masked row, would drop log(Nk): an fp32 step there
// is 64). The plain PyTorch version is reference_bias_attention in
// ops/bias_attention.py.
//
// What bounds it on the H100: at the LM-Transformer's training shape (B 64,
// H 12, N 101, dh 64) the bytes are q, k, v and O in bf16 (39.7 MB), the
// fp32 bias (31.3 MB) and the fp64 LSE: 71 MB, 0.0214 ms at 3.35 TB/s. The
// products are 2 x 64 x 12 x 101 x 101 x 128 = 2.0 GFLOP (3.2 padded to the
// tiles), 0.002-0.003 ms on the bf16 tensor cores. So the bound is the bytes,
// and above all the bias, which the kernel reads exactly once.
//
// Two routes, chosen by the inputs' type:
//
//   * bf16, bias_fwd_tc_kernel: the tensor-core design. One block of four
//     warps per (64 query rows, head, batch), 1,536 blocks at the LM shape;
//     each warp owns 16 query rows. q, k and v stay bf16 in shared memory
//     (rows padded by 8 elements, so ldmatrix reads no two rows from one
//     bank group), copied with 16-byte cp.async where every row is 16-byte
//     aligned (the LM's rows are 1,536 bytes apart) and element by element
//     otherwise (dqk 90, strided heads); widths are zero-padded to 16. Keys
//     stream in tiles of 32, double-buffered: tile t + 1's copies are in
//     flight while tile t's products run. S = q k^T and O += P v run on
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate); k in row-major is the
//     B operand of q k^T as it is, v goes through ldmatrix.trans. P, rounded
//     to bf16 in registers, is the A fragment of P v (the TPU kernels round
//     it the same way, p.astype(v.dtype)). The bias tile is copied with
//     4-byte cp.async, a warp on 32 consecutive keys of a row (its rows are
//     404 bytes apart, so no wider copy is aligned), and added to S in the
//     accumulator's layout. The online softmax keeps each row's max and sum
//     in fp32 registers, reduced over the four lanes that share a row. 48 KB
//     of shared memory a block at dh 64: four blocks an SM. Measured on the
//     H100 at the LM's shape (PERF.md): about 0.043 ms, twice the byte
//     bound; the instructions around the products (the copies' addresses,
//     the softmax) and their latency set the pace, not the bytes.
//   * fp32, bias_fwd_kernel<float, J>: fp32 FMAs from shared memory (TF32
//     products would miss the fp32 checks, 1e-4, by an order). The q tile
//     sits feature-major (4 rows are one 16-byte load); keys and values
//     stream in tiles of 64; each thread owns a 4 x 4 tile of scores.
//
// Both read the bias once, through its own strides: a broadcast
// (B|1, H|1, Nq|1, Nk) bias or a key mask is never expanded. Keys past Nk
// (the tile's ragged edge) are excluded outright (-inf, probability exactly
// 0), so a row whose real keys all carry the -1e9 mask averages over the real
// keys only, as the plain version does. No (N, Nk) tensor reaches device
// memory.
//
// Inputs: q, k, v of type T (float for the FMA kernel, bf16 for the
// tensor-core one) with arbitrary batch/head/row strides and unit feature
// stride; bias fp32 or bf16 with unit key stride and
// (batch, head, row) strides that are 0 along broadcast axes, or null. The
// kernel allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 256;   // a 16 x 16 grid: ty owns 4 rows, tx 4 key columns
constexpr int LDQ = BQ + 4;     // qT row stride: [feature][query row], 16-byte rows
constexpr int LDP = BQ + 4;     // psT row stride: [key][query row], 16-byte rows
constexpr int LDK = BK + 1;     // kT row stride: [feature][key], odd for the stores
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
  void* o;
  double* lse;          // (B, H, Nq)
  int nq, nk, dqk, dv, bias_bf16;
  int64_t q_sb, q_sh, q_sn;
  int64_t k_sb, k_sh, k_sn;
  int64_t v_sb, v_sh, v_sn;
  int64_t o_sb, o_sh, o_sn;
  int64_t bias_sb, bias_sh, bias_sn;
  float scale;
  bool q_vec, k_vec, v_vec, o_vec;   // rows copyable in 16-byte pieces (tc::vec16)
};

__device__ __forceinline__ float load_bias(const Params& p, int64_t off) {
  return p.bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[off])
                     : static_cast<const float*>(p.bias)[off];
}

// output columns per thread: dv <= 16 * jmax
__host__ __device__ inline int jmax_for(int d) {
  return d <= 32 ? 2 : d <= 64 ? 4 : d <= 96 ? 6 : 8;
}

__host__ __device__ inline size_t r4(size_t floats) { return (floats + 3) & ~static_cast<size_t>(3); }

__host__ __device__ inline size_t smem_floats(int dqk, int dv) {
  return static_cast<size_t>(dqk) * LDQ + r4(static_cast<size_t>(dqk) * LDK) +
         static_cast<size_t>(BK) * 16 * jmax_for(dv) + BK * LDP;
}

template <typename T, int JMAX>
__global__ void __launch_bounds__(NTHREADS) bias_fwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DVP = 16 * JMAX;                 // padded V row
  const int dqk = p.dqk, dv = p.dv;
  float* qT = smem;                              // dqk x LDQ: q^T of the block's rows
  float* kT = qT + dqk * LDQ;                    // dqk x LDK: k^T of a key tile
  float* vs = kT + r4(static_cast<size_t>(dqk) * LDK);  // BK x DVP: the V tile, zero-padded
  float* psT = vs + BK * DVP;                    // BK x LDP: the probabilities, key-major

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int64_t bias_bh = b * p.bias_sb + h * p.bias_sh;

  // 1. the q tile, feature-major (zero past Nq): a warp per row, a lane per
  //    feature, so the global reads are coalesced
  for (int r = warp; r < BQ; r += NTHREADS / 32) {
    const int qi = q0 + r;
    const bool ok = qi < p.nq;
    for (int d = lane; d < dqk; d += 32) qT[d * LDQ + r] = ok ? to_f32(qp[qi * p.q_sn + d]) : 0.f;
  }

  float m[4], l[4], o[4][JMAX];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < JMAX; ++j) o[i][j] = 0.f;
  }

  // 2. stream the keys
  for (int k0 = 0; k0 < p.nk; k0 += BK) {
    // k^T and V of the tile, a warp per key; their previous readers finished
    // at the loop's last barrier
    for (int c = warp; c < BK; c += NTHREADS / 32) {
      const int kj = k0 + c;
      const bool ok = kj < p.nk;
      for (int d = lane; d < dqk; d += 32) kT[d * LDK + c] = ok ? to_f32(kp[kj * p.k_sn + d]) : 0.f;
      for (int d = lane; d < DVP; d += 32) {
        vs[c * DVP + d] = (ok && d < dv) ? to_f32(vp[kj * p.v_sn + d]) : 0.f;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[i][cc] = 0.f;
    const float* qt = qT + ty * 4;
#pragma unroll 4
    for (int d = 0; d < dqk; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * LDQ);
      const float* krow = kT + d * LDK + tx;
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

    // scale and bias; keys past Nk excluded outright. Rows past Nq keep a
    // finite score (their output is never written).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      const bool row_ok = qi < p.nq;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int kj = k0 + tx + 16 * cc;
        if (kj >= p.nk) {
          s[i][cc] = -INFINITY;
        } else {
          const float bv = (p.bias && row_ok) ? load_bias(p, bias_bh + qi * p.bias_sn + kj) : 0.f;
          s[i][cc] = s[i][cc] * p.scale + bv;
        }
      }
    }

    // online softmax: the 16 threads of a row group are one half-warp. Each
    // tile holds key k0, so every row's running max is finite after it.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        s[i][cc] = expf(s[i][cc] - m_new);
        sum += s[i][cc];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < JMAX; ++j) o[i][j] *= alpha;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      *reinterpret_cast<float4*>(psT + (tx + 16 * cc) * LDP + ty * 4) =
          make_float4(s[0][cc], s[1][cc], s[2][cc], s[3][cc]);
    }
    __syncthreads();

    // O += P V over this key tile
    for (int c = 0; c < BK; ++c) {
      const float4 pr = *reinterpret_cast<const float4*>(psT + c * LDP + ty * 4);
      const float* vrow = vs + c * DVP + tx;
#pragma unroll
      for (int j = 0; j < JMAX; ++j) {
        const float vv = vrow[16 * j];
        o[0][j] = fmaf(pr.x, vv, o[0][j]);
        o[1][j] = fmaf(pr.y, vv, o[1][j]);
        o[2][j] = fmaf(pr.z, vv, o[2][j]);
        o[3][j] = fmaf(pr.w, vv, o[3][j]);
      }
    }
    __syncthreads();
  }

  // 3. normalise and write O (input type) and the LSE (fp64)
  T* op = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.nq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      const int d = tx + 16 * j;
      if (d < dv) op[qi * p.o_sn + d] = from_f32<T>(o[i][j] * inv);
    }
    if (tx == 0) {
      p.lse[(static_cast<int64_t>(b) * gridDim.y + h) * p.nq + qi] =
          static_cast<double>(m[i]) + log(static_cast<double>(l[i]));
    }
  }
}

// ------------------------------------------------ bf16: the tensor cores

constexpr int TC_THREADS = 128;  // four warps, 16 query rows each
constexpr int TC_BQ = 64;        // query rows per block
constexpr int TC_BK = 32;        // keys per tile
constexpr int TC_STAGES = 2;     // key tiles in the ring of shared-memory stages
constexpr int TC_LDB = TC_BK + 8;  // bias tile row stride (floats): a half-warp's
                                   // 8-byte fragment reads hit 32 distinct banks

// bytes of shared memory at padded width dmax: q and the stages of k and v
// (bf16, rows of dmax + 8) and of the fp32 bias tile
__host__ __device__ constexpr size_t tc_smem_bytes(int dmax) {
  return static_cast<size_t>(TC_BQ + 2 * TC_STAGES * TC_BK) * (dmax + 8) * sizeof(__nv_bfloat16) +
         TC_STAGES * static_cast<size_t>(TC_BQ) * TC_LDB * sizeof(float);
}

// DMAX: the padded head width the registers are sized for (64 or 128); the
// loops over features stop at the real widths rounded up to 16.
template <int DMAX>
__global__ void __launch_bounds__(TC_THREADS) bias_fwd_tc_kernel(Params p) {
  using tc::bf16;
  constexpr int LD = DMAX + 8;    // shared row stride, elements (16 bytes of padding)
  constexpr int NT = TC_BK / 8;   // 8-key tiles of a score tile
  constexpr int DK = DMAX / 16;   // 16-wide feature steps
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);           // [TC_BQ][LD]
  bf16* ks = qs + TC_BQ * LD;                              // [TC_STAGES][TC_BK][LD]
  bf16* vs = ks + TC_STAGES * TC_BK * LD;                  // [TC_STAGES][TC_BK][LD]
  float* bs = reinterpret_cast<float*>(vs + TC_STAGES * TC_BK * LD);  // [TC_STAGES][TC_BQ][TC_LDB]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int q0 = blockIdx.x * TC_BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int64_t bias_bh = b * p.bias_sb + h * p.bias_sh;
  const int kq = tc::round16(p.dqk) >> 4, nv = tc::round16(p.dv) >> 4;
  const int ntiles = (p.nk + TC_BK - 1) / TC_BK;

  auto load_keys = [&](int t) {
    const int buf = t % TC_STAGES, k0 = t * TC_BK;
    tc::load_tile<TC_BK, LD, DMAX, TC_THREADS>(ks + buf * TC_BK * LD, kp, p.k_sn, k0, p.nk,
                                               p.dqk, p.k_vec);
    tc::load_tile<TC_BK, LD, DMAX, TC_THREADS>(vs + buf * TC_BK * LD, vp, p.v_sn, k0, p.nk,
                                               p.dv, p.v_vec);
    if (p.bias) {
      tc::load_bias_tile<TC_BQ, TC_BK, TC_LDB, TC_THREADS>(
          bs + buf * TC_BQ * TC_LDB, p.bias, p.bias_bf16, bias_bh, p.bias_sn, q0, k0, p.nq, p.nk);
    }
  };

  // 1. copies in flight: the q tile with key tile 0, then the next tiles
  //    up to one short of the ring
  tc::load_tile<TC_BQ, LD, DMAX, TC_THREADS>(
      qs, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_sn, q0, p.nq, p.dqk,
      p.q_vec);
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < ntiles) load_keys(st);
    tc::cp_async_commit();
  }

  float o[2 * DK][4];
#pragma unroll
  for (int j = 0; j < 2 * DK; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8 of the warp
  uint32_t qf[DK][4];
  const int r0 = warp * 16 + g;
  // this lane's ldmatrix addresses: the warp's q rows, the first stage of k and v
  constexpr uint32_t STAGE = TC_BK * LD * 2;   // bytes of a k or v stage
  const uint32_t q_a = tc::a_lane<LD>(qs + warp * 16 * LD, lane);
  const uint32_t k_b = tc::b_lane<LD>(ks, lane), v_bt = tc::bt_lane<LD>(vs, lane);

  // 2. stream the key tiles
  for (int t = 0; t < ntiles; ++t) {
    tc::cp_async_wait<TC_STAGES - 2>();   // tile t (and the q tile) landed
    __syncthreads();   // ... for every thread; every warp is done with tile t - 1
    if (t + TC_STAGES - 1 < ntiles) load_keys(t + TC_STAGES - 1);   // into tile t - 1's stage
    tc::cp_async_commit();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        if (kk < kq) tc::ldsm_x4(qf[kk], q_a + tc::blk<LD>(0, kk));
      }
    }
    const int buf = t % TC_STAGES, k0 = t * TC_BK;
    const uint32_t kt_b = k_b + buf * STAGE, vt_bt = v_bt + buf * STAGE;
    const float* bt = bs + buf * TC_BQ * TC_LDB;

    // S = q k^T, 16 rows x 32 keys a warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      if (kk < kq) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          tc::ldsm_x4(bf, kt_b + tc::blk<LD>(np, kk));
          tc::mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
          tc::mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
        }
      }
    }

    // scale and bias, in the accumulator's layout; keys past Nk excluded
    // outright. Rows past Nq keep a finite score (never written).
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int col = j * 8 + 2 * c;
        float2 bv = make_float2(0.f, 0.f);
        if (p.bias) bv = *reinterpret_cast<const float2*>(bt + (r0 + 8 * hr) * TC_LDB + col);
        s[j][2 * hr] = k0 + col < p.nk ? s[j][2 * hr] * p.scale + bv.x : -INFINITY;
        s[j][2 * hr + 1] = k0 + col + 1 < p.nk ? s[j][2 * hr + 1] * p.scale + bv.y : -INFINITY;
      }
    }

    // online softmax; the four lanes of a quad share a row
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a tile of -inf scores
      const float alpha = __expf(m[hr] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][2 * hr] = __expf(s[j][2 * hr] - m_use);
        s[j][2 * hr + 1] = __expf(s[j][2 * hr + 1] - m_use);
        sum += s[j][2 * hr] + s[j][2 * hr + 1];
      }
      l[hr] = l[hr] * alpha + sum;   // this lane's part; the quad is summed at the end
      m[hr] = m_new;
#pragma unroll
      for (int j = 0; j < 2 * DK; ++j) {
        o[j][2 * hr] *= alpha;
        o[j][2 * hr + 1] *= alpha;
      }
    }

    // O += P v, P as bf16 A fragments straight from the registers
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
      tc::acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < DK; ++n2) {
        if (n2 < nv) {
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, vt_bt + tc::blk<LD>(kk, n2));
          tc::mma_bf16(o[2 * n2], a, bf[0], bf[1]);
          tc::mma_bf16(o[2 * n2 + 1], a, bf[2], bf[3]);
        }
      }
    }
  }

  // 3. normalise; O through the warp's own rows of the q tile (no other
  //    warp reads them) to whole-row stores; the LSE in fp64
  bf16* stage = qs + warp * 16 * LD;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const float inv = 1.f / l[hr];
#pragma unroll
    for (int j = 0; j < 2 * DK; ++j) {
      if (j < 2 * nv) {
        *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8 * hr) * LD + j * 8 + 2 * c) =
            __floats2bfloat162_rn(o[j][2 * hr] * inv, o[j][2 * hr + 1] * inv);
      }
    }
    const int qi = q0 + r0 + 8 * hr;
    if (c == 0 && qi < p.nq) {
      p.lse[(static_cast<int64_t>(b) * gridDim.y + h) * p.nq + qi] =
          static_cast<double>(m[hr]) + log(static_cast<double>(l[hr]));
    }
  }
  __syncwarp();
  tc::store_rows<LD>(static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh, p.o_sn, stage, 16,
                     q0 + warp * 16, p.nq, p.dv, p.o_vec, lane, 32);
}

cudaError_t prepare(const void* fn, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int JMAX>
cudaError_t launch_j(const Params& p, int batch, int heads, size_t bytes, cudaStream_t stream) {
  cudaError_t err = prepare(reinterpret_cast<const void*>(&bias_fwd_kernel<float, JMAX>), bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.nq + BQ - 1) / BQ, heads, batch);
  bias_fwd_kernel<float, JMAX><<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_fp32(const Params& p, int batch, int heads, cudaStream_t stream) {
  const size_t bytes = smem_floats(p.dqk, p.dv) * sizeof(float);
  if (p.dqk > MAX_WIDTH || p.dv > MAX_WIDTH || bytes > MAX_SMEM) return cudaErrorInvalidValue;
  switch (jmax_for(p.dv)) {
    case 2: return launch_j<2>(p, batch, heads, bytes, stream);
    case 4: return launch_j<4>(p, batch, heads, bytes, stream);
    case 6: return launch_j<6>(p, batch, heads, bytes, stream);
    default: return launch_j<8>(p, batch, heads, bytes, stream);
  }
}

// the padded width the tensor-core kernel's registers are sized for
inline int tc_dmax(int dqk, int dv) {
  const int d = tc::round16(dqk) > tc::round16(dv) ? tc::round16(dqk) : tc::round16(dv);
  return d <= 64 ? 64 : 128;
}

template <int DMAX>
cudaError_t launch_tc_d(const Params& p, int batch, int heads, cudaStream_t stream) {
  const size_t bytes = tc_smem_bytes(DMAX);
  cudaError_t err = prepare(reinterpret_cast<const void*>(&bias_fwd_tc_kernel<DMAX>), bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.nq + TC_BQ - 1) / TC_BQ, heads, batch);
  bias_fwd_tc_kernel<DMAX><<<grid, TC_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const Params& p, int batch, int heads, cudaStream_t stream) {
  const int dmax = tc_dmax(p.dqk, p.dv);
  if (p.dqk > MAX_WIDTH || p.dv > MAX_WIDTH || tc_smem_bytes(dmax) > MAX_SMEM) {
    return cudaErrorInvalidValue;
  }
  return dmax == 64 ? launch_tc_d<64>(p, batch, heads, stream)
                    : launch_tc_d<128>(p, batch, heads, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 for q, k, v and o; bias_bf16: the bias's
// type. Returns a cudaError_t.
int ecf_bias_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, const void* bias, void* o,
    double* lse, int batch, int heads, int nq, int nk, int dqk, int dv, int bias_bf16,
    int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn,
    int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t o_sb, int64_t o_sh, int64_t o_sn,
    int64_t bias_sb, int64_t bias_sh, int64_t bias_sn, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || nq <= 0 || nk <= 0 || dqk <= 0 || dv <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q, k, v, bias, o, lse, nq, nk, dqk, dv, bias_bf16,
           q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn,
           bias_sb, bias_sh, bias_sn, scale,
           tc::vec16(q, q_sb, q_sh, q_sn, dqk), tc::vec16(k, k_sb, k_sh, k_sn, dqk),
           tc::vec16(v, v_sb, v_sh, v_sn, dv), tc::vec16(o, o_sb, o_sh, o_sn, dv)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_fp32(p, batch, heads, s));
  if (dtype == 1) return static_cast<int>(launch_bf16(p, batch, heads, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory a block of the route for `dtype` takes at these
// widths, in bytes (ptxas reports none: it is sized at launch).
long long ecf_bias_attention_fwd_smem(int dtype, int dqk, int dv) {
  if (dtype == 1) return static_cast<long long>(tc_smem_bytes(tc_dmax(dqk, dv)));
  return static_cast<long long>(smem_floats(dqk, dv) * sizeof(float));
}

const char* ecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
