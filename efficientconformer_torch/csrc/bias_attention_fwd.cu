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
//     bank group), copied with 16-byte cp.async: every row is 16-byte
//     aligned (the entry point refuses other rows; the wrapper pads widths
//     such as 135 and 90 to a multiple of 8), and widths are zero-padded to
//     16 in shared memory. Keys
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
// Widths up to 256 (bf16: padded to 16) on both routes as above. The FMA
// kernel holds up to 16 output columns a thread (219 KB of shared memory at
// 256). The tensor-core kernel is instantiated at padded widths 64, 128,
// 144 and 256; at 256 its 64 fp32 accumulators a thread cover 128 output
// columns, so two blocks share a query tile, each forming the same S and
// its own half of O, and q's fragments are read from shared memory at each
// key tile.
//
// Past 256 the TPU kernels go on as before (they pad dqk and dv to 128
// lanes and take any width that fits VMEM), but here neither the rows of q,
// k and v whole in shared memory nor 16 output columns a thread fit any
// more. The chunked kernels take every wider width, dqk and dv
// independently, at no more shared memory than at 256:
//   * bf16, bias_fwd_tc_chunked_kernel: S = q k^T streamed in chunks of 64
//     features (a q chunk of the block's 64 rows and a k chunk of the key
//     tile, double-buffered with cp.async), the online softmax as above,
//     and O in column groups of 128: each group is a block of its own that
//     forms the same S (the 256 kernel's split, generalised) and reads only
//     its group's columns of V. 64 KB a block at any width. Score products
//     per (row, key) pair: dqk x ceil(dv / 128).
//   * fp32, two kernels on bias_fma.cuh's register-tiled 64 x 64 tiles (a
//     thread's 8 x 4 micro-tile of FMAs, operands through a 3-stage
//     cp.async ring), which form S once per (query tile, key tile) whatever
//     dv is: score products per (row, key) pair dqk, then dv for O.
//     bias_fwd_chunked_scores_kernel, a block per tile pair, forms S over
//     chunks of 32 features and writes E = exp(S - m) (m the row's max over
//     the tile's keys) into an fp32 scratch the wrapper allocates, 64 x 64
//     floats a tile pair (8.7 MB at the causal 4-head Large's serving
//     window, B 32 x H 4 x N 118; ~3 us at 3.35 TB/s), with each row's m and
//     sum of E. bias_fwd_chunked_out_kernel, a block per (query tile, 64
//     output columns), reads the query tile's E tiles and v's rows over the
//     keys in chunks of 32, and folds each key tile's product in with its
//     rows' weight exp(m - M) / L (M, L over all keys, from the tiles'
//     statistics), so O comes out normalised; it writes the LSE. 54 KB and
//     50 KB a block at any width. The scratch traded a recomputed S for an
//     (Nq, Nk) round trip: S costs dqk / 128 of a 128-column group's product
//     (2.1x at 270, 8x at 1,024), so recomputing it per group (PR 20's
//     kernel) did 2x-4.5x the products at those widths.
// What bounds them at the encoders' shapes (head 270 at N 118-134): bf16
// the bytes (q, k, v, O and the fp32 bias ~40 MB a call at 32 slots x 4
// heads, 0.012 ms at 3.35 TB/s); fp32 the products (2 B H Nq Nk (dqk + dv)
// FLOP, 0.0215-0.1090 ms at 67 TFLOP/s over 270-1,024 at that window).
//
// Every kernel reads the bias once, through its own strides: a broadcast
// (B|1, H|1, Nq|1, Nk) bias or a key mask is never expanded. Keys past Nk
// (the tile's ragged edge) are excluded outright (-inf, probability exactly
// 0), so a row whose real keys all carry the -1e9 mask averages over the real
// keys only, as the plain version does. No (N, Nk) tensor reaches device
// memory but the fp32 chunked route's scratch.
//
// Inputs: q, k, v of type T (float for the FMA kernels, bf16 for the
// tensor-core ones) with arbitrary batch/head/row strides and unit feature
// stride; bias fp32 or bf16 with unit key stride and
// (batch, head, row) strides that are 0 along broadcast axes, or null; the
// fp32 chunked route's scratch (ecf_bias_attention_fwd_work). The kernels
// allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bias_fma.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 256;   // a 16 x 16 grid: ty owns 4 rows, tx 4 key columns
constexpr int LDQ = BQ + 4;     // qT row stride: [feature][query row], 16-byte rows
constexpr int LDP = BQ + 4;     // psT row stride: [key][query row], 16-byte rows
constexpr int LDK = BK + 1;     // kT row stride: [feature][key], odd for the stores
constexpr int WHOLE_WIDTH = 256;   // widest dqk and dv the kernels that hold a row whole take
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
};

__device__ __forceinline__ float load_bias(const Params& p, int64_t off) {
  return p.bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[off])
                     : static_cast<const float*>(p.bias)[off];
}

// output columns per thread: dv <= 16 * jmax
__host__ __device__ inline int jmax_for(int d) {
  return d <= 32 ? 2 : d <= 64 ? 4 : d <= 96 ? 6 : d <= 128 ? 8 : d <= 192 ? 12 : 16;
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
  return static_cast<size_t>(TC_BQ + 2 * TC_STAGES * TC_BK) * (dmax + 8) * sizeof(tc::bf16) +
         TC_STAGES * static_cast<size_t>(TC_BQ) * TC_LDB * sizeof(float);
}

// DMAX: the padded head width of the shared tiles (64, 128, 144 or 256); the
// loops over features stop at the real widths rounded up to 16. DOUT: the
// output columns a block accumulates in registers (DMAX, or 128 at 256: 64
// fp32 accumulators a thread, not 128). Past DOUT the grid carries
// ceil(dv / DOUT) blocks per query tile, each computing the same S and
// softmax and its own DOUT columns of O; the first writes the LSE. At
// DMAX 256 the q fragments are read from shared memory at each key tile
// instead of being held in registers.
template <int DMAX, int DOUT>
__global__ void __launch_bounds__(TC_THREADS) bias_fwd_tc_kernel(Params p, int nsplit) {
  using tc::bf16;
  constexpr int LD = DMAX + 8;    // shared row stride, elements (16 bytes of padding)
  constexpr int NT = TC_BK / 8;   // 8-key tiles of a score tile
  constexpr int DK = DMAX / 16;   // 16-wide feature steps
  constexpr int DO = DOUT / 16;   // 16-wide output column steps a block owns
  constexpr bool QREG = DMAX <= 144;  // q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);           // [TC_BQ][LD]
  bf16* ks = qs + TC_BQ * LD;                              // [TC_STAGES][TC_BK][LD]
  bf16* vs = ks + TC_STAGES * TC_BK * LD;                  // [TC_STAGES][TC_BK][LD]
  float* bs = reinterpret_cast<float*>(vs + TC_STAGES * TC_BK * LD);  // [TC_STAGES][TC_BQ][TC_LDB]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int split = blockIdx.x % nsplit, nb = split * DO;   // first output column step
  const int q0 = (blockIdx.x / nsplit) * TC_BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int64_t bias_bh = b * p.bias_sb + h * p.bias_sh;
  const int kq = tc::round16(p.dqk) >> 4, nv = tc::round16(p.dv) >> 4;
  const int ntiles = (p.nk + TC_BK - 1) / TC_BK;

  auto load_keys = [&](int t) {
    const int buf = t % TC_STAGES, k0 = t * TC_BK;
    tc::load_tile<TC_BK, LD, DMAX, TC_THREADS>(ks + buf * TC_BK * LD, kp, p.k_sn, k0, p.nk,
                                               p.dqk);
    tc::load_tile<TC_BK, LD, DMAX, TC_THREADS>(vs + buf * TC_BK * LD, vp, p.v_sn, k0, p.nk,
                                               p.dv);
    if (p.bias) {
      tc::load_bias_tile<TC_BQ, TC_BK, TC_LDB, TC_THREADS>(
          bs + buf * TC_BQ * TC_LDB, p.bias, p.bias_bf16, bias_bh, p.bias_sn, q0, k0, p.nq, p.nk);
    }
  };

  // 1. copies in flight: the q tile with key tile 0, then the next tiles
  //    up to one short of the ring
  tc::load_tile<TC_BQ, LD, DMAX, TC_THREADS>(
      qs, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_sn, q0, p.nq, p.dqk);
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < ntiles) load_keys(st);
    tc::cp_async_commit();
  }

  float o[2 * DO][4];
#pragma unroll
  for (int j = 0; j < 2 * DO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8 of the warp
  uint32_t qf[QREG ? DK : 1][4];
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
    if (QREG && t == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        if (kk < kq) tc::ldsm_x4(qf[QREG ? kk : 0], q_a + tc::blk<LD>(0, kk));
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
        const int qk = QREG ? kk : 0;
        if (!QREG) tc::ldsm_x4(qf[0], q_a + tc::blk<LD>(0, kk));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          tc::ldsm_x4(bf, kt_b + tc::blk<LD>(np, kk));
          tc::mma_bf16(s[2 * np], qf[qk], bf[0], bf[1]);
          tc::mma_bf16(s[2 * np + 1], qf[qk], bf[2], bf[3]);
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
      for (int j = 0; j < 2 * DO; ++j) {
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
      for (int n2 = 0; n2 < DO; ++n2) {
        if (nb + n2 < nv) {
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, vt_bt + tc::blk<LD>(kk, nb + n2));
          tc::mma_bf16(o[2 * n2], a, bf[0], bf[1]);
          tc::mma_bf16(o[2 * n2 + 1], a, bf[2], bf[3]);
        }
      }
    }
  }

  // 3. normalise; this block's columns of O through the warp's own rows of
  //    the q tile (no other warp reads them) to whole-row stores; the LSE
  //    in fp64, from the first block of the query tile
  const int col0 = nb * 16;
  bf16* stage = qs + warp * 16 * LD;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const float inv = 1.f / l[hr];
#pragma unroll
    for (int j = 0; j < 2 * DO; ++j) {
      if (nb * 2 + j < 2 * nv) {
        *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8 * hr) * LD + col0 + j * 8 + 2 * c) =
            __floats2bfloat162_rn(o[j][2 * hr] * inv, o[j][2 * hr + 1] * inv);
      }
    }
    const int qi = q0 + r0 + 8 * hr;
    if (split == 0 && c == 0 && qi < p.nq) {
      p.lse[(static_cast<int64_t>(b) * gridDim.y + h) * p.nq + qi] =
          static_cast<double>(m[hr]) + log(static_cast<double>(l[hr]));
    }
  }
  __syncwarp();
  const int width = p.dv - col0 < DOUT ? p.dv - col0 : DOUT;
  tc::store_rows<LD>(static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh + col0, p.o_sn,
                     stage + col0, 16, q0 + warp * 16, p.nq, width, lane, 32);
}

// ------------------------------------------- past a width of 256: chunked

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// the padded width the tensor-core kernels see: the wider of dqk and dv,
// each rounded up to 16
__host__ __device__ inline int tc_width(int dqk, int dv) {
  return tc::round16(dqk) > tc::round16(dv) ? tc::round16(dqk) : tc::round16(dv);
}
__host__ __device__ inline bool tc_chunked(int dqk, int dv) { return tc_width(dqk, dv) > WHOLE_WIDTH; }
__host__ __device__ inline bool fma_chunked(int dqk, int dv) { return dqk > WHOLE_WIDTH || dv > WHOLE_WIDTH; }

constexpr int CK_KC = 64;            // features of a streamed chunk of q and k
constexpr int CK_LDC = CK_KC + 8;    // its bf16 row stride (16 bytes of padding)
constexpr int CK_DOUT = 128;         // output columns a block owns: a column group
constexpr int CK_LDG = CK_DOUT + 8;  // bf16 row stride of a column group's tile
constexpr int CK_STAGES = 2;         // chunk stages in the ring

// bf16 (2 bytes): the ring of (q chunk [64][LDC], k chunk [32][LDC])
// stages, and for two key tiles the V column group [32][LDG] and the fp32
// bias tile
constexpr size_t TC_CK_SMEM = static_cast<size_t>(CK_STAGES) * (TC_BQ + TC_BK) * CK_LDC * 2 +
                              2 * (static_cast<size_t>(TC_BK) * CK_LDG * 2 +
                                   static_cast<size_t>(TC_BQ) * TC_LDB * sizeof(float));

// O in column groups of CK_DOUT, nsplit blocks a query tile; the first
// writes the LSE. The steps of the ring walk (key tile t, chunk c): a
// step's q and k chunks land while the previous step's products run; the
// first chunk of a tile also brings its V group and bias tile, into the
// tile's own buffers (t & 1), which the tile's last step reads.
__global__ void __launch_bounds__(TC_THREADS) bias_fwd_tc_chunked_kernel(Params p, int nsplit) {
  using tc::bf16;
  constexpr int NT = TC_BK / 8, DO = CK_DOUT / 16;
  constexpr uint32_t STAGE = (TC_BQ + TC_BK) * CK_LDC * 2, VBUF = TC_BK * CK_LDG * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);               // [STAGES][q | k]
  bf16* vg = ring + CK_STAGES * (TC_BQ + TC_BK) * CK_LDC;      // [2][TC_BK][LDG]
  float* bs = reinterpret_cast<float*>(vg + 2 * TC_BK * CK_LDG);  // [2][TC_BQ][TC_LDB]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int split = blockIdx.x % nsplit, col0 = split * CK_DOUT;
  const int q0 = (blockIdx.x / nsplit) * TC_BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int64_t bias_bh = b * p.bias_sb + h * p.bias_sh;
  const int nchunks = (p.dqk + CK_KC - 1) / CK_KC;
  const int nsteps = (p.nk + TC_BK - 1) / TC_BK * nchunks;
  const int nv = imin(tc::round16(p.dv) - col0, CK_DOUT) >> 4;   // the group's 16-column steps

  auto load_step = [&](int s) {
    const int t = s / nchunks, f0 = (s - t * nchunks) * CK_KC, k0 = t * TC_BK;
    bf16* st = ring + (s % CK_STAGES) * (TC_BQ + TC_BK) * CK_LDC;
    tc::load_tile<TC_BQ, CK_LDC, CK_KC, TC_THREADS>(st, qp + f0, p.q_sn, q0, p.nq, p.dqk - f0);
    tc::load_tile<TC_BK, CK_LDC, CK_KC, TC_THREADS>(st + TC_BQ * CK_LDC, kp + f0, p.k_sn, k0,
                                                    p.nk, p.dqk - f0);
    if (f0 == 0) {
      tc::load_tile<TC_BK, CK_LDG, CK_DOUT, TC_THREADS>(vg + (t & 1) * TC_BK * CK_LDG, vp + col0,
                                                        p.v_sn, k0, p.nk, p.dv - col0);
      if (p.bias) {
        tc::load_bias_tile<TC_BQ, TC_BK, TC_LDB, TC_THREADS>(
            bs + (t & 1) * TC_BQ * TC_LDB, p.bias, p.bias_bf16, bias_bh, p.bias_sn, q0, k0, p.nq,
            p.nk);
      }
    }
  };

  load_step(0);
  tc::cp_async_commit();
  float o[2 * DO][4];
#pragma unroll
  for (int j = 0; j < 2 * DO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8 of the warp
  float s[NT][4];
  const int r0 = warp * 16 + g;
  const uint32_t q_a = tc::a_lane<CK_LDC>(ring + warp * 16 * CK_LDC, lane);
  const uint32_t k_b = tc::b_lane<CK_LDC>(ring + TC_BQ * CK_LDC, lane);
  const uint32_t v_bt = tc::bt_lane<CK_LDG>(vg, lane);

  for (int step = 0; step < nsteps; ++step) {
    tc::cp_async_wait<0>();   // this step's chunks (and at a tile's first, its V and bias)
    __syncthreads();          // ... for every thread; every warp is done with the last step
    if (step + 1 < nsteps) load_step(step + 1);
    tc::cp_async_commit();
    const int t = step / nchunks, f0 = (step - t * nchunks) * CK_KC;
    if (f0 == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
    // S += q k^T over this chunk, 16 rows x 32 keys a warp
    const uint32_t st = (step % CK_STAGES) * STAGE;
    tc::mma_rows<CK_LDC, NT, CK_KC / 16>(s, q_a + st, k_b + st,
                                          imin(tc::round16(p.dqk - f0), CK_KC) >> 4);
    if (f0 + CK_KC < p.dqk) continue;

    // scale and bias, in the accumulator's layout; keys past Nk excluded
    // outright. Rows past Nq keep a finite score (never written).
    const int k0 = t * TC_BK;
    const float* bt = bs + (t & 1) * TC_BQ * TC_LDB;
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
      for (int j = 0; j < 2 * DO; ++j) {
        o[j][2 * hr] *= alpha;
        o[j][2 * hr + 1] *= alpha;
      }
    }
    // O += P v over the group's columns, P as bf16 A fragments from the registers
    tc::mma_pv<CK_LDG, NT, DO>(o, s, v_bt + (t & 1) * VBUF, nv);
  }

  // normalise; the group's columns of O staged through the warp's own rows
  // of the ring (free once every warp is done with it) to whole-row
  // stores; the LSE in fp64, from the first block of the query tile
  tc::cp_async_wait<0>();
  __syncthreads();
  bf16* stage = ring + warp * 16 * CK_LDG;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const float inv = 1.f / l[hr];
#pragma unroll
    for (int j = 0; j < 2 * DO; ++j) {
      if (j < 2 * nv) {
        *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8 * hr) * CK_LDG + j * 8 + 2 * c) =
            __floats2bfloat162_rn(o[j][2 * hr] * inv, o[j][2 * hr + 1] * inv);
      }
    }
    const int qi = q0 + r0 + 8 * hr;
    if (split == 0 && c == 0 && qi < p.nq) {
      p.lse[(static_cast<int64_t>(b) * gridDim.y + h) * p.nq + qi] =
          static_cast<double>(m[hr]) + log(static_cast<double>(l[hr]));
    }
  }
  __syncwarp();
  tc::store_rows<CK_LDG>(static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh + col0, p.o_sn, stage,
                         16, q0 + warp * 16, p.nq, imin(p.dv - col0, CK_DOUT), lane, 32);
}

// fp32 past WHOLE_WIDTH (bias_fma.cuh's tiles): the scores kernel's ring,
// and the output kernel's with each row's max and 1 / sum over all keys
constexpr size_t FC_SCORES_SMEM = bfma::SCORES_RING;
constexpr size_t FC_OUT_SMEM = bfma::PRODUCT_RING + 2 * bfma::T * sizeof(float);
static_assert(TC_CK_SMEM <= MAX_SMEM && FC_SCORES_SMEM <= MAX_SMEM && FC_OUT_SMEM <= MAX_SMEM &&
                  tc_smem_bytes(WHOLE_WIDTH) <= MAX_SMEM,
              "every route's block fits the 227 KB a block may use");

// fp32 past WHOLE_WIDTH, first kernel: a block per (query tile, key tile,
// head, batch) forms S = q k^T * scale + bias over its 64 x 64 tile pair,
// once, in chunks of KC features, and writes E = exp(S - m) key-major
// ([key][row], the output kernel's depth-major operand) into the pair's
// scratch tile, m the row's max over the tile's keys, with each row's m and
// sum of E (stats, [key tile][row]). Keys past Nk give E = 0; a row whose
// keys in the tile all score -inf gives m = -inf and E = 0 (no NaN).
__global__ void __launch_bounds__(bfma::THREADS) bias_fwd_chunked_scores_kernel(Params p,
                                                                                float* work) {
  using bfma::KC;
  using bfma::LDT;
  using bfma::T;
  extern __shared__ __align__(16) float smem[];
  const int ntq = bfma::tiles(p.nq), ntk = bfma::tiles(p.nk);
  const int qt = blockIdx.x / ntk, kt = blockIdx.x - qt * ntk;
  const int q0 = qt * T, k0 = kt * T, h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * gridDim.y + h;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int nsteps = (p.dqk + KC - 1) / KC;
  auto load = [&](int s, int st) {
    float* d = smem + st * 2 * KC * LDT;
    bfma::load_t(d, qp, p.q_sn, q0, p.nq, s * KC, p.dqk);
    bfma::load_t(d + KC * LDT, kp, p.k_sn, k0, p.nk, s * KC, p.dqk);
  };
  bfma::ring_start(nsteps, load);
  bfma::ring_run(nsteps, load, [&](int, int st) {
    const float* d = smem + st * 2 * KC * LDT;
    bfma::fma_chunk<LDT, LDT>(acc, d + 8 * ty, d + KC * LDT + 4 * tx);
  });

  // scale and bias; the row's max and sum over the tile's keys, over the
  // 16 threads (a half-warp) that share its rows
  float* wb = work + bh * bfma::fwd_work(p.nq, p.nk);
  float2* stats = reinterpret_cast<float2*>(wb + static_cast<int64_t>(ntq) * ntk * bfma::TILE) +
                  static_cast<int64_t>(kt) * ntq * T;
  const int64_t bias_bh = b * p.bias_sb + h * p.bias_sh;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + 8 * ty + i;
    const bool row_ok = qi < p.nq;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + 4 * tx + j;
      float sc = -INFINITY;
      if (kj < p.nk) {
        const float bv = (p.bias && row_ok) ? load_bias(p, bias_bh + qi * p.bias_sn + kj) : 0.f;
        sc = acc[i][j] * p.scale + bv;
      }
      acc[i][j] = sc;
      mx = fmaxf(mx, sc);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = expf(acc[i][j] - m_use);
      sum += acc[i][j];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (tx == 0) stats[q0 + 8 * ty + i] = make_float2(mx, sum);
  }
  bfma::put_tile(wb + (static_cast<int64_t>(qt) * ntk + kt) * bfma::TILE, acc, true);
}

// fp32 past WHOLE_WIDTH, second kernel: a block per (query tile, column
// tile of 64, head, batch) forms its 64 x 64 tile of O from the query
// tile's E tiles and v's rows, in chunks of KC keys. The rows' max M and sum
// L over all keys come from the stats first (M the max of the tiles' m, L
// the sum of their sums times exp(m - M), in key-tile order); each key
// tile's partial product is folded in as O += exp(m - M) / L (E v), so O
// comes out normalised. The first column tile writes the LSE, M + log L in
// fp64.
__global__ void __launch_bounds__(bfma::THREADS) bias_fwd_chunked_out_kernel(Params p,
                                                                             const float* work,
                                                                             int vec) {
  using bfma::KC;
  using bfma::LDX;
  using bfma::T;
  extern __shared__ __align__(16) float smem[];
  float* row_max = smem + bfma::PRODUCT_RING / sizeof(float);   // [T]
  float* row_inv = row_max + T;                                  // [T]: 1 / L
  const int ntq = bfma::tiles(p.nq), ntk = bfma::tiles(p.nk), nct = bfma::tiles(p.dv);
  const int qt = blockIdx.x / nct, ct = blockIdx.x - qt * nct;
  const int q0 = qt * T, c0 = ct * T, h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * gridDim.y + h;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* wb = work + bh * bfma::fwd_work(p.nq, p.nk);
  const float* et = wb + static_cast<int64_t>(qt) * ntk * bfma::TILE;   // its key tiles in turn
  const float2* stats = reinterpret_cast<const float2*>(wb + static_cast<int64_t>(ntq) * ntk *
                                                                 bfma::TILE) + q0;
  const int64_t stat_step = static_cast<int64_t>(ntq) * T;   // from one key tile's to the next

  const int nsteps = ntk * (T / KC);
  auto load = [&](int s, int st) {
    float* d = smem + st * KC * (T + LDX);
    const int t = s / (T / KC), d0 = (s - t * (T / KC)) * KC;
    bfma::load_a(d, et + static_cast<int64_t>(t) * bfma::TILE + d0 * T);
    bfma::load_x(d + KC * T, vp, p.v_sn, t * T + d0, p.nk, c0, p.dv, vec);
  };
  bfma::ring_start(nsteps, load);

  // the rows' M and L while the first chunks land (the ring's first barrier
  // publishes them)
  if (tid < T) {
    float mx = -INFINITY, l = 0.f;
    for (int t = 0; t < ntk; ++t) mx = fmaxf(mx, stats[t * stat_step + tid].x);
    for (int t = 0; t < ntk; ++t) {
      const float2 ml = stats[t * stat_step + tid];
      l += ml.y * expf(ml.x - mx);
    }
    row_max[tid] = mx;
    row_inv[tid] = 1.f / l;
    if (ct == 0 && q0 + tid < p.nq) {
      p.lse[bh * p.nq + q0 + tid] = static_cast<double>(mx) + log(static_cast<double>(l));
    }
  }

  float acc[8][4], part[8][4], m_t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  bfma::ring_run(nsteps, load, [&](int s, int st) {
    const float* d = smem + st * KC * (T + LDX);
    if (s % (T / KC) == 0) {   // a key tile's first chunk: its rows' m, read ahead of the fold
      const float2* st_t = stats + (s / (T / KC)) * stat_step + 8 * ty;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        m_t[i] = st_t[i].x;
        part[i][0] = part[i][1] = part[i][2] = part[i][3] = 0.f;
      }
    }
    bfma::fma_chunk<T, LDX>(part, d + 8 * ty, d + KC * T + 4 * tx);
    if (s % (T / KC) == T / KC - 1) {   // its last chunk: fold its product in
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 8 * ty + i;
        const float g = expf(m_t[i] - row_max[r]) * row_inv[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(g, part[i][j], acc[i][j]);
      }
    }
  });
  bfma::store_tile(static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh, p.o_sn, q0, p.nq, c0,
                   p.dv, 1.f, acc);
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

// the bf16 chunked kernel, nsplit column groups a query tile
cudaError_t launch_tc_chunked(const Params& p, int batch, int heads, cudaStream_t stream) {
  cudaError_t err = prepare(reinterpret_cast<const void*>(&bias_fwd_tc_chunked_kernel), TC_CK_SMEM);
  if (err != cudaSuccess) return err;
  const int nsplit = (p.dv + CK_DOUT - 1) / CK_DOUT;
  const dim3 grid((p.nq + TC_BQ - 1) / TC_BQ * nsplit, heads, batch);
  bias_fwd_tc_chunked_kernel<<<grid, TC_THREADS, TC_CK_SMEM, stream>>>(p, nsplit);
  return cudaGetLastError();
}

// fp32 past WHOLE_WIDTH: the scores kernel over every tile pair, then the
// output kernel (same stream, so it reads the scratch complete)
cudaError_t launch_fp32_chunked(const Params& p, float* work, int batch, int heads,
                                cudaStream_t stream) {
  const int ntq = bfma::tiles(p.nq), ntk = bfma::tiles(p.nk);
  cudaError_t err =
      prepare(reinterpret_cast<const void*>(&bias_fwd_chunked_scores_kernel), FC_SCORES_SMEM);
  if (err != cudaSuccess) return err;
  bias_fwd_chunked_scores_kernel<<<dim3(ntq * ntk, heads, batch), bfma::THREADS, FC_SCORES_SMEM,
                                   stream>>>(p, work);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = prepare(reinterpret_cast<const void*>(&bias_fwd_chunked_out_kernel), FC_OUT_SMEM);
  if (err != cudaSuccess) return err;
  const int vec = bfma::vec_floats(p.v, p.v_sb, p.v_sh, p.v_sn, p.dv);
  bias_fwd_chunked_out_kernel<<<dim3(ntq * bfma::tiles(p.dv), heads, batch), bfma::THREADS,
                                FC_OUT_SMEM, stream>>>(p, work, vec);
  return cudaGetLastError();
}

cudaError_t launch_fp32(const Params& p, float* work, int batch, int heads,
                        cudaStream_t stream) {
  if (fma_chunked(p.dqk, p.dv)) return launch_fp32_chunked(p, work, batch, heads, stream);
  const size_t bytes = smem_floats(p.dqk, p.dv) * sizeof(float);
  switch (jmax_for(p.dv)) {
    case 2: return launch_j<2>(p, batch, heads, bytes, stream);
    case 4: return launch_j<4>(p, batch, heads, bytes, stream);
    case 6: return launch_j<6>(p, batch, heads, bytes, stream);
    case 8: return launch_j<8>(p, batch, heads, bytes, stream);
    case 12: return launch_j<12>(p, batch, heads, bytes, stream);
    default: return launch_j<16>(p, batch, heads, bytes, stream);
  }
}

// the padded width of the tensor-core kernel's shared tiles, up to WHOLE_WIDTH
inline int tc_dmax(int dqk, int dv) {
  const int d = tc_width(dqk, dv);
  return d <= 64 ? 64 : d <= 128 ? 128 : d <= 144 ? 144 : 256;
}

template <int DMAX, int DOUT>
cudaError_t launch_tc_d(const Params& p, int batch, int heads, cudaStream_t stream) {
  const size_t bytes = tc_smem_bytes(DMAX);
  const void* fn = reinterpret_cast<const void*>(&bias_fwd_tc_kernel<DMAX, DOUT>);
  cudaError_t err = prepare(fn, bytes);
  if (err != cudaSuccess) return err;
  const int nsplit = (tc::round16(p.dv) + DOUT - 1) / DOUT;
  const dim3 grid((p.nq + TC_BQ - 1) / TC_BQ * nsplit, heads, batch);
  bias_fwd_tc_kernel<DMAX, DOUT><<<grid, TC_THREADS, bytes, stream>>>(p, nsplit);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const Params& p, int batch, int heads, cudaStream_t stream) {
  if (tc_chunked(p.dqk, p.dv)) {
    return launch_tc_chunked(p, batch, heads, stream);
  }
  switch (tc_dmax(p.dqk, p.dv)) {
    case 64: return launch_tc_d<64, 64>(p, batch, heads, stream);
    case 128: return launch_tc_d<128, 128>(p, batch, heads, stream);
    case 144: return launch_tc_d<144, 144>(p, batch, heads, stream);
    default: return launch_tc_d<256, 128>(p, batch, heads, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 for q, k, v and o; bias_bf16: the bias's
// type; work: fp32 scratch of ecf_bias_attention_fwd_work floats per (batch,
// head), or null when that is 0. Returns a cudaError_t.
int ecf_bias_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, const void* bias, void* o,
    double* lse, float* work, int batch, int heads, int nq, int nk, int dqk, int dv,
    int bias_bf16,
    int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn,
    int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t o_sb, int64_t o_sh, int64_t o_sn,
    int64_t bias_sb, int64_t bias_sh, int64_t bias_sn, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || nq <= 0 || nk <= 0 || dqk <= 0 || dv <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q, k, v, bias, o, lse, nq, nk, dqk, dv, bias_bf16,
           q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn,
           bias_sb, bias_sh, bias_sn, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && fma_chunked(dqk, dv) && work == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return static_cast<int>(launch_fp32(p, work, batch, heads, s));
  // the tensor-core kernels copy rows in 16-byte pieces only
  const bool rows16 = tc::vec16(q, q_sb, q_sh, q_sn, dqk) && tc::vec16(k, k_sb, k_sh, k_sn, dqk) &&
                      tc::vec16(v, v_sb, v_sh, v_sn, dv) && tc::vec16(o, o_sb, o_sh, o_sn, dv);
  if (dtype == 1 && rows16) return static_cast<int>(launch_bf16(p, batch, heads, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel the route for `dtype` runs at these widths: 0 the FMA kernel,
// 1 the chunked FMA kernel (fp32); 2 the tensor-core kernel, 3 the chunked
// tensor-core kernel (bf16).
int ecf_bias_attention_fwd_route(int dtype, int dqk, int dv) {
  if (dtype == 1 && tc_chunked(dqk, dv)) return 3;
  if (dtype == 1) return 2;
  if (fma_chunked(dqk, dv)) return 1;
  return 0;
}

// Dynamic shared memory a block of that route's (first) kernel takes at
// these widths, in bytes (ptxas reports none: it is sized at launch).
size_t ecf_bias_attention_fwd_smem(int dtype, int dqk, int dv) {
  if (dtype == 1 && tc_chunked(dqk, dv)) return TC_CK_SMEM;
  if (dtype == 1) return tc_smem_bytes(tc_dmax(dqk, dv));
  if (fma_chunked(dqk, dv)) return FC_SCORES_SMEM;
  return smem_floats(dqk, dv) * sizeof(float);
}

// ... and of its second kernel (0: the route runs one)
size_t ecf_bias_attention_fwd_out_smem(int dtype, int dqk, int dv) {
  if (dtype == 0 && fma_chunked(dqk, dv)) return FC_OUT_SMEM;
  return 0;
}

// fp32 scratch the route takes per (batch, head), in floats (0: none)
size_t ecf_bias_attention_fwd_work(int dtype, int nq, int nk, int dqk, int dv) {
  if (dtype == 0 && fma_chunked(dqk, dv)) return bfma::fwd_work(nq, nk);
  return 0;
}

const char* ecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
