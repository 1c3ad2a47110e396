// Attention with an additive bias, forward pass, for sm_90a.
//
// Replaces the TPU kernels efficientconformer_tpu/ops/pallas_attention.py:
// _kernel (launched by _fused_forward, the whole (b, h) block in VMEM) and
// _flash_kernel (launched by _flash_forward, keys tiled with an online
// softmax). One key-tiled kernel covers both. Per (batch, head) it computes
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
// H 12, N <= 101, dh 64) the bytes are q, k, v and o in bf16 (about 40 MB)
// and the fp32 bias (about 31 MB), 0.021 ms at 3.35 TB/s; the product work is
// about 4 GFLOP, 0.004 ms on the bf16 tensor cores. So the bound is the
// bytes, and above all the bias, which the kernel reads exactly once.
//
// What the design does about it: one thread block per (64 query rows, head,
// batch), 1,536 blocks at the LM shape. The q tile sits in shared memory
// feature-major (4 rows are one 16-byte load); keys and values stream in
// tiles of 64. Each thread owns a 4 x 4 tile of scores: per feature one
// 16-byte and four 4-byte shared-memory loads feed 16 fp32 FMAs. The bias is
// read once, straight from device memory, through its own strides: a
// broadcast (B|1, H|1, Nq|1, Nk) bias or a key mask is never expanded, and
// 16 neighbouring threads read 16 neighbouring keys of one row. The online
// softmax (running max, denominator) and each thread's 4-row slice of the
// output accumulator live in registers, so no (N, Nk) tensor exists. Keys
// past Nk (the tile's ragged edge) are excluded outright (-inf, probability
// exactly 0), so a row whose real keys all carry the -1e9 mask averages over
// the real keys only, as the plain version does. Tensor cores (mma/wgmma)
// and TMA are later work.
//
// Inputs: q, k, v of type T (float or bf16) with arbitrary batch/head/row
// strides and unit feature stride; bias fp32 or bf16 with unit key stride and
// (batch, head, row) strides that are 0 along broadcast axes, or null. The
// kernel allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <typename T, int JMAX>
cudaError_t launch_j(const Params& p, int batch, int heads, size_t bytes, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(&bias_fwd_kernel<T, JMAX>);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.nq + BQ - 1) / BQ, heads, batch);
  bias_fwd_kernel<T, JMAX><<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  const size_t bytes = smem_floats(p.dqk, p.dv) * sizeof(float);
  if (p.dqk > MAX_WIDTH || p.dv > MAX_WIDTH || bytes > MAX_SMEM) return cudaErrorInvalidValue;
  switch (jmax_for(p.dv)) {
    case 2: return launch_j<T, 2>(p, batch, heads, bytes, stream);
    case 4: return launch_j<T, 4>(p, batch, heads, bytes, stream);
    case 6: return launch_j<T, 6>(p, batch, heads, bytes, stream);
    default: return launch_j<T, 8>(p, batch, heads, bytes, stream);
  }
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
