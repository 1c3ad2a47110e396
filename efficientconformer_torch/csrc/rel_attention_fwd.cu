// Fused factorized relative-position attention, forward pass, for sm_90a.
//
// Replaces the TPU kernel efficientconformer_tpu/ops/pallas_rel_attention.py:
// _fwd_kernel (launched by _forward). Per (batch, head) it computes
//
//     qv     = qu + delta_h
//     [P|Q]  = qv W_h                               (W_h: dh x 2hd)
//     A      = [sin*P + cos*Q | sin*Q - cos*P]       (sin|cos from the row table)
//     S      = (qu k^T + A keytab^T) * scale + key bias
//     O      = softmax(S) V,  LSE = logsumexp(S)     (fp32 softmax)
//
// and writes O in the input type and the row log-sum-exp in fp32. The plain
// PyTorch version is reference_relpos_attention in ops/rel_attention.py.
//
// What bounds it on the H100: at the flagship's sizes (N = 126..251 rows,
// head widths 42/60/90, rel widths 120..240) a (batch, head) is a few MFLOP
// over a few tens of KB, so the kernel is compute-bound on the SM, not on
// HBM. None of the widths is a multiple of 16, which the tensor-core
// instructions need, so this kernel runs fp32 FMAs, and what limits FMAs fed
// from shared memory is the shared-memory bandwidth (32 words per clock per
// SM, against 128 FMA per clock).
//
// What the design does about it: one thread block per (64 query rows, head,
// batch). The block forms its A rows once, in shared memory beside the qu
// tile (stored feature-major, so 4 rows are one 16-byte load), as a
// register-tiled product with W staged through shared memory, and the score
// of a (row, key) pair is one dot product of the augmented features
// [qu | A] and [k | keytab]. Each thread owns a 4x4 tile of scores: per
// feature it makes one 16-byte load and four 4-byte loads for 16 FMAs. Keys
// stream in tiles of 64, their augmented features in double-buffered chunks
// of 32 (they share shared memory with the probabilities, which are never
// live at the same time, so two blocks fit on an SM at every flagship
// shape). The online softmax (running max, denominator) lives in registers,
// and so does each thread's 4-row slice of the output accumulator, so no
// (N, Nk) tensor exists anywhere. Padding to tensor-core shapes (mma/wgmma,
// TMA) is later work.
//
// Inputs: qu, k, v of type T (float or bf16) with arbitrary batch/head/row
// strides and unit feature stride; delta, w, rowtab, keytab and bias in fp32
// and contiguous; bias is (B or 1, Nk) with batch stride bias_sb (0 when it
// broadcasts). The kernel allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int DC = 32;          // augmented features per streamed chunk
constexpr int NTHREADS = 256;   // a 16 x 16 grid: ty owns 4 rows, tx 4 key columns
constexpr int LDQ = BQ;         // qaT row stride: [feature][query row]
constexpr int LDP = BQ + 4;     // psT row stride: [key][query row], 16-byte rows
constexpr int LDK = BK + 1;     // kaT row stride: [feature][key], odd for the stores
constexpr int CHUNK_PER_THREAD = DC * BK / NTHREADS;
constexpr float MASKED = -1e30f;
constexpr size_t MAX_SMEM = 232448;  // 227 KB a block may use on sm_90
constexpr int WCHUNK = 32;      // rows of W staged at a time while forming A

static_assert(NTHREADS == 16 * 16 && BQ == 4 * 16 && BK == 4 * 16, "thread grid");
static_assert(DC * BK % NTHREADS == 0 && NTHREADS % DC == 0, "chunk loader");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* qu;
  const void* k;
  const void* v;
  const float* delta;   // (H, dh)
  const float* w;       // (H, dh, d2)
  const float* rowtab;  // (N, d2)  [sin | cos]
  const float* keytab;  // (Nk, d2) [cos | sin]
  const float* bias;    // (B or 1, Nk) or null
  void* o;
  float* lse;           // (B, H, N)
  int n, nk, dh, d2;
  int64_t qu_sb, qu_sh, qu_sn;
  int64_t k_sb, k_sh, k_sn;
  int64_t v_sb, v_sh, v_sn;
  int64_t o_sb, o_sh, o_sn;
  int64_t bias_sb;
  float scale;
};

// output columns per thread: dh <= 16 * jmax
__host__ __device__ inline int jmax_for(int dh) {
  return dh <= 32 ? 2 : dh <= 64 ? 4 : dh <= 96 ? 6 : 8;
}

// the key chunks and the probabilities are never live together: one region
constexpr int SHARED_REGION = BK * LDP > 2 * DC * LDK ? BK * LDP : 2 * DC * LDK;
static_assert(WCHUNK * 128 <= SHARED_REGION, "the staged W chunk fits the key-chunk region");

__host__ __device__ inline size_t smem_floats(int dh, int d2) {
  const size_t da = dh + d2;
  return da * LDQ + SHARED_REGION + BK * 16 * jmax_for(dh);
}

template <typename T, int JMAX>
__global__ void __launch_bounds__(NTHREADS) relpos_fwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int dh = p.dh, d2 = p.d2, hd = d2 / 2;
  const int da = dh + d2;          // augmented width: [qu | A] and [k | keytab]
  constexpr int DHP = 16 * JMAX;   // padded V row
  float* qaT = smem;               // da x LDQ: [qu | A]^T of the block's rows
  float* kaT = qaT + da * LDQ;     // 2 x DC x LDK: chunks of [k | keytab]^T, then
  float* psT = kaT;                // BK x LDP: the probabilities, key-major
  float* vs = kaT + SHARED_REGION; // BK x DHP: the V tile, zero-padded

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qu = static_cast<const T*>(p.qu) + b * p.qu_sb + h * p.qu_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;
  const float* dl = p.delta + h * dh;

  // 1. the qu tile, feature-major (zero beyond N); rows vary fastest across
  //    threads so the shared-memory stores do not conflict
  for (int i = tid; i < BQ * dh; i += NTHREADS) {
    const int r = i % BQ, d = i / BQ;
    const int qi = q0 + r;
    qaT[d * LDQ + r] = qi < p.n ? to_f32(qu[qi * p.qu_sn + d]) : 0.f;
  }

  // 2. the A rows: [P | Q] = (qu + delta) W_h, rotated by the row table.
  //    A register-tiled product: thread (ty, tx) forms rows tx + 16 i of
  //    columns ty + 16 m (i, m < 4) of both halves, 64 columns of each at a
  //    time, with W staged through the (still unused) key-chunk region 32
  //    rows at a time, so each shared-memory load feeds 4 to 8 FMAs.
  const float* wh = p.w + static_cast<int64_t>(h) * dh * d2;
  float* ws = kaT;
  for (int j0 = 0; j0 < hd; j0 += 64) {
    float pacc[4][4], qacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) pacc[i][m] = qacc[i][m] = 0.f;
    for (int d0 = 0; d0 < dh; d0 += WCHUNK) {
      const int dc = min(WCHUNK, dh - d0);
      __syncthreads();   // qu is in place; the previous chunk's readers are done
      for (int i = tid; i < dc * 128; i += NTHREADS) {
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
        for (int i = 0; i < 4; ++i) x[i] = qaT[d * LDQ + tx + 16 * i] + dv;
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
        qaT[(dh + j) * LDQ + r] = a_even;
        qaT[(dh + hd + j) * LDQ + r] = a_odd;
      }
    }
  }
  __syncthreads();   // the key loop overwrites the staged W

  float m[4], l[4], o[4][JMAX];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < JMAX; ++j) o[i][j] = 0.f;
  }

  const int nchunks = (da + DC - 1) / DC;
  // chunk loader: a warp reads 32 neighbouring features of one key
  const int ld_f = tid % DC, ld_c0 = tid / DC;
  constexpr int LD_CSTEP = NTHREADS / DC;
  float stage[CHUNK_PER_THREAD];

  // 3. stream the keys
  for (int k0 = 0; k0 < p.nk; k0 += BK) {
    auto load_chunk = [&](int ch) {
      const int f = ch * DC + ld_f;
#pragma unroll
      for (int e = 0; e < CHUNK_PER_THREAD; ++e) {
        const int kj = k0 + ld_c0 + e * LD_CSTEP;
        float val = 0.f;
        if (kj < p.nk && f < da) {
          val = f < dh ? to_f32(kp[kj * p.k_sn + f])
                       : p.keytab[static_cast<int64_t>(kj) * d2 + (f - dh)];
        }
        stage[e] = val;
      }
    };
    auto store_chunk = [&](int buf) {
#pragma unroll
      for (int e = 0; e < CHUNK_PER_THREAD; ++e) {
        kaT[buf * DC * LDK + ld_f * LDK + ld_c0 + e * LD_CSTEP] = stage[e];
      }
    };

    // the V tile and chunk 0 (their previous readers, P.V, finished at the
    // last barrier)
    for (int i = tid; i < BK * DHP; i += NTHREADS) {
      const int c = i / DHP, d = i - c * DHP;
      const int kj = k0 + c;
      vs[i] = (kj < p.nk && d < dh) ? to_f32(vp[kj * p.v_sn + d]) : 0.f;
    }
    load_chunk(0);
    store_chunk(0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[i][cc] = 0.f;

    for (int ch = 0; ch < nchunks; ++ch) {
      const bool more = ch + 1 < nchunks;
      if (more) load_chunk(ch + 1);
      const float* kt = kaT + (ch & 1) * DC * LDK;
      const int dend = min(DC, da - ch * DC);
      const float* qt = qaT + ch * DC * LDQ + ty * 4;
#pragma unroll 4
      for (int dd = 0; dd < dend; ++dd) {
        const float4 a = *reinterpret_cast<const float4*>(qt + dd * LDQ);
        const float* krow = kt + dd * LDK + tx;
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
      if (more) store_chunk((ch + 1) & 1);
      __syncthreads();
    }

    // scale, key bias, and the ragged edge of the keys
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int kj = k0 + tx + 16 * cc;
      const bool valid = kj < p.nk;
      const float kb = (valid && bias) ? bias[kj] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][cc] = valid ? s[i][cc] * p.scale + kb : MASKED;
    }

    // online softmax: the 16 threads of a row group are one half-warp. The
    // chunk loop ended at a barrier, so psT may overwrite the key chunks.
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
      const float* vrow = vs + c * DHP + tx;
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

  // 4. normalise and write O (input type) and the LSE (fp32)
  T* op = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.n) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      const int d = tx + 16 * j;
      if (d < dh) op[qi * p.o_sn + d] = from_f32<T>(o[i][j] * inv);
    }
    if (tx == 0) {
      p.lse[(static_cast<int64_t>(b) * gridDim.y + h) * p.n + qi] = m[i] + logf(l[i]);
    }
  }
}

template <typename T, int JMAX>
cudaError_t launch_j(const Params& p, int batch, int heads, size_t bytes, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(&relpos_fwd_kernel<T, JMAX>);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + BQ - 1) / BQ, heads, batch);
  relpos_fwd_kernel<T, JMAX><<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  const size_t bytes = smem_floats(p.dh, p.d2) * sizeof(float);
  if (p.dh > 128 || bytes > MAX_SMEM) return cudaErrorInvalidValue;
  switch (jmax_for(p.dh)) {
    case 2: return launch_j<T, 2>(p, batch, heads, bytes, stream);
    case 4: return launch_j<T, 4>(p, batch, heads, bytes, stream);
    case 6: return launch_j<T, 6>(p, batch, heads, bytes, stream);
    default: return launch_j<T, 8>(p, batch, heads, bytes, stream);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes, for head width dh and rel width d2.
size_t ecf_relpos_attention_fwd_smem(int dh, int d2) {
  return smem_floats(dh, d2) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16 for qu, k, v and o. Returns a cudaError_t.
int ecf_relpos_attention_fwd(
    int dtype, const void* qu, const void* k, const void* v, const float* delta,
    const float* w, const float* rowtab, const float* keytab, const float* bias,
    void* o, float* lse, int batch, int heads, int n, int nk, int dh, int d2,
    int64_t qu_sb, int64_t qu_sh, int64_t qu_sn, int64_t k_sb, int64_t k_sh,
    int64_t k_sn, int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t o_sb,
    int64_t o_sh, int64_t o_sn, int64_t bias_sb, float scale, void* stream) {
  if (n <= 0 || nk <= 0 || dh <= 0 || d2 <= 0 || d2 % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{qu, k, v, delta, w, rowtab, keytab, bias, o, lse, n, nk, dh, d2,
           qu_sb, qu_sh, qu_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn,
           o_sb, o_sh, o_sn, bias_sb, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(p, batch, heads, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(p, batch, heads, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
