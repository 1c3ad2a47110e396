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
// What bounds it on the H100: per (batch, head) the backward is a few tens
// of MFLOP over a few hundred KB (flagship sizes: N = 201..401 rows, head
// widths 42/60/90, rel widths 120..240), so it is compute-bound, not
// HBM-bound. The widths are not multiples of 16, so, like the forward, it
// runs fp32 FMAs from shared memory, and shared-memory bandwidth limits them.
//
// What the design does about it. The TPU kernel holds a whole (b, h) block
// in VMEM and carries the dW / ddelta sums across a sequential batch grid
// axis. Hopper blocks run in parallel and in no order, so the work is split
// into two passes over 64 x 64 tiles, as FlashAttention-2 splits its
// backward, and no (N, Nk) tensor ever reaches device memory:
//
//   * query-side pass, one block per (64 query rows, head, batch), looping
//     over key tiles: it forms A for its rows as the forward does and
//     writes it out (fp32, per token) with Di for the other pass; then the
//     scores and dP from the augmented features [qu | A] . [k | keytab],
//     dS, and d[qu | A] += dS [k | keytab] in registers. After the loop dA
//     goes through the rotation to dpq in shared memory, dqu = scale dS k +
//     dpq W^T, and the block writes its partial dW = qv^T dpq and ddelta =
//     (sum of dpq rows) W^T. The wrapper sums the partials in a fixed order:
//     no atomics, the gradients are the same from run to run.
//   * key-side pass, one block per (64 keys, head, batch), looping over query
//     tiles: it reads the A rows instead of rebuilding them (a rebuild per
//     key block repeats the product 5-7 times per row at the flagship's
//     lengths, and measured as most of this pass), recomputes the scores,
//     P and dS, and accumulates dv, dk and the dbias column sums in
//     registers.
//
// Each thread owns a 4 x 4 tile of scores: one 16-byte and four 4-byte
// shared-memory loads per 16 FMAs. A and dqv are register-tiled products
// with W (or W^T) staged through shared memory, since loads of W from
// global memory inside the FMA loops left those phases waiting on L2. Tiles
// read four rows at a time are stored with a row stride of 68 floats
// (16-byte aligned), tiles read one word at a time with 65 (odd, so the 16
// neighbouring columns of a half-warp fall in distinct banks). Rows past N
// and keys past Nk are masked by the kernel itself (P = 0 there). One block
// fills most of an SM's shared memory at the flagship's widest stage
// (da = dh + 2hd = 300: 214,896 bytes in the query-side pass), so blocks
// run one per SM; tensor cores, and with them padding the widths to 16, are
// later work.
//
// Inputs: qu, k, v, o, dO of type T (float or bf16) with arbitrary
// batch/head/row strides and unit feature stride; lse (B, H, N) fp32; delta,
// w (H, dh, 2hd), wt = w^T per head (H, 2hd, dh), rowtab, keytab and bias in
// fp32 and contiguous; bias is (B or 1, Nk) with batch stride bias_sb.
// Outputs: dqu, dk, dv of type T (strided); dw_part (B * ceil(N/64), H, dh,
// 2hd) and ddelta_part (B * ceil(N/64), H, dh) fp32; di (B, H, N) and atab
// (B, H, N, 2hd) fp32 scratch; dbias (B, H, Nk) fp32, or null when not
// wanted. The kernels allocate nothing and do not synchronise; the
// key-side pass reads what the query-side pass wrote, in stream order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 256;   // a 16 x 16 grid of threads, each a 4 x 4 tile
constexpr int LDV = 68;         // row stride of tiles read four rows at a time
constexpr int LDS = 65;         // row stride of tiles read one word at a time
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

// ---------------------------------------------------------------- launch

cudaError_t prepare(const void* fn, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int JA>
cudaError_t launch_q(const Params& p, int batch, int heads, cudaStream_t stream) {
  const size_t bytes = q_smem_floats(p.dh, p.d2) * sizeof(float);
  cudaError_t err = prepare(reinterpret_cast<const void*>(&relpos_bwd_q_kernel<T, JA>), bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + BQ - 1) / BQ, heads, batch);
  relpos_bwd_q_kernel<T, JA><<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int JD>
cudaError_t launch_k(const Params& p, int batch, int heads, cudaStream_t stream) {
  const size_t bytes = k_smem_floats(p.dh, p.d2) * sizeof(float);
  cudaError_t err = prepare(reinterpret_cast<const void*>(&relpos_bwd_k_kernel<T, JD>), bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.nk + BK - 1) / BK, heads, batch);
  relpos_bwd_k_kernel<T, JD><<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  const int da = p.dh + p.d2;
  if (p.dh > 128 || da > 16 * 26 || q_smem_floats(p.dh, p.d2) * sizeof(float) > MAX_SMEM ||
      k_smem_floats(p.dh, p.d2) * sizeof(float) > MAX_SMEM) {
    return cudaErrorInvalidValue;
  }
  // the key-side pass reads the Di that the query-side pass writes: same
  // stream, so in order
  cudaError_t err;
  switch (ja_for(da)) {
    case 4: err = launch_q<T, 4>(p, batch, heads, stream); break;
    case 8: err = launch_q<T, 8>(p, batch, heads, stream); break;
    case 14: err = launch_q<T, 14>(p, batch, heads, stream); break;
    case 20: err = launch_q<T, 20>(p, batch, heads, stream); break;
    default: err = launch_q<T, 26>(p, batch, heads, stream); break;
  }
  if (err != cudaSuccess) return err;
  switch (jd_for(p.dh)) {
    case 2: return launch_k<T, 2>(p, batch, heads, stream);
    case 4: return launch_k<T, 4>(p, batch, heads, stream);
    case 6: return launch_k<T, 6>(p, batch, heads, stream);
    default: return launch_k<T, 8>(p, batch, heads, stream);
  }
}

}  // namespace

extern "C" {

// Shared memory the larger of the two passes needs per block, in bytes.
size_t ecf_relpos_attention_bwd_smem(int dh, int d2) {
  return zmax(q_smem_floats(dh, d2), k_smem_floats(dh, d2)) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16 for qu, k, v, o, dO and the token
// gradients. Returns a cudaError_t.
int ecf_relpos_attention_bwd(
    int dtype, const void* qu, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, const float* delta, const float* w, const float* wt,
    const float* rowtab, const float* keytab, const float* bias, void* dqu, void* dk,
    void* dv, float* dw_part, float* ddelta_part, float* di, float* atab, float* dbias,
    int batch,
    int heads, int n, int nk, int dh, int d2, int64_t qu_sb, int64_t qu_sh, int64_t qu_sn,
    int64_t k_sb, int64_t k_sh, int64_t k_sn, int64_t v_sb, int64_t v_sh, int64_t v_sn,
    int64_t o_sb, int64_t o_sh, int64_t o_sn, int64_t do_sb, int64_t do_sh, int64_t do_sn,
    int64_t dqu_sb, int64_t dqu_sh, int64_t dqu_sn, int64_t dk_sb, int64_t dk_sh,
    int64_t dk_sn, int64_t dv_sb, int64_t dv_sh, int64_t dv_sn, int64_t bias_sb, float scale,
    void* stream) {
  if (n <= 0 || nk <= 0 || dh <= 0 || d2 <= 0 || d2 % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{qu, k, v, o, dout, lse, delta, w, wt, rowtab, keytab, bias, dqu, dk, dv,
           dw_part, ddelta_part, di, atab, dbias, n, nk, dh, d2,
           qu_sb, qu_sh, qu_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn,
           do_sb, do_sh, do_sn, dqu_sb, dqu_sh, dqu_sn, dk_sb, dk_sh, dk_sn,
           dv_sb, dv_sh, dv_sn, bias_sb, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(p, batch, heads, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(p, batch, heads, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
