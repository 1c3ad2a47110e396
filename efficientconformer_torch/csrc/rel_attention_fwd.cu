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
// What bounds it on the H100: at the flagship's inference shapes (b128 x
// 10 s: N = 167/251/126 rows, head widths 90/42/60, rel widths
// 120/168/240) the bytes (qu, k, v and O in bf16, small tables) and the
// products (2 B H N (N (2 dh + D) + dh D) = 4-18 GFLOP a shape, on the bf16
// tensor cores) bound it about equally: 0.046 ms over the three shapes. What
// sets the pace is the instructions around the products (PERF.md).
//
// Two routes, chosen by the inputs' type:
//
//   * bf16, relpos_fwd_tc_kernel: the tensor-core design (relpos_tc.cuh).
//     One block of four warps per (64 query rows, head, batch), each warp 16
//     rows. The block copies its qu rows into shared memory (bf16, widths
//     zero-padded to 16; 16-byte cp.async where the strides allow, 4-byte
//     where they are even, 2-byte for an odd head width) and forms A beside
//     them on mma.sync: [P | Q] = bf16(qu + delta) W in chunks of 32 paired
//     columns, each warp rotating its own rows in fp32 registers and
//     rounding A to bf16 (the TPU kernel's a.astype(keytab.dtype)). Keys
//     then stream in tiles of 64: a content step brings the tile's k and v
//     (S = qu k^T), then the keytab rows come in chunks of 64 columns (S +=
//     A keytab^T, into the same accumulators), double-buffered: the next
//     step's copies fly while this step's products run, so no width is
//     bounded by shared memory (the widest shipped shape, D 720, takes
//     177,152 bytes). The online softmax keeps each row's max and sum in
//     fp32 registers; P, rounded to bf16, is the A fragment of P v straight
//     from the accumulators (FlashAttention-2's register reuse). About 100
//     KB of shared memory at the flagship's shapes: two blocks an SM. It
//     takes a padded head up to 144 where [qu | A] and the ring fit in
//     227 KB (tc_fits); past either, the wide route: rtc::prep_wide_kernel
//     writes the A rows (B, H, N, D) in bf16, then relpos_fwd_wide_tc_kernel
//     streams [qu | A] and [k | keytab] in chunks of 64 columns and splits
//     O into column groups of at most 128 (rtc::wide_gw), each group's
//     blocks computing the same scores; 71,680 bytes at any width.
//   * fp32, fp32 FMAs from shared memory (TF32 products would miss the
//     fp32 checks), one block of 256 threads per (64 query rows, head,
//     batch), each thread a 4 x 4 tile of scores (one 16-byte and four
//     4-byte loads per 16 FMAs) and J = ceil(dh / 16), rounded up to 2, 4,
//     6, 8, 12 or 16, output columns; keys stream in tiles of 64, [k |
//     keytab] in double-buffered chunks of 32 features, then O += P V from
//     a V tile of 64 x 16 J floats. Two kernels, chosen by the widths
//     (resident_fits):
//       - relpos_fwd_resident_kernel<J> where the block's transposed [qu |
//         A] tile, (dh + D) x 64 floats, fits in shared memory beside the
//         key chunks and the V tile, and dh <= 128: the block forms its A
//         rows there as a register-tiled product, W staged 32 rows at a
//         time. It takes the flagship's shapes and every shipped shape
//         but the two below (D up to 712 at dh 64, 181,248 bytes at (64,
//         512)).
//       - otherwise two passes (relpos_fma.cuh): rfma::prep_kernel writes
//         the A rows (B, H, N, 2hd) to device memory, then
//         relpos_fwd_kernel<J> streams [qu | A] in chunks of 32 too. No
//         feature row is held whole, so the rel width is bounded by nothing
//         but device memory; the head width by the V tile and O's
//         registers: up to 256, where the largest pass, the prep's, takes
//         119,040 bytes of shared memory. The A rows cost a round trip
//         through device memory (B H N 2hd fp32: 9.3 MB at EfficientConformer
//         Large's stage 3, b2 x 16 s) and [qu | A] is read again from L2 for
//         every key tile, so it is slower where the resident kernel fits.
//         It takes the shipped widths the resident kernel cannot: head 135
//         (Medium and Large stage 1) and (90, 720) (Large stage 3). Past a
//         head of 256 the prep pass stages qu in chunks and the key loop
//         splits O into column groups of at most 256 (fwd_group_width), so
//         no width bounds it.

// Both keep the online softmax in registers, so no (N, Nk) tensor exists
// anywhere; keys past Nk are excluded by the kernels themselves.
//
// Inputs: qu, k, v (fp32 or bf16) with arbitrary batch/head/row strides and
// unit feature stride; the fp32 route takes delta, w, rowtab and keytab in
// fp32 (and the streamed kernel a scratch buffer for the A rows), the bf16
// route in bf16 at the padded widths of relpos_tc.cuh, all contiguous; bias
// is fp32 (B or 1, Nk) with batch stride bias_sb (0 when it broadcasts). The kernels allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "relpos_fma.cuh"
#include "relpos_tc.cuh"

namespace {

using rfma::BK;
using rfma::MAX_SMEM;
using rfma::BQ;
using rfma::NTHREADS;

struct Params {
  const float* qu;
  const float* k;
  const float* v;
  const float* delta;   // (H, dh)
  const float* w;       // (H, dh, d2)
  const float* rowtab;  // (N, d2)  [sin | cos]
  const float* keytab;  // (Nk, d2) [cos | sin]
  const float* bias;    // (B or 1, Nk) or null
  float* o;
  float* lse;           // (B, H, N)
  float* atab;          // (B, H, N, d2): the A rows from the prep pass (streamed only)
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
  return dh <= 32 ? 2 : dh <= 64 ? 4 : dh <= 96 ? 6 : dh <= 128 ? 8 : dh <= 192 ? 12 : 16;
}

// the streamed kernel's column group: the whole head up to MAX_DH columns,
// past it the fewest groups of at most MAX_DH, of equal width rounded up to
// 16 (each group's blocks compute the same scores)
__host__ __device__ inline int fwd_group_width(int dh) {
  const int groups = (dh + rfma::MAX_DH - 1) / rfma::MAX_DH;
  return ((dh + groups - 1) / groups + 15) / 16 * 16;
}

// the key loop's shared memory: tile_product's chunks (the probabilities
// reuse them between products) and the V tile of a column group
__host__ __device__ inline size_t smem_floats(int dh) {
  return rfma::TILE_FLOATS + static_cast<size_t>(BK) * 16 * jmax_for(fwd_group_width(dh));
}

// One block per (64 query rows, head, batch x column group of gw), after
// the prep pass wrote the A rows. For each tile of 64 keys: S = [qu | A] [k
// | keytab]^T streamed over the augmented features in chunks of 32
// (tile_product), the scale, key bias and ragged key edge, the online
// softmax in registers, P to shared memory, O += P V over the group's
// columns of the V tile. The first group writes the LSE.
template <int JMAX>
__global__ void __launch_bounds__(NTHREADS) relpos_fwd_kernel(Params p, int gw) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DHP = 16 * JMAX;         // padded V row
  const int dh = p.dh, d2 = p.d2, da = dh + d2;
  float* buf = smem;                     // tile_product's chunks
  float* psT = smem;                     // BK x LDV: the probabilities, key-major
  float* vs = smem + rfma::TILE_FLOATS;  // BK x DHP: the V tile, zero-padded
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int groups = (dh + gw - 1) / gw;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z / groups;
  const int c0 = (blockIdx.z % groups) * gw, cw = min(gw, dh - c0);   // columns [c0, c0 + cw)
  const int64_t bh = static_cast<int64_t>(b) * gridDim.y + h;
  const float* qu = p.qu + b * p.qu_sb + h * p.qu_sh;
  const float* kp = p.k + b * p.k_sb + h * p.k_sh;
  const float* vp = p.v + b * p.v_sb + h * p.v_sh;
  const float* ap = p.atab + bh * p.n * d2;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;

  float m[4], l[4], o[4][JMAX];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = rfma::MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < JMAX; ++j) o[i][j] = 0.f;
  }
  // [qu | A] of query row q0 + r, [k | keytab] of key k0 + c, at feature f
  auto qa = [&](int f, int r) {
    const int qi = q0 + r;
    if (qi >= p.n) return 0.f;
    return f < dh ? qu[qi * p.qu_sn + f] : ap[static_cast<int64_t>(qi) * d2 + f - dh];
  };

  for (int k0 = 0; k0 < p.nk; k0 += BK) {
    auto ka = [&](int f, int c) {
      const int kj = k0 + c;
      if (kj >= p.nk) return 0.f;
      return f < dh ? kp[kj * p.k_sn + f] : p.keytab[static_cast<int64_t>(kj) * d2 + f - dh];
    };
    // the V tile (its readers, P V, finished at the last barrier)
    for (int i = tid; i < BK * DHP; i += NTHREADS) {
      const int c = i / DHP, d = i - c * DHP;
      const int kj = k0 + c;
      vs[i] = (kj < p.nk && d < cw) ? vp[kj * p.v_sn + c0 + d] : 0.f;
    }
    float s[4][4];
    rfma::zero(s);
    rfma::tile_product<true, true>(s, da, buf, qa, ka);

    // scale, key bias, and the ragged edge of the keys
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int kj = k0 + tx + 16 * cc;
      const bool valid = kj < p.nk;
      const float kb = (valid && bias) ? bias[kj] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][cc] = valid ? s[i][cc] * p.scale + kb : rfma::MASKED;
    }

    // online softmax: the 16 threads of a row group are one half-warp.
    // tile_product ended at a barrier, so psT may overwrite its chunks.
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
      *reinterpret_cast<float4*>(psT + (tx + 16 * cc) * rfma::LDV + ty * 4) =
          make_float4(s[0][cc], s[1][cc], s[2][cc], s[3][cc]);
    }
    __syncthreads();

    // O += P V over this key tile
    for (int c = 0; c < BK; ++c) {
      const float4 pr = *reinterpret_cast<const float4*>(psT + c * rfma::LDV + ty * 4);
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

  // normalise and write O and the LSE
  float* op = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.n) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      const int d = tx + 16 * j;
      if (d < cw) op[qi * p.o_sn + c0 + d] = o[i][j] * inv;
    }
    if (tx == 0 && c0 == 0) p.lse[bh * p.n + qi] = m[i] + logf(l[i]);
  }
}

// ---------------------------------- fp32: [qu | A] resident in shared memory

// Where the block's whole transposed [qu | A] tile fits in shared memory
// (resident_fits), the block forms its A rows there beside the qu tile and
// streams only the keys: no prep pass and no A rows in device memory.
constexpr int DC = rfma::DC;           // augmented features per streamed key chunk
constexpr int WCHUNK = rfma::WCHUNK;   // rows of W staged at a time while forming A
constexpr int LDQ = BQ;                // qaT row stride: [feature][query row]
constexpr int LDP = rfma::LDV;         // psT row stride: [key][query row], 16-byte rows
constexpr int LDK = rfma::LDS;         // kaT row stride: [feature][key], odd for the stores
constexpr int CHUNK_PER_THREAD = DC * BK / NTHREADS;
constexpr int RESIDENT_MAX_DH = 128;   // 8 output columns a thread
// the key chunks and the probabilities are never live together: one region
constexpr int SHARED_REGION = BK * LDP > 2 * DC * LDK ? BK * LDP : 2 * DC * LDK;
static_assert(DC * BK % NTHREADS == 0 && NTHREADS % DC == 0, "chunk loader");
static_assert(WCHUNK * 128 <= SHARED_REGION, "the staged W chunk fits the key-chunk region");

__host__ __device__ inline size_t resident_smem_floats(int dh, int d2) {
  return static_cast<size_t>(dh + d2) * LDQ + SHARED_REGION + BK * 16 * jmax_for(dh);
}
__host__ __device__ inline bool resident_fits(int dh, int d2) {
  return dh <= RESIDENT_MAX_DH && resident_smem_floats(dh, d2) * sizeof(float) <= MAX_SMEM;
}

// One block per (64 query rows, head, batch): the qu tile and the A rows,
// feature-major, then for each tile of 64 keys S = [qu | A] [k | keytab]^T
// with [k | keytab] in double-buffered chunks of DC, the online softmax and
// O += P V, as relpos_fwd_kernel does it.
template <int JMAX>
__global__ void __launch_bounds__(NTHREADS) relpos_fwd_resident_kernel(Params p) {
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
  const float* qu = p.qu + b * p.qu_sb + h * p.qu_sh;
  const float* kp = p.k + b * p.k_sb + h * p.k_sh;
  const float* vp = p.v + b * p.v_sb + h * p.v_sh;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;
  const float* dl = p.delta + h * dh;

  // 1. the qu tile, feature-major (zero beyond N); rows vary fastest across
  //    threads so the shared-memory stores do not conflict
  for (int i = tid; i < BQ * dh; i += NTHREADS) {
    const int r = i % BQ, d = i / BQ;
    const int qi = q0 + r;
    qaT[d * LDQ + r] = qi < p.n ? qu[qi * p.qu_sn + d] : 0.f;
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
    m[i] = rfma::MASKED;
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
          val = f < dh ? kp[kj * p.k_sn + f]
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
      vs[i] = (kj < p.nk && d < dh) ? vp[kj * p.v_sn + d] : 0.f;
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
      for (int i = 0; i < 4; ++i) s[i][cc] = valid ? s[i][cc] * p.scale + kb : rfma::MASKED;
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
  float* op = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.n) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      const int d = tx + 16 * j;
      if (d < dh) op[qi * p.o_sn + d] = o[i][j] * inv;
    }
    if (tx == 0) {
      p.lse[(static_cast<int64_t>(b) * gridDim.y + h) * p.n + qi] = m[i] + logf(l[i]);
    }
  }
}

// ------------------------------------------------ bf16: the tensor cores

constexpr int TC_BK = 64;   // keys a tile

struct TcParams {
  const tc::bf16* qu;
  const tc::bf16* k;
  const tc::bf16* v;
  rtc::RelTab rt;       // padded bf16 delta, W and tables
  const float* bias;    // (B or 1, Nk) or null
  tc::bf16* o;
  float* lse;           // (B, H, N)
  int n, nk, dh;
  int64_t qu_sb, qu_sh, qu_sn;
  int64_t k_sb, k_sh, k_sn;
  int64_t v_sb, v_sh, v_sn;
  int64_t o_sb, o_sh, o_sn;
  int64_t bias_sb;
  float scale;
  int qu_bytes, k_bytes, v_bytes, o_bytes;   // widest copies the strides allow (tc::copy_bytes)
  tc::bf16* atab;       // (B, H, N, d2p): the wide route's A rows (null on the resident route)
};

// bytes of shared memory: [qu | A] of the rows, then one region that first
// holds form_a's scratch (qv, a W chunk) and then the key ring (two (k, v)
// tile pairs and two keytab chunks)
__host__ __device__ inline size_t tc_smem_bytes(int dhp, int d2p) {
  const size_t lda = dhp + d2p + 8, ldt = dhp + 8;
  const size_t prep = rtc::BQ * ldt + dhp * rtc::LDC;
  const size_t ring = 2 * 2 * TC_BK * ldt + 2 * TC_BK * rtc::LDC;
  return (rtc::BQ * lda + (prep > ring ? prep : ring)) * sizeof(tc::bf16);
}
// whether relpos_fwd_tc_kernel takes padded widths dhp, d2p: its registers
// hold a padded head of 144 and its tiles fit in shared memory
__host__ __device__ inline bool tc_fits(int dhp, int d2p) {
  return dhp <= 144 && tc_smem_bytes(dhp, d2p) <= MAX_SMEM;
}
// the wide route's key loop: the ring of [qu | A] and [k | keytab] chunks,
// and two V tiles of a column group (rtc::wide_gw)
__host__ __device__ inline size_t tc_wide_smem_bytes(int dhp) {
  const size_t ldv = rtc::wide_dmax(rtc::wide_gw(dhp)) + 8;
  return (2 * 2 * rtc::BQ * rtc::LDC + 2 * TC_BK * ldv) * sizeof(tc::bf16);
}

// DMAX: the padded head width the registers are sized for (64, 96 or 144);
// the loops stop at the real dhp.
template <int DMAX>
__global__ void __launch_bounds__(rtc::THREADS) relpos_fwd_tc_kernel(TcParams p) {
  using tc::bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dhp = p.rt.dhp, hdp = p.rt.hdp, d2p = 2 * hdp;
  const int lda = dhp + d2p + 8, ldt = dhp + 8, nd = dhp >> 4, ngr = dhp >> 3;
  bf16* qa = reinterpret_cast<bf16*>(smem_raw);   // [64][lda]: [qu | A] of the rows
  bf16* region = qa + rtc::BQ * lda;
  bf16* kv = region;                              // [2][k [64][ldt], v [64][ldt]]
  bf16* ch = region + 2 * 2 * TC_BK * ldt;        // [2][64][LDC]: keytab chunks

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int q0 = blockIdx.x * rtc::BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* kp = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vp = p.v + b * p.v_sb + h * p.v_sh;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;

  // 1. the qu rows (zero past N and dh), then A beside them
  rtc::load_rows<rtc::BQ, DMAX / 8>(qa, lda, p.qu + b * p.qu_sb + h * p.qu_sh, p.qu_sn, q0, p.n,
                                    p.dh, ngr, p.qu_bytes);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  rtc::form_a<DMAX>(qa, lda, region, region + rtc::BQ * ldt, p.rt, p.n, q0, h);

  // 2. the key tiles: step 0 of a tile brings its k and v (and forms the
  //    content scores), steps 1..nrel bring keytab chunks (the rel scores)
  const int nrel = (d2p + rtc::KC - 1) / rtc::KC, nsteps = 1 + nrel;
  const int total = (p.nk + TC_BK - 1) / TC_BK * nsteps;
  auto load_step = [&](int st) {
    const int t = st / nsteps, f = st - t * nsteps, k0 = t * TC_BK;
    if (f == 0) {
      bf16* kt = kv + (t & 1) * 2 * TC_BK * ldt;
      rtc::load_rows<TC_BK, DMAX / 8>(kt, ldt, kp, p.k_sn, k0, p.nk, p.dh, ngr, p.k_bytes);
      rtc::load_rows<TC_BK, DMAX / 8>(kt + TC_BK * ldt, ldt, vp, p.v_sn, k0, p.nk, p.dh, ngr,
                                      p.v_bytes);
    } else {
      const int c0 = (f - 1) * rtc::KC;
      rtc::load_rows<TC_BK, rtc::KC / 8>(ch + (st & 1) * TC_BK * rtc::LDC, rtc::LDC,
                                         p.rt.keytab + c0, d2p, k0, p.nk, d2p - c0,
                                         rtc::KC / 8, 16);
    }
  };

  float o[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // rows g and g + 8 of the warp
  float s[8][4];
  // this lane's ldmatrix addresses (tc::a_lane / b_lane / bt_lane with the
  // runtime row strides)
  const uint32_t qa_a = tc::smem_addr(qa + (warp * 16 + (lane & 15)) * lda + ((lane >> 4) << 3));
  const uint32_t k_b = tc::smem_addr(kv + ((lane & 7) + ((lane >> 4) << 3)) * ldt +
                                     (((lane >> 3) & 1) << 3));
  const uint32_t v_bt = tc::smem_addr(kv + TC_BK * ldt +
                                      ((lane & 7) + (((lane >> 3) & 1) << 3)) * ldt +
                                      ((lane >> 4) << 3));
  const uint32_t ch_b = tc::b_lane<rtc::LDC>(ch, lane);
  const uint32_t tile_bytes = 2 * TC_BK * ldt * 2, blk_row = 16 * ldt * 2;
  constexpr uint32_t CH_BYTES = TC_BK * rtc::LDC * 2;

  load_step(0);
  tc::cp_async_commit();
  for (int st = 0; st < total; ++st) {
    tc::cp_async_wait<0>();
    __syncthreads();   // step st landed for every thread; step st - 1's buffers are free
    if (st + 1 < total) load_step(st + 1);
    tc::cp_async_commit();
    const int t = st / nsteps, f = st - t * nsteps;
    if (f == 0) {   // S = qu k^T
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint32_t kb = k_b + (t & 1) * tile_bytes;
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        if (kk < nd) {
          uint32_t a[4];
          tc::ldsm_x4(a, qa_a + kk * 32);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bf[4];
            tc::ldsm_x4(bf, kb + np * blk_row + kk * 32);
            tc::mma_bf16(s[2 * np], a, bf[0], bf[1]);
            tc::mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
          }
        }
      }
    } else {        // S += A keytab^T over this chunk's features
      const int c0 = (f - 1) * rtc::KC, ksteps = (d2p - c0) >> 4;
      const uint32_t cb = ch_b + (st & 1) * CH_BYTES, ab = qa_a + (dhp + c0) * 2;
#pragma unroll
      for (int kk = 0; kk < rtc::KC / 16; ++kk) {
        if (kk < ksteps) {
          uint32_t a[4];
          tc::ldsm_x4(a, ab + kk * 32);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bf[4];
            tc::ldsm_x4(bf, cb + tc::blk<rtc::LDC>(np, kk));
            tc::mma_bf16(s[2 * np], a, bf[0], bf[1]);
            tc::mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
          }
        }
      }
    }
    if (f != nsteps - 1) continue;

    // scale, key bias and the online softmax; keys past Nk excluded
    rtc::softmax_tile<DMAX / 8>(s, m, l, o, bias, t * TC_BK, p.nk, p.scale, c);
    // O += P v, P as bf16 A fragments straight from the registers
    const uint32_t vb = v_bt + (t & 1) * tile_bytes;
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t a[4];
      tc::acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < DMAX / 16; ++n2) {
        if (n2 < nd) {
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, vb + kk * blk_row + n2 * 32);
          tc::mma_bf16(o[2 * n2], a, bf[0], bf[1]);
          tc::mma_bf16(o[2 * n2 + 1], a, bf[2], bf[3]);
        }
      }
    }
  }

  // 3. normalise; O through the warp's own rows of qa (no other warp reads
  //    them) to whole-row stores; the LSE in fp32
  bf16* stage = qa + warp * 16 * lda;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const float inv = 1.f / l[hr];
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      if (j < 2 * nd) {
        *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8 * hr) * lda + j * 8 + 2 * c) =
            __floats2bfloat162_rn(o[j][2 * hr] * inv, o[j][2 * hr + 1] * inv);
      }
    }
    const int qi = q0 + warp * 16 + g + 8 * hr;
    if (c == 0 && qi < p.n) {
      p.lse[(static_cast<int64_t>(b) * gridDim.y + h) * p.n + qi] = m[hr] + logf(l[hr]);
    }
  }
  __syncwarp();
  tc::store_rows_rt(p.o + b * p.o_sb + h * p.o_sh, p.o_sn, stage, lda, 16, q0 + warp * 16, p.n,
                    p.dh, p.o_bytes, lane, 32);
}

// The wide route (relpos_tc.cuh), after rtc::prep_wide_kernel wrote the A
// rows: one block of four warps per (64 query rows, head, batch x column
// group of gw), each warp 16 rows. For each tile of 64 keys, S = [qu | A]
// [k | keytab]^T over the augmented width in steps of 64 columns, each step
// a [qu | A] chunk (from qu, or the A rows) and a [k | keytab] chunk (from k,
// or the table), double-buffered, the tile's V columns of the group coming
// with its first step; then the scale, key bias, online softmax and O += P v
// as relpos_fwd_tc_kernel does them. DMAX: the group width the registers
// are sized for (64 or 128). The first group writes the LSE.
template <int DMAX>
__global__ void __launch_bounds__(rtc::THREADS) relpos_fwd_wide_tc_kernel(TcParams p, int gw) {
  using tc::bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LDC = rtc::LDC, LDV = DMAX + 8, STAGE = 2 * rtc::BQ * LDC;
  const int dhp = p.rt.dhp, d2p = 2 * p.rt.hdp;
  const int nc = (dhp + 63) / 64, nsteps = nc + (d2p + 63) / 64;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // [2][rows [64][LDC], keys [64][LDC]]
  bf16* vt = ring + 2 * STAGE;                      // [2][64][LDV]: V columns of the group

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int groups = (dhp + gw - 1) / gw;
  const int q0 = blockIdx.x * rtc::BQ, h = blockIdx.y, b = blockIdx.z / groups;
  const int g0 = (blockIdx.z % groups) * gw, ngd = min(gw, dhp - g0) >> 4;
  const int64_t bh = static_cast<int64_t>(b) * gridDim.y + h;
  const bf16* qp = p.qu + b * p.qu_sb + h * p.qu_sh;
  const bf16* kp = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vp = p.v + b * p.v_sb + h * p.v_sh;
  const bf16* ap = p.atab + bh * p.n * d2p;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;

  const int total = (p.nk + TC_BK - 1) / TC_BK * nsteps;
  auto load_step = [&](int st) {
    const int t = st / nsteps, f = st - t * nsteps, k0 = t * TC_BK;
    bf16* rows = ring + (st & 1) * STAGE;
    bf16* keys = rows + rtc::BQ * LDC;
    if (f < nc) {
      const int c0 = 64 * f;
      rtc::load_rows<rtc::BQ, 8>(rows, LDC, qp + c0, p.qu_sn, q0, p.n, p.dh - c0, 8, p.qu_bytes);
      rtc::load_rows<TC_BK, 8>(keys, LDC, kp + c0, p.k_sn, k0, p.nk, p.dh - c0, 8, p.k_bytes);
      if (f == 0) {
        rtc::load_rows<TC_BK, DMAX / 8>(vt + (t & 1) * TC_BK * LDV, LDV, vp + g0, p.v_sn, k0, p.nk,
                                        p.dh - g0, gw >> 3, p.v_bytes);
      }
    } else {
      const int c0 = 64 * (f - nc);
      rtc::load_rows<rtc::BQ, 8>(rows, LDC, ap + c0, d2p, q0, p.n, d2p - c0, 8, 16);
      rtc::load_rows<TC_BK, 8>(keys, LDC, p.rt.keytab + c0, d2p, k0, p.nk, d2p - c0, 8, 16);
    }
  };

  float o[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // rows g and g + 8 of the warp
  float s[8][4];
  const uint32_t rows_a = tc::a_lane<LDC>(ring + warp * 16 * LDC, lane);
  const uint32_t keys_b = tc::b_lane<LDC>(ring + rtc::BQ * LDC, lane);
  const uint32_t v_bt = tc::bt_lane<LDV>(vt, lane);
  constexpr uint32_t STAGE_BYTES = STAGE * 2, VT_BYTES = TC_BK * LDV * 2;

  load_step(0);
  tc::cp_async_commit();
  for (int st = 0; st < total; ++st) {
    tc::cp_async_wait<0>();
    __syncthreads();   // step st landed for every thread; step st - 1's buffers are free
    if (st + 1 < total) load_step(st + 1);
    tc::cp_async_commit();
    const int t = st / nsteps, f = st - t * nsteps;
    if (f == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
    const int ksteps = (f < nc ? min(64, dhp - 64 * f) : min(64, d2p - 64 * (f - nc))) >> 4;
    const uint32_t sb = (st & 1) * STAGE_BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < ksteps) {
        uint32_t a[4];
        tc::ldsm_x4(a, rows_a + sb + kk * 32);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bf[4];
          tc::ldsm_x4(bf, keys_b + sb + tc::blk<LDC>(np, kk));
          tc::mma_bf16(s[2 * np], a, bf[0], bf[1]);
          tc::mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
        }
      }
    }
    if (f != nsteps - 1) continue;

    // scale, key bias and the online softmax; keys past Nk excluded
    rtc::softmax_tile<DMAX / 8>(s, m, l, o, bias, t * TC_BK, p.nk, p.scale, c);
    // O += P v over the group's columns, P as bf16 A fragments
    const uint32_t vb = v_bt + (t & 1) * VT_BYTES;
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t a[4];
      tc::acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < DMAX / 16; ++n2) {
        if (n2 < ngd) {
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, vb + tc::blk<LDV>(kk, n2));
          tc::mma_bf16(o[2 * n2], a, bf[0], bf[1]);
          tc::mma_bf16(o[2 * n2 + 1], a, bf[2], bf[3]);
        }
      }
    }
  }

  // normalise; O through the ring (every warp is past its last read of it)
  // to whole-row stores of the group's columns; the LSE in fp32
  __syncthreads();
  bf16* stage = ring + warp * 16 * LDV;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const float inv = 1.f / l[hr];
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      if (j < 2 * ngd) {
        *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8 * hr) * LDV + j * 8 + 2 * c) =
            __floats2bfloat162_rn(o[j][2 * hr] * inv, o[j][2 * hr + 1] * inv);
      }
    }
    const int qi = q0 + warp * 16 + g + 8 * hr;
    if (g0 == 0 && c == 0 && qi < p.n) p.lse[bh * p.n + qi] = m[hr] + logf(l[hr]);
  }
  __syncwarp();
  tc::store_rows_rt(p.o + b * p.o_sb + h * p.o_sh + g0, p.o_sn, stage, LDV, 16, q0 + warp * 16,
                    p.n, min(gw, p.dh - g0), p.o_bytes, lane, 32);
}

cudaError_t prepare(const void* fn, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

cudaError_t launch_kernel(const void* fn, const Params& p, int batch, int heads, size_t bytes,
                          cudaStream_t stream) {
  cudaError_t err = prepare(fn, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + BQ - 1) / BQ, heads, batch);
  void* args[] = {const_cast<Params*>(&p)};
  return cudaLaunchKernel(fn, grid, dim3(NTHREADS), args, bytes, stream);
}

template <int JMAX>
const void* resident() { return reinterpret_cast<const void*>(&relpos_fwd_resident_kernel<JMAX>); }

template <int JMAX>
cudaError_t launch_streamed(const Params& p, int batch, int heads, int gw, size_t bytes,
                            cudaStream_t stream) {
  cudaError_t err = prepare(reinterpret_cast<const void*>(&relpos_fwd_kernel<JMAX>), bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + BQ - 1) / BQ, heads, batch * ((p.dh + gw - 1) / gw));
  relpos_fwd_kernel<JMAX><<<grid, NTHREADS, bytes, stream>>>(p, gw);
  return cudaGetLastError();
}

cudaError_t launch_fp32(const Params& p, int batch, int heads, cudaStream_t stream) {
  if (resident_fits(p.dh, p.d2)) {
    const size_t bytes = resident_smem_floats(p.dh, p.d2) * sizeof(float);
    switch (jmax_for(p.dh)) {
      case 2: return launch_kernel(resident<2>(), p, batch, heads, bytes, stream);
      case 4: return launch_kernel(resident<4>(), p, batch, heads, bytes, stream);
      case 6: return launch_kernel(resident<6>(), p, batch, heads, bytes, stream);
      default: return launch_kernel(resident<8>(), p, batch, heads, bytes, stream);
    }
  }
  // streamed, in stream order: the prep pass writes the A rows the key loop reads
  const size_t bytes = smem_floats(p.dh) * sizeof(float);
  if (bytes > MAX_SMEM || p.atab == nullptr) return cudaErrorInvalidValue;
  const rfma::PrepParams pp{p.qu, nullptr, nullptr, p.delta, p.w, p.rowtab, p.atab, nullptr,
                            p.n, p.dh, p.d2, p.qu_sb, p.qu_sh, p.qu_sn, 0, 0, 0, 0, 0, 0};
  cudaError_t err = rfma::launch_prep(pp, batch, heads, stream);
  if (err != cudaSuccess) return err;
  const int gw = fwd_group_width(p.dh);
  switch (jmax_for(gw)) {
    case 2: return launch_streamed<2>(p, batch, heads, gw, bytes, stream);
    case 4: return launch_streamed<4>(p, batch, heads, gw, bytes, stream);
    case 6: return launch_streamed<6>(p, batch, heads, gw, bytes, stream);
    case 8: return launch_streamed<8>(p, batch, heads, gw, bytes, stream);
    case 12: return launch_streamed<12>(p, batch, heads, gw, bytes, stream);
    default: return launch_streamed<16>(p, batch, heads, gw, bytes, stream);
  }
}

// the padded head width the tensor-core kernel's registers are sized for
inline int tc_dmax(int dhp) { return dhp <= 64 ? 64 : dhp <= 96 ? 96 : 144; }

template <int DMAX>
cudaError_t launch_tc_d(const TcParams& p, int batch, int heads, size_t bytes,
                        cudaStream_t stream) {
  cudaError_t err = prepare(reinterpret_cast<const void*>(&relpos_fwd_tc_kernel<DMAX>), bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + rtc::BQ - 1) / rtc::BQ, heads, batch);
  relpos_fwd_tc_kernel<DMAX><<<grid, rtc::THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_wide_d(const TcParams& p, int batch, int heads, int gw, size_t bytes,
                          cudaStream_t stream) {
  cudaError_t err = prepare(reinterpret_cast<const void*>(&relpos_fwd_wide_tc_kernel<DMAX>), bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + rtc::BQ - 1) / rtc::BQ, heads, batch * ((p.rt.dhp + gw - 1) / gw));
  relpos_fwd_wide_tc_kernel<DMAX><<<grid, rtc::THREADS, bytes, stream>>>(p, gw);
  return cudaGetLastError();
}

// the resident kernel where it takes the widths (tc_fits), else the wide
// route: in stream order, the prep pass writes the A rows the key loop reads
cudaError_t launch_bf16(const TcParams& p, int batch, int heads, cudaStream_t stream) {
  const int dhp = p.rt.dhp, d2p = 2 * p.rt.hdp;
  if (tc_fits(dhp, d2p)) {
    const size_t bytes = tc_smem_bytes(dhp, d2p);
    switch (tc_dmax(dhp)) {
      case 64: return launch_tc_d<64>(p, batch, heads, bytes, stream);
      case 96: return launch_tc_d<96>(p, batch, heads, bytes, stream);
      default: return launch_tc_d<144>(p, batch, heads, bytes, stream);
    }
  }
  if (p.atab == nullptr) return cudaErrorInvalidValue;
  const rtc::PrepWide pw{p.qu, nullptr, nullptr, p.rt, p.atab, nullptr, p.n, p.dh, p.qu_sb,
                         p.qu_sh, p.qu_sn, 0, 0, 0, 0, 0, 0, p.qu_bytes};
  cudaError_t err = rtc::launch_prep_wide(pw, batch, heads, stream);
  if (err != cudaSuccess) return err;
  const int gw = rtc::wide_gw(dhp);
  const size_t bytes = tc_wide_smem_bytes(dhp);
  if (rtc::wide_dmax(gw) == 64) return launch_wide_d<64>(p, batch, heads, gw, bytes, stream);
  return launch_wide_d<rtc::WIDE_DMAX>(p, batch, heads, gw, bytes, stream);
}

// the bf16 route's padded widths
inline int tc_dhp(int dh) { return tc::round16(dh); }
inline int tc_d2p(int d2) { return 2 * rtc::round8(d2 / 2); }

}  // namespace

extern "C" {

// 1 where the fp32 route runs the resident kernel at widths dh and d2 (it
// needs no atab), 0 where it runs the prep pass and the streamed kernel.
int ecf_relpos_attention_fwd_resident(int dh, int d2) { return resident_fits(dh, d2) ? 1 : 0; }

// 1 where the bf16 route runs the wide route at widths dh and d2 (the prep
// pass and relpos_fwd_wide_tc_kernel, which need atab), 0 where it runs
// relpos_fwd_tc_kernel.
int ecf_relpos_attention_fwd_wide(int dh, int d2) { return tc_fits(tc_dhp(dh), tc_d2p(d2)) ? 0 : 1; }

// Shared memory one block of the route for `dtype` (0 float32: the FMA
// kernels, the resident kernel where it fits, else the larger of the prep
// pass and the streamed key loop; 1 bfloat16: the tensor-core kernel where
// it fits, else the larger of the wide route's prep pass and key loop) needs
// at head width dh and rel width d2, in bytes (ptxas reports none: it is
// sized at launch).
size_t ecf_relpos_attention_fwd_smem(int dtype, int dh, int d2) {
  if (dtype == 1 && tc_fits(tc_dhp(dh), tc_d2p(d2))) return tc_smem_bytes(tc_dhp(dh), tc_d2p(d2));
  if (dtype == 1) return tc_wide_smem_bytes(tc_dhp(dh));
  if (resident_fits(dh, d2)) return resident_smem_floats(dh, d2) * sizeof(float);
  const size_t prep = rfma::prep_smem_floats(dh), loop = smem_floats(dh);
  return (prep > loop ? prep : loop) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16 for qu, k, v and o. float32 takes delta,
// w, rowtab and keytab in fp32 at widths dh and d2, and atab (B, H, N, d2)
// fp32 as the scratch of the streamed kernel's A rows (null where the
// resident kernel takes the widths: ecf_relpos_attention_fwd_resident);
// bfloat16 takes them in bf16, padded as relpos_tc.cuh describes, with d2
// the padded rel width, and atab (B, H, N, d2) bf16 as the wide route's A
// rows (null where relpos_fwd_tc_kernel takes the widths:
// ecf_relpos_attention_fwd_wide). Returns a cudaError_t.
int ecf_relpos_attention_fwd(
    int dtype, const void* qu, const void* k, const void* v, const void* delta,
    const void* w, const void* rowtab, const void* keytab, const float* bias,
    void* o, float* lse, void* atab, int batch, int heads, int n, int nk, int dh, int d2,
    int64_t qu_sb, int64_t qu_sh, int64_t qu_sn, int64_t k_sb, int64_t k_sh,
    int64_t k_sn, int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t o_sb,
    int64_t o_sh, int64_t o_sn, int64_t bias_sb, float scale, void* stream) {
  if (n <= 0 || nk <= 0 || dh <= 0 || d2 <= 0 || d2 % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Params p{static_cast<const float*>(qu), static_cast<const float*>(k),
             static_cast<const float*>(v), static_cast<const float*>(delta),
             static_cast<const float*>(w), static_cast<const float*>(rowtab),
             static_cast<const float*>(keytab), bias, static_cast<float*>(o), lse,
             static_cast<float*>(atab),
             n, nk, dh, d2, qu_sb, qu_sh, qu_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn,
             o_sb, o_sh, o_sn, bias_sb, scale};
    return static_cast<int>(launch_fp32(p, batch, heads, s));
  }
  if (dtype != 1 || d2 % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  using tc::bf16;
  TcParams p{static_cast<const bf16*>(qu), static_cast<const bf16*>(k),
             static_cast<const bf16*>(v),
             {static_cast<const bf16*>(delta), static_cast<const bf16*>(w),
              static_cast<const bf16*>(rowtab), static_cast<const bf16*>(keytab), tc_dhp(dh),
              d2 / 2},
             bias, static_cast<bf16*>(o), lse, n, nk, dh, qu_sb, qu_sh, qu_sn, k_sb, k_sh, k_sn,
             v_sb, v_sh, v_sn, o_sb, o_sh, o_sn, bias_sb, scale,
             tc::copy_bytes(qu, qu_sb, qu_sh, qu_sn, dh), tc::copy_bytes(k, k_sb, k_sh, k_sn, dh),
             tc::copy_bytes(v, v_sb, v_sh, v_sn, dh), tc::copy_bytes(o, o_sb, o_sh, o_sn, dh),
             static_cast<bf16*>(atab)};
  return static_cast<int>(launch_bf16(p, batch, heads, s));
}

const char* ecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
