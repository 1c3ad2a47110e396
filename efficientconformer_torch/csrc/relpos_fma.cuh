// The fp32 route of the factorized rel-pos attention kernels: the pieces
// that rel_attention_fwd.cu and rel_attention_bwd.cu share. Every product is
// an fp32 FMA from shared memory (TF32 products would miss the fp32 checks).
// The backward always runs on them; the forward where its resident kernel,
// which holds [qu | A] whole, does not fit (rel_attention_fwd.cu).
//
// Nothing here holds a whole row of augmented features in shared memory, so
// no rel width is bounded by it:
//   * prep_kernel forms the A rows of 64 query rows (the qu tile, a staged W
//     chunk and a 64 x 128 staging tile of A in shared memory: 4 dh (68) +
//     16,384 + 33,024 bytes, 119,040 at dh 256) and writes them to device
//     memory, with Di = rowsum(dO * O) for the backward;
//   * tile_product is every product of the route: a 64 x 64 fp32 tile, each
//     of 256 threads owning a 4 x 4 piece, contracted over any depth in
//     double-buffered chunks of DC = 32 (34,048 bytes);
//   * what a block keeps beside it is bounded by the head width: the V tile
//     of the forward (64 x 16 JMAX floats, 65,536 bytes at dh 256) and the
//     dO and qu columns of the backward's key side (two 16 JD x 65, JD <= 8).
// So the largest pass needs 119,040 bytes at the widest head taken (256), at
// any rel width, within the 232,448 bytes a block may use on sm_90.
// ops/rel_attention.py mirrors these constants and sizes (fma_smem_bytes).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rfma {

constexpr int BQ = 64;          // query rows a tile
constexpr int BK = 64;          // keys a tile
constexpr int DC = 32;          // depth of a streamed chunk
constexpr int NTHREADS = 256;   // a 16 x 16 grid: ty owns 4 rows of a tile, tx 4 columns
constexpr int LDA = BQ + 4;     // A-chunk row stride ([depth][row]): 16-byte float4 reads
constexpr int LDB = BK + 1;     // B-chunk row stride ([depth][column]): odd, one word reads
constexpr int STAGE = DC * LDA + DC * LDB;   // one chunk of each operand
constexpr int TILE_FLOATS = 2 * STAGE;       // tile_product's double buffer
constexpr int LDV = 68;         // row stride of tiles read four rows at a time
constexpr int LDS = 65;         // row stride of tiles read one word at a time
constexpr int WCHUNK = 32;      // rows of W staged at a time while forming A
constexpr int LDAS = 129;       // row stride of prep's A staging tile (64 rows x 128 columns)
constexpr int MAX_DH = 256;     // widest head: 16 output columns a thread in the forward
constexpr size_t MAX_SMEM = 232448;   // 227 KB a block may use on sm_90
constexpr float MASKED = -1e30f;

static_assert(NTHREADS == 16 * 16 && BQ == 4 * 16 && BK == 4 * 16, "thread grid");
static_assert(DC * BQ == 8 * NTHREADS && DC * BK == 8 * NTHREADS, "8 chunk elements a thread");
static_assert(BK * LDV <= TILE_FLOATS, "a 64 x 68 tile fits tile_product's buffer");

__host__ __device__ inline size_t prep_smem_floats(int dh) {
  return static_cast<size_t>(dh) * LDV + WCHUNK * 128 + BQ * LDAS;
}

// acc[i][c] += sum over depth kk < kdim of A(kk, 4 ty + i) * B(kk, tx + 16 c),
// the operands streamed through `buf` (TILE_FLOATS floats) in chunks of DC.
// load_a(kk, row) and load_b(kk, col) return the operands' elements (0 past
// their edges); A_KFAST / B_KFAST say which index the operand's memory runs
// along, so that a warp's loads are coalesced: true, the depth (a warp reads
// 32 neighbouring depths of one row); false, the rows (a warp reads 32
// neighbouring rows at one depth). No thread may still read `buf` on entry;
// none reads it on return.
template <bool A_KFAST, bool B_KFAST, class LoadA, class LoadB>
__device__ __forceinline__ void tile_product(float (&acc)[4][4], int kdim, float* buf,
                                             LoadA load_a, LoadB load_b) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nch = (kdim + DC - 1) / DC;
  float sa[8], sb[8];
  auto at = [&](bool kfast, int e, int& kk, int& idx) {
    if (kfast) {
      kk = tid % DC;
      idx = tid / DC + 8 * e;
    } else {
      idx = tid % 64;
      kk = tid / 64 + 4 * e;
    }
  };
  auto load = [&](int ch) {
    const int k0 = ch * DC;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      int kk, idx;
      at(A_KFAST, e, kk, idx);
      sa[e] = k0 + kk < kdim ? load_a(k0 + kk, idx) : 0.f;
      at(B_KFAST, e, kk, idx);
      sb[e] = k0 + kk < kdim ? load_b(k0 + kk, idx) : 0.f;
    }
  };
  auto store = [&](int stage) {
    float* as = buf + stage * STAGE;
    float* bs = as + DC * LDA;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      int kk, idx;
      at(A_KFAST, e, kk, idx);
      as[kk * LDA + idx] = sa[e];
      at(B_KFAST, e, kk, idx);
      bs[kk * LDB + idx] = sb[e];
    }
  };
  if (nch == 0) return;
  load(0);
  store(0);
  __syncthreads();
  for (int ch = 0; ch < nch; ++ch) {
    const bool more = ch + 1 < nch;
    if (more) load(ch + 1);
    const float* as = buf + (ch & 1) * STAGE + ty * 4;
    const float* bs = buf + (ch & 1) * STAGE + DC * LDA + tx;
    const int dend = min(DC, kdim - ch * DC);
#pragma unroll 4
    for (int dd = 0; dd < dend; ++dd) {
      const float4 a = *reinterpret_cast<const float4*>(as + dd * LDA);
      const float* brow = bs + dd * LDB;
      const float b0 = brow[0], b1 = brow[16], b2 = brow[32], b3 = brow[48];
      acc[0][0] = fmaf(a.x, b0, acc[0][0]); acc[0][1] = fmaf(a.x, b1, acc[0][1]);
      acc[0][2] = fmaf(a.x, b2, acc[0][2]); acc[0][3] = fmaf(a.x, b3, acc[0][3]);
      acc[1][0] = fmaf(a.y, b0, acc[1][0]); acc[1][1] = fmaf(a.y, b1, acc[1][1]);
      acc[1][2] = fmaf(a.y, b2, acc[1][2]); acc[1][3] = fmaf(a.y, b3, acc[1][3]);
      acc[2][0] = fmaf(a.z, b0, acc[2][0]); acc[2][1] = fmaf(a.z, b1, acc[2][1]);
      acc[2][2] = fmaf(a.z, b2, acc[2][2]); acc[2][3] = fmaf(a.z, b3, acc[2][3]);
      acc[3][0] = fmaf(a.w, b0, acc[3][0]); acc[3][1] = fmaf(a.w, b1, acc[3][1]);
      acc[3][2] = fmaf(a.w, b2, acc[3][2]); acc[3][3] = fmaf(a.w, b3, acc[3][3]);
    }
    if (more) store((ch + 1) & 1);
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
}

struct PrepParams {
  const float* qu;
  const float* o;       // the backward's: O and dO, for Di; null in the forward
  const float* dout;
  const float* delta;   // (H, dh)
  const float* w;       // (H, dh, d2)
  const float* rowtab;  // (N, d2)  [sin | cos]
  float* atab;          // (B, H, N, d2): the A rows
  float* di;            // (B, H, N), or null
  int n, dh, d2;
  int64_t qu_sb, qu_sh, qu_sn;
  int64_t o_sb, o_sh, o_sn;
  int64_t do_sb, do_sh, do_sn;
};

// One block per (64 query rows, head, batch): the A rows of the tile,
//   [P | Q] = (qu + delta) W_h,  A = [sin*P + cos*Q | sin*Q - cos*P],
// written to atab (rows past N are not written), and, when di is given,
// Di = rowsum(dO * O). A register-tiled product: thread (ty, tx) forms rows
// tx + 16 i (i < 4) of columns ty + 16 m (m < 4) of both halves, 64 columns
// of each at a time, with W staged 32 rows at a time, so each shared-memory
// load feeds 4 to 8 FMAs; the 64 x 128 result goes out through a staging
// tile as whole-row stores.
__global__ void __launch_bounds__(NTHREADS) prep_kernel(PrepParams p) {
  extern __shared__ __align__(16) float smem[];
  const int dh = p.dh, d2 = p.d2, hd = d2 / 2;
  float* quT = smem;                        // dh x LDV: qu of the rows, feature-major
  float* ws = quT + dh * LDV;               // WCHUNK x 128: a chunk of W's rows
  float* as = ws + WCHUNK * 128;            // BQ x LDAS: A of 64 paired columns
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * gridDim.y + h;
  const float* qu = p.qu + b * p.qu_sb + h * p.qu_sh;

  for (int r = warp; r < BQ; r += NTHREADS / 32) {
    const int qi = q0 + r;
    for (int d = lane; d < dh; d += 32) quT[d * LDV + r] = qi < p.n ? qu[qi * p.qu_sn + d] : 0.f;
  }
  if (p.di != nullptr) {   // Di, a warp a row
    const float* op = p.o + b * p.o_sb + h * p.o_sh;
    const float* dop = p.dout + b * p.do_sb + h * p.do_sh;
    for (int r = warp; r < BQ && q0 + r < p.n; r += NTHREADS / 32) {
      const int qi = q0 + r;
      float acc = 0.f;
      for (int d = lane; d < dh; d += 32) acc = fmaf(dop[qi * p.do_sn + d], op[qi * p.o_sn + d], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) p.di[bh * p.n + qi] = acc;
    }
  }

  const float* wh = p.w + static_cast<int64_t>(h) * dh * d2;
  const float* dl = p.delta + h * dh;
  for (int j0 = 0; j0 < hd; j0 += 64) {
    float pacc[4][4], qacc[4][4];
    zero(pacc);
    zero(qacc);
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
        for (int i = 0; i < 4; ++i) x[i] = quT[d * LDV + tx + 16 * i] + dv;
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
    // rotate into the staging tile: column c < 64 is A_even j0 + c, c >= 64
    // A_odd j0 + c - 64 (the previous pass's stores finished at the barrier
    // of this pass's first W chunk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tx + 16 * i, qi = q0 + r;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int c = ty + 16 * m, j = j0 + c;
        float a_even = 0.f, a_odd = 0.f;
        if (qi < p.n && j < hd) {
          const float sn = p.rowtab[static_cast<int64_t>(qi) * d2 + j];
          const float cs = p.rowtab[static_cast<int64_t>(qi) * d2 + hd + j];
          a_even = sn * pacc[i][m] + cs * qacc[i][m];
          a_odd = sn * qacc[i][m] - cs * pacc[i][m];
        }
        as[r * LDAS + c] = a_even;
        as[r * LDAS + 64 + c] = a_odd;
      }
    }
    __syncthreads();
    const int width = min(64, hd - j0);
    for (int r = warp; r < BQ && q0 + r < p.n; r += NTHREADS / 32) {
      float* arow = p.atab + (bh * p.n + q0 + r) * d2;
      for (int c = lane; c < 128; c += 32) {
        const int jj = c & 63;
        if (jj < width) arow[(c < 64 ? 0 : hd) + j0 + jj] = as[r * LDAS + c];
      }
    }
  }
}

// Shared memory the prep pass takes, and its launch, on the given stream.
inline cudaError_t launch_prep(const PrepParams& p, int batch, int heads, cudaStream_t stream) {
  const size_t bytes = prep_smem_floats(p.dh) * sizeof(float);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&prep_kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + BQ - 1) / BQ, heads, batch);
  prep_kernel<<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace rfma
