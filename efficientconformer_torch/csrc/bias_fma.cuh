// fp32 FMA tiles of the bias-attention kernels past a head width of 256
// (bias_attention_fwd.cu: bias_fwd_chunked_{scores,out}_kernel,
// bias_attention_bwd.cu: bias_bwd_chunked_{scores,grads}_kernel), for
// sm_90a.
//
// Every block is THREADS = 128 threads over a 64 x 64 output tile, thread
// (ty, tx) = (tid / 16, tid % 16) accumulating the 8 x 4 micro-tile of rows
// 8 ty .. 8 ty + 7 and columns 4 tx .. 4 tx + 3 in registers, as fp32 FMAs
// (TF32 products would miss the fp32 checks, 1e-4, by an order). The
// operands stream through shared memory in chunks of KC along the product's
// depth, copied by cp.async into a ring of STAGES stages, so that the
// copies of chunk s + 2 are in flight while chunk s is multiplied. Each
// depth step of a thread is 32 FMAs from three 16-byte shared-memory loads
// (8 values of its rows, 4 of its columns): 2.7 FMAs a float loaded.
//
// Two kinds of product:
//   * scores, acc[r][c] = sum_f A[r][f] B[c][f]: rows of two strided
//     matrices (q and k, or dO and v) over a head width. Each chunk lands
//     transposed, [feature][row], so that a thread's 8 rows are two 16-byte
//     loads. A transposing copy moves 4 bytes at a time, which also takes
//     rows of any width and alignment (257 and 270 are not 16-byte
//     aligned): a warp copies 8 rows x 4 features, and with the row stride
//     LDT = 72 (8 mod 32) its 32 stores fall in 32 distinct banks.
//   * products, acc[r][c] = sum_d A[d][r] X[d][c]: A a column of 64 x 64
//     tiles of a scratch the score kernels wrote depth-major ([d][r]: 16-byte
//     copies of contiguous rows), X the rows of a strided matrix (v, k, q or
//     dO) over the block's 64 columns, row-major, copied in 16-, 8- or 4-byte
//     pieces as its rows' alignment allows (vec_floats).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace bfma {

constexpr int T = 64;          // rows, keys and columns of a tile
constexpr int THREADS = 128;   // an 8 x 16 thread grid, an 8 x 4 micro-tile a thread
constexpr int KC = 32;         // depth of a ring stage: features, keys or query rows
constexpr int STAGES = 3;      // stages of the ring
constexpr int LDT = T + 8;     // row stride of a transposed chunk [KC][LDT]
constexpr int LDX = T + 4;     // row stride of a row-major chunk of X [KC][LDX]
constexpr int TILE = T * T;    // floats of a scratch tile

// bytes of shared memory of a ring: a score kernel's (two transposed chunks
// a stage), a product kernel's (a chunk of A tiles and one of X a stage)
constexpr size_t SCORES_RING = static_cast<size_t>(STAGES) * 2 * KC * LDT * sizeof(float);
constexpr size_t PRODUCT_RING = static_cast<size_t>(STAGES) * KC * (T + LDX) * sizeof(float);

static_assert(THREADS == 128 && T == 64 && KC % 4 == 0 && T % KC == 0, "the copies' shapes");
static_assert(LDT % 32 == 8 && LDT % 4 == 0 && LDX % 4 == 0, "banks and 16-byte rows");

// tiles of T covering n
__host__ __device__ inline int tiles(int n) { return (n + T - 1) / T; }

// floats of scratch per (batch, head). The forward: an E tile per (query
// tile, key tile) and each (key tile, row)'s max and sum (two floats).
__host__ __device__ inline size_t fwd_work(int nq, int nk) {
  return static_cast<size_t>(tiles(nq)) * tiles(nk) * (TILE + 2 * T);
}
// The backward: a P, a dS and a dS^T tile per (query tile, key tile).
__host__ __device__ inline size_t bwd_work(int nq, int nk) {
  return static_cast<size_t>(tiles(nq)) * tiles(nk) * 3 * TILE;
}

// The widest piece (4, 2 or 1 floats) in which every row of a strided fp32
// matrix can be copied: the base, the batch, head and row strides and the
// width all multiples of it.
inline int vec_floats(const void* ptr, int64_t sb, int64_t sh, int64_t sn, int width) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(ptr);
  if (a % 16 == 0 && sb % 4 == 0 && sh % 4 == 0 && sn % 4 == 0 && width % 4 == 0) return 4;
  if (a % 8 == 0 && sb % 2 == 0 && sh % 2 == 0 && sn % 2 == 0 && width % 2 == 0) return 2;
  return 1;
}

// Rows [row0, row0 + T) and features [f0, f0 + KC) of a strided fp32
// matrix (nrows rows of `width` features, row stride sn) into shared
// dst[f][r] (row stride LDT), zero outside, by 4-byte cp.async: warp w's
// copy h takes rows 8 (w + 4 h) + lane / 4, features 4 i + lane % 4.
__device__ __forceinline__ void load_t(float* dst, const float* src, int64_t sn, int row0,
                                       int nrows, int f0, int width) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, f = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 8 * (warp + 4 * h) + (lane >> 2);
    const bool row_ok = row0 + r < nrows;
    const float* s = src + (row_ok ? static_cast<int64_t>(row0 + r) * sn : 0) + f0 + f;
#pragma unroll
    for (int i = 0; i < KC / 4; ++i) {
      const bool ok = row_ok && f0 + 4 * i + f < width;
      tc::cp_async4(dst + (4 * i + f) * LDT + r, ok ? s + 4 * i : src, ok);
    }
  }
}

// Rows [d0, d0 + KC) and columns [c0, c0 + T) of a strided fp32 matrix
// (nrows rows of `width` columns, row stride sn) into shared dst[d][c] (row
// stride LDX), zero outside, in pieces of vec floats (vec_floats, which
// also makes `width` a multiple of vec: a piece lies wholly inside or out).
__device__ __forceinline__ void load_x(float* dst, const float* src, int64_t sn, int d0,
                                       int nrows, int c0, int width, int vec) {
  const int lv = vec == 4 ? 2 : vec == 2 ? 1 : 0;   // log2 of a piece
  const int shift = 6 - lv;                          // pieces a row: T >> lv = 1 << shift
  for (int i = threadIdx.x; i < KC << shift; i += THREADS) {
    const int r = i >> shift, c = (i & ((1 << shift) - 1)) << lv;
    const bool ok = d0 + r < nrows && c0 + c < width;
    const float* s = ok ? src + static_cast<int64_t>(d0 + r) * sn + c0 + c : src;
    float* d = dst + r * LDX + c;
    if (lv == 2) {
      tc::cp_async16(d, s, ok);
    } else if (lv == 1) {
      tc::cp_async8(d, s, ok);
    } else {
      tc::cp_async4(d, s, ok);
    }
  }
}

// KC rows of a scratch tile (contiguous [.][T] floats from src) into shared
// dst[KC][T] by 16-byte cp.async
__device__ __forceinline__ void load_a(float* dst, const float* src) {
#pragma unroll
  for (int k = 0; k < KC * T / 4 / THREADS; ++k) {
    const int i = 4 * (threadIdx.x + k * THREADS);
    tc::cp_async16(dst + i, src + i, true);
  }
}

// acc[i][j] += sum_{d < KC} a[d LDA + i] b[d LDB + j]: a and b this
// thread's first row and column in a stage
template <int LDA, int LDB>
__device__ __forceinline__ void fma_chunk(float (&acc)[8][4], const float* a, const float* b) {
#pragma unroll
  for (int d = 0; d < KC; ++d) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + d * LDA);
    const float4 a1 = *reinterpret_cast<const float4*>(a + d * LDA + 4);
    const float4 bv = *reinterpret_cast<const float4*>(b + d * LDB);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
  }
}

// The ring: load(s, stage) issues step s's copies into a stage; the
// prologue puts the first STAGES - 1 steps in flight, then run() waits for
// each step in turn and calls compute(s, stage) on it, with the copies of
// step s + STAGES - 1 in flight (into the stage step s - 1 used, which
// every thread is done with at the barrier). Split in two, so that a block
// may do other work while the first copies land.
template <class Load>
__device__ __forceinline__ void ring_start(int nsteps, Load load) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load(s, s);
    tc::cp_async_commit();
  }
}

template <class Load, class Compute>
__device__ __forceinline__ void ring_run(int nsteps, Load load, Compute compute) {
  for (int s = 0; s < nsteps; ++s) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < nsteps) load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    tc::cp_async_commit();
    compute(s, s % STAGES);
  }
}

// out[r][c] (rows [r0, r0 + T) below nrows, columns [c0, c0 + T) below
// width, row stride sn) = alpha acc, from this thread's micro-tile
__device__ __forceinline__ void store_tile(float* out, int64_t sn, int r0, int nrows, int c0,
                                           int width, float alpha, const float (&acc)[8][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + 8 * ty + i;
    if (r >= nrows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * tx + j;
      if (c < width) out[static_cast<int64_t>(r) * sn + c] = alpha * acc[i][j];
    }
  }
}

// this thread's micro-tile of acc as a T x T tile, row-major ([r][c]) and,
// with `trans`, column-major ([c][r]), in 16-byte stores
__device__ __forceinline__ void put_tile(float* tile, const float (&acc)[8][4], bool trans) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  if (trans) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* col = tile + (4 * tx + j) * T + 8 * ty;
      *reinterpret_cast<float4*>(col) = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      *reinterpret_cast<float4*>(col + 4) =
          make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<float4*>(tile + (8 * ty + i) * T + 4 * tx) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

}  // namespace bfma
