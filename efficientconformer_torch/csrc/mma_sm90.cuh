// Tensor-core building blocks for the bf16 attention kernels, for sm_90a:
// inline PTX for mma.sync (m16n8k16, bf16 in, fp32 accumulate), ldmatrix and
// cp.async, and the tile loaders and stores the bias-attention kernels share.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, c = lane % 4):
//   A (16 x 16, row-major), four b32 registers of two bf16 each:
//     a0 (row g, cols 2c, 2c+1), a1 (row g+8, cols 2c..), a2 (row g, cols
//     2c+8..), a3 (row g+8, cols 2c+8..);
//   B (16 x 8, "col": each column's 16 values contiguous), two registers:
//     b0 (rows 2c, 2c+1 of column g), b1 (rows 2c+8, 2c+9 of column g);
//   C (16 x 8 fp32), four floats: c0, c1 (row g, cols 2c, 2c+1), c2, c3
//     (row g+8, cols 2c, 2c+1).
// So the accumulators of two neighbouring 8-column tiles, rounded to bf16,
// are the A fragment of the next product over those 16 columns
// (FlashAttention-2's register reuse of P).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// asynchronous copies global -> shared; with full = false the destination is
// zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 8 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's most recent groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, as shared-window byte addresses (a lane's base computed once, plus
// compile-time offsets, keeps the address arithmetic out of the loops)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16x2 register, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a product over 16 columns from the accumulators of the
// two 8-column tiles that hold them.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// This lane's ldmatrix.x4 address for the 16 x 16 bf16 block at the top left
// of a row-major shared tile with row stride LD; add 2 * (16 rows * LD + 16
// columns) bytes per block step:
//   a_lane: the A fragment (the tile's rows are the product's rows);
//   b_lane: two B fragments of neighbouring 8-column tiles, the tile stored
//           with the product's columns as its rows (k for q k^T);
//   bt_lane: two B fragments, the tile stored with the product's depth as
//           its rows (v for P v), for ldsm_x4_t.
template <int LD>
__device__ __forceinline__ uint32_t a_lane(const bf16* tile, int lane) {
  return smem_addr(tile + (lane & 15) * LD + ((lane >> 4) << 3));
}
template <int LD>
__device__ __forceinline__ uint32_t b_lane(const bf16* tile, int lane) {
  return smem_addr(tile + ((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3));
}
template <int LD>
__device__ __forceinline__ uint32_t bt_lane(const bf16* tile, int lane) {
  return smem_addr(tile + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + ((lane >> 4) << 3));
}
// byte offset of 16 x 16 block (row block i, column block j)
template <int LD>
__device__ __forceinline__ constexpr uint32_t blk(int i, int j) {
  return static_cast<uint32_t>((i * 16 * LD + j * 16) * 2);
}

// True when every row of a strided bf16 matrix can be copied in 16-byte
// pieces: the base, the batch, head and row strides (in elements) and the
// width are all multiples of 8 elements.
inline bool vec16(const void* ptr, int64_t sb, int64_t sh, int64_t sn, int width) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 && sh % 8 == 0 &&
         sn % 8 == 0 && width % 8 == 0;
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// The widest piece (16, 4 or 2 bytes) in which every row of a strided bf16
// matrix can be copied: 16 as vec16; 4 when the base is 4-byte aligned and
// the strides and the width are even; 2 otherwise (an odd head width).
inline int copy_bytes(const void* ptr, int64_t sb, int64_t sh, int64_t sn, int width) {
  if (vec16(ptr, sb, sh, sn, width)) return 16;
  if (reinterpret_cast<uintptr_t>(ptr) % 4 == 0 && sb % 2 == 0 && sh % 2 == 0 && sn % 2 == 0 &&
      width % 2 == 0) {
    return 4;
  }
  return 2;
}

// Eight bf16 into 16-byte-aligned shared dst: elements [0, n) from src, the
// rest zero; src must be a valid address even when n <= 0 (nothing is read
// then). bytes is what the source allows (copy_bytes): one 16-byte cp.async,
// four 4-byte ones (n even), or 2-byte loads and stores (done on return);
// cp.async completes through cp_async_wait.
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, int n, int bytes) {
  if (n >= 8 && bytes == 16) {
    cp_async16(dst, src, true);
  } else if (n <= 0) {
    cp_async16(dst, src, false);
  } else if (bytes >= 4 && (n & 1) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) cp_async4(dst + 2 * i, 2 * i < n ? src + 2 * i : src, 2 * i < n);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = i < n ? src[i] : __float2bfloat16(0.f);
  }
}

// Rows [0, rows) of shared [.][lds] (runtime stride) to rows [row0, row0 +
// rows) of a (nrows, width) bf16 matrix with row stride ld_g, by `nlanes`
// threads numbered `lane`, in pieces of `bytes` (copy_bytes of the output).
__device__ __forceinline__ void store_rows_rt(bf16* dst, int64_t ld_g, const bf16* src, int lds,
                                              int rows, int row0, int nrows, int width,
                                              int bytes, int lane, int nlanes) {
  const int per = bytes == 16 ? 8 : bytes == 4 ? 2 : 1;   // elements a piece
  const int npc = width / per;
  for (int i = lane; i < rows * npc; i += nlanes) {
    const int r = i / npc, col = (i - r * npc) * per;
    if (row0 + r >= nrows) continue;
    bf16* d = dst + (row0 + r) * ld_g + col;
    const bf16* s = src + r * lds + col;
    if (per == 8) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else if (per == 2) {
      *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
    } else {
      *d = *s;
    }
  }
}

// Rows [row0, row0 + ROWS) of a (nrows, width) bf16 matrix with row stride
// ld_g into shared [ROWS][LD], by all NTHREADS threads; width <= DMAX.
// Rows past nrows and columns in [width, round16(width)) are zero. With vec,
// 16-byte cp.async (completion through cp_async_wait); otherwise 2-byte
// loads and stores, done on return. The trip counts and divisors are
// compile-time, so a copy costs a handful of instructions.
template <int ROWS, int LD, int DMAX, int NTHREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t ld_g, int row0,
                                          int nrows, int width, bool vec) {
  constexpr int CH = DMAX / 8;   // 16-byte chunks of a row at the widest
  static_assert((ROWS * CH) % NTHREADS == 0, "whole sweeps of the block");
  const int nch = round16(width) >> 3;
  if (vec) {
#pragma unroll
    for (int k = 0; k < ROWS * CH / NTHREADS; ++k) {
      const int i = threadIdx.x + k * NTHREADS, r = i / CH, ch = i % CH;
      if (ch < nch) {
        const bool ok = row0 + r < nrows && (ch << 3) < width;
        cp_async16(dst + r * LD + (ch << 3), ok ? src + (row0 + r) * ld_g + (ch << 3) : src, ok);
      }
    }
  } else {
    const int wp = nch << 3;
    for (int i = threadIdx.x; i < ROWS * wp; i += NTHREADS) {
      const int r = i / wp, col = i - r * wp;
      const bool ok = row0 + r < nrows && col < width;
      dst[r * LD + col] = ok ? src[(row0 + r) * ld_g + col] : __float2bfloat16(0.f);
    }
  }
}

// A (ROWS, COLS) tile of the bias of one (batch, head), rows from row0 and
// columns from col0, into shared fp32 [ROWS][LDB]: an fp32 bias by 4-byte
// cp.async (its rows need not be 16-byte aligned: the LM's are 404 bytes
// apart), a bf16 bias by loads; zero outside (nrows, ncols). Consecutive
// threads take consecutive columns, so a warp reads a row's run of keys.
template <int ROWS, int COLS, int LDB, int NTHREADS>
__device__ __forceinline__ void load_bias_tile(float* dst, const void* bias, bool is_bf16,
                                               int64_t off_bh, int64_t sn, int row0, int col0,
                                               int nrows, int ncols) {
  static_assert(NTHREADS % COLS == 0 && ROWS % (NTHREADS / COLS) == 0, "whole rows a sweep");
  constexpr int STEP = NTHREADS / COLS;   // rows a sweep of the block covers
  const int c = threadIdx.x % COLS, r0 = threadIdx.x / COLS;
  const bool col_ok = col0 + c < ncols;
  const int64_t off = off_bh + (row0 + r0) * sn + col0 + c, step = STEP * sn;
  if (is_bf16) {
    const bf16* src = static_cast<const bf16*>(bias) + off;
#pragma unroll
    for (int k = 0; k < ROWS / STEP; ++k, src += step) {
      const int r = r0 + k * STEP;
      dst[r * LDB + c] = col_ok && row0 + r < nrows ? __bfloat162float(*src) : 0.f;
    }
  } else {
    const float* src = static_cast<const float*>(bias) + off;
#pragma unroll
    for (int k = 0; k < ROWS / STEP; ++k, src += step) {
      const int r = r0 + k * STEP;
      const bool ok = col_ok && row0 + r < nrows;
      cp_async4(dst + r * LDB + c, ok ? src : bias, ok);
    }
  }
}

// Rows [0, rows) of shared [.][LD] to rows [row0, row0 + rows) of a
// (nrows, width) bf16 matrix with row stride ld_g, by `nlanes` threads
// numbered `lane`: 16-byte stores when vec, else 2-byte ones.
template <int LD>
__device__ __forceinline__ void store_rows(bf16* dst, int64_t ld_g, const bf16* src, int rows,
                                           int row0, int nrows, int width, bool vec, int lane,
                                           int nlanes) {
  if (vec) {
    const int nch = width >> 3;
    for (int i = lane; i < rows * nch; i += nlanes) {
      const int r = i / nch, ch = i - r * nch;
      if (row0 + r < nrows) {
        *reinterpret_cast<uint4*>(dst + (row0 + r) * ld_g + (ch << 3)) =
            *reinterpret_cast<const uint4*>(src + r * LD + (ch << 3));
      }
    }
  } else {
    for (int i = lane; i < rows * width; i += nlanes) {
      const int r = i / width, col = i - r * width;
      if (row0 + r < nrows) dst[(row0 + r) * ld_g + col] = src[r * LD + col];
    }
  }
}

}  // namespace tc
