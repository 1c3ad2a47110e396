// RNN-T lattice forward (the alphas and the loss), for sm_90a.
//
// Replaces the TPU kernel efficientconformer_tpu/ops/pallas_rnnt.py:
// _fwd_kernel (launched by _alphas). For each utterance b it computes, over
// the whole (T, U+1) lattice of the gathered log-probs,
//
//     alpha[0, 0] = 0
//     alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
//                             alpha[t, u-1] + emit[t, u-1])
//
// (a term off the lattice is LOG_EPS) and the loss
// -(alpha[f_len-1, y_len] + blank[f_len-1, y_len]). The plain PyTorch version
// is reference_rnnt_alphas in ops/rnnt_loss.py; both take logaddexp(a, b) as
// max(a, b) + log1p(exp(-|a - b|)) with the precise expf and log1pf (no fast
// math: __expf and __logf would not keep the fp32 tolerance), and
// logaddexp(LOG_EPS, LOG_EPS) stays finite.
//
// What bounds it on the H100: the chain of T + U dependent anti-diagonals of
// an utterance (291 at the Transducer's training shape, B 16, T 201,
// U+1 91), not the bytes (3.5 MB there, about 1 us at 3.35 TB/s). The cells
// of a diagonal d = t + u are independent, each needs the one before, and
// one block per utterance keeps B of the 132 SMs busy. A diagonal costs
// about 0.16 us there (chip_smoke.py, [rnnt-kernel-time]): the logaddexp,
// the barrier and the loop's own dependent shared-memory, shuffle and copy
// operations, which a warp issues in order. The loads are off the chain:
// staged RING diagonals ahead, they have arrived when they are read.
//
// What the design does about it: one block per utterance, one thread per
// label position u, a loop over the diagonals whose body is one basic block
// (predicates, no branches, so the compiler can interleave the independent
// work with the chain).
//  - Staging: the operands, blank at (d-1-u, u) and emit at (d-u, u-1), are
//    copied into a ring of RING diagonals in shared memory (skewed: one
//    slot per thread and operand) with 4-byte cp.async, one commit group a
//    diagonal, RING diagonals ahead of the chain. Each thread reads back
//    only its own slots, so the ring needs no barrier; cells off the lattice
//    are not copied. RING (8, rnnt_wavefront.cuh) was chosen from a sweep
//    of 1 to 16 at U+1 91: a ring of 1 was slower, 2 to 8 alike, and 16,
//    with twice the shared memory, slower again.
//  - Exchange: alpha[t, u-1] of the last diagonal comes from the lane below
//    by __shfl_up_sync; across a warp boundary lane 31 leaves its value in
//    shared memory (double-buffered) and one __syncthreads() a diagonal
//    orders it, which a block of one warp (U+1 <= 32) skips. A flag per
//    warp pair and a split-phase mbarrier in its place were tried and
//    measured slower at U+1 91; their code is not kept.
//  - Order: after diagonal d's value the thread publishes and shuffles it,
//    stages diagonal d + RING and loads d + 1's operands before the barrier,
//    and stores it after, so that after the barrier only the boundary value
//    and the arithmetic stand on the chain. Addresses follow the thread's
//    column by running offsets, and a cell's test is one unsigned compare:
//    the fewer instructions a diagonal, the shorter the chain, since a warp
//    issues them in order.
//
// Past MAX_THREADS label positions a thread cannot own one position, so two
// more routes take every U+1 (rnnt_wavefront.cuh gives their geometry). Each
// keeps every cell's arithmetic, so their results are the plain version's.
//  - rnnt_fwd_strip_kernel<K> (K = 2, 4, 8): thread i owns the strip of K
//    consecutive positions u0 = i K .. u0 + K - 1 and keeps their alphas of
//    the last diagonal in registers. On diagonal d its cell j reads
//    alpha[t-1, u] from its own cell j and alpha[t, u-1] from its own cell
//    j - 1; only cell 0 needs the thread below, whose last cell comes by the
//    shuffle and edge slots above, one __syncthreads() a diagonal. The K
//    cells of a diagonal are independent, work for the warp beside the
//    chain. The operands are staged as above, K slots a thread and operand,
//    in a ring as deep as the shared memory allows (RING down to 1; at U+1
//    8,192 three diagonals).
//  - rnnt_fwd_readback_kernel (no ring; the wrapper takes it for strips
//    wider than STRIP_MAX, past STRIP_MAX x MAX_THREADS positions): the
//    same strips, but the last diagonal is read back from the alphas this
//    kernel writes (a thread's own cells, and the thread below's last cell,
//    which the diagonal's __syncthreads() makes visible inside the block),
//    and the operands are read straight from global memory. Slow, and it
//    takes any U+1 that device memory holds.
//
// Inputs: blank, emit (B, T, U1) fp32 contiguous; f_len, y_len (B,) int32;
// the launch geometry of rnnt_loss.launch_geometry (threads, strip, ring,
// shared bytes). Outputs: alphas (B, T, U1) fp32; loss (B,) fp32. The
// kernels allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rnnt_wavefront.cuh"

namespace {

using namespace rnnt;

constexpr int OPERANDS = 2;   // blank and emit

__global__ void __launch_bounds__(MAX_THREADS)
    rnnt_fwd_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
                    const int* __restrict__ f_len, const int* __restrict__ y_len,
                    float* __restrict__ alphas, float* __restrict__ loss, int t_max, int u1) {
  extern __shared__ float smem[];   // edge (EDGE) | ring (RING x (blank, emit) x threads)
  const int nt = blockDim.x, u = threadIdx.x, lane = u & 31, warp = u >> 5;
  const bool warps = nt > 32;
  const int b = blockIdx.x;
  const int64_t base = static_cast<int64_t>(b) * t_max * u1;
  const float* bl = blank + base;
  const float* em = emit + base;
  float* al = alphas + base;
  const int n_diag = t_max + u1 - 1;
  const uint32_t edge = smem_addr(smem);   // warp w's last alpha of diagonal d at (d & 1) * 32 + w
  const uint32_t mine_slot = edge + 4 * (EDGE + u);
  auto slot = [&](int d) { return mine_slot + 4 * OPERANDS * nt * (d % RING); };

  // copy diagonal d's operands of this thread: blank at (t-1, u) where the
  // stay term reads it (1 <= t < T), emit at (t, u-1) where the move term
  // does (u >= 1, 0 <= t < T); then close the diagonal's group, empty or
  // not, so that every thread counts the same groups. Called for d = 1, 2,
  // ... in turn: `at` follows the cell (d - u, u) down its column.
  const bool col = u < u1;
  int64_t at = static_cast<int64_t>(1 - u) * u1 + u;
  auto stage = [&](int d) {
    const uint32_t s = slot(d);
    const int t = d - u;
    const bool cell =
        col && d < n_diag && static_cast<unsigned>(t) < static_cast<unsigned>(t_max);
    cp_async4_if(s, bl + at - u1, cell && t >= 1);
    cp_async4_if(s + 4 * nt, em + at - 1, cell && u >= 1);
    cp_async_commit();
    at += u1;
  };

  for (int d = 1; d <= RING; ++d) stage(d);
  float mine = u == 0 ? 0.f : LOG_EPS;   // this thread's alpha on the last diagonal
  if (u == 0) al[0] = 0.f;
  if (u < EDGE) smem[u] = LOG_EPS;
  cp_async_wait<RING - 1>();
  float sb = ld_shared(slot(1)), se = ld_shared(slot(1) + 4 * nt);   // diagonal 1's operands
  float left = __shfl_up_sync(0xffffffffu, mine, 1);                 // alpha[t, u-1]
  int64_t out = static_cast<int64_t>(1 - u) * u1 + u;                // cell (d - u, u)
  __syncthreads();
  for (int d = 1; d < n_diag; ++d) {
    if (lane == 0) {
      left = warp > 0 ? ld_shared(edge + 4 * (((d - 1) & 1) * 32 + warp - 1)) : LOG_EPS;
    }
    const int t = d - u;
    const float stay = t >= 1 ? mine + sb : LOG_EPS;
    const float move = u >= 1 ? left + se : LOG_EPS;
    const float value = logaddexp(stay, move);
    const bool cell = col && static_cast<unsigned>(t) < static_cast<unsigned>(t_max);
    const float next = cell ? value : LOG_EPS;
    if (warps && lane == 31) st_shared(edge + 4 * ((d & 1) * 32 + warp), next);
    left = __shfl_up_sync(0xffffffffu, next, 1);
    mine = next;
    stage(d + RING);   // into the slot of diagonal d, read already
    cp_async_wait<RING - 1>();
    sb = ld_shared(slot(d + 1));
    se = ld_shared(slot(d + 1) + 4 * nt);
    if (warps) __syncthreads();
    if (cell) al[out] = next;   // after the barrier, off the chain
    out += u1;
  }
  cp_async_wait<0>();

  if (u == y_len[b]) {
    const int64_t cell = static_cast<int64_t>(f_len[b] - 1) * u1 + u;
    loss[b] = -(al[cell] + bl[cell]);
  }
}


// U+1 past MAX_THREADS: a strip of K positions a thread in registers, the
// operands staged in a ring of `ring` diagonals (1 <= ring <= RING)
template <int K>
__global__ void __launch_bounds__(MAX_THREADS)
    rnnt_fwd_strip_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
                          const int* __restrict__ f_len, const int* __restrict__ y_len,
                          float* __restrict__ alphas, float* __restrict__ loss, int t_max, int u1,
                          int ring) {
  extern __shared__ float smem[];   // edge (EDGE) | ring (ring x (blank, emit) x K x threads)
  const int nt = blockDim.x, i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const int u0 = i * K;
  const int b = blockIdx.x;
  const int64_t base = static_cast<int64_t>(b) * t_max * u1;
  const float* bl = blank + base;
  const float* em = emit + base;
  float* al = alphas + base;
  const int n_diag = t_max + u1 - 1;
  const uint32_t edge = smem_addr(smem);   // warp w's last alpha of diagonal d at (d & 1) * 32 + w
  const uint32_t mine_slot = edge + 4 * (EDGE + i);
  // operand o (0 blank, 1 emit) of cell j on diagonal d
  auto slot = [&](int d, int o, int j) {
    return mine_slot + 4 * nt * ((d % ring) * OPERANDS * K + o * K + j);
  };
  // cell j of the strip on diagonal d is (d - u0 - j, u0 + j), at offset
  // row - j * step, where row is cell 0's offset
  const int64_t step = u1 - 1;

  // copy diagonal d's operands of the strip (as rnnt_fwd_kernel's stage),
  // then close the diagonal's group
  int64_t at = static_cast<int64_t>(1 - u0) * u1 + u0;   // cell 0 on diagonal 1
  auto stage = [&](int d) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int u = u0 + j, t = d - u;
      const bool cell =
          u < u1 && d < n_diag && static_cast<unsigned>(t) < static_cast<unsigned>(t_max);
      const int64_t c = at - j * step;
      cp_async4_if(slot(d, 0, j), bl + c - u1, cell && t >= 1);
      cp_async4_if(slot(d, 1, j), em + c - 1, cell && u >= 1);
    }
    cp_async_commit();
    at += u1;
  };

  for (int d = 1; d <= ring; ++d) stage(d);
  float mine[K];   // the strip's alphas on the last diagonal
#pragma unroll
  for (int j = 0; j < K; ++j) mine[j] = u0 + j == 0 ? 0.f : LOG_EPS;
  if (i == 0) al[0] = 0.f;
  if (i < EDGE) smem[i] = LOG_EPS;
  cp_async_wait_dyn(ring - 1);
  float sb[K], se[K];   // the next diagonal's operands
#pragma unroll
  for (int j = 0; j < K; ++j) {
    sb[j] = ld_shared(slot(1, 0, j));
    se[j] = ld_shared(slot(1, 1, j));
  }
  float left = __shfl_up_sync(0xffffffffu, mine[K - 1], 1);   // alpha[t, u0-1]
  int64_t row = static_cast<int64_t>(1 - u0) * u1 + u0;        // cell 0 on diagonal d
  __syncthreads();
  for (int d = 1; d < n_diag; ++d) {
    if (lane == 0) {
      left = warp > 0 ? ld_shared(edge + 4 * (((d - 1) & 1) * 32 + warp - 1)) : LOG_EPS;
    }
    float next[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int u = u0 + j, t = d - u;
      const float stay = t >= 1 ? mine[j] + sb[j] : LOG_EPS;
      const float move = u >= 1 ? (j == 0 ? left : mine[j - 1]) + se[j] : LOG_EPS;
      const float value = logaddexp(stay, move);
      const bool cell = u < u1 && static_cast<unsigned>(t) < static_cast<unsigned>(t_max);
      next[j] = cell ? value : LOG_EPS;
    }
    if (lane == 31) st_shared(edge + 4 * ((d & 1) * 32 + warp), next[K - 1]);
    left = __shfl_up_sync(0xffffffffu, next[K - 1], 1);
#pragma unroll
    for (int j = 0; j < K; ++j) mine[j] = next[j];
    stage(d + ring);   // into the slots of diagonal d, read already
    cp_async_wait_dyn(ring - 1);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      sb[j] = ld_shared(slot(d + 1, 0, j));
      se[j] = ld_shared(slot(d + 1, 1, j));
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < K; ++j) {   // after the barrier, off the chain
      const int u = u0 + j, t = d - u;
      if (u < u1 && static_cast<unsigned>(t) < static_cast<unsigned>(t_max)) {
        al[row - j * step] = mine[j];
      }
    }
    row += u1;
  }
  cp_async_wait<0>();

  const int y = y_len[b];
  if (y >= u0 && y < u0 + K) {
    const int64_t cell = static_cast<int64_t>(f_len[b] - 1) * u1 + y;
    loss[b] = -(al[cell] + bl[cell]);
  }
}

// no ring: a strip of `strip` positions a thread, the last diagonal read
// back from the alphas written (not restrict: the kernel reads what it
// writes), the operands from global memory
__global__ void __launch_bounds__(MAX_THREADS)
    rnnt_fwd_readback_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
                             const int* __restrict__ f_len, const int* __restrict__ y_len,
                             float* alphas, float* __restrict__ loss, int t_max, int u1,
                             int strip) {
  const int u0 = threadIdx.x * strip, u_end = min(u0 + strip, u1);
  const int b = blockIdx.x;
  const int64_t base = static_cast<int64_t>(b) * t_max * u1;
  const float* bl = blank + base;
  const float* em = emit + base;
  float* al = alphas + base;
  const int n_diag = t_max + u1 - 1;
  if (threadIdx.x == 0) al[0] = 0.f;
  __syncthreads();
  for (int d = 1; d < n_diag; ++d) {
    for (int u = u0; u < u_end; ++u) {
      const int t = d - u;
      if (static_cast<unsigned>(t) >= static_cast<unsigned>(t_max)) continue;
      const int64_t c = static_cast<int64_t>(t) * u1 + u;
      const float stay = t >= 1 ? al[c - u1] + bl[c - u1] : LOG_EPS;
      const float move = u >= 1 ? al[c - 1] + em[c - 1] : LOG_EPS;
      al[c] = logaddexp(stay, move);
    }
    __syncthreads();   // the diagonal's alphas, visible to the block
  }

  const int y = y_len[b];
  if (y >= u0 && y < u_end) {
    const int64_t cell = static_cast<int64_t>(f_len[b] - 1) * u1 + y;
    loss[b] = -(al[cell] + bl[cell]);
  }
}

template <int K>
cudaError_t launch_strip(const float* blank, const float* emit, const int* f_len,
                         const int* y_len, float* alphas, float* loss, int batch, int t_max,
                         int u1, int threads, int ring, int smem, cudaStream_t stream) {
  const auto kernel = rnnt_fwd_strip_kernel<K>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<batch, threads, smem, stream>>>(blank, emit, f_len, y_len, alphas, loss, t_max, u1,
                                           ring);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t. threads, strip, ring and smem are the launch
// geometry (rnnt_wavefront.cuh, geometry_ok): strip 1 runs rnnt_fwd_kernel,
// no ring the read-back kernel, strips 2, 4 and 8 with a ring
// rnnt_fwd_strip_kernel<K>.
int ecf_rnnt_fwd(const float* blank, const float* emit, const int* f_len, const int* y_len,
                 float* alphas, float* loss, int batch, int t_max, int u1, int threads,
                 int strip, int ring, int smem, void* stream) {
  if (batch <= 0 || t_max <= 0 || !geometry_ok(u1, threads, strip, ring, smem, OPERANDS)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (ring == 0) {
    rnnt_fwd_readback_kernel<<<batch, threads, 0, s>>>(blank, emit, f_len, y_len, alphas, loss,
                                                       t_max, u1, strip);
    return static_cast<int>(cudaGetLastError());
  }
  switch (strip) {
    case 2: return static_cast<int>(launch_strip<2>(blank, emit, f_len, y_len, alphas, loss,
                                                    batch, t_max, u1, threads, ring, smem, s));
    case 4: return static_cast<int>(launch_strip<4>(blank, emit, f_len, y_len, alphas, loss,
                                                    batch, t_max, u1, threads, ring, smem, s));
    case 8: return static_cast<int>(launch_strip<8>(blank, emit, f_len, y_len, alphas, loss,
                                                    batch, t_max, u1, threads, ring, smem, s));
  }
  const auto kernel = rnnt_fwd_kernel;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<batch, threads, smem, s>>>(blank, emit, f_len, y_len, alphas, loss, t_max, u1);
  return static_cast<int>(cudaGetLastError());
}

const char* ecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
