// RNN-T lattice backward (the betas and the gradients), for sm_90a.
//
// Replaces the TPU kernel efficientconformer_tpu/ops/pallas_rnnt.py:
// _bwd_kernel (launched by _vjp_bwd). For each utterance b, with f = f_len[b],
// y = y_len[b] and ll[b] the log likelihood, it runs the beta recursion from
// the terminal cell (f-1, y) down over the cells t < f, u <= y,
//
//     beta[f-1, y] = blank[f-1, y]
//     beta[t, u]   = logaddexp(blank[t, u] + beta[t+1, u], emit[t, u] + beta[t, u+1])
//
// (beta = LOG_EPS off the utterance's lattice) and writes
//
//     d ll / d blank[t, u] = exp(alpha[t, u] + blank[t, u] + beta[t+1, u] - ll)
//     d ll / d emit[t, u]  = exp(alpha[t, u] + emit[t, u] + beta[t, u+1] - ll)
//
// with beta[t+1, u] := 0 at the terminal cell, and exact zeros in both
// gradients outside the utterance's lattice (t >= f or u > y). The caller
// scales them by the cotangent. The plain PyTorch version is
// reference_rnnt_grads in ops/rnnt_loss.py; both take logaddexp(a, b) as
// max(a, b) + log1p(exp(-|a - b|)) and sum the exponents in the same order,
// with the precise expf and log1pf (no fast math).
//
// What bounds it on the H100: as for the forward, the chain of f + y
// dependent diagonals of an utterance (up to 291 at the Transducer's
// training shape, B 16, T 201, U+1 91), not the bytes (about 5.9 MB there,
// under 2 us at 3.35 TB/s); one block per utterance keeps B of the 132 SMs
// busy. A diagonal of the betas costs about 0.19 us there, the gradient
// kernel included (chip_smoke.py, [rnnt-kernel-time]). Computed in the
// chain, as the TPU kernel does, the gradients' exponentials, loads and
// stores are issued in order by the same warps between the chain's steps;
// that form was tried and measured slower than the two kernels below.
//
// What the design does about it: two kernels on the stream.
//  - rnnt_bwd_kernel runs only the beta recursion, as the forward runs the
//    alphas: one block per utterance, one thread per label position u, a
//    loop over the diagonals from d = f - 1 + y down to 0 (a short
//    utterance stops early) whose body is one basic block, and the betas
//    inside the lattice stored into a scratch tensor. Its operands, blank
//    and emit at (d-u, u), are staged in shared memory ahead of the chain:
//    a ring of RING diagonals (skewed: one slot per thread and operand)
//    filled with 4-byte cp.async, one commit group a diagonal; only cells
//    inside the lattice are copied, and each thread reads back only its own
//    slots, so the ring needs no barrier. beta[t+1, u] is the thread's own
//    last value; beta[t, u+1] comes from the lane above by
//    __shfl_down_sync, and across a warp boundary lane 0 leaves its value in
//    shared memory (double-buffered) under one __syncthreads() a diagonal,
//    which a block of one warp skips (the forward's head comment says what
//    was tried in its place). After a diagonal's beta the thread publishes
//    and shuffles it, stages diagonal d - RING and loads d - 1's operands
//    before the barrier, and stores it after.
//  - rnnt_grad_kernel then writes both gradients of every cell, one thread
//    each across the whole card, exact zeros outside the lattice included,
//    with the same expressions in the same order (its index is 64-bit where
//    T x U+1 passes 2^31 cells).
//
// Past MAX_THREADS label positions the betas take the forward's two other
// routes (rnnt_fwd.cu's head comment), mirrored: in rnnt_bwd_strip_kernel<K>
// a thread's cell j reads beta[t+1, u] from its own cell j and beta[t, u+1]
// from its own cell j + 1; only the strip's last cell needs the thread
// above (__shfl_down_sync and the edge slots); rnnt_bwd_readback_kernel
// reads both back from the betas scratch it writes. The gradient kernel is
// the same for every route.
//
// Inputs: blank, emit, alphas (B, T, U1) fp32 contiguous; f_len, y_len (B,)
// int32; ll (B,) fp32; the launch geometry of rnnt_loss.launch_geometry
// (threads, strip, ring, shared bytes). Outputs: g_blank, g_emit (B, T, U1) fp32;
// betas (B, T, U1) fp32 is the caller's scratch, written inside each
// lattice only. The kernels allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rnnt_wavefront.cuh"

namespace {

using namespace rnnt;

constexpr int OPERANDS = 2;   // blank and emit

constexpr int GRAD_THREADS = 256;

// the betas inside each utterance's lattice, into `betas`; nothing else of it
// is written
__global__ void __launch_bounds__(MAX_THREADS)
    rnnt_bwd_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
                    const int* __restrict__ f_len, const int* __restrict__ y_len,
                    float* __restrict__ betas, int t_max, int u1) {
  extern __shared__ float smem[];   // edge (EDGE) | ring (RING x (blank, emit) x threads)
  const int nt = blockDim.x, u = threadIdx.x, lane = u & 31, warp = u >> 5;
  const bool warps = nt > 32;
  const int b = blockIdx.x;
  const int64_t base = static_cast<int64_t>(b) * t_max * u1;
  const float* bl = blank + base;
  const float* em = emit + base;
  float* be = betas + base;
  const int f = f_len[b], y = y_len[b];
  const uint32_t edge = smem_addr(smem);   // warp w's first beta of diagonal d at (d & 1) * 32 + w
  const uint32_t mine_slot = edge + 4 * (EDGE + u);
  // diagonal d >= -RING in slot (d + RING) % RING
  auto slot = [&](int d) { return mine_slot + 4 * OPERANDS * nt * ((d + RING) % RING); };

  // copy blank and emit of this thread's cell on diagonal d where it lies
  // inside the utterance's lattice; then close the diagonal's group, empty
  // or not, so that every thread counts the same groups. Called for
  // d = d_final, d_final - 1, ... in turn: `at` follows the cell (d - u, u)
  // up its column.
  const int d_final = f - 1 + y;
  const bool col = u <= y;
  int64_t at = static_cast<int64_t>(d_final - u) * u1 + u;
  auto stage = [&](int d) {
    const uint32_t s = slot(d);
    const bool cell = col && d >= 0 && static_cast<unsigned>(d - u) < static_cast<unsigned>(f);
    cp_async4_if(s, bl + at, cell);
    cp_async4_if(s + 4 * nt, em + at, cell);
    cp_async_commit();
    at -= u1;
  };

  for (int i = 0; i < RING; ++i) stage(d_final - i);
  if (u < EDGE) smem[u] = LOG_EPS;
  float own = LOG_EPS;   // beta[t+1, u]: this thread's value on the last diagonal
  cp_async_wait<RING - 1>();
  float sb = ld_shared(slot(d_final)), se = ld_shared(slot(d_final) + 4 * nt);
  float right = LOG_EPS;   // beta[t, u+1]
  int64_t out = static_cast<int64_t>(d_final - u) * u1 + u;   // cell (d - u, u)
  __syncthreads();
  for (int d = d_final; d >= 0; --d) {
    if (lane == 31) {
      right = warp + 1 < nt / 32 ? ld_shared(edge + 4 * (((d + 1) & 1) * 32 + warp + 1))
                                 : LOG_EPS;
    }
    const int t = d - u;
    const bool cell = col && static_cast<unsigned>(t) < static_cast<unsigned>(f);
    const float beta = t == f - 1 && u == y ? sb : logaddexp(sb + own, se + right);
    own = cell ? beta : LOG_EPS;
    if (warps && lane == 0) st_shared(edge + 4 * ((d & 1) * 32 + warp), own);
    right = __shfl_down_sync(0xffffffffu, own, 1);
    stage(d - RING);   // into the slot of diagonal d, read already
    cp_async_wait<RING - 1>();
    sb = ld_shared(slot(d - 1));
    se = ld_shared(slot(d - 1) + 4 * nt);
    if (warps) __syncthreads();
    if (cell) be[out] = own;   // after the barrier, off the chain
    out -= u1;
  }
  cp_async_wait<0>();
}

// the gradients of every cell (b, t, u), one thread each, from the betas of
// the beta kernel: exact zeros outside the lattice, beta = LOG_EPS past its
// edge, beta[t+1, u] := 0 at the terminal cell. Index is int where T x U+1
// fits in it (every lattice up to U+1 1024 the kernels took before the
// strips) and int64_t past it.
template <typename Index>
__global__ void __launch_bounds__(GRAD_THREADS)
    rnnt_grad_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
                     const float* __restrict__ alphas, const float* __restrict__ betas,
                     const int* __restrict__ f_len, const int* __restrict__ y_len,
                     const float* __restrict__ ll, float* __restrict__ g_blank,
                     float* __restrict__ g_emit, int t_max, int u1) {
  const int b = blockIdx.y;
  const Index i = static_cast<Index>(blockIdx.x) * GRAD_THREADS + threadIdx.x;
  if (i >= static_cast<Index>(t_max) * u1) return;
  const int t = static_cast<int>(i / u1), u = static_cast<int>(i - static_cast<Index>(t) * u1);
  const int f = f_len[b], y = y_len[b];
  const int64_t at = static_cast<int64_t>(b) * t_max * u1 + i;
  float g_b = 0.f, g_e = 0.f;
  if (t < f && u <= y) {
    const float a = alphas[at], llb = ll[b];
    const float bn = t == f - 1 ? (u == y ? 0.f : LOG_EPS) : betas[at + u1];   // beta[t+1, u]
    const float bup = u < y ? betas[at + 1] : LOG_EPS;                         // beta[t, u+1]
    g_b = expf(a + blank[at] + bn - llb);
    g_e = expf(a + emit[at] + bup - llb);
  }
  g_blank[at] = g_b;
  g_emit[at] = g_e;
}

// U+1 past MAX_THREADS: a strip of K positions a thread in registers, the
// operands staged in a ring of `ring` diagonals (1 <= ring <= RING)
template <int K>
__global__ void __launch_bounds__(MAX_THREADS)
    rnnt_bwd_strip_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
                          const int* __restrict__ f_len, const int* __restrict__ y_len,
                          float* __restrict__ betas, int t_max, int u1, int ring) {
  extern __shared__ float smem[];   // edge (EDGE) | ring (ring x (blank, emit) x K x threads)
  const int nt = blockDim.x, i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const int u0 = i * K;
  const int b = blockIdx.x;
  const int64_t base = static_cast<int64_t>(b) * t_max * u1;
  const float* bl = blank + base;
  const float* em = emit + base;
  float* be = betas + base;
  const int f = f_len[b], y = y_len[b];
  const uint32_t edge = smem_addr(smem);   // warp w's first beta of diagonal d at (d & 1) * 32 + w
  const uint32_t mine_slot = edge + 4 * (EDGE + i);
  // operand o (0 blank, 1 emit) of cell j on diagonal d >= -ring
  auto slot = [&](int d, int o, int j) {
    return mine_slot + 4 * nt * (((d + ring) % ring) * OPERANDS * K + o * K + j);
  };
  const int64_t step = u1 - 1;   // cell j's offset is cell 0's less j * step

  // copy blank and emit of the strip's cells on diagonal d inside the
  // utterance's lattice (as rnnt_bwd_kernel's stage), then close the group
  const int d_final = f - 1 + y;
  int64_t at = static_cast<int64_t>(d_final - u0) * u1 + u0;   // cell 0 on diagonal d_final
  auto stage = [&](int d) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int u = u0 + j;
      const bool cell =
          u <= y && d >= 0 && static_cast<unsigned>(d - u) < static_cast<unsigned>(f);
      cp_async4_if(slot(d, 0, j), bl + at - j * step, cell);
      cp_async4_if(slot(d, 1, j), em + at - j * step, cell);
    }
    cp_async_commit();
    at -= u1;
  };

  for (int k = 0; k < ring; ++k) stage(d_final - k);
  if (i < EDGE) smem[i] = LOG_EPS;
  float own[K];   // beta[t+1, u]: the strip's betas on the last diagonal
#pragma unroll
  for (int j = 0; j < K; ++j) own[j] = LOG_EPS;
  cp_async_wait_dyn(ring - 1);
  float sb[K], se[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    sb[j] = ld_shared(slot(d_final, 0, j));
    se[j] = ld_shared(slot(d_final, 1, j));
  }
  float right = LOG_EPS;   // beta[t, u0+K]
  int64_t row = static_cast<int64_t>(d_final - u0) * u1 + u0;   // cell 0 on diagonal d
  __syncthreads();
  for (int d = d_final; d >= 0; --d) {
    if (lane == 31) {
      right = warp + 1 < nt / 32 ? ld_shared(edge + 4 * (((d + 1) & 1) * 32 + warp + 1))
                                 : LOG_EPS;
    }
    float next[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int u = u0 + j, t = d - u;
      const bool cell = u <= y && static_cast<unsigned>(t) < static_cast<unsigned>(f);
      const float up = j == K - 1 ? right : own[j + 1];
      const float beta = t == f - 1 && u == y ? sb[j] : logaddexp(sb[j] + own[j], se[j] + up);
      next[j] = cell ? beta : LOG_EPS;
    }
    if (lane == 0) st_shared(edge + 4 * ((d & 1) * 32 + warp), next[0]);
    right = __shfl_down_sync(0xffffffffu, next[0], 1);
#pragma unroll
    for (int j = 0; j < K; ++j) own[j] = next[j];
    stage(d - ring);   // into the slots of diagonal d, read already
    cp_async_wait_dyn(ring - 1);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      sb[j] = ld_shared(slot(d - 1, 0, j));
      se[j] = ld_shared(slot(d - 1, 1, j));
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < K; ++j) {   // after the barrier, off the chain
      const int u = u0 + j;
      if (u <= y && static_cast<unsigned>(d - u) < static_cast<unsigned>(f)) {
        be[row - j * step] = own[j];
      }
    }
    row -= u1;
  }
  cp_async_wait<0>();
}

// no ring: a strip of `strip` positions a thread, beta[t+1, u] and
// beta[t, u+1] read back from the betas written (not restrict: the kernel
// reads what it writes), the operands from global memory
__global__ void __launch_bounds__(MAX_THREADS)
    rnnt_bwd_readback_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
                             const int* __restrict__ f_len, const int* __restrict__ y_len,
                             float* betas, int t_max, int u1, int strip) {
  const int b = blockIdx.x;
  const int f = f_len[b], y = y_len[b];
  const int u0 = threadIdx.x * strip, u_end = min(u0 + strip, y + 1);
  const int64_t base = static_cast<int64_t>(b) * t_max * u1;
  const float* bl = blank + base;
  const float* em = emit + base;
  float* be = betas + base;
  for (int d = f - 1 + y; d >= 0; --d) {
    for (int u = u0; u < u_end; ++u) {
      const int t = d - u;
      if (static_cast<unsigned>(t) >= static_cast<unsigned>(f)) continue;
      const int64_t c = static_cast<int64_t>(t) * u1 + u;
      const float below = t + 1 < f ? be[c + u1] : LOG_EPS;   // beta[t+1, u]
      const float up = u < y ? be[c + 1] : LOG_EPS;           // beta[t, u+1]
      be[c] = t == f - 1 && u == y ? bl[c] : logaddexp(bl[c] + below, em[c] + up);
    }
    __syncthreads();   // the diagonal's betas, visible to the block
  }
}

template <int K>
cudaError_t launch_strip(const float* blank, const float* emit, const int* f_len,
                         const int* y_len, float* betas, int batch, int t_max, int u1,
                         int threads, int ring, int smem, cudaStream_t stream) {
  const auto kernel = rnnt_bwd_strip_kernel<K>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<batch, threads, smem, stream>>>(blank, emit, f_len, y_len, betas, t_max, u1, ring);
  return cudaGetLastError();
}

// the betas by the route of the geometry
cudaError_t launch_betas(const float* blank, const float* emit, const int* f_len,
                         const int* y_len, float* betas, int batch, int t_max, int u1,
                         int threads, int strip, int ring, int smem, cudaStream_t s) {
  if (ring == 0) {
    rnnt_bwd_readback_kernel<<<batch, threads, 0, s>>>(blank, emit, f_len, y_len, betas, t_max,
                                                       u1, strip);
    return cudaGetLastError();
  }
  switch (strip) {
    case 2: return launch_strip<2>(blank, emit, f_len, y_len, betas, batch, t_max, u1, threads,
                                   ring, smem, s);
    case 4: return launch_strip<4>(blank, emit, f_len, y_len, betas, batch, t_max, u1, threads,
                                   ring, smem, s);
    case 8: return launch_strip<8>(blank, emit, f_len, y_len, betas, batch, t_max, u1, threads,
                                   ring, smem, s);
  }
  const auto kernel = rnnt_bwd_kernel;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<batch, threads, smem, s>>>(blank, emit, f_len, y_len, betas, t_max, u1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t. threads, strip, ring and smem are the launch
// geometry (rnnt_wavefront.cuh, geometry_ok). Launches two kernels: the
// betas by the geometry's route, then the gradients.
int ecf_rnnt_bwd(const float* blank, const float* emit, const float* alphas, const int* f_len,
                 const int* y_len, const float* ll, float* g_blank, float* g_emit, float* betas,
                 int batch, int t_max, int u1, int threads, int strip, int ring, int smem,
                 void* stream) {
  const int64_t cells = static_cast<int64_t>(t_max) * u1;
  const int64_t blocks = (cells + GRAD_THREADS - 1) / GRAD_THREADS;
  if (batch <= 0 || batch > 65535 || t_max <= 0 || blocks > INT32_MAX ||
      !geometry_ok(u1, threads, strip, ring, smem, OPERANDS)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_betas(blank, emit, f_len, y_len, betas, batch, t_max, u1, threads,
                                 strip, ring, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks), batch);
  if (cells + GRAD_THREADS <= INT32_MAX) {
    rnnt_grad_kernel<int><<<grid, GRAD_THREADS, 0, s>>>(blank, emit, alphas, betas, f_len, y_len,
                                                        ll, g_blank, g_emit, t_max, u1);
  } else {
    rnnt_grad_kernel<int64_t><<<grid, GRAD_THREADS, 0, s>>>(blank, emit, alphas, betas, f_len,
                                                            y_len, ll, g_blank, g_emit, t_max,
                                                            u1);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
