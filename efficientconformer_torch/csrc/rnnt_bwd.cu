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
// dependent diagonals per utterance (up to 291 at the Transducer's training
// shape), not the bytes (about 5.9 MB at B = 16, T = 201, U+1 = 91: under
// 2 us at 3.35 TB/s); one block per utterance keeps B of the 132 SMs busy.
//
// What the design does about it: one block per utterance, one thread per
// label position u, and a loop over the diagonals from d = f - 1 + y down to
// 0, so a short utterance stops early. Thread u reads alpha, blank and emit
// at (d-u, u) from the unskewed (B, T, U+1) tensors one diagonal ahead; it
// keeps beta[t+1, u] (its own value of the last diagonal) in a register and
// reads beta[t, u+1] (its neighbour's) from shared memory, double-buffered,
// with one __syncthreads() per diagonal. The zeros outside the lattice are
// written first, coalesced, by the whole block.
//
// Inputs: blank, emit, alphas (B, T, U1) fp32 contiguous; f_len, y_len (B,)
// int32; ll (B,) fp32. Outputs: g_blank, g_emit (B, T, U1) fp32. The kernel
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG_EPS = -1e30f;
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__global__ void rnnt_bwd_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
                                const float* __restrict__ alphas, const int* __restrict__ f_len,
                                const int* __restrict__ y_len, const float* __restrict__ ll,
                                float* __restrict__ g_blank, float* __restrict__ g_emit,
                                int t_max, int u1) {
  extern __shared__ float nxt[];   // 2 x (blockDim + 1): beta of a diagonal at u, slot u;
                                   // slot blockDim stays LOG_EPS
  const int u = threadIdx.x;
  const int b = blockIdx.x;
  const int64_t base = static_cast<int64_t>(b) * t_max * u1;
  const float* bl = blank + base;
  const float* em = emit + base;
  const float* al = alphas + base;
  float* gb = g_blank + base;
  float* ge = g_emit + base;
  const int f = f_len[b], y = y_len[b];
  const float llb = ll[b];
  const int stride = blockDim.x + 1;

  // zeros outside the utterance's lattice
  for (int i = u; i < t_max * u1; i += blockDim.x) {
    const int t = i / u1, uu = i - t * u1;
    if (t >= f || uu > y) {
      gb[i] = 0.f;
      ge[i] = 0.f;
    }
  }
  for (int i = u; i < 2 * stride; i += blockDim.x) nxt[i] = LOG_EPS;

  // alpha, blank and emit of this thread's cell on diagonal d (if inside)
  auto load = [&](int d, float& a, float& sb, float& se) {
    const int t = d - u;
    if (t >= 0 && t < f && u <= y) {
      const int64_t cell = static_cast<int64_t>(t) * u1 + u;
      a = al[cell];
      sb = bl[cell];
      se = em[cell];
    } else {
      a = sb = se = 0.f;
    }
  };

  const int d_final = f - 1 + y;
  float own = LOG_EPS;   // beta[t+1, u]: this thread's value on diagonal d + 1
  float na, nb, ne;
  load(d_final, na, nb, ne);
  __syncthreads();
  for (int d = d_final; d >= 0; --d) {
    const float* up = nxt + ((d + 1) & 1) * stride;
    float* cur = nxt + (d & 1) * stride;
    const float a = na, sb = nb, se = ne;
    if (d > 0) load(d - 1, na, nb, ne);
    const int t = d - u;
    float beta = LOG_EPS;
    if (t >= 0 && t < f && u <= y) {
      const bool terminal = t == f - 1 && u == y;
      const float bup = up[u + 1];                 // beta[t, u+1]
      const float bn = terminal ? 0.f : own;
      const int64_t cell = static_cast<int64_t>(t) * u1 + u;
      gb[cell] = expf(a + sb + bn - llb);
      ge[cell] = expf(a + se + bup - llb);
      beta = terminal ? sb : logaddexp(sb + own, se + bup);
    }
    cur[u] = beta;
    own = beta;
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t.
int ecf_rnnt_bwd(const float* blank, const float* emit, const float* alphas, const int* f_len,
                 const int* y_len, const float* ll, float* g_blank, float* g_emit, int batch,
                 int t_max, int u1, void* stream) {
  if (batch <= 0 || t_max <= 0 || u1 <= 0 || u1 > MAX_THREADS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (u1 + 31) / 32 * 32;
  const size_t smem = 2 * (threads + 1) * sizeof(float);
  rnnt_bwd_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      blank, emit, alphas, f_len, y_len, ll, g_blank, g_emit, t_max, u1);
  return static_cast<int>(cudaGetLastError());
}

const char* ecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
