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
// What bounds it on the H100: not the bytes. The cells of one anti-diagonal
// d = t + u are independent, but each diagonal needs the one before, so an
// utterance is a chain of T + U dependent steps (291 at the Transducer's
// training shape, B = 16, T = 201, U+1 = 91), each a few hundred
// nanoseconds of load latency and a barrier; the 3.5 MB the kernel must move
// take about 1 us at 3.35 TB/s. With one block per utterance only B of the
// 132 SMs are busy.
//
// What the design does about it: one block per utterance and one thread per
// label position u, looping over the diagonals. Thread u reads
// blank[b, d-1-u, u] and emit[b, d-u, u-1] straight from the unskewed
// (B, T, U+1) tensors (the TPU kernel's skew to (T+U, B, U+1) and its
// 128-lane padding are not carried over), one diagonal ahead, so that the
// loads are in flight while the previous diagonal finishes. The previous
// diagonal's alphas live in shared memory, double-buffered, so one
// __syncthreads() per diagonal orders them. Filling the other SMs (several
// utterances or a split of U per block) is later work.
//
// Inputs: blank, emit (B, T, U1) fp32 contiguous; f_len, y_len (B,) int32.
// Outputs: alphas (B, T, U1) fp32; loss (B,) fp32. The kernel allocates
// nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG_EPS = -1e30f;
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__global__ void rnnt_fwd_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
                                const int* __restrict__ f_len, const int* __restrict__ y_len,
                                float* __restrict__ alphas, float* __restrict__ loss,
                                int t_max, int u1) {
  extern __shared__ float prev[];   // 2 x (blockDim + 1): alpha of the last diagonal at u,
                                    // slot u + 1; slot 0 stays LOG_EPS
  const int u = threadIdx.x;
  const int b = blockIdx.x;
  const int64_t base = static_cast<int64_t>(b) * t_max * u1;
  const float* bl = blank + base;
  const float* em = emit + base;
  float* al = alphas + base;
  const int stride = blockDim.x + 1;
  const bool lane = u < u1;

  // the operands of diagonal d for this thread: blank at (d-1-u, u) and emit
  // at (d-u, u-1), LOG_EPS where they fall off the lattice
  auto load = [&](int d, float& sb, float& se) {
    const int t = d - u;
    sb = (lane && t >= 1 && t <= t_max) ? bl[static_cast<int64_t>(t - 1) * u1 + u] : 0.f;
    se = (lane && u >= 1 && t >= 0 && t < t_max) ? em[static_cast<int64_t>(t) * u1 + u - 1] : 0.f;
  };

  prev[u + 1] = u == 0 ? 0.f : LOG_EPS;
  prev[stride + u + 1] = LOG_EPS;
  if (u == 0) {
    prev[0] = LOG_EPS;
    prev[stride] = LOG_EPS;
    al[0] = 0.f;
  }
  float mine = u == 0 ? 0.f : LOG_EPS;   // this thread's alpha on the last diagonal
  const int n_diag = t_max + u1 - 1;
  float nb, ne;
  load(1, nb, ne);
  __syncthreads();
  for (int d = 1; d < n_diag; ++d) {
    const float* last = prev + ((d - 1) & 1) * stride;
    float* cur = prev + (d & 1) * stride;
    const float sb = nb, se = ne;
    if (d + 1 < n_diag) load(d + 1, nb, ne);
    const int t = d - u;
    float alpha = LOG_EPS;
    if (lane && t >= 0 && t < t_max) {
      const float stay = t >= 1 ? mine + sb : LOG_EPS;
      const float move = u >= 1 ? last[u] + se : LOG_EPS;   // last[u] is alpha at (t, u-1)
      alpha = logaddexp(stay, move);
      al[static_cast<int64_t>(t) * u1 + u] = alpha;
    }
    cur[u + 1] = alpha;
    mine = alpha;
    __syncthreads();
  }

  if (u == y_len[b]) {
    const int64_t cell = static_cast<int64_t>(f_len[b] - 1) * u1 + u;
    loss[b] = -(al[cell] + bl[cell]);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t.
int ecf_rnnt_fwd(const float* blank, const float* emit, const int* f_len, const int* y_len,
                 float* alphas, float* loss, int batch, int t_max, int u1, void* stream) {
  if (batch <= 0 || t_max <= 0 || u1 <= 0 || u1 > MAX_THREADS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (u1 + 31) / 32 * 32;
  const size_t smem = 2 * (threads + 1) * sizeof(float);
  rnnt_fwd_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      blank, emit, f_len, y_len, alphas, loss, t_max, u1);
  return static_cast<int>(cudaGetLastError());
}

const char* ecf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
