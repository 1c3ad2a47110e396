// What the RNN-T lattice kernels (rnnt_fwd.cu, rnnt_bwd.cu) share, for
// sm_90a: the logaddexp of the recursion, and the shared-memory helpers of
// their wavefront. Shared addresses are 32-bit shared-window addresses,
// computed once per thread, so the loops over the diagonals spend no
// instruction on converting generic pointers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rnnt {

constexpr float LOG_EPS = -1e30f;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_SMEM = 232448;   // what a block may use on sm_90
constexpr int EDGE = 2 * 32;       // a value per warp boundary, double-buffered
constexpr int RING = 8;            // diagonals of operands staged ahead of the chain

// max(a, b) + log1p(exp(-|a - b|)) with the precise expf and log1pf, as the
// plain versions compute it; logaddexp(LOG_EPS, LOG_EPS) stays finite
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte asynchronous copy global -> shared, issued only where `take` holds
// (a predicate, not a branch, so the loop body stays one block)
__device__ __forceinline__ void cp_async4_if(uint32_t dst, const float* src, bool take) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n @p cp.async.ca.shared.global [%0], [%1], 4;\n}\n"
      ::"r"(dst), "l"(src), "r"(static_cast<int>(take)));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's most recent groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// the geometry both entry points check: whole warps that cover u1 label
// positions, the ring of RING diagonals of `operands` fp32 operands a
// thread, and the edge slots
__host__ __device__ constexpr size_t smem_bytes(int threads, int operands) {
  return (EDGE + static_cast<size_t>(RING) * operands * threads) * sizeof(float);
}

inline bool geometry_ok(int u1, int threads, int ring, int smem, int operands) {
  return u1 > 0 && threads >= u1 && threads % 32 == 0 && threads <= MAX_THREADS &&
         ring == RING && smem >= 0 && smem <= MAX_SMEM &&
         static_cast<size_t>(smem) >= smem_bytes(threads, operands);
}

}  // namespace rnnt
