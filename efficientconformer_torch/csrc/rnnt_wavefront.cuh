// What the RNN-T lattice kernels (rnnt_fwd.cu, rnnt_bwd.cu) share, for
// sm_90a: the logaddexp of the recursion, the shared-memory helpers of
// their wavefront, and the launch geometry both entry points check. Shared
// addresses are 32-bit shared-window addresses, computed once per thread, so
// the loops over the diagonals spend no instruction on converting generic
// pointers.
//
// The geometry (threads, strip, ring, shared bytes) of one block, one block
// per utterance, as ops/rnnt_loss.launch_geometry sets it:
//  - strip 1 (U+1 <= MAX_THREADS): one thread per label position and a ring
//    of RING staged diagonals, the kernels rnnt_{fwd,bwd}_kernel;
//  - strip 2, 4 or 8 (up to STRIP_MAX x MAX_THREADS positions): each thread
//    owns a strip of that many consecutive positions, held in registers,
//    and the ring is as deep as the shared memory allows (1 to RING),
//    rnnt_{fwd,bwd}_strip_kernel<K>;
//  - no ring (any strip of 2 or more; the wrapper takes it past those held
//    in registers): the previous diagonal is read back from the output the
//    kernel writes (alphas, or the betas scratch) and the operands straight
//    from global memory, rnnt_{fwd,bwd}_readback_kernel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rnnt {

constexpr float LOG_EPS = -1e30f;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_SMEM = 232448;   // what a block may use on sm_90
constexpr int EDGE = 2 * 32;       // a value per warp boundary, double-buffered
constexpr int RING = 8;            // diagonals of operands staged ahead of the chain
constexpr int STRIP_MAX = 8;       // the widest strip of label positions held in registers

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
// the same with the count known only at run time (a ring's depth less one):
// the instruction takes an immediate, so one branch a call picks it
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}
__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// shared bytes of a block: the edge slots and a ring of `ring` diagonals of
// `operands` fp32 operands for each of a thread's `strip` positions
__host__ __device__ constexpr size_t smem_bytes(int threads, int strip, int ring, int operands) {
  return (EDGE + static_cast<size_t>(ring) * operands * strip * threads) * sizeof(float);
}

// the strips rnnt_{fwd,bwd}_strip_kernel<K> are built for
constexpr bool register_strip(int strip) { return strip == 2 || strip == 4 || strip == 8; }

// the geometry both entry points check: whole warps whose strips cover u1
// label positions; strip 1 with the ring of RING diagonals, a wider strip
// with no ring (read back) or, held in registers, a ring of 1 to RING; the
// shared memory they need, within what a block may use
inline bool geometry_ok(int u1, int threads, int strip, int ring, int smem, int operands) {
  return u1 > 0 && threads > 0 && threads % 32 == 0 && threads <= MAX_THREADS && strip >= 1 &&
         static_cast<int64_t>(threads) * strip >= u1 && smem >= 0 && smem <= MAX_SMEM &&
         static_cast<size_t>(smem) >= smem_bytes(threads, strip, ring, operands) &&
         (strip == 1 ? ring == RING
                     : ring == 0 || (register_strip(strip) && ring >= 1 && ring <= RING));
}

}  // namespace rnnt
