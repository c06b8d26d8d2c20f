// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// cp.async (sm_80+): copy `bytes` (0 or the copy size; the rest of the copy
// is zero-filled) from global to shared memory without passing through
// registers. The source of a zero-byte copy is not read, but must be a
// valid address. A group of copies completes at cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait until at most N of this thread's groups are still in flight; the
// completed copies are then visible to this thread (to the block after a
// barrier).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// jax.nn.gelu(approximate=True) in f32 (the epilogues of K8, int8_mm.cu,
// and of the projection GEMM, fused_attn.cu): 0.5 y (1 + tanh(u)) = y / (1 +
// exp(-2u)); exp(-2u) = 2^(-2 log2(e) u). Past |u| ~ 44 the exponential is 0
// or inf and the quotient y or -0, the limits of the exact form.
__device__ __forceinline__ float gelu_tanh(float y) {
  constexpr float k = 0.7978845608028654f;                    // sqrt(2 / pi)
  constexpr float c = -2.0f * 1.4426950408889634f * k;        // -2 log2(e) sqrt(2 / pi)
  const float e = ex2_approx(c * (y + 0.044715f * y * y * y));
  return __fdividef(y, 1.f + e);
}
