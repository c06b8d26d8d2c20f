// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
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

// Copy `rows` x D bf16 (one head slice per row) from global memory with row
// stride `stride` elements into shared memory with row stride `lds`; rows in
// [rows, rows_pad) are zero-filled. 16-byte chunks, D / 8 per row.
template <int D>
__device__ __forceinline__ void load_head_rows(bf16* dst, int lds, const bf16* src, long long stride,
                                               int rows, int rows_pad, int tid, int nthreads) {
  constexpr int CH = D / 8;
  for (int c = tid; c < rows_pad * CH; c += nthreads) {
    int r = c / CH, col = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + r * stride + col);
    *reinterpret_cast<uint4*>(dst + r * lds + col) = val;
  }
}
