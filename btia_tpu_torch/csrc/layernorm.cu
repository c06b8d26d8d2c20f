// K7 on Hopper: single-pass row LayerNorm with f32 statistics and the fast
// variance max(0, E[x^2] - E[x]^2).
//
// Replaces btia_tpu/ops/norms.py:_ln_kernel (wrapper _layernorm_pallas,
// behind the custom_vjp _layernorm_fast). The wrapper is
// btia_tpu_torch/ops/norms.py:_layernorm_cuda, behind the entries layernorm
// (every LayerNorm of the models) and layernorm_fast (the ops API); K1's
// LayerNorm prologue and post-LN epilogue (ops/fused_attn.py) launch the same
// kernel.
//
// What bounds it on an H100: a few operations per element over one read and
// one write of every row, so bytes (at the serving step's largest site,
// 131072 x 768 bf16, ~0.4 GB in and out: ~0.12 ms at 3.35 TB/s). The TPU
// kernel keeps a 512-row block in VMEM; here each row is read once into
// registers, its sum and sum of squares reduced there (a warp per row up to
// D = 1024, a 256-thread block per row up to D = 4096), and written once, so
// no statistic or intermediate goes back to device memory. Wider rows (the
// TPU kernel takes any width) have no register array that holds them: a
// 512-thread block per row reads the row once for its sums and once more to
// normalise it, the second read mostly from L2 (a row of 8192 bf16 values is
// 16 KB). x and y may be the same buffer: every thread has read its values
// before the reduction that precedes any write, and in the two-read kernel
// each element is read and then written by the same thread.
//
// Arithmetic as the TPU kernel's: mean and mean of squares in f32, var =
// max(0, mean2 - mean^2), rsqrt(var + eps), then ((x - mean) * inv) * scale
// + bias in f32 without contraction into FMAs, cast to x's type (bf16 or
// f32).

#include "common.cuh"

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float ln_out(float x, float mean, float inv, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(x - mean, inv), scale), bias);
}

constexpr int LN_WARP_ROWS = 8;  // rows (warps) per block of the warp-per-row kernel
constexpr int LN_BLOCK = 256;    // threads of the block-per-row kernel
constexpr int LN_BLOCK_NPT = 16; // values per thread there: D <= 4096
constexpr int LN_WIDE_BLOCK = 512; // threads of the two-read kernel (D > 4096)

// A warp per row, NPL <= 32 values per lane (D <= 32 * NPL), lane-strided
// so that each load instruction reads consecutive elements.
template <typename T, int NPL>
__global__ void __launch_bounds__(LN_WARP_ROWS * 32)
ln_warp_kernel(const T* x, T* y, const float* __restrict__ scale, const float* __restrict__ bias, int M, int D,
               float eps) {
  const int row = blockIdx.x * LN_WARP_ROWS + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + static_cast<long long>(row) * D;
  T* yr = y + static_cast<long long>(row) * D;
  float v[NPL];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < D ? to_f32<T>(xr[c]) : 0.f;
    s += v[i];
    s2 += v[i] * v[i];
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = s / D;
  const float inv = rsqrtf(fmaxf(0.f, s2 / D - mean * mean) + eps);
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    if (c < D) yr[c] = from_f32<T>(ln_out(v[i], mean, inv, scale[c], bias[c]));
  }
}

// A block per row for 1024 < D <= LN_BLOCK * LN_BLOCK_NPT.
template <typename T>
__global__ void __launch_bounds__(LN_BLOCK)
ln_block_kernel(const T* x, T* y, const float* __restrict__ scale, const float* __restrict__ bias, int D,
                float eps) {
  __shared__ float part[2][LN_BLOCK / 32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* xr = x + static_cast<long long>(blockIdx.x) * D;
  T* yr = y + static_cast<long long>(blockIdx.x) * D;
  float v[LN_BLOCK_NPT];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < LN_BLOCK_NPT; ++i) {
    const int c = tid + LN_BLOCK * i;
    v[i] = c < D ? to_f32<T>(xr[c]) : 0.f;
    s += v[i];
    s2 += v[i] * v[i];
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  if (lane == 0) {
    part[0][warp] = s;
    part[1][warp] = s2;
  }
  __syncthreads();
  s = lane < LN_BLOCK / 32 ? part[0][lane] : 0.f;
  s2 = lane < LN_BLOCK / 32 ? part[1][lane] : 0.f;
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = s / D;
  const float inv = rsqrtf(fmaxf(0.f, s2 / D - mean * mean) + eps);
#pragma unroll
  for (int i = 0; i < LN_BLOCK_NPT; ++i) {
    const int c = tid + LN_BLOCK * i;
    if (c < D) yr[c] = from_f32<T>(ln_out(v[i], mean, inv, scale[c], bias[c]));
  }
}

// A block per row for D > LN_BLOCK * LN_BLOCK_NPT, any width: the row is
// read twice, so nothing bounds D but the int that holds it.
template <typename T>
__global__ void __launch_bounds__(LN_WIDE_BLOCK)
ln_wide_kernel(const T* x, T* y, const float* __restrict__ scale, const float* __restrict__ bias, int D,
               float eps) {
  __shared__ float part[2][LN_WIDE_BLOCK / 32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* xr = x + static_cast<long long>(blockIdx.x) * D;
  T* yr = y + static_cast<long long>(blockIdx.x) * D;
  float s = 0.f, s2 = 0.f;
  for (int c = tid; c < D; c += LN_WIDE_BLOCK) {
    const float v = to_f32<T>(xr[c]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  if (lane == 0) {
    part[0][warp] = s;
    part[1][warp] = s2;
  }
  __syncthreads();
  s = lane < LN_WIDE_BLOCK / 32 ? part[0][lane] : 0.f;
  s2 = lane < LN_WIDE_BLOCK / 32 ? part[1][lane] : 0.f;
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = s / D;
  const float inv = rsqrtf(fmaxf(0.f, s2 / D - mean * mean) + eps);
  for (int c = tid; c < D; c += LN_WIDE_BLOCK) {
    yr[c] = from_f32<T>(ln_out(to_f32<T>(xr[c]), mean, inv, scale[c], bias[c]));
  }
}

template <typename T>
static int launch_ln(const void* x, void* y, const float* scale, const float* bias, int M, int D, float eps,
                     cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const dim3 wgrid((M + LN_WARP_ROWS - 1) / LN_WARP_ROWS), wblock(LN_WARP_ROWS * 32);
  if (D <= 64) {
    ln_warp_kernel<T, 2><<<wgrid, wblock, 0, stream>>>(xt, yt, scale, bias, M, D, eps);
  } else if (D <= 128) {
    ln_warp_kernel<T, 4><<<wgrid, wblock, 0, stream>>>(xt, yt, scale, bias, M, D, eps);
  } else if (D <= 256) {
    ln_warp_kernel<T, 8><<<wgrid, wblock, 0, stream>>>(xt, yt, scale, bias, M, D, eps);
  } else if (D <= 512) {
    ln_warp_kernel<T, 16><<<wgrid, wblock, 0, stream>>>(xt, yt, scale, bias, M, D, eps);
  } else if (D <= 1024) {
    ln_warp_kernel<T, 32><<<wgrid, wblock, 0, stream>>>(xt, yt, scale, bias, M, D, eps);
  } else if (D <= LN_BLOCK * LN_BLOCK_NPT) {
    ln_block_kernel<T><<<M, LN_BLOCK, 0, stream>>>(xt, yt, scale, bias, D, eps);
  } else {
    ln_wide_kernel<T><<<M, LN_WIDE_BLOCK, 0, stream>>>(xt, yt, scale, bias, D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: (M, D) row-major, bf16 (is_f32 == 0) or f32; y may be x. scale,
// bias: (D,) f32, any D >= 1. Returns a CUDA error code.
extern "C" int btia_layernorm(const void* x, void* y, const void* scale, const void* bias, int M, int D, float eps,
                              int is_f32, void* stream) {
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f32 ? launch_ln<float>(x, y, sc, bi, M, D, eps, s) : launch_ln<bf16>(x, y, sc, bi, M, D, eps, s);
}
