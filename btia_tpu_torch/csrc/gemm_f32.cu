// K1/K2's projection GEMM for f32 operands, on the CUDA cores.
//
// Replaces, under the fp32 policy, the products that
// btia_tpu/ops/fused_attn.py:_fused_kernel and _staticq_kernel compute in
// their own bodies (q, [k|v] and the output projection, the bias added in
// f32, the residual rows of the output projection). The bf16 policy runs
// them on gemm_bias_wgmma_kernel (fused_attn.cu); wgmma's f32 input type is
// TF32, so the fp32 policy, held to the CPU's f32 at 1e-4, runs here: every
// product is an f32 FFMA.
//
// C[M, N] = A[M, K] @ W[K, N] + bias[N] (+ resid[row % resid_rows, N]);
// A, W, C and resid row-major and packed, any M, N, K.
//
// What bounds it on an H100: operations at the f32 CUDA-core rate
// (67 TFLOP/s) at every projection shape of the registered configs (K of
// 512-1024 against rows of 4 bytes). The design is the classic tiled SIMT
// GEMM: a block of 256 threads computes a 64 x 64 tile of C in 16-deep K
// chunks; each chunk of A (stored transposed) and W goes through shared
// memory, and each thread keeps a 4 x 4 block of C in registers, reading 4
// values of A and 4 of W (two 16-byte loads) for 16 FFMAs. Loads past M, N
// or K read 0. Double buffering and larger register tiles are later work.

#include "common.cuh"

namespace {

constexpr int GF_BM = 64, GF_BN = 64, GF_BK = 16;
constexpr int GF_THREADS = 256;

__global__ void __launch_bounds__(GF_THREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W, const float* __restrict__ bias,
                const float* __restrict__ resid, int resid_rows, float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[GF_BK][GF_BM + 4];  // padded: the transposed stores spread over banks
  __shared__ __align__(16) float Ws[GF_BK][GF_BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // C rows ty*4.., columns tx*4..
  const int m0 = blockIdx.y * GF_BM, n0 = blockIdx.x * GF_BN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += GF_BK) {
#pragma unroll
    for (int i = 0; i < GF_BM * GF_BK / GF_THREADS; ++i) {
      const int e = tid + i * GF_THREADS;
      const int r = e / GF_BK, c = e % GF_BK;  // A: 16 neighbouring K columns a row
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < K) ? A[static_cast<long long>(m) * K + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < GF_BK * GF_BN / GF_THREADS; ++i) {
      const int e = tid + i * GF_THREADS;
      const int r = e / GF_BN, c = e % GF_BN;  // W: 64 neighbouring N columns a row
      const int k = k0 + r, n = n0 + c;
      Ws[r][c] = (k < K && n < N) ? W[static_cast<long long>(k) * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GF_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float y = acc[i][j] + bias[n];
      if (resid != nullptr) y += resid[static_cast<long long>(m % resid_rows) * N + n];
      C[static_cast<long long>(m) * N + n] = y;
    }
  }
}

}  // namespace

extern "C" int btia_gemm_f32(const void* A, const void* W, const void* bias, const void* resid, int resid_rows,
                             void* C, int M, int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 1 || resid_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + GF_BN - 1) / GF_BN, (M + GF_BM - 1) / GF_BM);
  gemm_f32_kernel<<<grid, GF_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(W), static_cast<const float*>(bias),
      static_cast<const float*>(resid), resid_rows, static_cast<float*>(C), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
