// K1/K2's projection GEMM for f32 operands, on the CUDA cores.
//
// Replaces, under the fp32 policy, the products that
// btia_tpu/ops/fused_attn.py:_fused_kernel and _staticq_kernel compute in
// their own bodies (q, [k|v] and the output projection, the bias added in
// f32, the residual rows of the output projection). The bf16 policy runs
// them on gemm_bias_ws_kernel (fused_attn.cu); wgmma's f32 input type is
// TF32, so the fp32 policy, held to the CPU's f32 at 1e-4, runs here: every
// product is an f32 FFMA.
//
// C[M, N] = A[M, K] @ W[K, N] + bias[N] (+ resid[row % resid_rows, N]);
// A, W, C and resid row-major and packed, any M, N, K.
//
// What bounds it on an H100: operations at the f32 CUDA-core rate
// (67 TFLOP/s: 128 FFMA a clock an SM) at every projection shape of the
// registered configs (K of 512-1024 against rows of 4 bytes). Before that
// rate, an FFMA loop is held back by shared-memory loads (one 16-byte load
// a clock for eight threads) and by loads that do not overlap the
// arithmetic. So:
//
// * A block computes a 128 x 128 tile of C (256 threads), or 128 x 64 (256)
//   or 64 x 64 (128 threads) where the larger tile's grid would not give
//   every SM two blocks (the host picks: ops/fused_attn.py:gemm_f32_tile;
//   at vqa_rad_lstm's 3136 x 512 -> 512 the 128 x 128 grid has 100 blocks
//   for 132 SMs). Each thread holds an 8 x 8 (8 x 4) register tile: 2 x 2
//   (2 x 1) sub-tiles of 4 x 4, so that a warp's 16-byte loads of A and W
//   fall on distinct banks: four loads feed 64 FFMAs (three 32).
// * K comes in chunks (of 16, or 32 for the smallest tile) through a
//   three-stage cp.async ring, so chunk i + 2 loads while chunk i computes,
//   one barrier a chunk. A is stored
//   transposed (k-major, so a thread's four rows are one 16-byte load),
//   which takes 4-byte copies; W's rows take 16-byte copies where N % 4 == 0
//   and W is 16-byte aligned, 4-byte copies otherwise. Copies past M, N and K
//   zero-fill.
// * The epilogue adds the bias and the residual row (m % resid_rows) and
//   stores 16-byte vectors where N % 4 == 0 and the pointers are aligned.

#include "common.cuh"

namespace {

constexpr int GF_STAGES = 3;

// A block of THREADS threads computes a BM x BN tile of C: the threads are
// 16 columns of TY = THREADS / 16 rows; a thread holds TM = BM / TY rows in
// groups of 4, 4 * TY rows apart, and TN = BN / 16 columns in groups of 4,
// 64 columns apart. K comes in chunks of BK: 32 for the 64 x 64 tile, 16 for
// the others (in development calls on an H100, 32 won 4-6 % at 64 x 64 and
// lost 7-13 % at 128 x 64 and 128 x 128).
template <int BM, int BN, int THREADS>
struct GfLayout {
  static constexpr int BK = THREADS == 128 ? 32 : 16;
  static constexpr int TY = THREADS / 16;
  static constexpr int TM = BM / TY, TN = BN / 16;
  static constexpr int ALD = BM + 4;  // floats a k row of the transposed A tile
  static constexpr int STAGE = BK * ALD + BK * BN;
  static constexpr int SMEM = GF_STAGES * STAGE * 4;
  static constexpr int MIN_BLOCKS = THREADS == 256 ? 2 : 4;
};

// One K chunk into a stage. Thread tid copies A rows tid / BK + AR i,
// column tid % BK (stored k-major), and W's 16-byte chunks (or elements, on
// the 4-byte path) tid + THREADS i: one base pointer each, stepped by
// constants.
template <int BM, int BN, int THREADS>
__device__ __forceinline__ void gf_load(float* st, const float* __restrict__ A, const float* __restrict__ W, int M,
                                        int N, int K, int m0, int n0, int k0, int vec, int tid) {
  using L = GfLayout<BM, BN, THREADS>;
  constexpr int BK = L::BK, AR = THREADS / BK;  // AR: A rows a pass
  float* As = st + (tid % BK) * L::ALD + tid / BK;
  float* Ws = st + BK * L::ALD;
  const int ar = m0 + tid / BK, ac = k0 + tid % BK;
  const float* a = A + static_cast<long long>(ar) * K + ac;
#pragma unroll
  for (int i = 0; i < BM / AR; ++i) {
    const bool ok = ar + AR * i < M && ac < K;
    cp_async4(As + AR * i, ok ? a + static_cast<long long>(AR * i) * K : A, ok ? 4 : 0);
  }
  if (vec) {
    constexpr int CPR = BN / 4;  // 16-byte chunks a row
    const int wr = tid / CPR, wc = (tid % CPR) * 4;
    const float* w = W + static_cast<long long>(k0 + wr) * N + n0 + wc;
#pragma unroll
    for (int i = 0; i < BK * CPR / THREADS; ++i) {
      const int r = wr + i * (THREADS / CPR);
      const bool ok = k0 + r < K && n0 + wc < N;
      cp_async16(Ws + r * BN + wc, ok ? w + static_cast<long long>(i * (THREADS / CPR)) * N : W, ok ? 16 : 0);
    }
  } else {
    const int wr = tid / BN, wc = tid % BN;
    const float* w = W + static_cast<long long>(k0 + wr) * N + n0 + wc;
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int r = wr + i * (THREADS / BN);
      const bool ok = k0 + r < K && n0 + wc < N;
      cp_async4(Ws + r * BN + wc, ok ? w + static_cast<long long>(i * (THREADS / BN)) * N : W, ok ? 4 : 0);
    }
  }
}

template <int BM, int BN, int THREADS>
__global__ void __launch_bounds__(THREADS, (GfLayout<BM, BN, THREADS>::MIN_BLOCKS))
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W, const float* __restrict__ bias,
                const float* __restrict__ resid, int resid_rows, float* __restrict__ C, int M, int N, int K, int vec) {
  using L = GfLayout<BM, BN, THREADS>;
  constexpr int TM = L::TM, TN = L::TN, RS = 4 * L::TY;  // RS: rows between a thread's groups
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  constexpr int BK = L::BK;
  const int nk = (K + BK - 1) / BK;

#pragma unroll
  for (int s = 0; s < GF_STAGES - 1; ++s) {
    if (s < nk) gf_load<BM, BN, THREADS>(smem + s * L::STAGE, A, W, M, N, K, m0, n0, s * BK, vec, tid);
    cp_async_commit();  // empty groups keep the count uniform
  }

  // acc[i][j]: row (i / 4) * RS + ty * 4 + i % 4, column (j / 4) * 64 + tx * 4 + j % 4.
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<GF_STAGES - 2>();  // chunk kt has landed
    __syncthreads();                 // ... for every thread; chunk kt - 1's stage is free
    const int nxt = kt + GF_STAGES - 1;
    if (nxt < nk)
      gf_load<BM, BN, THREADS>(smem + (nxt % GF_STAGES) * L::STAGE, A, W, M, N, K, m0, n0, nxt * BK, vec, tid);
    cp_async_commit();
    const float* As = smem + (kt % GF_STAGES) * L::STAGE;
    const float* Ws = As + BK * L::ALD;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], w[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(As + kk * L::ALD + h * RS + ty * 4);
        a[4 * h] = v.x, a[4 * h + 1] = v.y, a[4 * h + 2] = v.z, a[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(Ws + kk * BN + h * 64 + tx * 4);
        w[4 * h] = v.x, w[4 * h + 1] = v.y, w[4 * h + 2] = v.z, w[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * RS + ty * 4 + i % 4;
    if (m >= M) continue;
    const float* rrow = resid != nullptr ? resid + static_cast<long long>(m % resid_rows) * N : nullptr;
    float* crow = C + static_cast<long long>(m) * N;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n >= N) continue;
      float y[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
      if (vec) {
        const float4 bv = *reinterpret_cast<const float4*>(bias + n);
        y[0] += bv.x, y[1] += bv.y, y[2] += bv.z, y[3] += bv.w;
        if (rrow != nullptr) {
          const float4 rv = *reinterpret_cast<const float4*>(rrow + n);
          y[0] += rv.x, y[1] += rv.y, y[2] += rv.z, y[3] += rv.w;
        }
        *reinterpret_cast<float4*>(crow + n) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (n + e >= N) break;
          float z = y[e] + bias[n + e];
          if (rrow != nullptr) z += rrow[n + e];
          crow[n + e] = z;
        }
      }
    }
  }
}

template <int BM, int BN, int THREADS>
int gf_launch(const float* A, const float* W, const float* bias, const float* resid, int resid_rows, float* C, int M,
              int N, int K, int vec, cudaStream_t stream) {
  using L = GfLayout<BM, BN, THREADS>;
  auto kernel = gemm_f32_kernel<BM, BN, THREADS>;
  static bool configured = false;  // once an instance
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, L::SMEM, stream>>>(A, W, bias, resid, resid_rows, C, M, N, K, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tile: the block tile (ops/fused_attn.py:gemm_f32_tile): 0 for 128 x 128
// (256 threads), 1 for 128 x 64 (256), 2 for 64 x 64 (128 threads). vec: 1
// for W's 16-byte copies and the 16-byte epilogue, which needs N % 4 == 0
// and W, bias, resid and C 16-byte aligned. Returns 0 or a CUDA error code
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int btia_gemm_f32(const void* A, const void* W, const void* bias, const void* resid, int resid_rows,
                             void* C, int M, int N, int K, int tile, int vec, void* stream) {
  if (M < 1 || N < 1 || K < 1 || resid_rows < 1 || tile < 0 || tile > 2 || (vec != 0 && vec != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec) {
    const uintptr_t ptrs[4] = {reinterpret_cast<uintptr_t>(W), reinterpret_cast<uintptr_t>(bias),
                               reinterpret_cast<uintptr_t>(resid), reinterpret_cast<uintptr_t>(C)};
    for (uintptr_t p : ptrs)
      if (p % 16 != 0 || N % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  const float *a = static_cast<const float*>(A), *w = static_cast<const float*>(W);
  const float *b = static_cast<const float*>(bias), *r = static_cast<const float*>(resid);
  float* c = static_cast<float*>(C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 0) return gf_launch<128, 128, 256>(a, w, b, r, resid_rows, c, M, N, K, vec, s);
  if (tile == 1) return gf_launch<128, 64, 256>(a, w, b, r, resid_rows, c, M, N, K, vec, s);
  return gf_launch<64, 64, 128>(a, w, b, r, resid_rows, c, M, N, K, vec, s);
}
