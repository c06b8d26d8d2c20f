// K8 on Hopper: y = act((int8(x) @ w_i8) * sx * ws + b), the fused int8 FFN
// matrix product of int8 serving, as two kernels behind one entry.
//
// Replaces btia_tpu/ops/quant.py:87 _int8_mm_kernel (pallas_call at
// quant.py:162, entry int8_matmul_fused), reached from every Mlp's fc1 and
// fc2 under DTypePolicy.int8 in a deterministic forward. The wrapper is
// btia_tpu_torch/ops/quant.py:int8_matmul_fused.
//
// What it computes, as the TPU kernel does: per row of x (bf16, M x K),
// sx = max(amax|x|, 1e-8) * f32(1/127) and xi = round_half_even(x * (1/sx))
// with no clip; the exact int32 product xi @ w_i8; then, in f32 and without
// contraction into FMAs, (acc * sx) * ws[n] + b[n], an optional tanh-GELU,
// and one rounding to the output type (bf16, or f32).
//
// What bounds it on an H100: at the int8 serve step of streaming_vitl
// (M = 9,232 to 131,072 rows, K and N 768 to 4096) each call does 2*M*K*N
// int8 operations, 18.1 T a step, against 1,979 TOPS dense int8: ~9.2 ms a
// step, operation-bound at every site except the AD head's two (M 131,072,
// 768 <-> 1536), which are bound by their bytes (bf16 x in, bf16 y out).
//
// Design. The TPU kernel walks a sequential grid and quantizes each (TM, K)
// block of x once, at the first N tile, into VMEM scratch that the later N
// tiles reuse; recomputing it per N tile cancelled the int8 win there, and
// did here (the previous kernel re-read and re-quantized x in every block).
// Hopper's blocks run in parallel with nothing carried between them, so the
// quantization is its own pass, once per row:
//
// (a) quant_rows_kernel: one warp per row reads x once in 16-byte vectors
//     held in registers, takes the amax with a warp reduction, and writes xi
//     (M, K) int8 and sx (M,) f32 to scratch the wrapper allocates. Bound by
//     bytes: 3 per element. Instantiated for rows of up to 256 V elements
//     (V = 1 ... 16, K <= 4096: every FFN width of the registered configs);
//     a wider row takes quant_rows_loop_kernel, which reads it twice, the
//     second time from cache. The loop kernel matches the register kernel
//     at K = 768 and is slower from K = 3072 on, where the second read
//     misses L1, so both stay; chip_smoke.py holds both against the twin.
// (b) int8_gemm_kernel: wgmma m64n128k32 s32.s8.s8 with both operands
//     K-major in shared memory (the only layout int8 wgmma takes): xi as
//     (M, K) and the weight as the (N, K) copy the wrapper makes. One block
//     per 128 x 128 output tile: a producer warp keeps TMA loads of 128-byte
//     K chunks (128-byte swizzle) in a ring of three stages on mbarriers,
//     two consumer warpgroups of 64 rows each issue the products with one
//     group in flight, and the epilogue works on the int32 accumulators in
//     registers, masking ragged M and N. Two blocks fit on an SM, so one
//     block's epilogue (the tanh-GELU is most of its cost) overlaps the
//     other's products. Blocks run along N first: the blocks of one M tile
//     run together and read its xi rows from L2, and the whole weight
//     (at most 4 MB) stays in L2. K % 16 == 0 is the only shape rule (the
//     tensor map's row stride); TMA zero-fills a K tail past a 128-byte
//     chunk, and zeros add nothing.

#include "common.cuh"
#include "hopper.cuh"

// jax.nn.gelu(approximate=True) in f32.
__device__ __forceinline__ float gelu_tanh(float y) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * y * (1.f + tanhf(k * (y + 0.044715f * y * y * y)));
}

__device__ __forceinline__ unsigned quant4(__nv_bfloat162 lo, __nv_bfloat162 hi, float inv) {
  float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  unsigned q0 = static_cast<unsigned>(__float2int_rn(__fmul_rn(a.x, inv))) & 0xffu;
  unsigned q1 = static_cast<unsigned>(__float2int_rn(__fmul_rn(a.y, inv))) & 0xffu;
  unsigned q2 = static_cast<unsigned>(__float2int_rn(__fmul_rn(b.x, inv))) & 0xffu;
  unsigned q3 = static_cast<unsigned>(__float2int_rn(__fmul_rn(b.y, inv))) & 0xffu;
  return q0 | (q1 << 8) | (q2 << 16) | (q3 << 24);
}

// ---------------------------------------------------------------------------
// (a) Row quantization: one warp per row, 8 rows per block.
// ---------------------------------------------------------------------------

constexpr int QR_ROWS = 8;

__device__ __forceinline__ float amax8(const uint4& v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
  }
  return m;
}

__device__ __forceinline__ void store_q8(int8_t* dst, const uint4& v, float inv) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  *reinterpret_cast<uint2*>(dst) = make_uint2(quant4(h[0], h[1], inv), quant4(h[2], h[3], inv));
}

__device__ __forceinline__ float row_scale(float amax, float* inv) {
  const float s = fmaxf(amax, 1e-8f) * (1.0f / 127.0f);
  *inv = 1.0f / s;  // IEEE division: no --use_fast_math
  return s;
}

// K <= 256 * V: the row stays in registers between the amax and the writes.
template <int V>
__global__ void __launch_bounds__(32 * QR_ROWS)
quant_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xi, float* __restrict__ sx, int M, int K) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * QR_ROWS + threadIdx.x / 32;
  if (row >= M) return;
  const bf16* xr = x + row * K;
  uint4 v[V];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = (i * 32 + lane) * 8;
    v[i] = c < K ? *reinterpret_cast<const uint4*>(xr + c) : make_uint4(0u, 0u, 0u, 0u);
    amax = fmaxf(amax, amax8(v[i]));
  }
  float inv;
  const float s = row_scale(warp_max(amax), &inv);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = (i * 32 + lane) * 8;
    if (c < K) store_q8(xi + row * K + c, v[i], inv);
  }
  if (lane == 0) sx[row] = s;
}

// Any K: two passes over the row (the second from the cache).
__global__ void __launch_bounds__(32 * QR_ROWS)
quant_rows_loop_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xi, float* __restrict__ sx, int M, int K) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * QR_ROWS + threadIdx.x / 32;
  if (row >= M) return;
  const bf16* xr = x + row * K;
  float amax = 0.f;
  for (int c = lane * 8; c < K; c += 256) amax = fmaxf(amax, amax8(*reinterpret_cast<const uint4*>(xr + c)));
  float inv;
  const float s = row_scale(warp_max(amax), &inv);
  for (int c = lane * 8; c < K; c += 256) store_q8(xi + row * K + c, *reinterpret_cast<const uint4*>(xr + c), inv);
  if (lane == 0) sx[row] = s;
}

// ---------------------------------------------------------------------------
// (b) The int8 wgmma GEMM with the fused epilogue.
// ---------------------------------------------------------------------------

constexpr int G_BM = 128, G_BN = 128, G_BK = 128;  // tile rows, columns, K bytes per stage
constexpr int G_STAGES = 3;
constexpr int G_THREADS = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr int G_CONSUMER_WARPS = 8;
constexpr int G_A_BYTES = G_BM * G_BK, G_B_BYTES = G_BN * G_BK;
constexpr int G_STAGE_BYTES = G_A_BYTES + G_B_BYTES;
constexpr int G_BAR_OFF = G_STAGES * G_STAGE_BYTES;
constexpr int G_SMEM = G_BAR_OFF + 64 + 1024;  // barriers; slack to align the base to 1 KB

__device__ __forceinline__ void store_pair(bf16* p, float a, float b, bool two, bool vec) {
  if (two && vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (two) p[1] = __float2bfloat16(b);
  }
}
__device__ __forceinline__ void store_pair(float* p, float a, float b, bool two, bool vec) {
  if (two && vec) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (two) p[1] = b;
  }
}

__device__ __forceinline__ float epilogue(int acc, float s, float w, float b, bool has_bias, int act) {
  float v = __fmul_rn(__fmul_rn(static_cast<float>(acc), s), w);
  if (has_bias) v = __fadd_rn(v, b);
  return act == 1 ? gelu_tanh(v) : v;
}

template <typename OutT>
__global__ void __launch_bounds__(G_THREADS, 2)
int8_gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                 const float* __restrict__ sx, const float* __restrict__ ws, const float* __restrict__ bias,
                 OutT* __restrict__ y, int M, int N, int K, int act) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G_BAR_OFF);
  uint64_t* empty = full + G_STAGES;

  const int bn = blockIdx.x * G_BN, bm = blockIdx.y * G_BM;
  const int nk = (K + G_BK - 1) / G_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G_CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == G_CONSUMER_WARPS) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % G_STAGES;
        if (kt >= G_STAGES) mbar_wait(&empty[s], (kt / G_STAGES - 1) & 1);
        mbar_expect_tx(&full[s], G_STAGE_BYTES);
        unsigned char* st = smem + s * G_STAGE_BYTES;
        tma_load_2d(st, &amap, &full[s], kt * G_BK, bm);
        tma_load_2d(st + G_A_BYTES, &bmap, &full[s], kt * G_BK, bn);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns output rows [64 wg, 64 wg + 64) of the
  // tile; this thread rows r0 and r0 + 8 of them.
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int r0 = 16 * (t / 32) + lane / 4, qd = lane % 4;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % G_STAGES;
    mbar_wait(&full[s], (kt / G_STAGES) & 1);
    const uint32_t a_addr = smem_u32(smem + s * G_STAGE_BYTES) + wg * 64 * G_BK;
    const uint32_t b_addr = smem_u32(smem + s * G_STAGE_BYTES + G_A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < G_BK / 32; ++kk)
      wgmma_s8_ss_n128(acc, wgmma_desc_sw128(a_addr + kk * 32, 16, 1024), wgmma_desc_sw128(b_addr + kk * 32, 16, 1024),
                       1);
    wgmma_commit();
    // Keep this chunk's products in flight; release the previous chunk's stage.
    wgmma_wait<1>();
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % G_STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int g0 = bm + wg * 64 + r0, g1 = g0 + 8;
  const float s0 = g0 < M ? sx[g0] : 0.f, s1 = g1 < M ? sx[g1] : 0.f;
  const bool has_bias = bias != nullptr, vec = (N % 2) == 0;
  OutT* y0 = y + static_cast<long long>(g0) * N;
  OutT* y1 = y + static_cast<long long>(g1) * N;
#pragma unroll
  for (int j = 0; j < G_BN / 8; ++j) {
    const int c = bn + 8 * j + 2 * qd;
    if (c >= N) continue;
    const bool two = c + 1 < N;
    const float w0 = ws[c], w1 = two ? ws[c + 1] : 0.f;
    const float b0 = has_bias ? bias[c] : 0.f, b1 = has_bias && two ? bias[c + 1] : 0.f;
    if (g0 < M)
      store_pair(y0 + c, epilogue(acc[4 * j], s0, w0, b0, has_bias, act),
                 epilogue(acc[4 * j + 1], s0, w1, b1, has_bias, act), two, vec);
    if (g1 < M)
      store_pair(y1 + c, epilogue(acc[4 * j + 2], s1, w0, b0, has_bias, act),
                 epilogue(acc[4 * j + 3], s1, w1, b1, has_bias, act), two, vec);
  }
}

// ---------------------------------------------------------------------------
// C interface. Each returns 0, a CUDA error code (cudaGetLastError() after
// the launch), or 1000 + the CUresult of encoding a tensor map.
// ---------------------------------------------------------------------------

// x: (M, K) bf16, 16-byte aligned; xi: (M, K) int8; sx: (M,) f32. K % 8 == 0.
extern "C" int btia_int8_quant_rows(const void* x, void* xi, void* sx, int M, int K, void* stream) {
  const dim3 grid((M + QR_ROWS - 1) / QR_ROWS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  int8_t* qp = static_cast<int8_t*>(xi);
  float* sp = static_cast<float*>(sx);
  const int v = (K + 255) / 256;
  if (v <= 1) quant_rows_kernel<1><<<grid, 32 * QR_ROWS, 0, s>>>(xp, qp, sp, M, K);
  else if (v <= 2) quant_rows_kernel<2><<<grid, 32 * QR_ROWS, 0, s>>>(xp, qp, sp, M, K);
  else if (v <= 3) quant_rows_kernel<3><<<grid, 32 * QR_ROWS, 0, s>>>(xp, qp, sp, M, K);
  else if (v <= 4) quant_rows_kernel<4><<<grid, 32 * QR_ROWS, 0, s>>>(xp, qp, sp, M, K);
  else if (v <= 6) quant_rows_kernel<6><<<grid, 32 * QR_ROWS, 0, s>>>(xp, qp, sp, M, K);
  else if (v <= 8) quant_rows_kernel<8><<<grid, 32 * QR_ROWS, 0, s>>>(xp, qp, sp, M, K);
  else if (v <= 12) quant_rows_kernel<12><<<grid, 32 * QR_ROWS, 0, s>>>(xp, qp, sp, M, K);
  else if (v <= 16) quant_rows_kernel<16><<<grid, 32 * QR_ROWS, 0, s>>>(xp, qp, sp, M, K);
  else quant_rows_loop_kernel<<<grid, 32 * QR_ROWS, 0, s>>>(xp, qp, sp, M, K);
  return static_cast<int>(cudaGetLastError());
}

// xi: (M, K) int8 and w: (N, K) int8, each 16-byte aligned; sx: (M,) f32;
// ws: (N,) f32; bias: (N,) f32 or null; y: (M, N) bf16 (out_f32 == 0) or
// f32. act: 0 none, 1 tanh-GELU. K % 16 == 0, M, N >= 1.
extern "C" int btia_int8_gemm(const void* xi, const void* sx, const void* w, const void* ws, const void* bias, void* y,
                              int M, int N, int K, int act, int out_f32, void* stream) {
  const uint64_t adims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t bdims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(N)};
  const uint64_t stride[1] = {static_cast<uint64_t>(K)};
  const uint32_t abox[2] = {G_BK, G_BM}, bbox[2] = {G_BK, G_BN};
  CUtensorMap am, bm;
  int err = encode_map(&am, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xi, adims, stride, abox);
  if (err == 0) err = encode_map(&bm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, bdims, stride, bbox);
  if (err != 0) return err;
  const dim3 grid((N + G_BN - 1) / G_BN, (M + G_BM - 1) / G_BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sxp = static_cast<const float*>(sx);
  const float* wsp = static_cast<const float*>(ws);
  const float* bp = static_cast<const float*>(bias);
  cudaError_t e;
  if (out_f32) {
    e = cudaFuncSetAttribute(int8_gemm_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    int8_gemm_kernel<float><<<grid, G_THREADS, G_SMEM, s>>>(am, bm, sxp, wsp, bp, static_cast<float*>(y), M, N, K,
                                                            act);
  } else {
    e = cudaFuncSetAttribute(int8_gemm_kernel<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    int8_gemm_kernel<bf16><<<grid, G_THREADS, G_SMEM, s>>>(am, bm, sxp, wsp, bp, static_cast<bf16*>(y), M, N, K, act);
  }
  return static_cast<int>(cudaGetLastError());
}
