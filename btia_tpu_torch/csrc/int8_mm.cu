// K8 on Hopper: y = act((int8(x) @ w_i8) * sx * ws + b), the fused int8 FFN
// matrix product of int8 serving.
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
// Design, and where it departs from the TPU kernel. The TPU kernel walks a
// sequential grid and quantizes each (TM, K) block of x once, at the first
// N tile, into VMEM scratch that the later N tiles reuse. Hopper's blocks
// run in parallel with nothing carried between them, so each block here,
// one (128-row M tile, 128-column N tile), first takes its rows' amax over
// the full K (one warp per row), then streams K in 64-wide chunks:
// quantizes each bf16 x chunk to int8 in shared memory (the next chunk's
// global loads are in flight in registers meanwhile), double-buffers the
// weight chunk with cp.async, and runs mma.sync.m16n8k32 s8 x s8 -> s32 on
// the tensor cores (8 warps, 64 x 32 outputs each, int32 accumulators in
// registers). The weight is read as (N, K), K-contiguous, the layout the
// instruction's B operand wants; the wrapper transposes the public (K, N)
// int8 weight. Ragged M and N edges are masked in the kernel (the TPU
// wrapper pads instead); K must be a multiple of 16. Each block reads its x
// rows twice (the amax, then the K loop), and the block of every N tile
// does so again; the L2 cache holds the M tile across the N tiles that run
// together. A persistent wgmma/TMA kernel that quantizes x once per M tile
// is later work.

#include "common.cuh"

constexpr int QBM = 128, QBN = 128, QBK = 64, QTHREADS = 256;
constexpr int QLD = QBK + 16;  // bytes per shared row: 16-byte aligned, no bank conflicts

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// jax.nn.gelu(approximate=True) in f32.
__device__ __forceinline__ float gelu_tanh(float y) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * y * (1.f + tanhf(k * (y + 0.044715f * y * y * y)));
}

__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

__device__ __forceinline__ unsigned quant4(__nv_bfloat162 lo, __nv_bfloat162 hi, float inv) {
  float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  unsigned q0 = static_cast<unsigned>(__float2int_rn(__fmul_rn(a.x, inv))) & 0xffu;
  unsigned q1 = static_cast<unsigned>(__float2int_rn(__fmul_rn(a.y, inv))) & 0xffu;
  unsigned q2 = static_cast<unsigned>(__float2int_rn(__fmul_rn(b.x, inv))) & 0xffu;
  unsigned q3 = static_cast<unsigned>(__float2int_rn(__fmul_rn(b.y, inv))) & 0xffu;
  return q0 | (q1 << 8) | (q2 << 16) | (q3 << 24);
}

template <typename OutT>
__global__ void __launch_bounds__(QTHREADS)
int8_mm_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ ws,
               const float* __restrict__ bias, OutT* __restrict__ y, int M, int N, int K, int act) {
  __shared__ __align__(16) int8_t As[2][QBM * QLD];
  __shared__ __align__(16) int8_t Bs[2][QBN * QLD];
  __shared__ float sx_s[QBM], inv_s[QBM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bn = blockIdx.x * QBN;
  const long long bm = static_cast<long long>(blockIdx.y) * QBM;

  // 1. Each row's scale over the full K, one warp per row.
  for (int r = warp; r < QBM; r += QTHREADS / 32) {
    const long long gr = bm + r;
    float amax = 0.f;
    if (gr < M) {
      const bf16* xr = x + gr * K;
      for (int c = lane * 8; c < K; c += 32 * 8) {
        uint4 v = *reinterpret_cast<const uint4*>(xr + c);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float2 f = __bfloat1622float2(h[e]);
          amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
        }
      }
    }
    amax = warp_max(amax);
    if (lane == 0) {
      const float s = fmaxf(amax, 1e-8f) * (1.0f / 127.0f);
      sx_s[r] = s;
      inv_s[r] = 1.0f / s;  // IEEE division: no --use_fast_math
    }
  }
  __syncthreads();

  // 2. The K loop. An x chunk is QBM x QBK bf16: 4 16-byte vectors a thread.
  constexpr int XV = QBM * QBK / 8 / QTHREADS;
  uint4 xv[XV];
  auto load_x = [&](int kt) {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int c = tid + i * QTHREADS;
      const int r = c / (QBK / 8), col = (c % (QBK / 8)) * 8;
      const long long gr = bm + r;
      const int gk = kt * QBK + col;
      xv[i] = (gr < M && gk < K) ? *reinterpret_cast<const uint4*>(x + gr * K + gk) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_x = [&](int buf) {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int c = tid + i * QTHREADS;
      const int r = c / (QBK / 8), col = (c % (QBK / 8)) * 8;
      const float inv = inv_s[r];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&xv[i]);
      *reinterpret_cast<uint2*>(&As[buf][r * QLD + col]) = make_uint2(quant4(h[0], h[1], inv), quant4(h[2], h[3], inv));
    }
  };
  auto load_w = [&](int kt, int buf) {
    for (int c = tid; c < QBN * QBK / 16; c += QTHREADS) {
      const int r = c / (QBK / 16), col = (c % (QBK / 16)) * 16;
      const int gn = bn + r, gk = kt * QBK + col;
      const bool ok = gn < N && gk < K;
      cp_async16(&Bs[buf][r * QLD + col], ok ? w + static_cast<long long>(gn) * K + gk : w, ok);
    }
    cp_async_commit();
  };

  const int wm = (warp >> 2) * 64;  // 2 warps along M
  const int wn = (warp & 3) * 32;   // 4 warps along N
  const int g = lane >> 2, t = lane & 3;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (K + QBK - 1) / QBK;
  load_w(0, 0);
  load_x(0);
  store_x(0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk kt is in As/Bs[buf]; nobody reads buf ^ 1 any more
    const bool more = kt + 1 < nk;
    if (more) {
      load_w(kt + 1, buf ^ 1);
      load_x(kt + 1);
    }
    const int8_t* A = As[buf];
    const int8_t* B = Bs[buf];
#pragma unroll
    for (int kk = 0; kk < QBK; kk += 32) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = A + (wm + i * 16 + g) * QLD + kk + t * 4;
        a[i][0] = *reinterpret_cast<const unsigned*>(p);
        a[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * QLD);
        a[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * QLD + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = B + (wn + j * 8 + g) * QLD + kk + t * 4;
        b[j][0] = *reinterpret_cast<const unsigned*>(p);
        b[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8_16832(acc[i][j], a[i], b[j]);
    }
    if (more) store_x(buf ^ 1);
  }

  // 3. Epilogue: rows g and g + 8 of each 16-row tile, columns 2t and 2t + 1
  // of each 8-column tile.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + i * 16 + g + h * 8;
      const long long gr = bm + r;
      if (gr >= M) continue;
      const float s = sx_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gc = bn + wn + j * 8 + t * 2 + e;
          if (gc >= N) continue;
          float v = __fmul_rn(__fmul_rn(static_cast<float>(acc[i][j][h * 2 + e]), s), ws[gc]);
          if (bias != nullptr) v = __fadd_rn(v, bias[gc]);
          if (act == 1) v = gelu_tanh(v);
          store_out(y + gr * N + gc, v);
        }
      }
    }
  }
}

// x: (M, K) bf16, 16-byte aligned; w: (N, K) int8; ws: (N,) f32; bias: (N,)
// f32 or null; y: (M, N) bf16 (out_f32 == 0) or f32. act: 0 none, 1 tanh-GELU.
// K % 16 == 0, M, N >= 1. Returns cudaGetLastError() after the launch.
extern "C" int btia_int8_mm(const void* x, const void* w, const void* ws, const void* bias, void* y, int M, int N,
                            int K, int act, int out_f32, void* stream) {
  dim3 grid((N + QBN - 1) / QBN, (M + QBM - 1) / QBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* wsp = static_cast<const float*>(ws);
  const float* bp = static_cast<const float*>(bias);
  if (out_f32)
    int8_mm_kernel<float><<<grid, QTHREADS, 0, s>>>(xp, wp, wsp, bp, static_cast<float*>(y), M, N, K, act);
  else
    int8_mm_kernel<bf16><<<grid, QTHREADS, 0, s>>>(xp, wp, wsp, bp, static_cast<bf16*>(y), M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}
