// K4 on Hopper: masked multi-head attention over pre-projected q/k/v in the
// projection-native (B, S, H*D) layout, for short sequences at a large batch.
//
// Replaces btia_tpu/ops/attention.py:_fanout_kernel (reached through
// mha_bshd when B >= 64 and D % 64 == 0; in training, the backward pass of
// every fused K1 site recomputes through it). The wrapper is
// btia_tpu_torch/ops/attention.py:fanout_attention.
//
// What bounds it on an H100: at the training shapes (B = 64, H = 12, D = 64;
// 32 x 32, 197 x 32 and 32 x 197) it does 0.2-1.2 GFLOP over 12.6-45.1 MB of
// q/k/v/o, so it is bound by bytes (3.8-13.5 us at 3.35 TB/s), not by the
// tensor cores (~1 us). The design reads each operand once, straight from the
// (B, S, H*D) rows with no transpose copy, keeps scores and probabilities in
// shared memory and registers, and writes the output once.
//
// The TPU kernel packs bb batch rows into one block-diagonal score matmul to
// fill 128-row MXU tiles at bb x the FLOPs; that buys nothing on Hopper, so
// here each block is one (batch row, 64-row q tile, head) and runs the
// masked online softmax of masked_flash.cuh over 64-key tiles, at D = 64,
// 128, 192 or 256 (a template parameter). q is prescaled by scale*log2(e) in f32 and
// rounded to bf16 inside the kernel, as the TPU kernel does
// (attention.py:376-378).

#include "common.cuh"
#include "masked_flash.cuh"

template <int D>
__global__ void __launch_bounds__(MF_THREADS)
fanout_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const float* __restrict__ colmask, bf16* __restrict__ o, int H, int Sq, int Sk, float qscale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  MaskedFlashSmem<D>& sm = *reinterpret_cast<MaskedFlashSmem<D>*>(smem_raw);
  const int nqt = (Sq + MF_T - 1) / MF_T;
  const int q0 = (blockIdx.x % nqt) * MF_T, b = blockIdx.x / nqt, h = blockIdx.y;
  const long long HD = static_cast<long long>(H) * D;
  const bf16* qb = q + (static_cast<long long>(b) * Sq + q0) * HD + h * D;
  const bf16* kb = k + static_cast<long long>(b) * Sk * HD + h * D;
  const bf16* vb = v + static_cast<long long>(b) * Sk * HD + h * D;
  bf16* ob = o + (static_cast<long long>(b) * Sq + q0) * HD + h * D;
  masked_flash_tile<D>(sm, qb, HD, min(MF_T, Sq - q0), qscale, kb, vb, HD, Sk,
                       colmask + static_cast<long long>(b) * Sk, ob, HD);
}

template <int D>
static int launch_fanout(const void* q, const void* k, const void* v, const void* colmask, void* o, int B, int H,
                         int Sq, int Sk, float qscale, cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(MaskedFlashSmem<D>));
  cudaError_t err = cudaFuncSetAttribute(fanout_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * ((Sq + MF_T - 1) / MF_T), H);
  fanout_kernel<D><<<grid, MF_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(colmask), static_cast<bf16*>(o), H, Sq, Sk, qscale);
  return static_cast<int>(cudaGetLastError());
}

// q: (B, Sq, H*D), k / v: (B, Sk, H*D) bf16; colmask: (B, Sk) f32 {0, 1};
// o: (B, Sq, H*D) bf16; D is 64, 128, 192 or 256. Returns cudaGetLastError() after the
// launch.
extern "C" int btia_fanout(const void* q, const void* k, const void* v, const void* colmask, void* o, int B, int H,
                           int D, int Sq, int Sk, float qscale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_fanout<64>(q, k, v, colmask, o, B, H, Sq, Sk, qscale, s);
  if (D == 128) return launch_fanout<128>(q, k, v, colmask, o, B, H, Sq, Sk, qscale, s);
  if (D == 192) return launch_fanout<192>(q, k, v, colmask, o, B, H, Sq, Sk, qscale, s);
  if (D == 256) return launch_fanout<256>(q, k, v, colmask, o, B, H, Sq, Sk, qscale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
