// K5 on Hopper: attention in the (B, H, S, D) layout at any head width D
// that is a multiple of 8 up to 128.
//
// Replaces btia_tpu/ops/attention.py:_mha_kernel (wrapper _mha_pallas),
// reached through mha(impl="pallas"), through mha() with the switch on the
// kernels and a score tile above 32768, and through mha_bshd's long-sequence
// road whenever D % 64 != 0 or H*D % 128 != 0 (there K3's packed layout does
// not apply). The wrapper is btia_tpu_torch/ops/attention.py:
// mha_bhsd_attention.
//
// What bounds it on an H100: at ViT-L/336 self-attention, (16, 16, 577, 64),
// it does ~22 GFLOP of score and PV products over ~76 MB of q/k/v/o, so
// memory (~23 us at 3.35 TB/s) and tensor-core operations (~22 us at
// 989 TF/s) are level; at the AD head's 2048 queries over 229 tokens at
// D = 96 it moves ~450 MB for ~92 GFLOP and is bound by bytes. The TPU
// kernel padded D to 128 in device memory whenever D % 64 != 0; here the
// padding exists only in shared memory (mha_tile.cuh zero-fills columns
// [D, DP)), and q/k/v/o are read and written through their strides, so the
// long-sequence road's (B, S, H, D) -> (B, H, S, D) transposes cost no copy.
// One block per (64-row q tile, head, batch row), a loop over 64-key tiles
// with an online softmax; no score tile reaches device memory.

#include "mha_tile.cuh"

template <int DP>
__global__ void __launch_bounds__(MT_THREADS)
mha_bhsd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                const float* __restrict__ mask, bf16* __restrict__ o, BhsdStrides tq, BhsdStrides tk,
                BhsdStrides tv, BhsdStrides to, int Sq, int Sk, int D, float qscale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  MhaTileSmem<DP>& sm = *reinterpret_cast<MhaTileSmem<DP>*>(smem_raw);
  const int q0 = blockIdx.x * MT_T, h = blockIdx.y, b = blockIdx.z;
  mha_tile<DP>(sm, q + b * tq.b + h * tq.h + q0 * tq.s, tq.s, min(MT_T, Sq - q0), qscale,
               k + b * tk.b + h * tk.h, tk.s, v + b * tv.b + h * tv.h, tv.s, Sk, D,
               mask != nullptr ? mask + static_cast<long long>(b) * Sk : nullptr,
               o + b * to.b + h * to.h + q0 * to.s, to.s);
}

template <int DP>
static int launch_mha_bhsd(const void* q, const void* k, const void* v, const void* mask, void* o,
                           const BhsdStrides* st, int B, int H, int Sq, int Sk, int D, float qscale,
                           cudaStream_t stream) {
  dim3 grid((Sq + MT_T - 1) / MT_T, H, B);
  return launch_mha_tile<DP>(mha_bhsd_kernel<DP>, grid, stream, static_cast<const bf16*>(q),
                             static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                             static_cast<const float*>(mask), static_cast<bf16*>(o), st[0], st[1], st[2], st[3],
                             Sq, Sk, D, qscale);
}

// strides: 12 values, the (batch, head, row) strides of q, k, v and o in
// elements. mask: (B, Sk) f32 {0, 1}, or null. Returns a CUDA error code;
// cudaErrorInvalidValue for a head width the kernel does not take.
extern "C" int btia_mha_bhsd(const void* q, const void* k, const void* v, const void* mask, void* o,
                             const long long* strides, int B, int H, int Sq, int Sk, int D, float qscale,
                             void* stream) {
  const BhsdStrides* st = reinterpret_cast<const BhsdStrides*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || D < 8 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  switch ((D + 15) / 16 * 16) {
    case 16: return launch_mha_bhsd<16>(q, k, v, mask, o, st, B, H, Sq, Sk, D, qscale, s);
    case 32: return launch_mha_bhsd<32>(q, k, v, mask, o, st, B, H, Sq, Sk, D, qscale, s);
    case 48: return launch_mha_bhsd<48>(q, k, v, mask, o, st, B, H, Sq, Sk, D, qscale, s);
    case 64: return launch_mha_bhsd<64>(q, k, v, mask, o, st, B, H, Sq, Sk, D, qscale, s);
    case 80: return launch_mha_bhsd<80>(q, k, v, mask, o, st, B, H, Sq, Sk, D, qscale, s);
    case 96: return launch_mha_bhsd<96>(q, k, v, mask, o, st, B, H, Sq, Sk, D, qscale, s);
    case 112: return launch_mha_bhsd<112>(q, k, v, mask, o, st, B, H, Sq, Sk, D, qscale, s);
    default: return launch_mha_bhsd<128>(q, k, v, mask, o, st, B, H, Sq, Sk, D, qscale, s);
  }
}
