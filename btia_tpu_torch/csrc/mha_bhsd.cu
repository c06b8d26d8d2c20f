// K5's entry: attention in the (B, H, S, D) layout at any head width D that
// is a multiple of 8 up to 256, on the attention kernel of flash_bshd.cu
// (TMA over 4-D tensor maps with the operands' own strides, wgmma, softmax
// in registers; see there for the design and what bounds it).
//
// Replaces btia_tpu/ops/attention.py:_mha_kernel (wrapper _mha_pallas),
// reached through mha(impl="pallas"), through mha() with the switch on the
// kernels and a score tile above 32768, and through mha_bshd's long-sequence
// road whenever D % 64 != 0 or H*D % 128 != 0 (there K3's packed layout does
// not apply). The wrapper is btia_tpu_torch/ops/attention.py:
// mha_bhsd_attention. The TPU kernel padded D in device memory (to D when
// D % 64 == 0, else to a multiple of 128); here TMA's zero fill pads it in
// shared memory, and the wrapper copies only a head whose width is not a
// multiple of 8 (TMA's 16-byte row rule), to the next multiple of 8.

#include "flash.cuh"

// strides: 12 values, the (batch, head, row) strides of q, k, v and o in
// elements, each a nonzero multiple of 8. mask: (B, Sk) bool (bytes,
// nonzero = a real key) or null. grid: the persistent blocks at D <= 128
// (ops/attention.py:flash_plan). Returns 0, a CUDA error code
// (cudaErrorInvalidValue for a head width the kernel does not take), or
// 1000 + the CUresult of encoding a tensor map.
extern "C" int btia_mha_bhsd(const void* q, const void* k, const void* v, const void* mask, void* o,
                             const long long* strides, int B, int H, int Sq, int Sk, int D, float qscale, int grid,
                             void* stream) {
  const long long* st = strides;
  const FlashOperand tq{q, st[0], st[1], st[2]}, tk{k, st[3], st[4], st[5]}, tv{v, st[6], st[7], st[8]},
      to{o, st[9], st[10], st[11]};
  const FlashLaunch a{mask, B, H, Sq, Sk, D, grid, qscale};
  return launch_flash_attention(tq, tk, tv, to, a, static_cast<cudaStream_t>(stream));
}
