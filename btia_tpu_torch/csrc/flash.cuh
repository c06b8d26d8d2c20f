// The host interface of the attention kernel in flash_bshd.cu, shared by
// K3's entry there and K5's in mha_bhsd.cu.

#pragma once

#include <cuda_runtime.h>

// A (B, H, S, D) bf16 operand: its base (16-byte aligned) and its batch,
// head and row strides in elements, each a nonzero multiple of 8 (TMA reads
// rows of 16-byte multiples); its columns are packed.
struct FlashOperand {
  const void* ptr;
  long long b, h, s;
};

// One attention call: the key mask (B, Sk) bool (bytes, nonzero = a real
// key) or null; heads of dw columns (a multiple of 8, at
// most 256); grid: the persistent blocks of the kernel at DP 64 and 128
// (ops/attention.py:flash_plan); qscale folds softmax's scale and log2(e)
// into q.
struct FlashLaunch {
  const void* mask;
  int B, H, Sq, Sk, dw, grid;
  float qscale;
};

// Attention over q (B, H, Sq, dw), k / v (B, H, Sk, dw) into o (B, H, Sq,
// dw). Returns 0, a CUDA error code, or 1000 + the CUresult of encoding a
// tensor map.
int launch_flash_attention(const FlashOperand& q, const FlashOperand& k, const FlashOperand& v,
                           const FlashOperand& o, const FlashLaunch& a, cudaStream_t stream);
