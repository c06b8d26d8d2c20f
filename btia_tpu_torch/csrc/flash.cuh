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

// Attention over heads of dw columns (a multiple of 8, at most 256): q
// (B, H, Sq, dw), k / v (B, H, Sk, dw), mask (B, Sk) f32 {0, 1} or null, o
// (B, H, Sq, dw). Returns 0, a CUDA error code, or 1000 + the CUresult of
// encoding a tensor map.
int launch_flash_attention(const FlashOperand& q, const FlashOperand& k, const FlashOperand& v, const void* mask,
                           const FlashOperand& o, int B, int H, int Sq, int Sk, int dw, float qscale,
                           cudaStream_t stream);
