// K4 on Hopper: masked multi-head attention over pre-projected q/k/v, for
// short sequences at a large batch, on the short-sequence kernel of
// short_flash.cuh in its zero-rows mode, which K1/K2's attention core
// (fused_attn.cu) shares (see there for the design and what bounds it).
//
// Replaces btia_tpu/ops/attention.py:_fanout_kernel (reached through
// mha_bshd when B >= 64 and D % 64 == 0; in training, the backward pass of
// every fused K1 site recomputes through it). The wrapper is
// btia_tpu_torch/ops/attention.py:fanout_attention, which hands the kernel
// the projection-native (B, S, H*D) operands as (B, H, S, D) views, the
// (batch, head, row) strides (S*H*D, D, H*D): no transpose is copied. q is
// prescaled by scale*log2(e) in f32 and rounded to bf16 inside the kernel,
// as the TPU kernel does (attention.py:376-378); a fully masked row gives 0.

#include "short_flash.cuh"

// q: (B, H, Sq, D) and k / v: (B, H, Sk, D) bf16 views, colmask: (B, Sk)
// f32 {0, 1}, o: (B, H, Sq, D); strides: 12 values, the (batch, head, row)
// strides of q, k, v and o in elements; plan: 6 values, the key tile (64 or
// 128) then pack, q_span, k_span, groups and q_tiles
// (ops/attention.py:short_plan). D is 64, 128, 192 or 256. Returns 0, a CUDA
// error code, or 1000 + the CUresult of encoding a tensor map.
extern "C" int btia_fanout(const void* q, const void* k, const void* v, const void* colmask, void* o,
                           const long long* strides, const int* plan, int B, int H, int Sq, int Sk, int D,
                           float qscale, void* stream) {
  if (D % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = strides;
  SfHostProblem p;
  p.q = {q, st[0], st[1], st[2]};
  p.k = {k, st[3], st[4], st[5]};
  p.v = {v, st[6], st[7], st[8]};
  p.o = {o, st[9], st[10], st[11]};
  p.mask = colmask;
  p.mask_bytes = 4;
  p.B = B, p.H = H, p.Sq = Sq, p.Sk = Sk;
  p.plan = plan + 1;
  p.q_shared = 0;
  return sf_dispatch<true>(&p, 1, D, plan[0], qscale, static_cast<cudaStream_t>(stream));
}
