// K6 on Hopper: both directions of BTIA's bidirectional cross-attention in
// one launch, on the short-sequence kernel of short_flash.cuh in its mean-V
// mode (see there for the design and what bounds it).
//
// Replaces the kernel closure of btia_tpu/ops/bicross.py:_bicross_pallas,
// reached through bicross_attention(impl="pallas"), through
// bicross_attention() with the switch on the kernels and Ni*Nt above 32768,
// and through bicross_bshd on such long tiles. The wrapper is
// btia_tpu_torch/ops/bicross.py:bicross_bhsd_attention.
//
//   img <- txt : out_i = softmax(Q_img K_txt^T / sqrt(d)) V_txt  (question mask)
//   txt <- img : out_t = softmax(Q_txt K_img^T / sqrt(d)) V_img  (dense)
//
// The TPU kernel exists to run both directions in one program per (batch,
// head); what carries over to Hopper is one launch for both: the two
// directions are the kernel's two problems, their items walked by one
// persistent grid. Every operand is read through its strides (TMA over 4-D
// maps), so bicross_bshd's transposes cost no copy. Any head width up to
// 256: the template DP = 64 * ceil(D / 64), TMA's zero fill supplying the
// columns [D, DP); the wrapper pads only a width that is not a multiple of 8.

#include "short_flash.cuh"

// strides: 24 values, the (batch, head, row) strides of qi, ki, vi, qt, kt,
// vt, oi and ot in elements; plan: 11 values, the key tile, then pack,
// q_span, k_span, groups and q_tiles of img <- txt and of txt <- img
// (ops/attention.py:short_plan). mask: (B, Nt) bool (True = a real token),
// or null. Returns 0, a CUDA error code (cudaErrorInvalidValue for a head
// width or plan the kernel does not take), or 1000 + the CUresult of
// encoding a tensor map.
extern "C" int btia_bicross(const void* qi, const void* ki, const void* vi, const void* qt, const void* kt,
                            const void* vt, const void* mask, void* oi, void* ot, const long long* strides,
                            const int* plan, int B, int H, int Ni, int Nt, int D, float qscale, void* stream) {
  const long long* st = strides;
  const SfOperand sqi{qi, st[0], st[1], st[2]}, ski{ki, st[3], st[4], st[5]}, svi{vi, st[6], st[7], st[8]};
  const SfOperand sqt{qt, st[9], st[10], st[11]}, skt{kt, st[12], st[13], st[14]}, svt{vt, st[15], st[16], st[17]};
  const SfOperand soi{oi, st[18], st[19], st[20]}, sot{ot, st[21], st[22], st[23]};
  SfHostProblem p[2];
  p[0] = {sqi, skt, svt, soi, mask, 1, B, H, Ni, Nt, plan + 1};     // img <- txt, masked by the question
  p[1] = {sqt, ski, svi, sot, nullptr, 1, B, H, Nt, Ni, plan + 6};  // txt <- img, dense
  return sf_dispatch<false>(p, 2, D, plan[0], qscale, static_cast<cudaStream_t>(stream));
}
