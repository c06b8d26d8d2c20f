// K6 on Hopper: both directions of BTIA's bidirectional cross-attention in
// one launch.
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
// What bounds it on an H100: at the pooled serving shape (B = 2048, H = 12,
// Ni = 50, Nt = 32, D = 64) it moves ~1 GB of q/k/v/o for ~20 GFLOP, so it
// is bound by bytes (~0.31 ms at 3.35 TB/s). The TPU kernel exists to run
// both directions in one program per (batch, head), with all six q/k/v
// slices in VMEM; on Hopper the point that carries over is one launch for
// both directions: the grid's x axis enumerates the img <- txt q tiles, then
// the txt <- img q tiles, so both run side by side on the card with no
// second launch and no dependence between them. Each block runs the shared
// online-softmax tile of mha_tile.cuh (q pre-scaled by scale*log2(e),
// -1e9 mask bias, exp2, division after PV), reading every operand through
// its strides so bicross_bshd's transposes cost no copy.

#include "mha_tile.cuh"

struct BicrossArgs {
  const bf16 *qi, *ki, *vi, *qt, *kt, *vt;
  const float* mask;  // (B, Nt) f32 {0, 1}, or null
  bf16 *oi, *ot;
  BhsdStrides sqi, ski, svi, sqt, skt, svt, soi, sot;
  int Ni, Nt, D;
  float qscale;
};

template <int DP>
__global__ void __launch_bounds__(MT_THREADS) bicross_kernel(BicrossArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  MhaTileSmem<DP>& sm = *reinterpret_cast<MhaTileSmem<DP>*>(smem_raw);
  const int tiles_i = (a.Ni + MT_T - 1) / MT_T;
  const int h = blockIdx.y, b = blockIdx.z;
  // img <- txt (masked by the question) for the first tiles_i blocks along
  // x, then txt <- img (every image token valid).
  const bool i2t = static_cast<int>(blockIdx.x) < tiles_i;
  const int q0 = (i2t ? blockIdx.x : blockIdx.x - tiles_i) * MT_T;
  const bf16* q = i2t ? a.qi : a.qt;
  const bf16* k = i2t ? a.kt : a.ki;
  const bf16* v = i2t ? a.vt : a.vi;
  bf16* o = i2t ? a.oi : a.ot;
  const BhsdStrides tq = i2t ? a.sqi : a.sqt, tk = i2t ? a.skt : a.ski;
  const BhsdStrides tv = i2t ? a.svt : a.svi, to = i2t ? a.soi : a.sot;
  const int Sq = i2t ? a.Ni : a.Nt, Sk = i2t ? a.Nt : a.Ni;
  const float* mrow = (i2t && a.mask != nullptr) ? a.mask + static_cast<long long>(b) * a.Nt : nullptr;
  mha_tile<DP>(sm, q + b * tq.b + h * tq.h + q0 * tq.s, tq.s, min(MT_T, Sq - q0), a.qscale,
               k + b * tk.b + h * tk.h, tk.s, v + b * tv.b + h * tv.h, tv.s, Sk, a.D, mrow,
               o + b * to.b + h * to.h + q0 * to.s, to.s);
}

template <int DP>
static int launch_bicross(const BicrossArgs& a, int B, int H, cudaStream_t stream) {
  dim3 grid((a.Ni + MT_T - 1) / MT_T + (a.Nt + MT_T - 1) / MT_T, H, B);
  return launch_mha_tile<DP>(bicross_kernel<DP>, grid, stream, a);
}

// strides: 24 values, the (batch, head, row) strides of qi, ki, vi, qt, kt,
// vt, oi and ot in elements. Returns a CUDA error code;
// cudaErrorInvalidValue for a head width the kernel does not take.
extern "C" int btia_bicross(const void* qi, const void* ki, const void* vi, const void* qt, const void* kt,
                            const void* vt, const void* mask, void* oi, void* ot, const long long* strides, int B,
                            int H, int Ni, int Nt, int D, float qscale, void* stream) {
  const BhsdStrides* st = reinterpret_cast<const BhsdStrides*>(strides);
  BicrossArgs a;
  a.qi = static_cast<const bf16*>(qi);
  a.ki = static_cast<const bf16*>(ki);
  a.vi = static_cast<const bf16*>(vi);
  a.qt = static_cast<const bf16*>(qt);
  a.kt = static_cast<const bf16*>(kt);
  a.vt = static_cast<const bf16*>(vt);
  a.mask = static_cast<const float*>(mask);
  a.oi = static_cast<bf16*>(oi);
  a.ot = static_cast<bf16*>(ot);
  a.sqi = st[0], a.ski = st[1], a.svi = st[2], a.sqt = st[3];
  a.skt = st[4], a.svt = st[5], a.soi = st[6], a.sot = st[7];
  a.Ni = Ni, a.Nt = Nt, a.D = D, a.qscale = qscale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || D < 8 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  switch ((D + 15) / 16 * 16) {
    case 16: return launch_bicross<16>(a, B, H, s);
    case 32: return launch_bicross<32>(a, B, H, s);
    case 48: return launch_bicross<48>(a, B, H, s);
    case 64: return launch_bicross<64>(a, B, H, s);
    case 80: return launch_bicross<80>(a, B, H, s);
    case 96: return launch_bicross<96>(a, B, H, s);
    case 112: return launch_bicross<112>(a, B, H, s);
    default: return launch_bicross<128>(a, B, H, s);
  }
}
