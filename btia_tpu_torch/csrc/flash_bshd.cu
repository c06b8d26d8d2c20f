// K3 and K5 on Hopper: one attention kernel over (B, H, S, D) operands in
// any strides, for K3's projection-native (B, S, H*D) layout (ViT
// self-attention: ViT-L/336's 577 tokens, 16 heads; the AD head's 2048
// answer queries in training) and K5's (B, H, S, D) views at every head
// width up to 256 (mha(impl="pallas"), and mha_bshd's long road where K3's
// packed layout does not apply).
//
// Replaces btia_tpu/ops/attention.py:_bshd_flash_kernel (K3, reached
// through mha_bshd when Sq*Sk exceeds the short-sequence score tile) and
// btia_tpu/ops/attention.py:_mha_kernel (K5, wrapper _mha_pallas). The
// wrappers are btia_tpu_torch/ops/attention.py:bshd_flash_attention (entry
// btia_flash_bshd below) and mha_bhsd_attention (entry btia_mha_bhsd in
// mha_bhsd.cu, which calls launch_flash_attention).
//
// What bounds it on an H100: per ViT-L layer at 16 images it does ~22 GFLOP
// of score and PV products over ~76 MB of q/k/v/o: ~22 us at 989 TF/s bf16
// and ~23 us at 3.35 TB/s, so bytes and tensor-core operations bound it
// about equally; at the AD head's 2048 queries over 229 tokens it is bound
// by bytes. Only wgmma reaches the tensor cores' rate on Hopper, and only
// TMA moves tiles without spending the math warps' issue slots, so the
// design is FlashAttention-3's:
//
// * One block per (BM-row q tile, head, batch row): BM / 64 consumer
//   warpgroups of 64 q rows and one producer warp. The kernel is built for
//   padded head widths DP = 64, 128, 192 and 256; a head of D <= DP columns
//   takes the template DP = 64 * ceil(D / 64). BM = 128 (two consumer
//   warpgroups) up to DP = 192. At DP = 256, O alone takes 128 registers a
//   thread, and ptxas budgets a block of 288 threads 168 registers a thread
//   (as for three whole warpgroups; setmaxnreg did not raise it), which
//   spilled; there BM = 64, one consumer warpgroup, whose budget is 255.
// * The producer loads Q once, then K and V tiles of BN keys with TMA
//   (128-byte swizzle) into a ring of stages completed on mbarriers; the
//   consumers release a stage through an "empty" mbarrier when their last
//   product has read it. K5's operands are read through 4-D tensor maps
//   over the (B, H, S, D) view with its own strides (dims {D, S, H, B},
//   boxes {64, rows, 1, 1}); a head takes DP / 64 boxes, and TMA's
//   out-of-bounds zero fill supplies the columns [D, DP), so no padded byte
//   is stored or read in device memory. K3's packed (B, S, H*D) operands
//   take 3-D maps over (B, S, H*D) (the PACKED instances): the 4-D maps
//   over the same bytes ran 1-7 % slower on an H100.
// * S = Q K^T is wgmma m64nBNk16 with Q and K read from shared memory
//   (K-major). S stays in registers: the online softmax takes a row's max
//   and sum with two quad shuffles, and the running output O (wgmma's
//   accumulator, m64nDPk16) is rescaled in registers.
// * O += P V takes P, converted to bf16 in registers, as wgmma's register A
//   operand (its accumulator layout is the A fragment's), and V from shared
//   memory as an MN-major (transposed) B.
// * BN = 128 keys per tile at DP = 64 and 128 rather than 64: 577 keys pad
//   to 640 either way (4 x 128 + 65, or 9 x 64 + 1), and the wider tile
//   halves the barrier round trips and softmax rescales per key and runs
//   wgmma at N = 128. At DP = 192 and 256, BN = 64: O alone takes DP / 2
//   registers a thread, and a two-stage ring of 128-key tiles with Q would
//   need 240 KB (DP = 192) of shared memory; 64-key tiles need 144 KB (and
//   160 KB at DP = 256 with BM = 64).
// * O is stored through o's own strides, columns [0, D) only: on mha_bshd's
//   long road that is the (B, S, H, D) buffer, so no transpose is copied.
//
// Semantics follow the TPU kernels: q pre-scaled by scale*log2(e) and
// rounded to bf16 (here in shared memory, once per block), exp2 softmax, an
// additive -1e9 bias on masked keys. Keys past Sk (TMA zero-fills them, and
// a zero key would score 0) are -inf; a row whose every key is masked
// averages V over the Sk real keys. The division by the softmax denominator
// comes once, after PV, as in K5's _attn_block_log2 (defer_div); K3's TPU
// kernel divides before PV, so K3 differs from it by the bf16 rounding of
// the probabilities. Rows past Sq are not stored.

#include "common.cuh"
#include "flash.cuh"
#include "hopper.cuh"

template <int D>  // the padded head width DP
struct F3Layout {
  static constexpr int BM = D <= 192 ? 128 : 64;       // q rows per block
  static constexpr int CONSUMER_WARPS = BM / 16;       // a warpgroup per 64 rows
  static constexpr int THREADS = 32 * CONSUMER_WARPS + 32;  // + the producer warp
  static constexpr int BN = D <= 128 ? 128 : 64;       // keys per tile
  static constexpr int NB = D / 64;                    // 64-column (128-byte) blocks
  static constexpr int STAGES = D == 64 ? 3 : 2;       // K/V ring depth
  static constexpr int Q_BLK = BM * 128;               // bytes of one column block of Q
  static constexpr int KV_BLK = BN * 128;              // ... of K or V
  static constexpr int Q_BYTES = NB * Q_BLK;
  static constexpr int KV_BYTES = NB * KV_BLK;         // one K (or V) tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;     // K, then V
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int SMEM = BAR_OFF + 64 + 1024;     // barriers; slack to align the base to 1 KB
};

// S (+)= Q K^T over 16 of D, for a tile of BN keys.
template <int BN>
__device__ __forceinline__ void qk_product(float (&s)[BN / 2], uint64_t da, uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void qk_product<64>(float (&s)[32], uint64_t da, uint64_t db, int scale_d) {
  wgmma_bf16_ss_n64(s, da, db, scale_d);
}
template <>
__device__ __forceinline__ void qk_product<128>(float (&s)[64], uint64_t da, uint64_t db, int scale_d) {
  wgmma_bf16_ss_n128(s, da, db, scale_d);
}

// O += P V over 16 keys, for a head of D columns.
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void pv_product<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_bf16_rs_tb_n64(o, a, db, 1);
}
template <>
__device__ __forceinline__ void pv_product<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_bf16_rs_tb_n128(o, a, db, 1);
}
template <>
__device__ __forceinline__ void pv_product<192>(float (&o)[96], const uint32_t (&a)[4], uint64_t db) {
  wgmma_bf16_rs_tb_n192(o, a, db, 1);
}
template <>
__device__ __forceinline__ void pv_product<256>(float (&o)[128], const uint32_t (&a)[4], uint64_t db) {
  wgmma_bf16_rs_tb_n256(o, a, db, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D is the padded width DP (a template); dw the head's own width (<= DP, a
// multiple of 8), the columns stored. PACKED: K3's (B, S, H*D) layout, read
// through 3-D tensor maps over (B, S, H*D) with dw == D; otherwise 4-D maps
// over the (B, H, S, D) operand.
template <int D, bool PACKED>
__global__ void __launch_bounds__(F3Layout<D>::THREADS, 1)
flash_attn_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const float* __restrict__ mask, bf16* __restrict__ o,
                  long long o_b, long long o_h, long long o_s, int dw, int Sq, int Sk, float qscale) {
  using L = F3Layout<D>;
  constexpr int BN = L::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sq = smem;
  unsigned char* skv = smem + L::Q_BYTES;  // stage s: K at s * STAGE_BYTES, V KV_BYTES after it
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + L::STAGES;
  uint64_t* qbar = empty + L::STAGES;

  const int q0 = blockIdx.x * L::BM, h = blockIdx.y, b = blockIdx.z;
  const int nkt = (Sk + BN - 1) / BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::CONSUMER_WARPS);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == L::CONSUMER_WARPS) {
    // Producer: one thread issues every load.
    if (lane == 0) {
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_expect_tx(qbar, L::Q_BYTES);
      for (int c = 0; c < L::NB; ++c) {
        if (PACKED) tma_load_3d(sq + c * L::Q_BLK, &qmap, qbar, h * D + c * 64, q0, b);
        else tma_load_4d(sq + c * L::Q_BLK, &qmap, qbar, c * 64, q0, h, b);
      }
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % L::STAGES;
        // Stage s last held tile kt - STAGES: wait for its release.
        if (kt >= L::STAGES) mbar_wait(&empty[s], (kt / L::STAGES - 1) & 1);
        mbar_expect_tx(&full[s], L::STAGE_BYTES);
        unsigned char* kd = skv + s * L::STAGE_BYTES;
        for (int c = 0; c < L::NB; ++c) {
          if (PACKED) {
            tma_load_3d(kd + c * L::KV_BLK, &kmap, &full[s], h * D + c * 64, kt * BN, b);
            tma_load_3d(kd + L::KV_BYTES + c * L::KV_BLK, &vmap, &full[s], h * D + c * 64, kt * BN, b);
          } else {
            tma_load_4d(kd + c * L::KV_BLK, &kmap, &full[s], c * 64, kt * BN, h, b);
            tma_load_4d(kd + L::KV_BYTES + c * L::KV_BLK, &vmap, &full[s], c * 64, kt * BN, h, b);
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) of the tile;
    // this thread rows r0 and r0 + 8 of them.
    const int wg = warp / 4, t = threadIdx.x % 128;
    const int r0 = 16 * (t / 32) + lane / 4, qd = lane % 4;

    // Q into the log2 domain, rounded to bf16, in place (an elementwise map,
    // so the swizzle does not matter), then handed to the async proxy.
    mbar_wait(qbar, 0);
#pragma unroll
    for (int c = 0; c < L::NB; ++c) {
      uint4* p = reinterpret_cast<uint4*>(sq + c * L::Q_BLK + wg * 64 * 128);
#pragma unroll
      for (int i = t; i < 64 * 128 / 16; i += 128) {
        uint4 v = p[i];
        __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(hv[e]);
          hv[e] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
        }
        p[i] = v;
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);

    const uint32_t q_addr = smem_u32(sq) + wg * 64 * 128;
    const float* mrow = mask != nullptr ? mask + static_cast<long long>(b) * Sk : nullptr;
    float acc_o[D / 2], sc[BN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % L::STAGES;
      mbar_wait(&full[s], (kt / L::STAGES) & 1);
      const uint32_t k_addr = smem_u32(skv + s * L::STAGE_BYTES);
      const uint32_t v_addr = k_addr + L::KV_BYTES;

      // S = Q K^T over D in steps of 16.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 bf16 along a 128-byte row
        qk_product<BN>(sc, wgmma_desc_sw128(q_addr + (kk / 4) * L::Q_BLK + off, 16, 1024),
                       wgmma_desc_sw128(k_addr + (kk / 4) * L::KV_BLK + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Masks: -1e9 on masked keys, -inf past Sk.
      const int k0 = kt * BN;
      if (mrow != nullptr || k0 + BN > Sk) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = k0 + 8 * j + 2 * qd + c;
            const float bias = col >= Sk ? -INFINITY : (mrow != nullptr && mrow[col] == 0.f ? -1e9f : 0.f);
            sc[4 * j + c] += bias;
            sc[4 * j + 2 + c] += bias;
          }
        }
      }

      // Online softmax, rows r0 (registers 4j, 4j+1) and r0 + 8 (4j+2, 4j+3).
      float x0 = m0, x1 = m1;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        x0 = fmaxf(x0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        x1 = fmaxf(x1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
      const float alpha0 = exp2f(m0 - x0), alpha1 = exp2f(m1 - x1);
      m0 = x0;
      m1 = x1;

      uint32_t pa[BN / 16][4];
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        float e[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) e[r] = exp2f(sc[8 * kk + r] - ((r & 2) ? m1 : m0));
        s0 += (e[0] + e[1]) + (e[4] + e[5]);
        s1 += (e[2] + e[3]) + (e[6] + e[7]);
        pa[kk][0] = pack_bf16(e[0], e[1]);  // row r0,     keys 16kk + 2qd, +1
        pa[kk][1] = pack_bf16(e[2], e[3]);  // row r0 + 8, the same keys
        pa[kk][2] = pack_bf16(e[4], e[5]);  // row r0,     keys 16kk + 8 + 2qd, +1
        pa[kk][3] = pack_bf16(e[6], e[7]);  // row r0 + 8
      }
      l0 = l0 * alpha0 + s0;
      l1 = l1 * alpha1 + s1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc_o[4 * j] *= alpha0;
        acc_o[4 * j + 1] *= alpha0;
        acc_o[4 * j + 2] *= alpha1;
        acc_o[4 * j + 3] *= alpha1;
      }

      // O += P V over the tile's keys in steps of 16 (V rows 16kk.., 2 KB
      // apart). V is MN-major: 1 KB between groups of eight keys (SBO), and
      // one column block to the next (LBO; unused at D = 64).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        pv_product<D>(acc_o, pa[kk], wgmma_desc_sw128(v_addr + kk * 2048, D == 64 ? 1024 : L::KV_BLK, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp has finished reading stage s
    }

    // The row sums live in four threads each; divide once and store.
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const int g0 = q0 + wg * 64 + r0, g1 = g0 + 8;
    bf16* o0 = o + b * o_b + h * o_h + g0 * o_s + 2 * qd;
    bf16* o1 = o0 + 8 * o_s;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (!PACKED && 8 * j >= dw) continue;  // a padded column
      if (g0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
            __floats2bfloat162_rn(acc_o[4 * j] / l0, acc_o[4 * j + 1] / l0);
      if (g1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
            __floats2bfloat162_rn(acc_o[4 * j + 2] / l1, acc_o[4 * j + 3] / l1);
    }
  }
}

// A 4-D tensor map over a (B, H, S, D) operand: dims {dw, S, H, B}, a box of
// 64 columns by `rows`.
static int encode_bhsd(CUtensorMap* map, const FlashOperand& t, int B, int H, int S, int dw, uint32_t rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(dw), static_cast<uint64_t>(S), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {2ull * t.s, 2ull * t.h, 2ull * t.b};
  const uint32_t box[4] = {64, rows, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, t.ptr, dims, strides, box);
}

template <int D, bool PACKED>
static int launch_flash(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, const void* mask,
                        const FlashOperand& o, int B, int H, int Sq, int Sk, int dw, float qscale,
                        cudaStream_t stream) {
  using L = F3Layout<D>;
  auto kernel = flash_attn_kernel<D, PACKED>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + L::BM - 1) / L::BM, H, B);
  kernel<<<grid, L::THREADS, L::SMEM, stream>>>(qm, km, vm, static_cast<const float*>(mask),
                                                static_cast<bf16*>(const_cast<void*>(o.ptr)), o.b, o.h, o.s, dw, Sq,
                                                Sk, qscale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
static int launch_bhsd(const FlashOperand& q, const FlashOperand& k, const FlashOperand& v, const void* mask,
                       const FlashOperand& o, int B, int H, int Sq, int Sk, int dw, float qscale, cudaStream_t stream) {
  using L = F3Layout<D>;
  CUtensorMap qm, km, vm;
  int err = encode_bhsd(&qm, q, B, H, Sq, dw, L::BM);
  if (err == 0) err = encode_bhsd(&km, k, B, H, Sk, dw, L::BN);
  if (err == 0) err = encode_bhsd(&vm, v, B, H, Sk, dw, L::BN);
  if (err != 0) return err;
  return launch_flash<D, false>(qm, km, vm, mask, o, B, H, Sq, Sk, dw, qscale, stream);
}

int launch_flash_attention(const FlashOperand& q, const FlashOperand& k, const FlashOperand& v, const void* mask,
                           const FlashOperand& o, int B, int H, int Sq, int Sk, int dw, float qscale,
                           cudaStream_t stream) {
  if (dw < 8 || dw % 8 != 0 || dw > 256) return static_cast<int>(cudaErrorInvalidValue);
  switch ((dw + 63) / 64) {
    case 1: return launch_bhsd<64>(q, k, v, mask, o, B, H, Sq, Sk, dw, qscale, stream);
    case 2: return launch_bhsd<128>(q, k, v, mask, o, B, H, Sq, Sk, dw, qscale, stream);
    case 3: return launch_bhsd<192>(q, k, v, mask, o, B, H, Sq, Sk, dw, qscale, stream);
    default: return launch_bhsd<256>(q, k, v, mask, o, B, H, Sq, Sk, dw, qscale, stream);
  }
}

template <int D>
static int launch_packed(const void* q, const void* k, const void* v, const void* mask, void* o, int B, int H, int Sq,
                         int Sk, float qscale, cudaStream_t stream) {
  using L = F3Layout<D>;
  const long long HD = static_cast<long long>(H) * D;
  const uint64_t qdims[3] = {static_cast<uint64_t>(HD), static_cast<uint64_t>(Sq), static_cast<uint64_t>(B)};
  const uint64_t kdims[3] = {static_cast<uint64_t>(HD), static_cast<uint64_t>(Sk), static_cast<uint64_t>(B)};
  const uint64_t qstr[2] = {2ull * HD, 2ull * HD * Sq}, kstr[2] = {2ull * HD, 2ull * HD * Sk};
  const uint32_t qbox[3] = {64, L::BM, 1}, kbox[3] = {64, L::BN, 1};
  CUtensorMap qm, km, vm;
  int err = encode_map(&qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, q, qdims, qstr, qbox);
  if (err == 0) err = encode_map(&km, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, k, kdims, kstr, kbox);
  if (err == 0) err = encode_map(&vm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, kdims, kstr, kbox);
  if (err != 0) return err;
  const FlashOperand out{o, Sq * HD, D, HD};
  return launch_flash<D, true>(qm, km, vm, mask, out, B, H, Sq, Sk, D, qscale, stream);
}

// K3. q: (B, Sq, H*D), k / v: (B, Sk, H*D) bf16, 16-byte aligned; mask:
// (B, Sk) f32 {0, 1} or null; o: (B, Sq, H*D) bf16. D is 64, 128, 192 or
// 256; Sq, Sk >= 1. Returns 0, a CUDA error code, or 1000 + the CUresult of
// encoding a tensor map.
extern "C" int btia_flash_bshd(const void* q, const void* k, const void* v, const void* mask, void* o, int B, int H,
                               int D, int Sq, int Sk, float qscale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_packed<64>(q, k, v, mask, o, B, H, Sq, Sk, qscale, s);
  if (D == 128) return launch_packed<128>(q, k, v, mask, o, B, H, Sq, Sk, qscale, s);
  if (D == 192) return launch_packed<192>(q, k, v, mask, o, B, H, Sq, Sk, qscale, s);
  if (D == 256) return launch_packed<256>(q, k, v, mask, o, B, H, Sq, Sk, qscale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
