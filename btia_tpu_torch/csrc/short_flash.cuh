// Short-sequence attention at a large batch on Hopper: the kernel of K1 and
// K2's attention core (fused_attn.cu), K4 (fanout.cu) and K6 (bicross.cu).
//
// Replaces the attention of btia_tpu/ops/fused_attn.py:_fused_kernel (K1)
// and _staticq_kernel (K2), the body of btia_tpu/ops/attention.py:
// _fanout_kernel (K4) and the kernel closure of btia_tpu/ops/bicross.py:
// _bicross_pallas (K6). All four TPU kernels attend a few dozen to a few
// hundred keys per row at batches of 64 to 2048 rows and 12 heads.
//
// What bounds it on an H100: bytes. K4 at 64 x 197 <- 32 (D 64) moves 45 MB
// of q/k/v/o (13.4 us at 3.35 TB/s) for under 1 us of tensor-core work; K6
// at the pooled BTIA shape (2048 x 12 heads, 50 <-> 32) about 1 GB. K1/K2's
// core at the serve step reads q and the [k|v] GEMM output and writes o:
// 0.40 GB at a BERT site (0.120 ms), 0.52 GB at a BTIA site (0.154 ms) and,
// for K2, 0.72 GB (0.214 ms) with its 64-row query table read once, not
// once a batch row. What such a kernel has to do is keep enough bytes in
// flight while it computes, and spend few instructions per item. So:
//
// * Work items, not a block per tile. An item is (problem, group of batch
//   rows, head, 64-row q tile); K6's two directions are two problems of one
//   launch. A persistent grid of a few blocks an SM walks the items.
// * Short rows share a tile. Where Sq <= 32 the host packs `pack` batch rows
//   into one 64-row tile (each at a row offset of q_span = Sq rounded up to
//   8), their keys side by side in the key tile (k_span = Sk rounded up to
//   8 apart), under a block-diagonal key mask: the TPU kernel's bb packing
//   (attention.py:367-369, 442-443). The host plans the items
//   (ops/attention.py:short_plan); sf_decode below is its inverse.
// * Bytes in flight all the time. A producer warp loads each item's Q and
//   its K / V key tiles with TMA (4-D tensor maps over the (B, H, S, D)
//   views with their own strides, 128-byte swizzle) into two rings on
//   mbarriers: two Q slots and two K/V stages. Item i + 1's loads run while
//   the consumer warpgroup computes item i, and the other resident blocks
//   of the SM fill the gaps. TMA zero-fills rows past S, batch rows past B
//   and the columns [dw, DP) of a head narrower than its template. K1/K2's
//   operands are the projection GEMM's outputs as they lie (q rows of H*D,
//   k and v side by side in rows of 2*H*D), read through their strides, so
//   no head transpose or split of [k|v] is copied; a shared query table
//   (K2, q_shared) is one batch row of Q that every item loads.
// * Scores, probabilities and O in registers, as in K3 (flash_bshd.cu):
//   S = Q K^T on wgmma m64nBNk16 from shared memory, the softmax with quad
//   shuffles, O += P V with P as the register A operand and V an MN-major B.
//   Key tiles are small, BN = 32 keys (64 where two short rows share a
//   tile), and longer rows loop over them with the online softmax: in
//   development calls on an H100 a 32-key tile ran faster than a 64- or
//   128-key tile that held the whole row (82, 197 and 577 keys), since the
//   smaller tile leaves room for more resident blocks an SM and spends no
//   exponentials on padding.
// * The key mask is read once a column into a table in shared memory,
//   issued before the score product. Read once a (column, thread) on the
//   softmax's path, its dependent global loads dominated the kernel's time.
// * The output is staged through the item's Q slot in the 128-byte swizzle
//   and stored in 16-byte vectors through o's strides: rows [0, Sq) and
//   columns [0, dw) only.
//
// Two softmax semantics (template parameter ZERO):
// * K1, K2 and K4 (ZERO): a -1e9 bias on masked keys before the row max,
//   exp2 times the {0, 1} key mask, the denominator floored at 1e-30, the
//   division after PV; a fully masked row gives exactly 0
//   (attention.py:349-412, fused_attn.py:262-271).
// * K6: a -1e9 bias on masked keys, keys past Sk excluded, the division
//   after PV (_attn_block_log2, defer_div=True); a fully masked row
//   averages V over the Sk real keys, as mha_reference and K5 do.
// In both, q is multiplied by qscale (scale*log2(e)) in f32 and rounded to
// bf16 in shared memory; K1/K2 fold that factor into wq/bq and pass 1,
// which skips the pass (bf16 x 1 rounds to itself). Keys past Sk and keys
// of another batch row of a packed tile are -inf. A stale row of a stage
// (past pack * k_span) meets a probability of exactly 0; the shared memory
// is zeroed once at the start.

#pragma once

#include <string.h>

#include <mutex>

#include "common.cuh"
#include "hopper.cuh"

constexpr int SF_THREADS = 160;  // one consumer warpgroup + one producer warp
constexpr int SF_STAGES = 2;     // Q slots, and K/V stages

template <int DP, int BN>
struct SfLayout {
  static constexpr int NB = DP / 64;                   // 64-column (128-byte) blocks
  static constexpr int Q_BLK = 64 * 128;               // one column block of a 64-row Q slot
  static constexpr int Q_BYTES = NB * Q_BLK;           // one Q slot
  static constexpr int KV_BLK = BN * 128;              // one column block of a K or V tile
  static constexpr int KV_BYTES = NB * KV_BLK;         // one K (or V) tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;     // K, then V
  static constexpr int KV_OFF = SF_STAGES * Q_BYTES;
  static constexpr int COL_OFF = KV_OFF + SF_STAGES * STAGE_BYTES;  // two tiles' key-column tables
  static constexpr int BAR_OFF = COL_OFF + 2 * BN * 8;
  static constexpr int SMEM = BAR_OFF + 32 * SF_STAGES + 1024;  // 4 barriers a stage; slack to align the base to 1 KB
  // Resident blocks an SM the registers are budgeted for (__launch_bounds__):
  // as many as the shared memory holds at that width. At DP 64 four blocks
  // at 96 registers, a little spilled, ran faster than three at 110, and
  // deeper rings, which fit fewer blocks, ran slower (development calls on
  // an H100).
  static constexpr int MIN_BLOCKS = DP == 64 ? 4 : DP == 128 ? (BN == 32 ? 3 : 2) : DP == 192 ? (BN == 32 ? 2 : 1) : 1;
};

// One problem as the kernel sees it. The plan fields come from the host's
// planner: pack batch rows per tile (1: none), q_span / k_span the rows and
// keys each packed batch row takes (64 / BN when pack == 1), groups =
// ceil(B / pack), q_tiles = ceil(Sq / 64) (1 when packed), items = groups *
// H * q_tiles.
struct SfProblem {
  const void* mask;  // (B, Sk) {0, 1}: f32 (mask_bytes 4) or bool (1); or null
  int mask_bytes;
  int q_shared;  // Q is one (1, H, Sq, dw) table that every batch row reads
  bf16* o;
  long long ob, oh, os;
  int B, H, Sq, Sk;
  int pack, q_span, k_span, groups, q_tiles, items;
};

struct SfParams {
  CUtensorMap qm[2], km[2], vm[2];
  SfProblem pr[2];
  int np, total, dw;
  float qscale;
};

// An item's place: problem p, first batch row b0, head h, first q row q0.
struct SfItem {
  int p, b0, h, q0;
};

// The inverse of the host's item numbering (ops/attention.py:short_items):
// problem 0's items first; within a problem the q tile fastest, then the
// head, then the group of batch rows.
__device__ __forceinline__ SfItem sf_decode(const SfParams& P, int it) {
  SfItem r;
  r.p = (P.np > 1 && it >= P.pr[0].items) ? 1 : 0;
  const SfProblem& pr = P.pr[r.p];
  int i = r.p ? it - P.pr[0].items : it;
  r.q0 = (i % pr.q_tiles) * 64;
  i /= pr.q_tiles;
  r.h = i % pr.H;
  r.b0 = (i / pr.H) * pr.pack;
  return r;
}

template <int BN>
__device__ __forceinline__ void sf_qk(float (&s)[BN / 2], uint64_t da, uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void sf_qk<32>(float (&s)[16], uint64_t da, uint64_t db, int scale_d) {
  wgmma_bf16_ss_n32(s, da, db, scale_d);
}
template <>
__device__ __forceinline__ void sf_qk<64>(float (&s)[32], uint64_t da, uint64_t db, int scale_d) {
  wgmma_bf16_ss_n64(s, da, db, scale_d);
}

template <int DP>
__device__ __forceinline__ void sf_pv(float (&o)[DP / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void sf_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_bf16_rs_tb_n64(o, a, db, 1);
}
template <>
__device__ __forceinline__ void sf_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_bf16_rs_tb_n128(o, a, db, 1);
}
template <>
__device__ __forceinline__ void sf_pv<192>(float (&o)[96], const uint32_t (&a)[4], uint64_t db) {
  wgmma_bf16_rs_tb_n192(o, a, db, 1);
}
template <>
__device__ __forceinline__ void sf_pv<256>(float (&o)[128], const uint32_t (&a)[4], uint64_t db) {
  wgmma_bf16_rs_tb_n256(o, a, db, 1);
}

__device__ __forceinline__ uint32_t sf_pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DP, int BN, bool ZERO>
__global__ void __launch_bounds__(SF_THREADS, SfLayout<DP, BN>::MIN_BLOCKS)
short_flash_kernel(const __grid_constant__ SfParams P) {
  using L = SfLayout<DP, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* qempty = qfull + SF_STAGES;
  uint64_t* kvfull = qempty + SF_STAGES;
  uint64_t* kvempty = kvfull + SF_STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Zero the Q slots and K/V stages once: rows no load of an item writes
  // (past pack * span) then hold finite values, which a probability of 0
  // cancels.
  for (int i = threadIdx.x; i < L::BAR_OFF / 16; i += SF_THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int s = 0; s < SF_STAGES; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], 4);
    }
    for (int s = 0; s < SF_STAGES; ++s) {
      mbar_init(&kvfull[s], 1);
      mbar_init(&kvempty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {
    // Producer: one thread issues every load, running ahead of the consumers
    // by up to two items' Q and two key tiles.
    if (lane == 0) {
      for (int p = 0; p < P.np; ++p) {
        tma_prefetch_map(&P.qm[p]);
        tma_prefetch_map(&P.km[p]);
        tma_prefetch_map(&P.vm[p]);
      }
      int n = 0, c = 0;
      for (int it = blockIdx.x; it < P.total; it += gridDim.x, ++n) {
        const SfItem w = sf_decode(P, it);
        const SfProblem& pr = P.pr[w.p];
        const int slot = n % SF_STAGES;
        if (n >= SF_STAGES) mbar_wait(&qempty[slot], (n / SF_STAGES - 1) & 1);
        mbar_expect_tx(&qfull[slot], pr.pack * pr.q_span * 128 * L::NB);
        unsigned char* qd = smem + slot * L::Q_BYTES;
        for (int j = 0; j < pr.pack; ++j)
          for (int cb = 0; cb < L::NB; ++cb)
            tma_load_4d(qd + cb * L::Q_BLK + j * pr.q_span * 128, &P.qm[w.p], &qfull[slot], cb * 64, w.q0, w.h,
                        pr.q_shared ? 0 : w.b0 + j);
        const int nkt = pr.pack > 1 ? 1 : (pr.Sk + BN - 1) / BN;
        for (int kt = 0; kt < nkt; ++kt, ++c) {
          const int s = c % SF_STAGES;
          if (c >= SF_STAGES) mbar_wait(&kvempty[s], (c / SF_STAGES - 1) & 1);
          mbar_expect_tx(&kvfull[s], 2 * pr.pack * pr.k_span * 128 * L::NB);
          unsigned char* kd = smem + L::KV_OFF + s * L::STAGE_BYTES;
          for (int j = 0; j < pr.pack; ++j)
            for (int cb = 0; cb < L::NB; ++cb) {
              unsigned char* dst = kd + cb * L::KV_BLK + j * pr.k_span * 128;
              tma_load_4d(dst, &P.km[w.p], &kvfull[s], cb * 64, kt * BN, w.h, w.b0 + j);
              tma_load_4d(dst + L::KV_BYTES, &P.vm[w.p], &kvfull[s], cb * 64, kt * BN, w.h, w.b0 + j);
            }
        }
      }
    }
    return;
  }

  // The consumer warpgroup: this thread holds score and output rows r0 and
  // r0 + 8 of the 64-row tile (wgmma's fragment layout, hopper.cuh).
  const int t = threadIdx.x;
  const int r0 = 16 * warp + lane / 4, qd = lane % 4;
  float acc_o[DP / 2], sc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  int n = 0, c = 0;
  for (int it = blockIdx.x; it < P.total; it += gridDim.x, ++n) {
    const SfItem w = sf_decode(P, it);
    const SfProblem& pr = P.pr[w.p];
    const bool packed = pr.pack > 1;
    const int slot = n % SF_STAGES;
    unsigned char* sq = smem + slot * L::Q_BYTES;
    const uint32_t q_addr = smem_u32(sq);

    // Q into the log2 domain, rounded to bf16, in place (an elementwise map,
    // so the swizzle does not matter), then handed to the async proxy. K1/K2
    // hand Q already scaled (qscale 1): the loaded tile is used as it lies.
    mbar_wait(&qfull[slot], (n / SF_STAGES) & 1);
    if (P.qscale != 1.f) {
#pragma unroll
      for (int i = t; i < L::Q_BYTES / 16; i += 128) {
        uint4 v = reinterpret_cast<uint4*>(sq)[i];
        __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(hv[e]);
          hv[e] = __floats2bfloat162_rn(f.x * P.qscale, f.y * P.qscale);
        }
        reinterpret_cast<uint4*>(sq)[i] = v;
      }
      fence_proxy_async();
      named_barrier(1, 128);
    }

    // The packed batch row of this thread's two rows (0 when not packed).
    const int jr0 = packed ? r0 / pr.q_span : 0, jr1 = packed ? (r0 + 8) / pr.q_span : 0;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc_o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    const int nkt = packed ? 1 : (pr.Sk + BN - 1) / BN;
    for (int kt = 0; kt < nkt; ++kt, ++c) {
      const int s = c % SF_STAGES;
      // The tile's key columns, one a thread: bias -1e9 on a masked key, -inf
      // past Sk or past the packed rows, else 0; and the packed batch row
      // jc the column belongs to. Written to shared memory once, so that the
      // mask's global load is issued once a column, before the products,
      // and not once a (column, thread) on the softmax's path.
      const int k0 = kt * BN;
      const bool plain = !packed && pr.mask == nullptr && k0 + BN <= pr.Sk;  // every key live
      float4* cols = reinterpret_cast<float4*>(smem + L::COL_OFF) + (c & 1) * (BN / 2);
      float cbias = 0.f;
      int cj = 0;
      if (!plain && t < BN) {
        int key = k0 + t;
        if (packed) {
          cj = t / pr.k_span;
          key = t - cj * pr.k_span;
        }
        cbias = -INFINITY;
        if (key < pr.Sk && cj < pr.pack) {
          const int b = w.b0 + cj;
          const long long i = static_cast<long long>(b) * pr.Sk + key;
          const bool on = pr.mask == nullptr || b >= pr.B ||
                          (pr.mask_bytes == 1 ? static_cast<const uint8_t*>(pr.mask)[i] != 0
                                              : static_cast<const float*>(pr.mask)[i] != 0.f);
          cbias = on ? 0.f : -1e9f;
        }
      }

      mbar_wait(&kvfull[s], (c / SF_STAGES) & 1);
      const uint32_t k_addr = smem_u32(smem + L::KV_OFF + s * L::STAGE_BYTES);
      const uint32_t v_addr = k_addr + L::KV_BYTES;

      // S = Q K^T over DP in steps of 16.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 bf16 along a 128-byte row
        sf_qk<BN>(sc, wgmma_desc_sw128(q_addr + (kk / 4) * L::Q_BLK + off, 16, 1024),
                  wgmma_desc_sw128(k_addr + (kk / 4) * L::KV_BLK + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      if (!plain) {
        // Two tiles' tables alternate, so one barrier a tile orders writes
        // after the previous readers.
        if (t < BN) reinterpret_cast<float2*>(cols)[t] = make_float2(cbias, __int_as_float(cj));
        named_barrier(1, 128);
      }
      wgmma_wait<0>();
      fence_regs(sc);

      // live: bit 2j + cc, the column's {0, 1} key mask (K4 multiplies the
      // exponentials by it); off the row's own batch block a score is -inf.
      uint32_t live = 0xffffffffu;
      if (!plain) {
        live = 0u;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float4 e = cols[4 * j + qd];  // columns 8j + 2qd and 8j + 2qd + 1
          const int jc0 = __float_as_int(e.y), jc1 = __float_as_int(e.w);
          sc[4 * j] += jc0 == jr0 ? e.x : -INFINITY;
          sc[4 * j + 1] += jc1 == jr0 ? e.z : -INFINITY;
          sc[4 * j + 2] += jc0 == jr1 ? e.x : -INFINITY;
          sc[4 * j + 3] += jc1 == jr1 ? e.z : -INFINITY;
          live |= (static_cast<uint32_t>(e.x == 0.f) | (static_cast<uint32_t>(e.z == 0.f) << 1)) << (2 * j);
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
      // A row with no key at all (past the packed rows) keeps a finite shift.
      const float u0 = x0 == -INFINITY ? 0.f : x0, u1 = x1 == -INFINITY ? 0.f : x1;
      const float alpha0 = exp2f(m0 - u0), alpha1 = exp2f(m1 - u1);
      m0 = x0;
      m1 = x1;

      uint32_t pa[BN / 16][4];
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        float e[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          e[r] = exp2f(sc[8 * kk + r] - ((r & 2) ? u1 : u0));
          // Register 8kk + r is column group 2kk + r / 4, pair member r % 2.
          if (ZERO && !((live >> (4 * kk + 2 * (r >> 2) + (r & 1))) & 1u)) e[r] = 0.f;
        }
        s0 += (e[0] + e[1]) + (e[4] + e[5]);
        s1 += (e[2] + e[3]) + (e[6] + e[7]);
        pa[kk][0] = sf_pack_bf16(e[0], e[1]);  // row r0,     keys 16kk + 2qd, +1
        pa[kk][1] = sf_pack_bf16(e[2], e[3]);  // row r0 + 8, the same keys
        pa[kk][2] = sf_pack_bf16(e[4], e[5]);  // row r0,     keys 16kk + 8 + 2qd, +1
        pa[kk][3] = sf_pack_bf16(e[6], e[7]);  // row r0 + 8
      }
      l0 = l0 * alpha0 + s0;
      l1 = l1 * alpha1 + s1;
      if (kt > 0) {
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          acc_o[4 * j] *= alpha0;
          acc_o[4 * j + 1] *= alpha0;
          acc_o[4 * j + 2] *= alpha1;
          acc_o[4 * j + 3] *= alpha1;
        }
      }

      // O += P V over the tile's keys in steps of 16 (V rows 16kk.., 2 KB
      // apart). V is MN-major: 1 KB between groups of eight keys (SBO), and
      // one column block to the next (LBO; unused at DP = 64).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        sf_pv<DP>(acc_o, pa[kk], wgmma_desc_sw128(v_addr + kk * 2048, DP == 64 ? 1024 : L::KV_BLK, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(&kvempty[s]);  // this warp has finished reading stage s
    }

    // The row sums live in four threads each; divide once (K4: by the sum
    // floored at 1e-30, so a row with no live key gives 0).
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = ZERO ? fmaxf(l0, 1e-30f) : l0, d1 = ZERO ? fmaxf(l1, 1e-30f) : l1;

    // Stage bf16(O) in the item's Q slot (the 128-byte swizzle: conflict-free
    // for the fragment layout), then store whole 16-byte chunks of rows.
    named_barrier(1, 128);  // every warp's products are done with the slot
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      unsigned char* box = sq + (j / 8) * L::Q_BLK + qd * 4;
      const int sw = ((j % 8) ^ (r0 % 8)) * 16;  // rows r0 and r0 + 8 share r0 % 8
      *reinterpret_cast<__nv_bfloat162*>(box + r0 * 128 + sw) =
          __floats2bfloat162_rn(acc_o[4 * j] / d0, acc_o[4 * j + 1] / d0);
      *reinterpret_cast<__nv_bfloat162*>(box + (r0 + 8) * 128 + sw) =
          __floats2bfloat162_rn(acc_o[4 * j + 2] / d1, acc_o[4 * j + 3] / d1);
    }
    named_barrier(1, 128);
    constexpr int CH = DP / 8;  // 16-byte chunks a row
#pragma unroll
    for (int idx = t; idx < 64 * CH; idx += 128) {
      const int r = idx / CH, cc = idx % CH;
      int b = w.b0, q = w.q0 + r;
      if (packed) {
        const int jr = r / pr.q_span;
        b += jr;
        q = r - jr * pr.q_span;
        if (jr >= pr.pack) continue;
      }
      if (8 * cc >= P.dw || b >= pr.B || q >= pr.Sq) continue;
      const uint4 y = *reinterpret_cast<const uint4*>(sq + (cc / 8) * L::Q_BLK + r * 128 + (((cc % 8) ^ (r % 8)) * 16));
      *reinterpret_cast<uint4*>(pr.o + b * pr.ob + w.h * pr.oh + q * pr.os + 8 * cc) = y;
    }
    fence_proxy_async();  // this thread's reads of the slot before TMA refills it
    __syncwarp();
    if (lane == 0) mbar_arrive(&qempty[slot]);
  }
}

// ---------------------------------------------------------------------------
// Host side, shared by K1/K2's entry (fused_attn.cu), K4's (fanout.cu) and
// K6's (bicross.cu).
// ---------------------------------------------------------------------------

// A (B, H, S, D) bf16 operand: its base (16-byte aligned) and its batch,
// head and row strides in elements, each a nonzero multiple of 8; its
// columns packed.
struct SfOperand {
  const void* ptr;
  long long b, h, s;
};

// One problem: q (B, H, Sq, dw), or with q_shared one (1, H, Sq, dw) table
// that every batch row reads; k / v (B, H, Sk, dw), o (B, H, Sq, dw), mask
// (B, Sk) {0, 1} of mask_bytes 4 (f32) or 1 (bool), or null; plan: the host
// planner's pack, q_span, k_span, groups and q_tiles
// (ops/attention.py:short_plan).
struct SfHostProblem {
  SfOperand q, k, v, o;
  const void* mask;
  int mask_bytes;
  int B, H, Sq, Sk;
  const int* plan;
  int q_shared;
};

// Hits and misses of one source file's tensor-map cache (sf_encode).
struct SfMapStats {
  long long hits, misses;
};

static inline SfMapStats& sf_map_stats() {
  static SfMapStats stats{0, 0};
  return stats;
}

// A 4-D tensor map over a (B, H, S, D) operand: dims {dw, S, H, B}, a box of
// 64 columns by `rows`. Encoding one is a driver call of a few microseconds,
// and a launch encodes three or six, as long as the kernel itself at a train
// step's shapes; the same operands recur from call to call (the caching
// allocator hands out the same addresses), so the last SF_MAP_CACHE maps are
// kept, keyed by everything that determines them. Each source file that
// includes this header has its own cache: K1/K2's 21 launches a serve step
// (three maps each) do not evict K4's or K6's.
constexpr int SF_MAP_CACHE = 256;

static inline int sf_encode(CUtensorMap* map, const SfOperand& t, int B, int H, int S, int dw, int rows) {
  struct Entry {
    CUtensorMap map;
    SfOperand t;
    int B, H, S, dw, rows;
  };
  static Entry cache[SF_MAP_CACHE];
  static int filled = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < filled; ++i) {
    const Entry& e = cache[i];
    if (e.t.ptr == t.ptr && e.t.b == t.b && e.t.h == t.h && e.t.s == t.s && e.B == B && e.H == H && e.S == S &&
        e.dw == dw && e.rows == rows) {
      *map = e.map;
      ++sf_map_stats().hits;
      return 0;
    }
  }
  ++sf_map_stats().misses;
  const uint64_t dims[4] = {static_cast<uint64_t>(dw), static_cast<uint64_t>(S), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {2ull * t.s, 2ull * t.h, 2ull * t.b};
  const uint32_t box[4] = {64, static_cast<uint32_t>(rows), 1, 1};
  const int err = encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, t.ptr, dims, strides, box);
  if (err == 0) {
    cache[next] = Entry{*map, t, B, H, S, dw, rows};
    next = (next + 1) % SF_MAP_CACHE;
    if (filled < SF_MAP_CACHE) ++filled;
  }
  return err;
}

// Whether a plan is one the kernel can run (and covers every row): the
// checks of ops/attention.py:short_plan, repeated so that a bad plan is an
// error code, not a wrong answer.
static inline bool sf_plan_ok(const SfHostProblem& h, int bn) {
  const int pack = h.plan[0], qs = h.plan[1], ks = h.plan[2], groups = h.plan[3], qt = h.plan[4];
  if (h.B < 1 || h.H < 1 || h.Sq < 1 || h.Sk < 1 || pack < 1 || groups * pack < h.B) return false;
  if (pack == 1) return qs == 64 && ks == bn && qt * 64 >= h.Sq;
  return qs % 8 == 0 && ks % 8 == 0 && qs >= h.Sq && ks >= h.Sk && pack * qs <= 64 && pack * ks <= bn && qt == 1;
}

template <int DP, int BN, bool ZERO>
static int sf_launch(const SfHostProblem* hp, int np, int dw, float qscale, cudaStream_t stream) {
  using L = SfLayout<DP, BN>;
  auto kernel = short_flash_kernel<DP, BN, ZERO>;
  static int blocks = 0;  // the grid: resident blocks an SM times the SMs
  if (blocks == 0) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(e);
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SF_THREADS, L::SMEM)) != cudaSuccess)
      return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    blocks = per_sm * sms;
  }
  SfParams P;
  memset(&P, 0, sizeof(P));
  P.np = np;
  P.dw = dw;
  P.qscale = qscale;
  for (int p = 0; p < np; ++p) {
    const SfHostProblem& h = hp[p];
    if (!sf_plan_ok(h, BN)) return static_cast<int>(cudaErrorInvalidValue);
    SfProblem& pr = P.pr[p];
    if (h.mask != nullptr && h.mask_bytes != 1 && h.mask_bytes != 4) return static_cast<int>(cudaErrorInvalidValue);
    pr.mask = h.mask;
    pr.mask_bytes = h.mask_bytes;
    pr.q_shared = h.q_shared;
    pr.o = static_cast<bf16*>(const_cast<void*>(h.o.ptr));
    pr.ob = h.o.b, pr.oh = h.o.h, pr.os = h.o.s;
    pr.B = h.B, pr.H = h.H, pr.Sq = h.Sq, pr.Sk = h.Sk;
    pr.pack = h.plan[0], pr.q_span = h.plan[1], pr.k_span = h.plan[2], pr.groups = h.plan[3];
    pr.q_tiles = h.plan[4];
    pr.items = pr.groups * pr.H * pr.q_tiles;
    int err = sf_encode(&P.qm[p], h.q, h.q_shared ? 1 : h.B, h.H, h.Sq, dw, pr.q_span);
    if (err == 0) err = sf_encode(&P.km[p], h.k, h.B, h.H, h.Sk, dw, pr.k_span);
    if (err == 0) err = sf_encode(&P.vm[p], h.v, h.B, h.H, h.Sk, dw, pr.k_span);
    if (err != 0) return err;
    P.total += pr.items;
  }
  const int grid = P.total < blocks ? P.total : blocks;
  kernel<<<grid, SF_THREADS, L::SMEM, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// Launch the kernel for one or two problems at head width dw (a multiple of
// 8 up to 256; the template DP = 64 * ceil(dw / 64)) with key tiles of bn
// keys (32 or 64). Returns 0, a CUDA error code
// (cudaErrorInvalidValue for a width, key tile or plan the kernel does not
// take), or 1000 + the CUresult of encoding a tensor map.
template <bool ZERO>
static int sf_dispatch(const SfHostProblem* hp, int np, int dw, int bn, float qscale, cudaStream_t stream) {
  if (np < 1 || np > 2 || dw < 8 || dw % 8 != 0 || dw > 256) return static_cast<int>(cudaErrorInvalidValue);
  switch ((dw + 63) / 64) {
    case 1:
      if (bn == 32) return sf_launch<64, 32, ZERO>(hp, np, dw, qscale, stream);
      if (bn == 64) return sf_launch<64, 64, ZERO>(hp, np, dw, qscale, stream);
      break;
    case 2:
      if (bn == 32) return sf_launch<128, 32, ZERO>(hp, np, dw, qscale, stream);
      if (bn == 64) return sf_launch<128, 64, ZERO>(hp, np, dw, qscale, stream);
      break;
    case 3:
      if (bn == 32) return sf_launch<192, 32, ZERO>(hp, np, dw, qscale, stream);
      if (bn == 64) return sf_launch<192, 64, ZERO>(hp, np, dw, qscale, stream);
      break;
    default:
      if (bn == 32) return sf_launch<256, 32, ZERO>(hp, np, dw, qscale, stream);
      if (bn == 64) return sf_launch<256, 64, ZERO>(hp, np, dw, qscale, stream);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
