// Masked exp2 attention of one 64-row query tile of one head: the tiled
// K1/K2 attention core (fused_attn.cu). K4 computes the same softmax on the
// short-sequence kernel of short_flash.cuh.
//
// Both TPU kernels (btia_tpu/ops/fused_attn.py:_fused_kernel and
// btia_tpu/ops/attention.py:_fanout_kernel) compute the same softmax:
// scores in the log2 domain, a -1e9 bias on masked keys BEFORE the row max,
// exp2 multiplied by the {0, 1} key mask, the denominator floored at 1e-30
// and the division after PV, so a fully masked row gives exactly 0. The TPU
// holds the whole score row in VMEM; a Hopper block has at most 227 KB of
// shared memory, so here the keys stream through in 64-key tiles with an
// online f32 softmax: the running max m starts at -inf and every tile
// rescales the running sum and the PV accumulator by exp2(m_old - m_new).
// Masked keys contribute exp2(.) * 0 = 0 to both, whatever the max, so the
// result is the one-pass softmax up to the bf16 rounding of the
// probabilities before PV. Keys beyond Sk (tile padding) are -inf and 0.
//
// Layout: four warps, each owning 16 query rows; bf16 wmma products with
// fp32 accumulation, PV accumulated straight into the warp's f32 output rows
// in shared memory; no score or probability tile reaches device memory.
// The head width D is a template parameter, a multiple of 64 up to 256
// (at D = 256 the block holds 194,560 bytes).

#pragma once

#include "common.cuh"

constexpr int MF_T = 64;           // query rows per block and keys per tile
constexpr int MF_THREADS = 128;    // 4 warps x 16 query rows

template <int D>
struct MaskedFlashSmem {
  static constexpr int LDH = D + 8;                        // bf16 q/k/v rows
  static constexpr int LDP = MF_T + 8;                     // bf16 probabilities
  static constexpr int LDF = MF_T + 4;                     // f32 scores
  static constexpr int LDO = D + 4;                        // f32 accumulators
  bf16 q[MF_T][LDH];
  bf16 k[MF_T][LDH];
  bf16 v[MF_T][LDH];
  float s[4][16][LDF];  // per-warp scores
  bf16 p[4][16][LDP];   // per-warp probabilities
  float o[4][16][LDO];  // per-warp output accumulators
};

// qb: first of the tile's nq (<= 64) query rows of this head, row stride
// q_rs elements; each value is multiplied by qscale in f32 and rounded to
// bf16 (qscale = 1 for a query already in the log2 domain). kb / vb: key
// and value row 0 of this head, row stride kv_rs. mrow: this batch row's
// (Sk,) f32 {0, 1} key mask, or null for all keys valid. ob: output row 0
// of the tile, row stride o_rs.
template <int D>
__device__ __forceinline__ void masked_flash_tile(MaskedFlashSmem<D>& sm, const bf16* __restrict__ qb, long long q_rs,
                                                  int nq, float qscale, const bf16* __restrict__ kb,
                                                  const bf16* __restrict__ vb, long long kv_rs, int Sk,
                                                  const float* __restrict__ mrow, bf16* __restrict__ ob,
                                                  long long o_rs) {
  using namespace nvcuda;
  using S = MaskedFlashSmem<D>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // Warps whose 16 rows are all past nq skip the arithmetic (they still
  // take part in the block's loads and barriers).
  const bool active = warp * 16 < nq;

  for (int c = tid; c < MF_T * D; c += MF_THREADS) {
    const int r = c / D, col = c % D;
    const float x = r < nq ? __bfloat162float(qb[r * q_rs + col]) * qscale : 0.f;
    sm.q[r][col] = __float2bfloat16(x);
  }
  for (int c = lane; c < 16 * D; c += 32) sm.o[warp][c / D][c % D] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wmma::load_matrix_sync(qa[kk], &sm.q[warp * 16][kk * 16], S::LDH);

  float m_run[16], l_run[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }

  const int nkt = (Sk + MF_T - 1) / MF_T;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * MF_T;
    const int nk = min(MF_T, Sk - k0);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_head_rows<D>(&sm.k[0][0], S::LDH, kb + k0 * kv_rs, kv_rs, nk, MF_T, tid, MF_THREADS);
    load_head_rows<D>(&sm.v[0][0], S::LDH, vb + k0 * kv_rs, kv_rs, nk, MF_T, tid, MF_THREADS);
    __syncthreads();
    if (!active) continue;

    // S_w = Q_w K^T for this warp's 16 rows (log2 domain).
#pragma unroll
    for (int tj = 0; tj < MF_T / 16; ++tj) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(bt, &sm.k[tj * 16][kk * 16], S::LDH);
        wmma::mma_sync(acc, qa[kk], bt, acc);
      }
      wmma::store_matrix_sync(&sm.s[warp][0][tj * 16], acc, S::LDF, wmma::mem_row_major);
    }
    __syncwarp();

    // Online masked softmax; each lane owns keys `lane` and `lane + 32`.
    const int j0 = lane, j1 = lane + 32;
    const bool in0 = j0 < nk, in1 = j1 < nk;
    const float cm0 = !in0 ? 0.f : (mrow != nullptr ? mrow[k0 + j0] : 1.f);
    const float cm1 = !in1 ? 0.f : (mrow != nullptr ? mrow[k0 + j1] : 1.f);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float s0 = in0 ? sm.s[warp][r][j0] - (1.f - cm0) * 1e9f : -INFINITY;
      const float s1 = in1 ? sm.s[warp][r][j1] - (1.f - cm1) * 1e9f : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(fmaxf(s0, s1)));
      const float alpha = exp2f(m_run[r] - m_new);
      const float e0 = in0 ? exp2f(s0 - m_new) * cm0 : 0.f;
      const float e1 = in1 ? exp2f(s1 - m_new) * cm1 : 0.f;
      l_run[r] = l_run[r] * alpha + warp_sum(e0 + e1);
      m_run[r] = m_new;
      sm.p[warp][r][j0] = __float2bfloat16(e0);
      sm.p[warp][r][j1] = __float2bfloat16(e1);
#pragma unroll
      for (int c = lane; c < D; c += 32) sm.o[warp][r][c] *= alpha;
    }
    __syncwarp();

    // O += P V for this tile, accumulated in place.
#pragma unroll
    for (int tj = 0; tj < D / 16; ++tj) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, &sm.o[warp][0][tj * 16], S::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < MF_T / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(pa, &sm.p[warp][0][kk * 16], S::LDP);
        wmma::load_matrix_sync(bv, &sm.v[kk * 16][tj * 16], S::LDH);
        wmma::mma_sync(acc, pa, bv, acc);
      }
      wmma::store_matrix_sync(&sm.o[warp][0][tj * 16], acc, S::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // Divide after PV, the denominator floored at 1e-30.
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r;
    if (row < nq) {
      const float den = fmaxf(l_run[r], 1e-30f);
      bf16* orow = ob + row * o_rs;
#pragma unroll
      for (int c = lane; c < D; c += 32) orow[c] = __float2bfloat16(sm.o[warp][r][c] / den);
    }
  }
}
