// Attention of one 64-row query tile of one head at any head width D that is
// a multiple of 8 up to 128: K6's tile (bicross.cu).
//
// Both TPU kernels (btia_tpu/ops/attention.py:_mha_kernel and the kernel
// closure of btia_tpu/ops/bicross.py:_bicross_pallas) run
// attention.py:_attn_block_log2 with defer_div=True: q pre-scaled by
// scale*log2(e) in f32 and rounded to bf16, scores in the log2 domain, an
// additive -1e9 bias on masked keys, exp2, the unnormalised exponentials
// rounded to bf16 for PV and the division by their f32 sum AFTER PV. The TPU
// holds a head's whole K/V in VMEM; a Hopper block has at most 227 KB of
// shared memory, so here the keys stream through in 64-key tiles with an
// online f32 softmax: every tile rescales the running sum and the PV
// accumulator by exp2(m_old - m_new). The result is the one-pass softmax up
// to the bf16 rounding of the exponentials, which are taken against the
// running max instead of the row's final max. Keys beyond Sk are excluded
// (-inf); the TPU pads them with -1e9, which differs only in a row whose
// every key is masked (there the TPU averages V over Sk rounded up to 128
// keys, this over the Sk real ones, as mha_reference does).
//
// The head width is a template parameter DP, D rounded up to 16; columns
// [D, DP) are zero in shared memory, so they add nothing to the scores and
// are never written. Layout: four warps, each owning 16 query rows; bf16
// wmma products with f32 accumulation; no score or probability tile reaches
// device memory.

#pragma once

#include "common.cuh"

constexpr int MT_T = 64;         // query rows per block and keys per tile
constexpr int MT_THREADS = 128;  // 4 warps x 16 query rows

template <int DP>
struct MhaTileSmem {
  static constexpr int LDH = DP + 8;                        // bf16 q/k/v rows
  static constexpr int LDP = MT_T + 8;                      // bf16 exponentials
  static constexpr int LDS = (DP > MT_T ? DP : MT_T) + 4;   // f32 scores, then PV partials
  static constexpr int LDO = DP + 4;                        // f32 accumulators
  bf16 q[MT_T][LDH];
  bf16 k[MT_T][LDH];
  bf16 v[MT_T][LDH];
  float s[4][16][LDS];
  bf16 p[4][16][LDP];
  float o[4][16][LDO];
};

// Copy `rows` rows of D (a multiple of 8) bf16 values from global memory
// (row stride `stride` elements, 16-byte aligned rows) into shared rows of
// DP values; rows [rows, MT_T) and columns [D, DP) are zero-filled.
template <int DP>
__device__ __forceinline__ void load_rows_padded(bf16* dst, const bf16* src, long long stride, int rows, int D,
                                                 int tid) {
  constexpr int CH = DP / 8;  // 16-byte chunks per shared row
  for (int c = tid; c < MT_T * CH; c += MT_THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && col < D) val = *reinterpret_cast<const uint4*>(src + r * stride + col);
    *reinterpret_cast<uint4*>(dst + r * MhaTileSmem<DP>::LDH + col) = val;
  }
}

// qb: the tile's first query row (nq <= 64 rows, row stride q_rs); each
// value is multiplied by qscale in f32 and rounded to bf16. kb / vb: key and
// value row 0 of this head (Sk rows, strides k_rs / v_rs). mrow: this batch
// row's (Sk,) f32 {0, 1} key mask, or null for all keys valid. ob: the
// tile's first output row, row stride o_rs; D columns are written.
template <int DP>
__device__ __forceinline__ void mha_tile(MhaTileSmem<DP>& sm, const bf16* __restrict__ qb, long long q_rs, int nq,
                                         float qscale, const bf16* __restrict__ kb, long long k_rs,
                                         const bf16* __restrict__ vb, long long v_rs, int Sk, int D,
                                         const float* __restrict__ mrow, bf16* __restrict__ ob, long long o_rs) {
  using namespace nvcuda;
  using S = MhaTileSmem<DP>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // Warps whose 16 rows are all past nq skip the arithmetic (they still
  // take part in the block's loads and barriers).
  const bool active = warp * 16 < nq;

  for (int c = tid; c < MT_T * DP; c += MT_THREADS) {
    const int r = c / DP, col = c % DP;
    const float x = (r < nq && col < D) ? __bfloat162float(qb[r * q_rs + col]) * qscale : 0.f;
    sm.q[r][col] = __float2bfloat16(x);
  }
  for (int c = lane; c < 16 * DP; c += 32) sm.o[warp][c / DP][c % DP] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[DP / 16];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) wmma::load_matrix_sync(qa[kk], &sm.q[warp * 16][kk * 16], S::LDH);

  float m_run[16], l_run[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }

  const int nkt = (Sk + MT_T - 1) / MT_T;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * MT_T;
    const int nk = min(MT_T, Sk - k0);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows_padded<DP>(&sm.k[0][0], kb + k0 * k_rs, k_rs, nk, D, tid);
    load_rows_padded<DP>(&sm.v[0][0], vb + k0 * v_rs, v_rs, nk, D, tid);
    __syncthreads();
    if (!active) continue;

    // S_w = Q_w K^T for this warp's 16 rows (log2 domain).
#pragma unroll
    for (int tj = 0; tj < MT_T / 16; ++tj) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(bt, &sm.k[tj * 16][kk * 16], S::LDH);
        wmma::mma_sync(acc, qa[kk], bt, acc);
      }
      wmma::store_matrix_sync(&sm.s[warp][0][tj * 16], acc, S::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax; each lane owns keys `lane` and `lane + 32` of the tile.
    const int j0 = lane, j1 = lane + 32;
    const bool in0 = j0 < nk, in1 = j1 < nk;
    const float b0 = (in0 && mrow != nullptr && mrow[k0 + j0] == 0.f) ? -1e9f : 0.f;
    const float b1 = (in1 && mrow != nullptr && mrow[k0 + j1] == 0.f) ? -1e9f : 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float s0 = in0 ? sm.s[warp][r][j0] + b0 : -INFINITY;
      const float s1 = in1 ? sm.s[warp][r][j1] + b1 : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(fmaxf(s0, s1)));
      const float alpha = exp2f(m_run[r] - m_new);
      const float e0 = in0 ? exp2f(s0 - m_new) : 0.f;
      const float e1 = in1 ? exp2f(s1 - m_new) : 0.f;
      l_run[r] = l_run[r] * alpha + warp_sum(e0 + e1);
      m_run[r] = m_new;
      sm.p[warp][r][j0] = __float2bfloat16(e0);
      sm.p[warp][r][j1] = __float2bfloat16(e1);
      for (int c = lane; c < DP; c += 32) sm.o[warp][r][c] *= alpha;
    }
    __syncwarp();

    // PV partial for this tile into the score buffer, then accumulate.
#pragma unroll
    for (int tj = 0; tj < DP / 16; ++tj) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < MT_T / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(pa, &sm.p[warp][0][kk * 16], S::LDP);
        wmma::load_matrix_sync(bv, &sm.v[kk * 16][tj * 16], S::LDH);
        wmma::mma_sync(acc, pa, bv, acc);
      }
      wmma::store_matrix_sync(&sm.s[warp][0][tj * 16], acc, S::LDS, wmma::mem_row_major);
    }
    __syncwarp();
    for (int c = lane; c < 16 * DP; c += 32) {
      const int r = c / DP, col = c % DP;
      sm.o[warp][r][col] += sm.s[warp][r][col];
    }
    __syncwarp();
  }

  // Divide after PV; the row's sum is at least 1 (its largest key adds 1).
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r;
    if (row < nq) {
      bf16* orow = ob + row * o_rs;
      for (int c = lane; c < D; c += 32) orow[c] = __float2bfloat16(sm.o[warp][r][c] / l_run[r]);
    }
  }
}

// (batch, head, row) strides of one (B, H, S, D) operand, in elements.
struct BhsdStrides {
  long long b, h, s;
};

// Launch `kernel` (a template instance over DP) with its dynamic shared
// memory raised to sizeof(MhaTileSmem<DP>); returns the CUDA error code.
template <int DP, typename Kernel, typename... Args>
int launch_mha_tile(Kernel kernel, dim3 grid, cudaStream_t stream, Args... args) {
  const int bytes = static_cast<int>(sizeof(MhaTileSmem<DP>));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, MT_THREADS, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}
