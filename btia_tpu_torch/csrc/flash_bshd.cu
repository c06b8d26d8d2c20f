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
// by bytes. Beside both stands the softmax: a 64 x 128 score tile's 8,192
// exp2s on the SM's 16 special-function lanes take about as long as its two
// products on the tensor cores (FlashAttention-3's observation), so the
// kernel is only as fast as its products and its exponentials overlap.
// Only wgmma reaches the tensor cores' rate and only TMA moves tiles
// without spending the math warps' issue slots.
//
// Head widths DP = 64 and 128 (every ViT and the AD head at 12 and 6
// heads) run the second design, flash_ws_kernel, after FlashAttention-3:
//
// * Persistent blocks, one an SM (grid and item order planned on the host,
//   ops/attention.py:flash_plan): a block walks the work items (128-row q
//   tile, head, batch), item = blockIdx.x + i * gridDim.x, q tiles of one
//   (batch, head) next to each other, so the blocks at work at one time
//   read that head's K and V from L2. The producer runs into the next item
//   (its Q into a second buffer, its first K/V tiles into the ring) while
//   the consumers finish this one, so no item waits for its own loads.
// * Three warpgroups. The producer's first thread issues every TMA load
//   (Q, then K and V tiles of BN keys into a ring of stages, K and V on
//   barriers of their own, so a score product waits only for K); its other
//   three warps put each item's Q into the log2 domain; it gives up its
//   registers (setmaxnreg, 24) to two consumer warpgroups of 64 q rows each
//   (240 registers: O, a score tile, P).
// * Inside a consumer, tile kt's score product is issued with tile kt - 1's
//   PV product, and tile kt's softmax runs while the PV product does
//   (wgmma_wait<1>, then <0> before O is rescaled).
// * Between the consumers, ping-pong on named barriers 3 and 4: a
//   warpgroup issues its products only once the other's scores have
//   retired, so that one's softmax runs while the other's products occupy
//   the tensor cores. (Arriving as soon as the products are issued lets both
//   softmaxes fall into step and contend for the special-function unit;
//   arriving only after the softmax serialises them: both measured slower.)
// * BN = 128 keys at DP 64; 577 keys are 4 x 128 + 65, and a 64-key last
//   tile would not hold 65. BN = 64 at DP 128, so that the score tile leaves
//   the registers for O's 64 columns (no spill) over a ring of four stages;
//   DP 64 has five. (Two score buffers, the next tile's product issued
//   before this tile's softmax, did not fit the registers at DP 64: ptxas
//   serialised the products.)
// * The key mask is read as the caller's bytes (a bool tensor as it lies):
//   where there is one, each thread reads the 32 (or 16) columns its
//   scores hold, a tile at a time.
// * The output, O times the reciprocal of each row's sum, is staged in a
//   warpgroup's own swizzled boxes and leaves by TMA store (rows past Sq and
//   columns past dw clipped), so the consumers go on to the next item.
//
// DP = 192 and 256 keep the first design (flash_attn_kernel: one block a
// q tile, a producer warp, the products and the softmax in turn): their
// output alone takes 96 or 128 registers a thread, too many for a second
// score tile. BM = 128 at DP = 192, 64 at DP = 256 (ptxas budgets a block
// of 288 threads 168 registers a thread, and O and S spilled), BN = 64
// (two stages of 64-key tiles and Q: 144 KB at DP = 192, 160 KB at 256).
//
// Both read K5's operands through 4-D tensor maps over the (B, H, S, D)
// view with its own strides (dims {D, S, H, B}, boxes {64, rows, 1, 1}); a
// head takes DP / 64 boxes, and TMA's out-of-bounds zero fill supplies the
// columns [D, DP), so no padded byte is stored or read in device memory.
// K3's packed (B, S, H*D) operands take 3-D maps over (B, S, H*D) (the
// PACKED instances; the 4-D maps over the same bytes ran 1-7 % slower with
// the first design on an H100). S = Q K^T is wgmma with Q and K read from
// shared memory (K-major); O += P V takes P, converted to bf16 in
// registers, as wgmma's register A operand, and V from shared memory as an
// MN-major B. O is written through o's own strides (the first design
// directly, the second by a tensor map over them), columns [0, D) only: on
// mha_bshd's long road that is the (B, S, H, D) buffer, so no transpose is
// copied.
//
// Semantics follow the TPU kernels: q pre-scaled by scale*log2(e) and
// rounded to bf16 (here in shared memory, once a q tile), exp2 softmax
// (ex2.approx on the special-function unit, results under 2^-126 flushed
// to zero), an additive -1e9 bias on masked keys. Keys past Sk (TMA
// zero-fills them, and a zero key would score 0) are -inf; a row whose
// every key is masked averages V over the Sk real keys. The division by the softmax denominator
// comes once, after PV, as in K5's _attn_block_log2 (defer_div): one
// reciprocal a row, multiplied in; K3's TPU kernel divides before PV, so K3
// differs from it by the bf16 rounding of the probabilities. Rows past Sq
// are not stored.

#include "common.cuh"
#include "flash.cuh"
#include "hopper.cuh"

// ---------------------------------------------------------------------------
// Pieces of both designs
// ---------------------------------------------------------------------------

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

// S = Q K^T over D in steps of 16, for a 64-row Q slab at q_addr and a key
// tile at k_addr (DP / 64 column blocks of q_blk and kv_blk bytes, 128-byte
// swizzle). The first step overwrites S.
template <int D, int BN>
__device__ __forceinline__ void score_tile(float (&sc)[BN / 2], uint32_t q_addr, uint32_t k_addr, int q_blk,
                                           int kv_blk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 16 bf16 along a 128-byte row
    qk_product<BN>(sc, wgmma_desc_sw128(q_addr + (kk / 4) * q_blk + off, 16, 1024),
                   wgmma_desc_sw128(k_addr + (kk / 4) * kv_blk + off, 16, 1024), kk > 0);
  }
}

// O += P V over a tile's keys in steps of 16 (V rows 16kk.., 2 KB apart). V
// is MN-major: 1 KB between groups of eight keys (SBO), and one column
// block to the next (LBO; unused at D = 64).
template <int D, int BN>
__device__ __forceinline__ void pv_tile(float (&acc_o)[D / 2], const uint32_t (&pa)[BN / 16][4], uint32_t v_addr,
                                        int kv_blk) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    pv_product<D>(acc_o, pa[kk], wgmma_desc_sw128(v_addr + kk * 2048, D == 64 ? 1024 : kv_blk, 1024));
}

// The key bias of a score tile of keys [k0, k0 + BN): -1e9 on masked keys,
// -inf past Sk. The mask, when there is one, is (B, Sk) bytes (a bool
// tensor as it lies); mrow points at this batch row's (or is null).
template <int BN>
__device__ __forceinline__ void mask_scores(float (&sc)[BN / 2], int k0, int Sk, const unsigned char* mrow,
                                            int qd) {
  if (mrow == nullptr && k0 + BN <= Sk) return;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = k0 + 8 * j + 2 * qd + c;
      const float bias = col >= Sk ? -INFINITY : (mrow != nullptr && mrow[col] == 0 ? -1e9f : 0.f);
      sc[4 * j + c] += bias;
      sc[4 * j + 2 + c] += bias;
    }
  }
}

// The running maxima of rows r0 (registers 4j, 4j+1) and r0 + 8 (4j+2,
// 4j+3), each row's scores spread over a quad of threads.
template <int BN>
__device__ __forceinline__ void row_max(const float (&sc)[BN / 2], float& x0, float& x1) {
  // Four partial maxima a row, so that the chains of dependent fmaxf are
  // short.
  float a[4] = {x0, x0, x0, x0}, c[4] = {x1, x1, x1, x1};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    a[j % 4] = fmaxf(a[j % 4], fmaxf(sc[4 * j], sc[4 * j + 1]));
    c[j % 4] = fmaxf(c[j % 4], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  x0 = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
  x1 = fmaxf(fmaxf(c[0], c[1]), fmaxf(c[2], c[3]));
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
}

// exp2 on the special-function unit, results below 2^-126 flushed to zero
// (they add nothing to a sum of probabilities that holds a 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P = exp2(S - m) in place and this thread's share of each row's sum (the
// second design runs it while the previous tile's PV product is in flight),
// then P packed into wgmma's register A operand (bf16 pairs).
template <int BN>
__device__ __forceinline__ void exp_rows(float (&sc)[BN / 2], float m0, float m1, float& s0, float& s1) {
  float a[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};  // partial sums, as row_max
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j] = ex2(sc[4 * j] - m0);
    sc[4 * j + 1] = ex2(sc[4 * j + 1] - m0);
    sc[4 * j + 2] = ex2(sc[4 * j + 2] - m1);
    sc[4 * j + 3] = ex2(sc[4 * j + 3] - m1);
    a[j % 4] += sc[4 * j] + sc[4 * j + 1];
    c[j % 4] += sc[4 * j + 2] + sc[4 * j + 3];
  }
  s0 = (a[0] + a[1]) + (a[2] + a[3]);
  s1 = (c[0] + c[1]) + (c[2] + c[3]);
}
template <int BN>
__device__ __forceinline__ void pack_p(const float (&sc)[BN / 2], uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);      // row r0,     keys 16kk + 2qd, +1
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);  // row r0 + 8, the same keys
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);  // row r0,     keys 16kk + 8 + 2qd, +1
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);  // row r0 + 8
  }
}

// Q into the log2 domain, rounded to bf16, in place: 16-byte chunks t,
// t + step, ... of n (an elementwise map, so the swizzle does not matter).
__device__ __forceinline__ void scale_q(unsigned char* q, int n, int t, int step, float qscale) {
  uint4* p = reinterpret_cast<uint4*>(q);
  for (int i = t; i < n; i += step) {
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

// The row sums live in four threads each; divide once and store rows g0 =
// row0 + r0 and g0 + 8 (those below Sq), columns [0, dw) (all D when
// PACKED).
template <int D, bool PACKED>
__device__ __forceinline__ void store_rows(const float (&acc_o)[D / 2], float l0, float l1, bf16* o, long long base,
                                           long long o_s, int g0, int qd, int dw, int Sq) {
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = 1.f / l0, i1 = 1.f / l1;  // one division a row
  const int g1 = g0 + 8;
  bf16* o0 = o + base + g0 * o_s + 2 * qd;
  bf16* o1 = o0 + 8 * o_s;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (!PACKED && 8 * j >= dw) continue;  // a padded column
    if (g0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) = __floats2bfloat162_rn(acc_o[4 * j] * i0, acc_o[4 * j + 1] * i0);
    if (g1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
          __floats2bfloat162_rn(acc_o[4 * j + 2] * i1, acc_o[4 * j + 3] * i1);
  }
}

// The operands' tensor maps: PACKED 3-D maps over (B, S, H*D) with
// coordinates {column, row, batch}, else 4-D maps over (B, H, S, D) with
// {column, row, head, batch}.
template <bool PACKED, int D>
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, uint64_t* bar, int c, int row, int h,
                                         int b) {
  if (PACKED) tma_load_3d(dst, map, bar, h * D + c * 64, row, b);
  else tma_load_4d(dst, map, bar, c * 64, row, h, b);
}

// ---------------------------------------------------------------------------
// The second design: persistent, warp-specialised (DP = 64 and 128)
// ---------------------------------------------------------------------------

// The next position of a ring of STAGES stages, and its parity.
template <int STAGES>
__device__ __forceinline__ void ring_advance(int& s, int& phase) {
  if (++s == STAGES) s = 0, phase ^= 1;
}

// Tile kt's online softmax, in two halves. The first: the key bias, the
// new row maxima, P = exp2(S - m) in place, and the scales of O (alpha)
// and this thread's share of the row sums. The second, once the PV product
// reading pa has retired: O and l rescaled, P packed into pa.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], int k0, int Sk, const unsigned char* mrow, int qd,
                                             float& m0, float& m1, float& alpha0, float& alpha1, float& s0,
                                             float& s1) {
  mask_scores<BN>(sc, k0, Sk, mrow, qd);
  float x0 = m0, x1 = m1;
  row_max<BN>(sc, x0, x1);
  alpha0 = ex2(m0 - x0);
  alpha1 = ex2(m1 - x1);
  m0 = x0;
  m1 = x1;
  exp_rows<BN>(sc, m0, m1, s0, s1);
}
template <int D, int BN>
__device__ __forceinline__ void rescale_pack(float (&acc_o)[D / 2], uint32_t (&pa)[BN / 16][4],
                                             const float (&sc)[BN / 2], float alpha0, float alpha1, float s0,
                                             float s1, float& l0, float& l1) {
  l0 = l0 * alpha0 + s0;
  l1 = l1 * alpha1 + s1;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc_o[4 * j] *= alpha0;
    acc_o[4 * j + 1] *= alpha0;
    acc_o[4 * j + 2] *= alpha1;
    acc_o[4 * j + 3] *= alpha1;
  }
  pack_p<BN>(sc, pa);
}

template <int D>  // the padded head width DP: 64 or 128
struct WsLayout {
  static constexpr int BM = 128;                        // q rows an item
  static constexpr int BN = D == 64 ? 128 : 64;         // keys a tile (at DP 128 a score tile of 64 keys
                                                        // leaves the registers for O's 64 columns)
  static constexpr int NB = D / 64;                     // 64-column (128-byte) blocks
  static constexpr int STAGES = D == 64 ? 5 : 4;        // K/V ring depth
  static constexpr int Q_BLK = BM * 128;                // bytes of one column block of Q
  static constexpr int KV_BLK = BN * 128;               // ... of K or V
  static constexpr int O_BLK = 64 * 128;                // ... of a warpgroup's output rows
  static constexpr int Q_BYTES = NB * Q_BLK;            // one of two Q buffers
  static constexpr int KV_BYTES = NB * KV_BLK;          // one K (or V) tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;      // K, then V
  static constexpr int KV_OFF = 2 * Q_BYTES;
  static constexpr int O_OFF = KV_OFF + STAGES * STAGE_BYTES;  // each warpgroup's output, staged
  static constexpr int BAR_OFF = O_OFF + 2 * NB * O_BLK;
  static constexpr int SMEM = BAR_OFF + 256 + 1024;     // barriers; slack to align the base to 1 KB
  static constexpr int THREADS = 384;                   // two consumer warpgroups, then the producer's
};

// The output box of 64 rows at row0 from shared memory (the 128-byte
// swizzle): columns h * D + 64 c.. of (B, Sq, H * D) when PACKED, else
// columns 64 c.. of head h of (B, H, Sq, dw).
template <bool PACKED, int D>
__device__ __forceinline__ void store_box(const CUtensorMap* map, const void* src, int c, int row0, int h, int b) {
  if (PACKED) tma_store_3d(map, src, h * D + c * 64, row0, b);
  else tma_store_4d(map, src, c * 64, row0, h, b);
}

template <int D, bool PACKED>
__global__ void __launch_bounds__(384, 1)
flash_ws_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                const unsigned char* __restrict__ mask, int Sq, int Sk, int H, int nqt, int items, float qscale) {
  using L = WsLayout<D>;
  constexpr int BN = L::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* skv = smem + L::KV_OFF;  // stage s: K at s * STAGE_BYTES, V KV_BYTES after it
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* v_full = k_full + L::STAGES;
  uint64_t* kv_empty = v_full + L::STAGES;
  uint64_t* q_full = kv_empty + L::STAGES;  // a Q buffer has landed,
  uint64_t* q_ready = q_full + 2;           // ... is in the log2 domain,
  uint64_t* q_empty = q_ready + 2;          // ... and its last score product has retired
  const int nkt = (Sk + BN - 1) / BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], 8);  // one arrival from each consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_ready[i], 3);  // one from each scaling warp
      mbar_init(&q_empty[i], 8);  // one from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg == 2) {
    // The producer warpgroup. The ring's stage and parity, and the Q
    // buffers' (item n uses buffer n % 2 for the (n / 2)-th time), run on
    // from one item to the next.
    setmaxnreg_dec<24>();
    if (t >= 32) {
      // Warps 1-3: each item's Q into the log2 domain.
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int buf = n & 1;
        mbar_wait(&q_full[buf], (n >> 1) & 1);
        scale_q(smem + buf * L::Q_BYTES, L::Q_BYTES / 16, t - 32, 96, qscale);
        fence_proxy_async();
        __syncwarp();
        mbar_arrive_if(&q_ready[buf], t % 32 == 0);
      }
    } else if (t == 0) {
      // One thread issues every load.
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      int s = 0, phase = 0, it = 0, n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int qt = item % nqt, bh = item / nqt, h = bh % H, b = bh / H;
        const int buf = n & 1;
        if (n >= 2) mbar_wait(&q_empty[buf], ((n >> 1) - 1) & 1);
        mbar_expect_tx(&q_full[buf], L::Q_BYTES);
        for (int c = 0; c < L::NB; ++c)
          load_box<PACKED, D>(smem + buf * L::Q_BYTES + c * L::Q_BLK, &qmap, &q_full[buf], c, qt * L::BM, h, b);
        for (int kt = 0; kt < nkt; ++kt, ++it) {
          if (it >= L::STAGES) mbar_wait(&kv_empty[s], phase ^ 1);
          unsigned char* kd = skv + s * L::STAGE_BYTES;
          mbar_expect_tx(&k_full[s], L::KV_BYTES);
          for (int c = 0; c < L::NB; ++c) load_box<PACKED, D>(kd + c * L::KV_BLK, &kmap, &k_full[s], c, kt * BN, h, b);
          mbar_expect_tx(&v_full[s], L::KV_BYTES);
          for (int c = 0; c < L::NB; ++c)
            load_box<PACKED, D>(kd + L::KV_BYTES + c * L::KV_BLK, &vmap, &v_full[s], c, kt * BN, h, b);
          ring_advance<L::STAGES>(s, phase);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // Consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) of an item's
  // tile; this thread rows r0 and r0 + 8 of them. Every register a product
  // reads is written before the wgmma fence (fence_regs), none while a
  // product is in flight, so ptxas keeps the products asynchronous.
  const int lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4, qd = lane % 4;
  int s = 0, phase = 0, n = 0;
  if (wg == 1) named_barrier_arrive(3, 256);
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int qt = item % nqt, bh = item / nqt, h = bh % H, b = bh / H;
    const int buf = n & 1;
    mbar_wait(&q_ready[buf], (n >> 1) & 1);

    const uint32_t q_addr = smem_u32(smem + buf * L::Q_BYTES + wg * 64 * 128);  // this warpgroup's rows of Q
    const unsigned char* mrow = mask != nullptr ? mask + static_cast<long long>(b) * Sk : nullptr;
    float acc_o[D / 2], sc[BN / 2];
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    // Key tile 0: its scores, their maxima and probabilities.
    mbar_wait(&k_full[s], phase);
    named_barrier(3 + wg, 256);
    wgmma_fence();
    score_tile<D, BN>(sc, q_addr, smem_u32(skv + s * L::STAGE_BYTES), L::Q_BLK, L::KV_BLK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    named_barrier_arrive(3 + (wg ^ 1), 256);
    {
      float a0, a1, s0, s1;
      softmax_tile<BN>(sc, 0, Sk, mrow, qd, m0, m1, a0, a1, s0, s1);
      rescale_pack<D, BN>(acc_o, pa, sc, a0, a1, s0, s1, l0, l1);
    }
    int prev = s, prev_phase = phase;  // the tile whose PV product is next
    ring_advance<L::STAGES>(s, phase);

    // Tile kt: its scores issued with tile kt - 1's PV product; its softmax
    // runs while that product does. At the top, O holds the tiles before
    // kt - 1 and pa tile kt - 1's P, both at the scale of m.
    for (int kt = 1; kt < nkt; ++kt) {
      mbar_wait(&k_full[s], phase);
      mbar_wait(&v_full[prev], prev_phase);
      named_barrier(3 + wg, 256);
      fence_regs(acc_o);
      fence_regs(pa);
      wgmma_fence();
      score_tile<D, BN>(sc, q_addr, smem_u32(skv + s * L::STAGE_BYTES), L::Q_BLK, L::KV_BLK);
      wgmma_commit();
      pv_tile<D, BN>(acc_o, pa, smem_u32(skv + prev * L::STAGE_BYTES + L::KV_BYTES), L::KV_BLK);
      wgmma_commit();
      wgmma_wait<1>();  // the scores
      fence_regs(sc);
      named_barrier_arrive(3 + (wg ^ 1), 256);
      float a0, a1, s0, s1;
      softmax_tile<BN>(sc, kt * BN, Sk, mrow, qd, m0, m1, a0, a1, s0, s1);
      wgmma_wait<0>();  // the PV product
      fence_regs(acc_o);
      fence_regs(pa);
      mbar_arrive_if(&kv_empty[prev], lane == 0);  // this warp has finished reading the stage
      rescale_pack<D, BN>(acc_o, pa, sc, a0, a1, s0, s1, l0, l1);
      prev = s, prev_phase = phase;
      ring_advance<L::STAGES>(s, phase);
    }

    // The last tile's PV product.
    mbar_wait(&v_full[prev], prev_phase);
    fence_regs(acc_o);
    fence_regs(pa);
    wgmma_fence();
    pv_tile<D, BN>(acc_o, pa, smem_u32(skv + prev * L::STAGE_BYTES + L::KV_BYTES), L::KV_BLK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_o);
    fence_regs(pa);
    mbar_arrive_if(&kv_empty[prev], lane == 0);
    mbar_arrive_if(&q_empty[buf], lane == 0);

    // The output: the row sums live in four threads each; one division a
    // row, then O / l rounded to bf16 into this warpgroup's staging boxes,
    // as a TMA load would have left them, and out by TMA store, which clips
    // rows past Sq and columns past dw. The item before's store has long
    // finished reading the boxes.
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    unsigned char* so = smem + L::O_OFF + wg * L::NB * L::O_BLK;
    if (t == 0) bulk_wait_read<0>();
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      unsigned char* blk = so + (j / 8) * L::O_BLK;
      *reinterpret_cast<__nv_bfloat162*>(blk + swz_frag(r0, j % 8, qd)) =
          __floats2bfloat162_rn(acc_o[4 * j] * i0, acc_o[4 * j + 1] * i0);
      *reinterpret_cast<__nv_bfloat162*>(blk + swz_frag(r0 + 8, j % 8, qd)) =
          __floats2bfloat162_rn(acc_o[4 * j + 2] * i1, acc_o[4 * j + 3] * i1);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (t == 0) {
      const int row0 = qt * L::BM + wg * 64;
      if (row0 < Sq)
        for (int c = 0; c < L::NB; ++c) store_box<PACKED, D>(&omap, so + c * L::O_BLK, c, row0, h, b);
      bulk_commit();
    }
  }
  if (wg == 0) named_barrier(3, 256);
  if (t == 0) bulk_wait<0>();  // the outputs have left shared memory before the block does
}

// ---------------------------------------------------------------------------
// The first design (DP = 192 and 256): one block a q tile
// ---------------------------------------------------------------------------

template <int D>  // the padded head width DP: 192 or 256
struct F3Layout {
  static constexpr int BM = D <= 192 ? 128 : 64;       // q rows per block
  static constexpr int CONSUMER_WARPS = BM / 16;       // a warpgroup per 64 rows
  static constexpr int THREADS = 32 * CONSUMER_WARPS + 32;  // + the producer warp
  static constexpr int BN = 64;                        // keys per tile
  static constexpr int NB = D / 64;                    // 64-column (128-byte) blocks
  static constexpr int STAGES = 2;                     // K/V ring depth
  static constexpr int Q_BLK = BM * 128;               // bytes of one column block of Q
  static constexpr int KV_BLK = BN * 128;              // ... of K or V
  static constexpr int Q_BYTES = NB * Q_BLK;
  static constexpr int KV_BYTES = NB * KV_BLK;         // one K (or V) tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;     // K, then V
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int SMEM = BAR_OFF + 64 + 1024;     // barriers; slack to align the base to 1 KB
};

template <int D, bool PACKED>
__global__ void __launch_bounds__(F3Layout<D>::THREADS, 1)
flash_attn_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const unsigned char* __restrict__ mask,
                  bf16* __restrict__ o, long long o_b, long long o_h,
                  long long o_s, int dw, int Sq, int Sk, float qscale) {
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
      for (int c = 0; c < L::NB; ++c) load_box<PACKED, D>(sq + c * L::Q_BLK, &qmap, qbar, c, q0, h, b);
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % L::STAGES;
        // Stage s last held tile kt - STAGES: wait for its release.
        if (kt >= L::STAGES) mbar_wait(&empty[s], (kt / L::STAGES - 1) & 1);
        mbar_expect_tx(&full[s], L::STAGE_BYTES);
        unsigned char* kd = skv + s * L::STAGE_BYTES;
        for (int c = 0; c < L::NB; ++c) {
          load_box<PACKED, D>(kd + c * L::KV_BLK, &kmap, &full[s], c, kt * BN, h, b);
          load_box<PACKED, D>(kd + L::KV_BYTES + c * L::KV_BLK, &vmap, &full[s], c, kt * BN, h, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) of the tile;
    // this thread rows r0 and r0 + 8 of them.
    const int wg = warp / 4, t = threadIdx.x % 128;
    const int r0 = 16 * (t / 32) + lane / 4, qd = lane % 4;
    mbar_wait(qbar, 0);
    for (int c = 0; c < L::NB; ++c) scale_q(sq + c * L::Q_BLK + wg * 64 * 128, 64 * 128 / 16, t, 128, qscale);
    fence_proxy_async();
    named_barrier(1 + wg, 128);

    const uint32_t q_addr = smem_u32(sq) + wg * 64 * 128;
    const unsigned char* mrow = mask != nullptr ? mask + static_cast<long long>(b) * Sk : nullptr;
    float acc_o[D / 2], sc[BN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % L::STAGES;
      mbar_wait(&full[s], (kt / L::STAGES) & 1);
      const uint32_t k_addr = smem_u32(skv + s * L::STAGE_BYTES);

      wgmma_fence();
      score_tile<D, BN>(sc, q_addr, k_addr, L::Q_BLK, L::KV_BLK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      uint32_t pa[BN / 16][4];
      float a0, a1, s0, s1;
      softmax_tile<BN>(sc, kt * BN, Sk, mrow, qd, m0, m1, a0, a1, s0, s1);
      rescale_pack<D, BN>(acc_o, pa, sc, a0, a1, s0, s1, l0, l1);

      wgmma_fence();
      pv_tile<D, BN>(acc_o, pa, k_addr + L::KV_BYTES, L::KV_BLK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp has finished reading stage s
    }
    store_rows<D, PACKED>(acc_o, l0, l1, o, b * o_b + h * o_h, o_s, q0 + wg * 64 + r0, qd, dw, Sq);
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// The maps: q, k, v and o's (o's boxes are 64 rows, a consumer
// warpgroup's; the first design stores through o's pointer and strides).
template <int D, bool PACKED>
static int launch_flash(const CUtensorMap (&maps)[4], const FlashLaunch& a, const FlashOperand& o,
                        cudaStream_t stream) {
  const unsigned char* mask = static_cast<const unsigned char*>(a.mask);
  if constexpr (D <= 128) {
    using L = WsLayout<D>;
    auto kernel = flash_ws_kernel<D, PACKED>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int nqt = (a.Sq + L::BM - 1) / L::BM, items = nqt * a.H * a.B;
    kernel<<<a.grid < items ? a.grid : items, L::THREADS, L::SMEM, stream>>>(
        maps[0], maps[1], maps[2], maps[3], mask, a.Sq, a.Sk, a.H, nqt, items, a.qscale);
  } else {
    const CUtensorMap &qm = maps[0], &km = maps[1], &vm = maps[2];
    bf16* out = static_cast<bf16*>(const_cast<void*>(o.ptr));
    using L = F3Layout<D>;
    auto kernel = flash_attn_kernel<D, PACKED>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((a.Sq + L::BM - 1) / L::BM, a.H, a.B);
    kernel<<<grid, L::THREADS, L::SMEM, stream>>>(qm, km, vm, mask, out, o.b, o.h, o.s, a.dw, a.Sq, a.Sk,
                                                  a.qscale);
  }
  return static_cast<int>(cudaGetLastError());
}

// Rows a tile of each design: (BM, BN) by DP.
template <int D>
struct FlashTile {
  static constexpr int BM = D <= 128 ? WsLayout<D>::BM : F3Layout<D>::BM;
  static constexpr int BN = D <= 128 ? WsLayout<D>::BN : F3Layout<D>::BN;
};

// A 4-D tensor map over a (B, H, S, D) operand: dims {dw, S, H, B}, a box of
// 64 columns by `rows`.
static int encode_bhsd(CUtensorMap* map, const FlashOperand& t, int B, int H, int S, int dw, uint32_t rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(dw), static_cast<uint64_t>(S), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {2ull * t.s, 2ull * t.h, 2ull * t.b};
  const uint32_t box[4] = {64, rows, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, t.ptr, dims, strides, box);
}

template <int D>
static int launch_bhsd(const FlashOperand& q, const FlashOperand& k, const FlashOperand& v, const FlashOperand& o,
                       const FlashLaunch& a, cudaStream_t stream) {
  CUtensorMap maps[4];
  int err = encode_bhsd(&maps[0], q, a.B, a.H, a.Sq, a.dw, FlashTile<D>::BM);
  if (err == 0) err = encode_bhsd(&maps[1], k, a.B, a.H, a.Sk, a.dw, FlashTile<D>::BN);
  if (err == 0) err = encode_bhsd(&maps[2], v, a.B, a.H, a.Sk, a.dw, FlashTile<D>::BN);
  if (err == 0) err = encode_bhsd(&maps[3], o, a.B, a.H, a.Sq, a.dw, 64);
  if (err != 0) return err;
  return launch_flash<D, false>(maps, a, o, stream);
}

static bool flash_args_ok(const FlashLaunch& a) {
  return a.B >= 1 && a.H >= 1 && a.Sq >= 1 && a.Sk >= 1 && a.grid >= 1;
}

int launch_flash_attention(const FlashOperand& q, const FlashOperand& k, const FlashOperand& v,
                           const FlashOperand& o, const FlashLaunch& a, cudaStream_t stream) {
  if (a.dw < 8 || a.dw % 8 != 0 || a.dw > 256 || !flash_args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch ((a.dw + 63) / 64) {
    case 1: return launch_bhsd<64>(q, k, v, o, a, stream);
    case 2: return launch_bhsd<128>(q, k, v, o, a, stream);
    case 3: return launch_bhsd<192>(q, k, v, o, a, stream);
    default: return launch_bhsd<256>(q, k, v, o, a, stream);
  }
}

template <int D>
static int launch_packed(const void* q, const void* k, const void* v, void* o, const FlashLaunch& a,
                         cudaStream_t stream) {
  const long long HD = static_cast<long long>(a.H) * D;
  const uint64_t qdims[3] = {static_cast<uint64_t>(HD), static_cast<uint64_t>(a.Sq), static_cast<uint64_t>(a.B)};
  const uint64_t kdims[3] = {static_cast<uint64_t>(HD), static_cast<uint64_t>(a.Sk), static_cast<uint64_t>(a.B)};
  const uint64_t qstr[2] = {2ull * HD, 2ull * HD * a.Sq}, kstr[2] = {2ull * HD, 2ull * HD * a.Sk};
  const uint32_t qbox[3] = {64, FlashTile<D>::BM, 1}, kbox[3] = {64, FlashTile<D>::BN, 1}, obox[3] = {64, 64, 1};
  CUtensorMap maps[4];
  int err = encode_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, q, qdims, qstr, qbox);
  if (err == 0) err = encode_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, k, kdims, kstr, kbox);
  if (err == 0) err = encode_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, kdims, kstr, kbox);
  if (err == 0) err = encode_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, o, qdims, qstr, obox);
  if (err != 0) return err;
  const FlashOperand out{o, a.Sq * HD, D, HD};
  return launch_flash<D, true>(maps, a, out, stream);
}

// K3. q: (B, Sq, H*D), k / v: (B, Sk, H*D) bf16, 16-byte aligned; mask:
// (B, Sk) bool (bytes, nonzero = a real key) or null; o: (B, Sq, H*D)
// bf16. D is 64, 128, 192 or 256; Sq, Sk >= 1; grid: the persistent
// blocks at D 64 and 128 (ops/attention.py:flash_plan). Returns 0, a CUDA
// error code, or 1000 + the CUresult of encoding a tensor map.
extern "C" int btia_flash_bshd(const void* q, const void* k, const void* v, const void* mask, void* o,
                               int B, int H, int D, int Sq, int Sk, float qscale, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FlashLaunch a{mask, B, H, Sq, Sk, D, grid, qscale};
  if (!flash_args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) return launch_packed<64>(q, k, v, o, a, s);
  if (D == 128) return launch_packed<128>(q, k, v, o, a, s);
  if (D == 192) return launch_packed<192>(q, k, v, o, a, s);
  if (D == 256) return launch_packed<256>(q, k, v, o, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
