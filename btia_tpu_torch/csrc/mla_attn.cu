// The attention core of the mla_moe question encoder's latent attention
// (btia_tpu_torch/models/mla_moe.py:MLA, wrapper ops/mla.py:mla_attention):
// causal attention within each question over the packed real tokens.
//
// Replaces no TPU kernel: the JAX package has no MLA. It was added because
// the core ran on plain PyTorch over the padded (B, S) grid: zero-filled q,
// k and v grids of every position and head, index_put scatters, f32 copies
// of q and k for an f32 batched product, separate passes for the scale, the
// mask, the softmax and the cast, and a gather back to the packed rows:
// 7-10 GB of device traffic a layer at the serve cell's 2,048 questions,
// where its operands are 0.43 GB.
//
// o[i, h] = softmax_j(q[i, h] . k[j, h] * scale) v[j, h] over the keys j of
// i's question at positions <= i's, where the packed rows i are the real
// tokens in flat grid order (index[i] = question * S + position, sorted), so
// a question's rows are contiguous and in position order: key j is allowed
// iff index[j] / S == index[i] / S and j <= i. q[i, h] is [q_nope | q_pe]
// and k[j, h] [k_nope | k_pe], k_pe one rotary key shared by every head.
// The arithmetic is the plain twin's (ops/mla.py:_mla_plain): the products
// of the bf16 operands summed in f32, the softmax in f32, the probabilities
// rounded once to bf16, P V summed in f32 and rounded once to bf16.
//
// What bounds it on an H100: bytes. At the serve cell (T ~ 23,100 real
// tokens, 16 heads, q_nope 128 + q_pe 64, v 128) it reads q_nope (95 MB),
// q_pe (47 MB), [k_nope | v] (190 MB) and k_pe (3 MB), and writes o (95
// MB): 0.43 GB, 0.128 ms at 3.35 TB/s, against 2.3e10 FLOP (0.023 ms at 989
// TFLOP/s) over a window of 96 keys. So:
//
// * A work item is (64 packed rows, one head). A query's keys lie at most
//   S - 1 <= 31 rows back, so the item's keys are the 96 rows [r0 - 32, r0 +
//   64): its 64 rows and the 32 before them. A key is allowed by a block-
//   diagonal causal mask built from the rows' question ids (index / S), read
//   once an item into a table in shared memory. No per-question plan exists:
//   the grid is ceil(T / 64) * H items, head fastest, so the blocks at work
//   at one time share rows, and the 32 key rows neighbouring items both read
//   come from L2.
// * A persistent grid of one block an SM (a stage is 84 KB; two stages),
//   a producer warp and one consumer warpgroup. The producer's lanes write
//   the item's question-id table and its lane 0 loads the item's Q, K and V
//   by TMA (3-D tensor maps over the (T, H, width) views through their
//   strides, 128-byte swizzle, zero fill past T, before row 0 and past each
//   part's width), while the consumers compute the item before. q_nope and
//   [k_nope | v] are the projections' outputs as they lie; q_pe and k_pe the
//   rotary embedding's; k_pe is loaded once an item, never expanded.
// * S = Q K^T on wgmma m64n96k16 from shared memory (K = 192 in 12 steps),
//   the mask, the row max (quad shuffles) and exp2 in registers, written
//   row-major over K's place in the stage. Then O = P V a question at a time
//   on mma.sync m16n8k16: for each question among a warp's 16 rows, P over
//   the question's own key positions 0..31 (the window's columns lo..lo +
//   31; the row sums by quad shuffles over those positions, P normalised and
//   rounded once to bf16 as the A fragments) times V's rows lo.. read
//   transposed from the swizzled tile by ldmatrix. bf16(O) is staged in the
//   item's Q slot and stored in 16-byte vectors: rows < T only.
// * Batch invariance: a question's answer must not depend on the questions
//   batched with it, and the model is chaotic (27 MoE layers route on bf16
//   states), so an ulp that depends on where the batch packs a question
//   moves answers. So every sum a question sees is grouped by positions of
//   its own. The score's K-sum on the tensor cores does not depend on the
//   row's or key's place in the tile, and the max is exact; a P V over the
//   window's columns would group keys by their column mod 16 (and a row sum
//   over the window by its column mod 8), so P V runs over question
//   positions instead, and a row gets exact zeros from the other questions'
//   products. The few more products (a warp's 16 rows hold ~2-3 questions
//   at the serve cell) cost little beside the item's loads.
//
// One instance: q_nope up to 128 columns (two 64-column blocks), q_pe and
// k_pe up to 64 (one), v up to 128 (two): the published MLA widths of
// DeepSeek-V2/V3 and Kimi-VL (128, 64, 128); narrower parts are zero-filled
// by TMA. Wider heads, S > 32, other dtypes and CPU tensors take the twin
// (ops/mla.py:kernel_refuses).

#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int MA_THREADS = 160;  // one consumer warpgroup + one producer warp
constexpr int MA_STAGES = 2;
constexpr int MA_ROWS = 64;      // query rows an item
constexpr int MA_BACK = 32;      // key rows before them (S <= 32)
constexpr int MA_KEYS = MA_ROWS + MA_BACK;
constexpr int NN = 2, NR = 1, NV = 2;  // 64-column blocks of q_nope / k_nope, q_pe / k_pe, v
constexpr int NQ = NN + NR;

constexpr int XS = MA_KEYS + 8;  // floats a row of exp2(score - max): a padded stride, 2-way bank conflicts at most

struct MaLayout {
  static constexpr int Q_BLK = MA_ROWS * 128;  // one 64-column block of 64 rows
  static constexpr int K_BLK = MA_KEYS * 128;  // one 64-column block of 96 rows
  static constexpr int Q_BYTES = NQ * Q_BLK;
  static constexpr int K_BYTES = NQ * K_BLK;
  static constexpr int V_BYTES = NV * K_BLK;
  static constexpr int STAGE_BYTES = Q_BYTES + K_BYTES + V_BYTES;
  static constexpr int QID_OFF = MA_STAGES * STAGE_BYTES;      // each stage's question ids of the 96 rows
  static constexpr int BAR_OFF = QID_OFF + MA_STAGES * MA_KEYS * 4;
  static constexpr int SMEM = BAR_OFF + 16 * MA_STAGES + 1024;  // full + empty a stage; slack to align to 1 KB
  static_assert(MA_ROWS * XS * 4 <= K_BYTES, "the scores take K's place");
};

struct MaParams {
  CUtensorMap qn, qr, kn, kr, vm;  // q_nope, q_pe, k_nope, k_pe (2-D: one for all heads), v
  const long long* index;
  bf16* o;
  long long o_row, o_head;
  int T, H, S, total, dv;
  float c;  // scale * log2(e): the scores into the log2 domain
};

// D(64 x 96, f32) (+)= A(64 x 16) B(16 x 96); A and B bf16 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_bf16_ss_n96(float (&d)[48], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(16 x 8, f32) += A(16 x 16) B(16 x 8): bf16, A in registers (rows g, g + 8; columns 2q, 2q + 1, + 8), B
// (k rows 2q, 2q + 1, + 8; column g), for lane 4g + q.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices from shared memory, transposed: lanes 8i..8i + 7
// address the rows of matrix i; lane 4g + q gets rows 2q, 2q + 1 of column g
// of matrix i in register i (an mma.sync B fragment where rows are k).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(MA_THREADS, 1) mla_attn_kernel(const __grid_constant__ MaParams P) {
  using L = MaLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + MA_STAGES;
  int* qids = reinterpret_cast<int*>(smem + L::QID_OFF);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < MA_STAGES; ++s) {
      mbar_init(&full[s], 32);  // every producer lane, after its share of the id table; lane 0 with the bytes
      mbar_init(&empty[s], 4);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {
    // Producer: up to two items ahead of the consumers.
    if (lane == 0) {
      tma_prefetch_map(&P.qn);
      tma_prefetch_map(&P.qr);
      tma_prefetch_map(&P.kn);
      tma_prefetch_map(&P.kr);
      tma_prefetch_map(&P.vm);
    }
    int n = 0;
    for (int it = blockIdx.x; it < P.total; it += gridDim.x, ++n) {
      const int tile = it / P.H, h = it - tile * P.H, r0 = tile * MA_ROWS;
      const int s = n % MA_STAGES;
      if (n >= MA_STAGES) mbar_wait(&empty[s], (n / MA_STAGES - 1) & 1);
      // The question of each of the window's rows; -1 before row 0 and past
      // T, where no real query looks.
      int* qid = qids + s * MA_KEYS;
      for (int k = lane; k < MA_KEYS; k += 32) {
        const int row = r0 - MA_BACK + k;
        qid[k] = (row >= 0 && row < P.T) ? static_cast<int>(P.index[row] / P.S) : -1;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], L::STAGE_BYTES);
        unsigned char* qd = smem + s * L::STAGE_BYTES;
        unsigned char* kd = qd + L::Q_BYTES;
        unsigned char* vd = kd + L::K_BYTES;
#pragma unroll
        for (int cb = 0; cb < NN; ++cb) {
          tma_load_3d(qd + cb * L::Q_BLK, &P.qn, &full[s], cb * 64, h, r0);
          tma_load_3d(kd + cb * L::K_BLK, &P.kn, &full[s], cb * 64, h, r0 - MA_BACK);
        }
        tma_load_3d(qd + NN * L::Q_BLK, &P.qr, &full[s], 0, h, r0);
        tma_load_2d(kd + NN * L::K_BLK, &P.kr, &full[s], 0, r0 - MA_BACK);
#pragma unroll
        for (int cb = 0; cb < NV; ++cb) tma_load_3d(vd + cb * L::K_BLK, &P.vm, &full[s], cb * 64, h, r0 - MA_BACK);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // The consumer warpgroup: this thread holds rows r and r + 8 of the
  // item's 64 (wgmma's fragment layout, hopper.cuh, which is also mma.sync's
  // within warp w's 16 rows), the window's rows r + 32 and r + 40.
  const int r = 16 * warp + lane / 4, qd = lane % 4;
  float sc[MA_KEYS / 2], acc[NV * 8][4];
  int n = 0;
  for (int it = blockIdx.x; it < P.total; it += gridDim.x, ++n) {
    const int tile = it / P.H, h = it - tile * P.H, r0 = tile * MA_ROWS;
    const int s = n % MA_STAGES;
    unsigned char* sq = smem + s * L::STAGE_BYTES;
    const uint32_t q_addr = smem_u32(sq), k_addr = q_addr + L::Q_BYTES, v_addr = k_addr + L::K_BYTES;
    float* xs = reinterpret_cast<float*>(sq + L::Q_BYTES);  // exp2 of the scores, over K once the product is done
    const int* qid = qids + s * MA_KEYS;
    mbar_wait(&full[s], (n / MA_STAGES) & 1);

    // S = Q K^T over [nope | rope] in steps of 16.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NQ * 4; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 bf16 along a 128-byte row
      wgmma_bf16_ss_n96(sc, wgmma_desc_sw128(q_addr + (kk / 4) * L::Q_BLK + off, 16, 1024),
                        wgmma_desc_sw128(k_addr + (kk / 4) * L::K_BLK + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    const int qa = qid[MA_BACK + r], qb = qid[MA_BACK + 8 + r];
    wgmma_wait<0>();
    fence_regs(sc);

    // Mask: column c (register 4j + 2i + e is column 8j + 2qd + e of row r +
    // 8i) is allowed iff its row is of the query's question and not after
    // it (c <= 32 + the query's row). The row max, then exp2 against it.
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < MA_KEYS / 8; ++j) {
      const int c0 = 8 * j + 2 * qd;
      const int2 kq = *reinterpret_cast<const int2*>(qid + c0);
      sc[4 * j] = (kq.x == qa && c0 <= MA_BACK + r) ? sc[4 * j] * P.c : -INFINITY;
      sc[4 * j + 1] = (kq.y == qa && c0 + 1 <= MA_BACK + r) ? sc[4 * j + 1] * P.c : -INFINITY;
      sc[4 * j + 2] = (kq.x == qb && c0 <= MA_BACK + 8 + r) ? sc[4 * j + 2] * P.c : -INFINITY;
      sc[4 * j + 3] = (kq.y == qb && c0 + 1 <= MA_BACK + 8 + r) ? sc[4 * j + 3] * P.c : -INFINITY;
      m0 = fmaxf(m0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      m1 = fmaxf(m1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    // Every row has its own key (past T too: question -1), so the max is
    // finite; the guard keeps a malformed index from making NaNs.
    const float u0 = m0 == -INFINITY ? 0.f : m0, u1 = m1 == -INFINITY ? 0.f : m1;
    named_barrier(1, 128);  // every warp's product is done with K
#pragma unroll
    for (int j = 0; j < MA_KEYS / 8; ++j) {
      *reinterpret_cast<float2*>(xs + r * XS + 8 * j + 2 * qd) =
          make_float2(exp2f(sc[4 * j] - u0), exp2f(sc[4 * j + 1] - u0));
      *reinterpret_cast<float2*>(xs + (r + 8) * XS + 8 * j + 2 * qd) =
          make_float2(exp2f(sc[4 * j + 2] - u1), exp2f(sc[4 * j + 3] - u1));
    }
    __syncwarp();  // a warp reads back only its own 16 rows

    // O = P V a question at a time, on mma.sync over the question's own key
    // positions 0..31 (window columns lo..lo + 31): a row's softmax sum and
    // products are grouped by position in its question, wherever the batch
    // put it; the products of other questions add exact zeros to it.
#pragma unroll
    for (int j = 0; j < NV * 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const float* xa = xs + r * XS;
    const float* xb = xs + (r + 8) * XS;
    const int end = min(16 * warp + 16, P.T - r0);  // this warp's real rows end here
    for (int cur = 16 * warp; cur < end;) {
      const int qc = qid[MA_BACK + cur];
      int lo = MA_BACK + cur, last = cur;
      while (lo > 0 && qid[lo - 1] == qc) --lo;  // the question's first column
      while (last + 1 < end && qid[MA_BACK + last + 1] == qc) ++last;
      const int top = MA_BACK + last;  // its last column any row of this warp reads
      // This thread's exp2 at the question's positions 16ks + 8hh + 2qd + e
      // (index 4ks + 2hh + e): zero past `top`, and on rows of other questions.
      float ea[8], eb[8], la = 0.f, lb = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = lo + 16 * (i / 4) + 8 * ((i / 2) % 2) + 2 * qd + i % 2;
        ea[i] = col <= top ? xa[col] : 0.f;
        eb[i] = col <= top ? xb[col] : 0.f;
        la += ea[i];
        lb += eb[i];
      }
      la += __shfl_xor_sync(0xffffffffu, la, 1);
      la += __shfl_xor_sync(0xffffffffu, la, 2);
      lb += __shfl_xor_sync(0xffffffffu, lb, 1);
      lb += __shfl_xor_sync(0xffffffffu, lb, 2);
      const float ia = la > 0.f ? 1.f / la : 0.f, ib = lb > 0.f ? 1.f / lb : 0.f;
      const int mi = lane / 8;  // the 8 x 8 matrix this lane addresses a row of: keys + 8 (mi % 2), columns + 8 (mi / 2)
      for (int ks = 0; ks < (top - lo >= 16 ? 2 : 1); ++ks) {
        // P's fragment: rows r, r + 8; positions 16ks + 2qd (+1), + 8.
        const uint32_t a[4] = {pack_bf16(ea[4 * ks] * ia, ea[4 * ks + 1] * ia),
                               pack_bf16(eb[4 * ks] * ib, eb[4 * ks + 1] * ib),
                               pack_bf16(ea[4 * ks + 2] * ia, ea[4 * ks + 3] * ia),
                               pack_bf16(eb[4 * ks + 2] * ib, eb[4 * ks + 3] * ib)};
        // V's rows past the window (P 0 there) read its last row instead.
        const int key = min(lo + 16 * ks + 8 * (mi % 2) + lane % 8, MA_KEYS - 1);
#pragma unroll
        for (int np = 0; np < NV * 4; ++np) {
          const int col = 16 * np + 8 * (mi / 2);
          uint32_t b[4];
          ldsm_x4_trans(b, v_addr + (col / 64) * L::K_BLK + key * 128 + ((((col % 64) / 8) ^ (key % 8)) * 16));
          mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
          mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
      cur = last + 1;
    }

    // Stage bf16(O) in the item's Q slot (the 128-byte swizzle; the product
    // is done with Q), then store whole 16-byte chunks of this warp's rows
    // < T and columns < dv.
#pragma unroll
    for (int j = 0; j < NV * 8; ++j) {
      unsigned char* box = sq + (j / 8) * L::Q_BLK + qd * 4;
      const int sw = ((j % 8) ^ (r % 8)) * 16;  // rows r and r + 8 share r % 8
      *reinterpret_cast<uint32_t*>(box + r * 128 + sw) = pack_bf16(acc[j][0], acc[j][1]);
      *reinterpret_cast<uint32_t*>(box + (r + 8) * 128 + sw) = pack_bf16(acc[j][2], acc[j][3]);
    }
    __syncwarp();
    constexpr int CH = NV * 8;  // 16-byte chunks a row
#pragma unroll
    for (int idx = lane; idx < 16 * CH; idx += 32) {
      const int rr = 16 * warp + idx / CH, cc = idx % CH, row = r0 + rr;
      if (row >= P.T || 8 * cc >= P.dv) continue;
      const uint4 y = *reinterpret_cast<const uint4*>(sq + (cc / 8) * L::Q_BLK + rr * 128 + (((cc % 8) ^ (rr % 8)) * 16));
      *reinterpret_cast<uint4*>(P.o + row * P.o_row + h * P.o_head + 8 * cc) = y;
    }
    fence_proxy_async();  // this thread's accesses to the stage before TMA refills it
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// q (T, H, >= dn): q_nope in columns [0, dn) of each head; q_pe (T, H, dr):
// the rotated rope part of q; kv (T, H, dn + dv): [k_nope | v]; k_pe (T,
// dr): the rotated shared key; o (T, H, dv), written. All bf16, rows and
// heads at the strides given (elements: q row, q head, q_pe row, q_pe head,
// kv row, kv head, k_pe row, o row, o head; each a positive multiple of 8),
// the last dim packed, every base 16-byte aligned. index (T,) int64: the
// rows' flat (question, position) grid indices, sorted ascending, positions
// < S. dn, dr, dv multiples of 8, dn <= 128, dr <= 64, dv <= 128; 1 <= S <=
// 32. scale: the scores' factor, (dn + dr)^-0.5 for the model. Returns 0, a
// CUDA error code (cudaErrorInvalidValue for shapes or layouts it does not
// take), or 1000 + the CUresult of encoding a tensor map.
extern "C" int btia_mla_attn(const void* q, const void* q_pe, const void* kv, const void* k_pe, void* o,
                             const void* index, const long long* strides, int T, int H, int S, int dn, int dr,
                             int dv, float scale, void* stream) {
  using L = MaLayout;
  if (T < 1 || H < 1 || S < 1 || S > MA_BACK || dn < 8 || dn > 64 * NN || dn % 8 != 0 || dr < 8 ||
      dr > 64 * NR || dr % 8 != 0 || dv < 8 || dv > 64 * NV || dv % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 9; ++i)
    if (strides[i] < 8 || strides[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(q_pe) || !aligned16(kv) || !aligned16(k_pe) || !aligned16(o) || index == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  static int blocks = 0;  // the persistent grid: resident blocks an SM times the SMs
  if (blocks == 0) {
    cudaError_t e = cudaFuncSetAttribute(mla_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(e);
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mla_attn_kernel, MA_THREADS, L::SMEM)) !=
        cudaSuccess)
      return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    blocks = per_sm * sms;
  }
  MaParams P;
  memset(&P, 0, sizeof(P));
  const uint64_t t = static_cast<uint64_t>(T), hh = static_cast<uint64_t>(H);
  const auto map3 = [&](CUtensorMap* m, const void* ptr, int width, long long row, long long head, int rows) {
    const uint64_t dims[3] = {static_cast<uint64_t>(width), hh, t};
    const uint64_t st[2] = {2ull * head, 2ull * row};
    const uint32_t box[3] = {64, 1, static_cast<uint32_t>(rows)};
    return encode_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims, st, box);
  };
  const bf16* kvp = static_cast<const bf16*>(kv);
  int err = map3(&P.qn, q, dn, strides[0], strides[1], MA_ROWS);
  if (err == 0) err = map3(&P.qr, q_pe, dr, strides[2], strides[3], MA_ROWS);
  if (err == 0) err = map3(&P.kn, kvp, dn, strides[4], strides[5], MA_KEYS);
  if (err == 0) err = map3(&P.vm, kvp + dn, dv, strides[4], strides[5], MA_KEYS);
  if (err == 0) {
    const uint64_t dims[2] = {static_cast<uint64_t>(dr), t};
    const uint64_t st[1] = {2ull * strides[6]};
    const uint32_t box[2] = {64, static_cast<uint32_t>(MA_KEYS)};
    err = encode_map(&P.kr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k_pe, dims, st, box);
  }
  if (err != 0) return err;
  P.index = static_cast<const long long*>(index);
  P.o = static_cast<bf16*>(o);
  P.o_row = strides[7];
  P.o_head = strides[8];
  P.T = T;
  P.H = H;
  P.S = S;
  P.dv = dv;
  P.total = (T + MA_ROWS - 1) / MA_ROWS * H;
  P.c = scale * 1.4426950408889634f;
  const int grid = P.total < blocks ? P.total : blocks;
  mla_attn_kernel<<<grid, MA_THREADS, L::SMEM, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
