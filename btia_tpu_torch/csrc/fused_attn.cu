// K1 / K2 on Hopper: the fused projection + attention + output projection
// sites of the serving path, as a short chain of launches.
//
// Replaces btia_tpu/ops/fused_attn.py:_fused_kernel (K1, BERT self-attention
// and both BTIA directions) and btia_tpu/ops/fused_attn.py:_staticq_kernel
// (K2, the AD head's answer-query attention). The wrappers that chain these
// launches are btia_tpu_torch/ops/fused_attn.py:fused_dense_attention and
// fused_static_q_attention.
//
// What bounds it on an H100: at the serving shapes (B*Q = 2048 rows of 32-82
// tokens, width 768) the four projections are ~95% of the operations, so the
// site is bound by tensor-core operations (~0.3-0.5 ms at 989 TF/s), not by
// the ~0.2-0.4 GB it must move. The design therefore puts the projections on
// the tensor cores at Hopper's rate (gemm_bias_wgmma_kernel: wgmma fed by
// TMA, f32 accumulators and the bias / residual epilogue in registers) and
// keeps each (row, head) score tile in shared memory, so
// no score or probability tensor goes to device memory; sequences longer
// than 128 (ViT-B/16's 197 image tokens in BTIA) stream their keys through
// an online softmax instead of holding the whole tile. The pre-LN prologue
// and post-LN epilogue are K7's single-pass row kernel (layernorm.cu),
// launched by the wrapper. Fusing the chain into one
// persistent kernel (the TPU kernel's one-pass form) is later work.
//
// Semantics follow the TPU kernel exactly: f32 LayerNorm with the fast
// variance max(0, E[x^2] - E[x]^2); scale*log2(e) folded into wq/bq by the
// caller; exp2 softmax with the key mask applied AFTER exp and the
// denominator floored at 1e-30 (a fully masked row gives 0, not NaN);
// division after PV; bias added in f32 before the bf16 rounding; the residual
// added in bf16.

#include "common.cuh"
#include "hopper.cuh"
#include "masked_flash.cuh"

using namespace nvcuda;

// ---------------------------------------------------------------------------
// The projection GEMM: C[M, N] = bf16(A[M, K] @ W[K, N] + bias[N]), then,
// with a residual, C = bf16(C + resid[row % resid_rows, N]). A, W, C and
// resid row-major and packed; K % 8 == 0 and N % 8 == 0 (TMA's 16-byte row
// rule); M ragged.
//
// wgmma m64n128k16 (bf16 in, f32 accumulators in registers) on 128 x 128
// output tiles, fed by TMA through a ring of three stages of 64-deep K
// chunks on mbarriers: a producer warp issues the loads, two consumer
// warpgroups of 64 rows each issue a chunk's four products, wait for them
// and release the stage at once. A is read K-major (boxes of 64 columns x
// 128 rows, 128-byte swizzle); W lies (K, N) row-major and is read as it
// lies, an MN-major B (two boxes of 64 columns x 64 K rows a stage), so no
// transposed copy of the weights is made. Two blocks fit on an SM (97 KB of
// shared memory each), so one block's epilogue overlaps the other's
// products. Blocks run along N first: the blocks of one M tile run together
// and read its A rows from L2, and the weights (at most 2.4 MB here) stay
// in L2. TMA zero-fills rows past M and a K or N tail.
//
// The epilogue is staged. Stores straight from wgmma's fragment layout
// write 4 bytes a thread across 8 rows, and on an H100 they cost the
// kernel a large share of its time at K = 768. So each warpgroup writes
// bf16(acc + bias) into the idle first stage as two 64 x 64 boxes in the
// 128-byte swizzle (conflict-free for the fragment layout), reads it back
// in rows of 16-byte chunks, adds the residual from 16-byte loads (all
// issued before any store), and stores whole rows; rows past M and columns
// past N are masked.
// ---------------------------------------------------------------------------

constexpr int PG_BM = 128, PG_BN = 128, PG_BK = 64;  // tile rows, columns, K per stage
constexpr int PG_STAGES = 3;
constexpr int PG_THREADS = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr int PG_CONSUMER_WARPS = 8;
constexpr int PG_A_BYTES = PG_BM * PG_BK * 2;            // 16 KB: 128 rows of 128 bytes
constexpr int PG_W_BLK = PG_BK * 128;                    // 8 KB: 64 K rows of one 64-column block
constexpr int PG_STAGE_BYTES = PG_A_BYTES + 2 * PG_W_BLK;
constexpr int PG_BIAS_OFF = PG_STAGES * PG_STAGE_BYTES;  // the tile's 128 biases, f32
constexpr int PG_BAR_OFF = PG_BIAS_OFF + PG_BN * 4;
constexpr int PG_SMEM = PG_BAR_OFF + 64 + 1024;          // barriers; slack to align the base to 1 KB
constexpr int PG_CHUNKS = 64 * PG_BN / 8 / 128;          // 16-byte output chunks a consumer thread stores

// Byte offset of the 16-byte chunk holding columns 8 cc.. of row r in a
// warpgroup's staged slab (two 64-column boxes, 128-byte swizzle).
__device__ __forceinline__ int pg_chunk(int r, int cc) {
  return (cc / 8) * PG_W_BLK + r * 128 + (((cc % 8) ^ (r % 8)) * 16);
}

__global__ void __launch_bounds__(PG_THREADS, 2)
gemm_bias_wgmma_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
                       const float* __restrict__ bias, const bf16* __restrict__ resid, int resid_rows,
                       bf16* __restrict__ C, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* sbias = reinterpret_cast<float*>(smem + PG_BIAS_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + PG_BAR_OFF);
  uint64_t* empty = full + PG_STAGES;

  const int bn = blockIdx.x * PG_BN, bm = blockIdx.y * PG_BM;
  const int nk = (K + PG_BK - 1) / PG_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < PG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], PG_CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == PG_CONSUMER_WARPS) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      tma_prefetch_map(&amap);
      tma_prefetch_map(&wmap);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % PG_STAGES;
        if (kt >= PG_STAGES) mbar_wait(&empty[s], (kt / PG_STAGES - 1) & 1);
        mbar_expect_tx(&full[s], PG_STAGE_BYTES);
        unsigned char* st = smem + s * PG_STAGE_BYTES;
        tma_load_2d(st, &amap, &full[s], kt * PG_BK, bm);
        tma_load_2d(st + PG_A_BYTES, &wmap, &full[s], bn, kt * PG_BK);
        tma_load_2d(st + PG_A_BYTES + PG_W_BLK, &wmap, &full[s], bn + 64, kt * PG_BK);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns output rows [64 wg, 64 wg + 64) of the
  // tile; this thread rows r0 and r0 + 8 of them.
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int r0 = 16 * (t / 32) + lane / 4, qd = lane % 4;
  if (threadIdx.x < PG_BN) sbias[threadIdx.x] = bn + threadIdx.x < N ? bias[bn + threadIdx.x] : 0.f;
  float acc[64];
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % PG_STAGES;
    mbar_wait(&full[s], (kt / PG_STAGES) & 1);
    const uint32_t a_addr = smem_u32(smem + s * PG_STAGE_BYTES) + wg * 64 * 128;
    const uint32_t w_addr = smem_u32(smem + s * PG_STAGE_BYTES + PG_A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PG_BK / 16; ++kk)
      // A: 16 columns = 32 bytes along its 128-byte rows. W: 16 K rows of
      // 128 bytes (2 KB) on; 1 KB between groups of eight K rows (SBO), one
      // 64-column block to the next (LBO). The tile's first product
      // overwrites the accumulators.
      wgmma_bf16_ss_tb_n128(acc, wgmma_desc_sw128(a_addr + kk * 32, 16, 1024),
                            wgmma_desc_sw128(w_addr + kk * 2048, PG_W_BLK, 1024), kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp has finished reading stage s
  }
  fence_regs(acc);

  // Both warpgroups are done with the stages (and sbias is written) before
  // either overwrites the first stage.
  named_barrier(1, 32 * PG_CONSUMER_WARPS);
  unsigned char* slab = smem + wg * 2 * PG_W_BLK;
#pragma unroll
  for (int j = 0; j < PG_BN / 8; ++j) {
    const float2 bi = *reinterpret_cast<const float2*>(sbias + 8 * j + 2 * qd);
    unsigned char* box = slab + (j / 8) * PG_W_BLK + qd * 4;
    *reinterpret_cast<__nv_bfloat162*>(box + r0 * 128 + (((j % 8) ^ (r0 % 8)) * 16)) =
        __floats2bfloat162_rn(acc[4 * j] + bi.x, acc[4 * j + 1] + bi.y);
    *reinterpret_cast<__nv_bfloat162*>(box + (r0 + 8) * 128 + (((j % 8) ^ ((r0 + 8) % 8)) * 16)) =
        __floats2bfloat162_rn(acc[4 * j + 2] + bi.x, acc[4 * j + 3] + bi.y);
  }
  named_barrier(2 + wg, 128);
  // Thread t takes chunks idx = 128 i + t: row idx / 16, columns 8 (idx % 16)..;
  // half of them at a time, each half's loads issued before its stores.
#pragma unroll
  for (int h = 0; h < PG_CHUNKS; h += PG_CHUNKS / 2) {
    uint4 y[PG_CHUNKS / 2], rv[PG_CHUNKS / 2];
#pragma unroll
    for (int i = 0; i < PG_CHUNKS / 2; ++i) {
      const int idx = (h + i) * 128 + t, r = idx / 16, cc = idx % 16;
      const int g = bm + wg * 64 + r, c = bn + 8 * cc;
      y[i] = *reinterpret_cast<const uint4*>(slab + pg_chunk(r, cc));
      rv[i] = resid != nullptr && g < M && c < N
                  ? *reinterpret_cast<const uint4*>(resid + static_cast<long long>(g % resid_rows) * N + c)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < PG_CHUNKS / 2; ++i) {
      const int idx = (h + i) * 128 + t, r = idx / 16, cc = idx % 16;
      const int g = bm + wg * 64 + r, c = bn + 8 * cc;
      if (resid != nullptr) {
        // bf16(y + resid), y already rounded: the twin's order.
        __nv_bfloat162* yh = reinterpret_cast<__nv_bfloat162*>(&y[i]);
        const __nv_bfloat162* rh = reinterpret_cast<const __nv_bfloat162*>(&rv[i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(yh[e]), b = __bfloat1622float2(rh[e]);
          yh[e] = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
        }
      }
      if (g < M && c < N) *reinterpret_cast<uint4*>(C + static_cast<long long>(g) * N + c) = y[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Attention core at head width D = 64, 128, 192 or 256 (a template
// parameter). q is pre-scaled by scale*log2(e). q_bs == 0 shares one query
// table across the batch (K2). mask: (B, Sk) f32 {0, 1} or null. o:
// (B, Sq, H*D). Two paths, chosen by btia_attn_core:
//  * Sq, Sk <= 128 where the block's tiles fit in the 232,448 bytes of
//    shared memory a block may use: one block per (batch row, head) holding
//    the whole score tile (attn_core_kernel, the serving shapes). At
//    Sq = Sk = 128 that holds up to D = 128 (207,360 bytes); at D = 192 or
//    256 it holds the short sites (the 32 x 32 text and 64 x 82 answer
//    tiles), and 128 x 128 takes the tiled path;
//  * anything else (the reference admits any Sq*Sk <= 32768, e.g. the
//    197 x 32 and 32 x 197 BTIA sites of ViT-B/16 configs): one block per
//    (64-row q tile, head, batch row) streaming 64-key tiles through an
//    online softmax (attn_core_tiled_kernel, masked_flash.cuh).
// ---------------------------------------------------------------------------

constexpr int AT_THREADS = 128;
constexpr int kWholeTileSeq = 128;   // largest Sq / Sk of the whole-tile path
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory one block may use

struct CoreLayout {
  int sqp, skp, lds, ldp;
  size_t q_off, k_off, v_off, s_off, p_off, d_off, bytes;
};

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~static_cast<size_t>(127); }

// D + 8: the bf16 row stride of the q/k/v tiles.
template <int D>
__host__ __device__ inline CoreLayout core_layout(int Sq, int Sk) {
  constexpr int LDH = D + 8;
  CoreLayout L;
  L.sqp = (Sq + 15) / 16 * 16;
  L.skp = (Sk + 15) / 16 * 16;
  L.lds = (L.skp > D ? L.skp : D) + 4;  // f32 scores, then f32 PV output
  L.ldp = L.skp + 8;                    // bf16 probabilities
  size_t off = 0;
  L.q_off = off; off = align128(off + sizeof(bf16) * L.sqp * LDH);
  L.k_off = off; off = align128(off + sizeof(bf16) * L.skp * LDH);
  L.v_off = off; off = align128(off + sizeof(bf16) * L.skp * LDH);
  L.s_off = off; off = align128(off + sizeof(float) * L.sqp * L.lds);
  L.p_off = off; off = align128(off + sizeof(bf16) * L.sqp * L.ldp);
  L.d_off = off; off = align128(off + sizeof(float) * L.sqp);
  L.bytes = off;
  return L;
}

template <int D>
__global__ void __launch_bounds__(AT_THREADS)
attn_core_kernel(const bf16* __restrict__ q, long long q_bs, int q_rs, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, long long kv_bs, int kv_rs, const float* __restrict__ mask,
                 bf16* __restrict__ o, int H, int Sq, int Sk) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDH = D + 8;
  const CoreLayout L = core_layout<D>(Sq, Sk);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q_off);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.k_off);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.v_off);
  float* ss = reinterpret_cast<float*>(smem + L.s_off);
  bf16* ps = reinterpret_cast<bf16*>(smem + L.p_off);
  float* den = reinterpret_cast<float*>(smem + L.d_off);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = AT_THREADS / 32;

  load_head_rows<D>(qs, LDH, q + b * q_bs + h * D, q_rs, Sq, L.sqp, tid, AT_THREADS);
  load_head_rows<D>(ks, LDH, k + b * kv_bs + h * D, kv_rs, Sk, L.skp, tid, AT_THREADS);
  load_head_rows<D>(vs, LDH, v + b * kv_bs + h * D, kv_rs, Sk, L.skp, tid, AT_THREADS);
  __syncthreads();

  // S = q k^T (log2 domain), f32 in shared memory.
  const int tq = L.sqp / 16, tk = L.skp / 16;
  for (int t = warp; t < tq * tk; t += nwarps) {
    const int ti = t / tk, tj = t % tk;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
      wmma::load_matrix_sync(a, qs + ti * 16 * LDH + kk, LDH);
      wmma::load_matrix_sync(bt, ks + tj * 16 * LDH + kk, LDH);
      wmma::mma_sync(acc, a, bt, acc);
    }
    wmma::store_matrix_sync(ss + ti * 16 * L.lds + tj * 16, acc, L.lds, wmma::mem_row_major);
  }
  __syncthreads();

  // Masked exp2 softmax numerators (bf16) and f32 denominators.
  const float* mrow = mask != nullptr ? mask + static_cast<long long>(b) * Sk : nullptr;
  for (int r = warp; r < L.sqp; r += nwarps) {
    bf16* prow = ps + r * L.ldp;
    if (r >= Sq) {
      for (int j = lane; j < L.skp; j += 32) prow[j] = __float2bfloat16(0.f);
      continue;
    }
    const float* srow = ss + r * L.lds;
    float m = -INFINITY;
    for (int j = lane; j < Sk; j += 32) {
      float s = srow[j];
      if (mrow != nullptr) s -= (1.f - mrow[j]) * 1e9f;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < L.skp; j += 32) {
      float e = 0.f;
      if (j < Sk) {
        float s = srow[j];
        float cm = 1.f;
        if (mrow != nullptr) {
          cm = mrow[j];
          s -= (1.f - cm) * 1e9f;
        }
        e = exp2f(s - m) * cm;
      }
      sum += e;
      prow[j] = __float2bfloat16(e);
    }
    sum = warp_sum(sum);
    if (lane == 0) den[r] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();

  // O = P V, f32 into the (now free) score buffer.
  for (int t = warp; t < tq * (D / 16); t += nwarps) {
    const int ti = t / (D / 16), tj = t % (D / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < L.skp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
      wmma::load_matrix_sync(a, ps + ti * 16 * L.ldp + kk, L.ldp);
      wmma::load_matrix_sync(bv, vs + kk * LDH + tj * 16, LDH);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(ss + ti * 16 * L.lds + tj * 16, acc, L.lds, wmma::mem_row_major);
  }
  __syncthreads();

  bf16* ob = o + (static_cast<long long>(b) * Sq * H + h) * D;
  for (int idx = tid; idx < Sq * D; idx += AT_THREADS) {
    const int r = idx / D, c = idx % D;
    ob[static_cast<long long>(r) * H * D + c] = __float2bfloat16(ss[r * L.lds + c] / den[r]);
  }
}

template <int D>
__global__ void __launch_bounds__(MF_THREADS)
attn_core_tiled_kernel(const bf16* __restrict__ q, long long q_bs, int q_rs, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, long long kv_bs, int kv_rs, const float* __restrict__ mask,
                       bf16* __restrict__ o, int H, int Sq, int Sk) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  MaskedFlashSmem<D>& sm = *reinterpret_cast<MaskedFlashSmem<D>*>(smem_raw);
  const int nqt = (Sq + MF_T - 1) / MF_T;
  const int q0 = (blockIdx.x % nqt) * MF_T, b = blockIdx.x / nqt, h = blockIdx.y;
  const long long o_rs = static_cast<long long>(H) * D;
  masked_flash_tile<D>(sm, q + b * q_bs + static_cast<long long>(q0) * q_rs + h * D, q_rs, min(MF_T, Sq - q0), 1.f,
                       k + b * kv_bs + h * D, v + b * kv_bs + h * D, kv_rs, Sk,
                       mask != nullptr ? mask + static_cast<long long>(b) * Sk : nullptr,
                       o + (static_cast<long long>(b) * Sq + q0) * o_rs + h * D, o_rs);
}

// ---------------------------------------------------------------------------
// C interface (pointers as void*, the stream as PyTorch's cudaStream_t).
// Each entry returns cudaGetLastError() after its launch.
// ---------------------------------------------------------------------------

// A: (M, K), W: (K, N), C: (M, N) bf16, resid: (resid_rows, N) bf16 or
// null, each packed and 16-byte aligned; bias: (N,) f32. K % 8 == 0,
// N % 8 == 0, M >= 1. Returns 0, a CUDA error code, or 1000 + the CUresult
// of encoding a tensor map.
extern "C" int btia_gemm_bias(const void* A, const void* W, const void* bias, const void* resid, int resid_rows,
                              void* C, int M, int N, int K, void* stream) {
  if (K % 8 != 0 || N % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t adims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t wdims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t astride[1] = {2ull * K}, wstride[1] = {2ull * N};
  const uint32_t abox[2] = {PG_BK, PG_BM}, wbox[2] = {64, PG_BK};
  CUtensorMap am, wm;
  int err = encode_map(&am, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, A, adims, astride, abox);
  if (err == 0) err = encode_map(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, W, wdims, wstride, wbox);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(gemm_bias_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PG_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + PG_BN - 1) / PG_BN, (M + PG_BM - 1) / PG_BM);
  gemm_bias_wgmma_kernel<<<grid, PG_THREADS, PG_SMEM, static_cast<cudaStream_t>(stream)>>>(
      am, wm, static_cast<const float*>(bias), static_cast<const bf16*>(resid), resid_rows, static_cast<bf16*>(C), M,
      N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
static int launch_attn_core(const void* q, long long q_bs, int q_rs, const void* k, const void* v, long long kv_bs,
                            int kv_rs, const void* mask, void* o, int B, int H, int Sq, int Sk, cudaStream_t stream) {
  const CoreLayout L = core_layout<D>(Sq, Sk);
  if (Sq > kWholeTileSeq || Sk > kWholeTileSeq || L.bytes > kMaxSmem) {
    const int bytes = static_cast<int>(sizeof(MaskedFlashSmem<D>));
    cudaError_t err =
        cudaFuncSetAttribute(attn_core_tiled_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(B * ((Sq + MF_T - 1) / MF_T), H);
    attn_core_tiled_kernel<D><<<grid, MF_THREADS, bytes, stream>>>(
        static_cast<const bf16*>(q), q_bs, q_rs, static_cast<const bf16*>(k), static_cast<const bf16*>(v), kv_bs,
        kv_rs, static_cast<const float*>(mask), static_cast<bf16*>(o), H, Sq, Sk);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaFuncSetAttribute(attn_core_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_core_kernel<D><<<B * H, AT_THREADS, L.bytes, stream>>>(
      static_cast<const bf16*>(q), q_bs, q_rs, static_cast<const bf16*>(k), static_cast<const bf16*>(v), kv_bs,
      kv_rs, static_cast<const float*>(mask), static_cast<bf16*>(o), H, Sq, Sk);
  return static_cast<int>(cudaGetLastError());
}

// D is 64, 128, 192 or 256.
extern "C" int btia_attn_core(const void* q, long long q_bs, int q_rs, const void* k, const void* v,
                              long long kv_bs, int kv_rs, const void* mask, void* o, int B, int H, int D, int Sq,
                              int Sk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_attn_core<64>(q, q_bs, q_rs, k, v, kv_bs, kv_rs, mask, o, B, H, Sq, Sk, s);
  if (D == 128) return launch_attn_core<128>(q, q_bs, q_rs, k, v, kv_bs, kv_rs, mask, o, B, H, Sq, Sk, s);
  if (D == 192) return launch_attn_core<192>(q, q_bs, q_rs, k, v, kv_bs, kv_rs, mask, o, B, H, Sq, Sk, s);
  if (D == 256) return launch_attn_core<256>(q, q_bs, q_rs, k, v, kv_bs, kv_rs, mask, o, B, H, Sq, Sk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
