// K1 / K2 on Hopper: the fused projection + attention + output projection
// sites of the serving path, as a short chain of launches.
//
// Replaces btia_tpu/ops/fused_attn.py:_fused_kernel (K1, BERT self-attention
// and both BTIA directions) and btia_tpu/ops/fused_attn.py:_staticq_kernel
// (K2, the AD head's answer-query attention). The wrappers that chain these
// launches are btia_tpu_torch/ops/fused_attn.py:fused_dense_attention and
// fused_static_q_attention: K7's LN prologue (layernorm.cu) -> the q and
// [k|v] projection GEMMs -> the attention core -> the output projection
// GEMM with the residual -> K7's post-LN. Fusing the chain into one
// persistent kernel (the TPU kernel's one-pass form) is later work.
//
// What bounds it on an H100. At the serving shapes (B*Q = 2048 rows of
// 32-82 tokens, width 768) the four projections are ~95% of the operations,
// so the site is bound by tensor-core operations (~0.3-0.5 ms at
// 989 TF/s), not by the ~0.2-0.4 GB it must move. The projections therefore
// run on the tensor cores at Hopper's rate (gemm_bias_wgmma_kernel: wgmma
// fed by TMA, f32 accumulators and the bias / residual epilogue in
// registers). The attention core alone is bound by bytes: it reads q and
// the [k|v] GEMM output and writes o, 0.120 ms at a BERT site, 0.154 ms at
// a BTIA site and 0.214 ms at K2's (2048 rows, 12 heads of 64, 3.35 TB/s),
// for a few percent of that in tensor-core work. It runs on the
// short-sequence kernel of short_flash.cuh in its zero-rows mode, shared
// with K4 (fanout.cu) and K6 (bicross.cu): persistent blocks over planned
// work items, TMA rings that keep the next item's bytes in flight, scores
// and probabilities in registers, two short batch rows a 64-row tile. The
// core reads the GEMM outputs in place through their strides (no head
// transpose, no split of [k|v]), K2's query table once for every batch row
// (never expanded over the batch), and the bool key mask as bytes; no
// score or probability reaches device memory. The wrappers prepare the
// chain's weights (scaled bf16 wq, [wk|wv], wo, f32 biases, K2's projected
// query table) once per weight version, not once a call.
//
// Semantics follow the TPU kernel exactly: f32 LayerNorm with the fast
// variance max(0, E[x^2] - E[x]^2); scale*log2(e) folded into wq/bq by the
// caller; exp2 softmax with a -1e9 bias on masked keys before the max, the
// key mask applied AFTER exp and the denominator floored at 1e-30 (a fully
// masked row gives 0, not NaN); division after PV; bias added in f32 before
// the bf16 rounding; the residual added in bf16.

#include "common.cuh"
#include "hopper.cuh"
#include "short_flash.cuh"

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

// K1/K2's attention core: q (B, H, Sq, D), or with q_shared one
// (1, H, Sq, D) query table that every batch row reads (K2); k / v
// (B, H, Sk, D); o (B, H, Sq, D): bf16 views of the chain's buffers, their
// (batch, head, row) strides in elements in `strides` (12 values: q, k, v,
// o; each a nonzero multiple of 8); q already scaled by scale*log2(e).
// mask: (B, Sk) {0, 1}, f32 (mask_bytes 4) or bool (1), or null. plan: 6
// values, the key tile then pack, q_span, k_span, groups and q_tiles
// (ops/attention.py:short_plan). D is 64, 128, 192 or 256. Returns 0, a
// CUDA error code, or 1000 + the CUresult of encoding a tensor map.
extern "C" int btia_attn_core(const void* q, const void* k, const void* v, const void* mask, int mask_bytes, void* o,
                              const long long* strides, const int* plan, int B, int H, int Sq, int Sk, int D,
                              int q_shared, void* stream) {
  if (D % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = strides;
  SfHostProblem p;
  p.q = {q, st[0], st[1], st[2]};
  p.k = {k, st[3], st[4], st[5]};
  p.v = {v, st[6], st[7], st[8]};
  p.o = {o, st[9], st[10], st[11]};
  p.mask = mask;
  p.mask_bytes = mask_bytes;
  p.B = B, p.H = H, p.Sq = Sq, p.Sk = Sk;
  p.plan = plan + 1;
  p.q_shared = q_shared;
  return sf_dispatch<true>(&p, 1, D, plan[0], 1.f, static_cast<cudaStream_t>(stream));
}

// The hits and misses of the core's tensor-map cache (sf_encode) since the
// library was loaded, into out[0] and out[1]. Returns 0.
extern "C" int btia_attn_core_map_stats(long long* out) {
  out[0] = sf_map_stats().hits;
  out[1] = sf_map_stats().misses;
  return 0;
}
