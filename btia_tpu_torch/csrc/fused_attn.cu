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
// run on the tensor cores at Hopper's rate (gemm_bias_ws_kernel: wgmma
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
// The projection GEMM: C[M, N] = bf16(act(A[M, K] @ W[K, N] + bias[N])),
// then, with a residual, C = bf16(C + resid[row % resid_rows, N]). act is
// none or the tanh-GELU (Dense's, models/layers.py, under an Mlp's fc1),
// never with a residual. A, W, C and resid row-major and packed; K % 8 == 0
// and N % 8 == 0 (TMA's 16-byte row rule); M ragged.
//
// A persistent, warp-specialised wgmma kernel (the second design; the first
// ran one 128 x 128 tile a block, drained its products after every K chunk
// and staged its epilogue through the ring):
//
// * One block an SM walks the output tiles (tile = blockIdx.x + i *
//   gridDim.x; N tiles fastest, so the blocks at work at one time share A's
//   rows in L2, and the weights, at most 2.4 MB here, stay there). The grid
//   and the tile shape, 128 x 256 or 128 x 128, are chosen on the host
//   (ops/fused_attn.py:gemm_plan): 128 x 256 reads each A row half as often
//   from L2 and issues wgmma at N = 256, where there are enough tiles for
//   the SMs, as at every serve site; 128 x 128 where the wide tile would
//   leave SMs idle, as at the train sites (M 2,048 and 12,608).
// * Three warpgroups: a producer, which keeps a ring of 64-deep K chunks
//   full with TMA (A K-major, boxes of 64 columns x 128 rows; W read as it
//   lies, (K, N) row-major, an MN-major B in boxes of 64 columns x 64 K
//   rows, so no transposed copy of the weights is made), and gives up its
//   registers (setmaxnreg) to two consumer warpgroups of 64 rows x BN
//   columns each (128 f32 accumulators a thread at BN = 256). The producer
//   runs into the next tile while the consumers finish this one.
// * The consumers keep one chunk's products in flight: chunk k is issued
//   before chunk k - 1 is waited for (wgmma_wait<1>) and its stage released.
// * The epilogue (bias in f32, the GELU in f32 where ACT is 1, the bf16
//   rounding, then the residual in bf16) writes 64 x 64 boxes in the
//   128-byte swizzle (conflict-free for wgmma's fragment layout) that leave
//   by TMA store, which clips rows past M and columns past N: the consumers
//   go on to the next tile's products while the stores drain. A residual
//   whose rows repeat every multiple of 64 (every site's: all rows, or K2's
//   64 answer queries) is loaded by the producer into a warpgroup's output
//   boxes after the tile's last chunk, so the epilogue adds it from shared
//   memory in place (TMA_RESID; a ring of three 48 KB stages then leaves
//   room for the four boxes); any other is read by the consumers, 16 bytes
//   a thread, loads issued first.
// * The GELU (common.cuh:gelu_tanh, K8's) is two special-function
//   operations an element, ex2 and the reciprocal: ~4,100 of a 128 x 256
//   tile's cycles, against ~12,300 of products at K = 768, and the tensor
//   cores idle while both warpgroups take it (an Mlp's fc1 at 1.15-1.2x
//   torch.addmm without it, 0.72-0.75x addmm then F.gelu). What did not
//   pay (compare_kernels.py mlp on the card): ping-pong consumers on
//   128 x 128 tiles of their own, one warpgroup's epilogue under the
//   other's products (0.92-1.03x this kernel at the four GELU sites across
//   two cards: the 128 x 128 tile reads more from L2 per product), and the
//   same over clusters of two blocks with W multicast (2.1-3x slower: each
//   stage then waits for both blocks' releases, at cluster scope).
// ---------------------------------------------------------------------------

template <int BN, bool TMA_RESID>  // output tile columns: 256 or 128; the residual by TMA
struct PgLayout {
  static constexpr int BM = 128, BK = 64;             // tile rows, K per stage
  static constexpr int NBOX = BN / 64;                // 64-column boxes of W (and of a warpgroup's output)
  // Output boxes a consumer warpgroup keeps: two in turn, or, when the
  // producer loads the residual into them, all of a tile's.
  static constexpr int OUT_BOXES = TMA_RESID ? NBOX : 2;
  static constexpr int STAGES = TMA_RESID && BN == 256 ? 3 : 4;
  static constexpr int A_BYTES = BM * BK * 2;         // 16 KB: 128 rows of 128 bytes
  static constexpr int W_BLK = BK * 128;              // 8 KB: 64 K rows of one 64-column block
  static constexpr int STAGE_BYTES = A_BYTES + NBOX * W_BLK;
  static constexpr int OUT_OFF = STAGES * STAGE_BYTES;
  static constexpr int OUT_BLK = 64 * 128;            // one 64 x 64 output box
  static constexpr int BAR_OFF = OUT_OFF + 2 * OUT_BOXES * OUT_BLK;
  static constexpr int SMEM = BAR_OFF + 128 + 1024;   // barriers; slack to align the base to 1 KB
  static constexpr int THREADS = 384;                 // 2 consumer warpgroups + 1 producer warpgroup
  static constexpr int CHUNKS = 64 * 64 / 8 / 128;    // 16-byte chunks of a box a consumer thread adds
};

template <int BN, bool TMA_RESID, int ACT>  // ACT: 0 none, 1 tanh-GELU (common.cuh:gelu_tanh)
__global__ void __launch_bounds__(384, 1)
gemm_bias_ws_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap rmap,
                    const float* __restrict__ bias, const bf16* __restrict__ resid, int resid_rows, int M, int N,
                    int K, int tiles_n, int tiles) {
  using L = PgLayout<BN, TMA_RESID>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + L::STAGES;
  uint64_t* rfull = empty + L::STAGES;  // a warpgroup's residual boxes have landed
  uint64_t* rempty = rfull + 2;         // ... and its last stores have left them
  const int nk = (K + L::BK - 1) / L::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(&rfull[w], 1);
      mbar_init(&rempty[w], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg == 2) {
    // Producer: one thread keeps the ring full across the block's tiles;
    // the ring's stage and parity run on from one tile to the next. With
    // TMA_RESID it loads a tile's residual into the consumers' output boxes
    // after the tile's last chunk, once their stores of the tile before
    // have left them.
    setmaxnreg_dec<40>();
    if (t == 0) {
      tma_prefetch_map(&amap);
      tma_prefetch_map(&wmap);
      int s = 0, phase = 0, it = 0, n = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
        const int bm = (tile / tiles_n) * L::BM, bn = (tile % tiles_n) * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          if (it >= L::STAGES) mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full[s], L::STAGE_BYTES);
          unsigned char* st = smem + s * L::STAGE_BYTES;
          tma_load_2d(st, &amap, &full[s], kt * L::BK, bm);
#pragma unroll
          for (int c = 0; c < L::NBOX; ++c)
            tma_load_2d(st + L::A_BYTES + c * L::W_BLK, &wmap, &full[s], bn + 64 * c, kt * L::BK);
          if (++s == L::STAGES) s = 0, phase ^= 1;
        }
        if constexpr (TMA_RESID) {
          for (int w = 0; w < 2; ++w) {
            if (n > 0) mbar_wait(&rempty[w], (n - 1) & 1);
            mbar_expect_tx(&rfull[w], L::NBOX * L::OUT_BLK);
            const int rrow = (bm + 64 * w) % resid_rows;  // resid_rows % 64 == 0: a box never wraps
            for (int c = 0; c < L::NBOX; ++c)
              tma_load_2d(smem + L::OUT_OFF + (w * L::OUT_BOXES + c) * L::OUT_BLK, &rmap, &rfull[w], bn + 64 * c,
                          rrow);
          }
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  // Consumers: warpgroup wg owns output rows [64 wg, 64 wg + 64) of a tile;
  // this thread rows r0 and r0 + 8 of them.
  const int lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4, qd = lane % 4;
  unsigned char* out_box = smem + L::OUT_OFF + wg * L::OUT_BOXES * L::OUT_BLK;
  int s = 0, phase = 0, n = 0;
  float acc[BN / 2];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
    const int bm = (tile / tiles_n) * L::BM, bn = (tile % tiles_n) * BN;

    // The first chunk overwrites the accumulators; each later chunk is
    // issued before the one before it is waited for and its stage released.
    // A: 16 columns = 32 bytes along its 128-byte rows. W: 16 K rows of 128
    // bytes (2 KB) on; 1 KB between groups of eight K rows (SBO), one
    // 64-column block to the next (LBO).
    mbar_wait(&full[s], phase);
    {
      const uint32_t a_addr = smem_u32(smem + s * L::STAGE_BYTES) + wg * 64 * 128;
      const uint32_t w_addr = a_addr - wg * 64 * 128 + L::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::BK / 16; ++kk) {
        const uint64_t da = wgmma_desc_sw128(a_addr + kk * 32, 16, 1024);
        const uint64_t db = wgmma_desc_sw128(w_addr + kk * 2048, L::W_BLK, 1024);
        if constexpr (BN == 256) wgmma_bf16_ss_tb_n256(acc, da, db, kk > 0);
        else wgmma_bf16_ss_tb_n128(acc, da, db, kk > 0);
      }
      wgmma_commit();
    }
    if constexpr (TMA_RESID) {
      // The stores of the tile before have left the output boxes: the
      // producer may load this tile's residual into them.
      if (t == 0 && n > 0) {
        bulk_wait_read<0>();
        mbar_arrive(&rempty[wg]);
      }
    }
    int prev = s;
    if (++s == L::STAGES) s = 0, phase ^= 1;
    for (int kt = 1; kt < nk; ++kt) {
      mbar_wait(&full[s], phase);
      const uint32_t a_addr = smem_u32(smem + s * L::STAGE_BYTES) + wg * 64 * 128;
      const uint32_t w_addr = a_addr - wg * 64 * 128 + L::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::BK / 16; ++kk) {
        const uint64_t da = wgmma_desc_sw128(a_addr + kk * 32, 16, 1024);
        const uint64_t db = wgmma_desc_sw128(w_addr + kk * 2048, L::W_BLK, 1024);
        if constexpr (BN == 256) wgmma_bf16_ss_tb_n256(acc, da, db, 1);
        else wgmma_bf16_ss_tb_n128(acc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      mbar_arrive_if(&empty[prev], lane == 0);  // this warp has finished reading the previous stage
      prev = s;
      if (++s == L::STAGES) s = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive_if(&empty[prev], lane == 0);

    // Epilogue, a 64 x 64 box at a time: bf16(act(acc + bias)), with the
    // residual added in bf16 (the twin's order), through shared memory, out
    // by TMA store.
    const int grow = bm + wg * 64;  // the warpgroup's first output row
    if constexpr (TMA_RESID) mbar_wait(&rfull[wg], n & 1);
#pragma unroll
    for (int c = 0; c < L::NBOX; ++c) {
      const int col0 = bn + 64 * c;
      unsigned char* box = out_box + (TMA_RESID ? c : c & 1) * L::OUT_BLK;
      uint4 rv[L::CHUNKS];
      if (!TMA_RESID && resid != nullptr) {
        // Any other residual: thread t's 16-byte chunks idx = 128 i + t of
        // the box, row idx / 8, columns 8 (idx % 8)..; loads issued first.
#pragma unroll
        for (int i = 0; i < L::CHUNKS; ++i) {
          const int idx = 128 * i + t, r = idx / 8, cc = idx % 8;
          const int g = grow + r, col = col0 + 8 * cc;
          rv[i] = g < M && col < N
                      ? *reinterpret_cast<const uint4*>(resid + static_cast<long long>(g % resid_rows) * N + col)
                      : make_uint4(0, 0, 0, 0);
        }
      }
      if constexpr (!TMA_RESID) {
        // The store issued from this box two boxes ago has finished reading it.
        if (t == 0) bulk_wait_read<1>();
        named_barrier(1 + wg, 128);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * c + jj;
        const int col = col0 + 8 * jj + 2 * qd;
        const float2 bi = col < N ? *reinterpret_cast<const float2*>(bias + col) : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(box + swz_frag(r0 + 8 * h, jj, qd));
          float y0 = acc[4 * j + 2 * h] + bi.x, y1 = acc[4 * j + 2 * h + 1] + bi.y;
          if constexpr (ACT == 1) y0 = gelu_tanh(y0), y1 = gelu_tanh(y1);
          __nv_bfloat162 y = __floats2bfloat162_rn(y0, y1);
          if constexpr (TMA_RESID) {
            const float2 a = __bfloat1622float2(y), r = __bfloat1622float2(*p);
            y = __floats2bfloat162_rn(a.x + r.x, a.y + r.y);
          }
          *p = y;
        }
      }
      if (!TMA_RESID && resid != nullptr) {
        named_barrier(1 + wg, 128);
#pragma unroll
        for (int i = 0; i < L::CHUNKS; ++i) {
          const int idx = 128 * i + t, r = idx / 8, cc = idx % 8;
          uint4* p = reinterpret_cast<uint4*>(box + r * 128 + ((cc ^ (r % 8)) * 16));
          uint4 y = *p;
          __nv_bfloat162* yh = reinterpret_cast<__nv_bfloat162*>(&y);
          const __nv_bfloat162* rh = reinterpret_cast<const __nv_bfloat162*>(&rv[i]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a = __bfloat1622float2(yh[e]), b = __bfloat1622float2(rh[e]);
            yh[e] = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
          }
          *p = y;
        }
      }
      if (!TMA_RESID || c == L::NBOX - 1) {
        fence_proxy_async();
        named_barrier(1 + wg, 128);
        if (t == 0) {
          for (int b = TMA_RESID ? 0 : c; b <= c; ++b)
            if (grow < M && bn + 64 * b < N)
              tma_store_2d(&cmap, out_box + (TMA_RESID ? b : b & 1) * L::OUT_BLK, bn + 64 * b, grow);
          bulk_commit();
        }
      }
    }
  }
  if (t == 0) bulk_wait<0>();  // the stores have left shared memory before the block does
}

// ---------------------------------------------------------------------------
// C interface (pointers as void*, the stream as PyTorch's cudaStream_t).
// Each entry returns cudaGetLastError() after its launch.
// ---------------------------------------------------------------------------

template <int BN, bool TMA_RESID, int ACT>
static int launch_gemm(const CUtensorMap& am, const CUtensorMap& wm, const CUtensorMap& cm, const CUtensorMap& rm,
                       const void* bias, const void* resid, int resid_rows, int M, int N, int K, int grid,
                       cudaStream_t stream) {
  using L = PgLayout<BN, TMA_RESID>;
  auto kernel = gemm_bias_ws_kernel<BN, TMA_RESID, ACT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_n = (N + BN - 1) / BN, tiles = ((M + L::BM - 1) / L::BM) * tiles_n;
  kernel<<<grid < tiles ? grid : tiles, L::THREADS, L::SMEM, stream>>>(
      am, wm, cm, rm, static_cast<const float*>(bias), static_cast<const bf16*>(resid), resid_rows, M, N, K, tiles_n,
      tiles);
  return static_cast<int>(cudaGetLastError());
}

// A: (M, K), W: (K, N), C: (M, N) bf16, resid: (resid_rows, N) bf16 or
// null, each packed and 16-byte aligned; bias: (N,) f32. K % 8 == 0,
// N % 8 == 0, M >= 1. act: 0 none, 1 the tanh-GELU after the bias (no
// residual then). tile: 0 for 128 x 256 output tiles, 1 for 128 x 128;
// grid: the persistent grid's blocks (ops/fused_attn.py:gemm_plan), at least
// 1 (at most one a tile is launched). Returns 0, a CUDA error code, or
// 1000 + the CUresult of encoding a tensor map.
extern "C" int btia_gemm_bias(const void* A, const void* W, const void* bias, const void* resid, int resid_rows,
                              void* C, int M, int N, int K, int act, int tile, int grid, void* stream) {
  if (K % 8 != 0 || N % 8 != 0 || M < 1 || resid_rows < 1 || (tile != 0 && tile != 1) || grid < 1 ||
      (act != 0 && act != 1) || (act != 0 && resid != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t adims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t wdims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t cdims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(M)};
  const uint64_t astride[1] = {2ull * K}, wstride[1] = {2ull * N};
  const uint32_t abox[2] = {64, 128}, wbox[2] = {64, 64}, cbox[2] = {64, 64};
  // A residual whose rows repeat every multiple of 64 (every site's: all
  // rows, or K2's 64 answer queries) is loaded by TMA, 64-row boxes that
  // never wrap; any other is read by the consumers.
  const bool tma_resid = resid != nullptr && resid_rows % 64 == 0;
  const uint64_t rdims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(resid_rows)};
  CUtensorMap am, wm, cm, rm;
  int err = encode_map(&am, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, A, adims, astride, abox);
  if (err == 0) err = encode_map(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, W, wdims, wstride, wbox);
  if (err == 0) err = encode_map(&cm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, C, cdims, wstride, cbox);
  if (err == 0 && tma_resid) err = encode_map(&rm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, resid, rdims, wstride, cbox);
  if (err != 0) return err;
  if (!tma_resid) rm = cm;  // not read
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tma_resid)
    return tile == 0 ? launch_gemm<256, true, 0>(am, wm, cm, rm, bias, resid, resid_rows, M, N, K, grid, s)
                     : launch_gemm<128, true, 0>(am, wm, cm, rm, bias, resid, resid_rows, M, N, K, grid, s);
  if (act == 1)
    return tile == 0 ? launch_gemm<256, false, 1>(am, wm, cm, rm, bias, resid, resid_rows, M, N, K, grid, s)
                     : launch_gemm<128, false, 1>(am, wm, cm, rm, bias, resid, resid_rows, M, N, K, grid, s);
  return tile == 0 ? launch_gemm<256, false, 0>(am, wm, cm, rm, bias, resid, resid_rows, M, N, K, grid, s)
                   : launch_gemm<128, false, 0>(am, wm, cm, rm, bias, resid, resid_rows, M, N, K, grid, s);
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
