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
// the tensor cores (bf16 wmma, fp32 accumulation, cp.async double-buffered
// 128x128 tiles) and keeps each (row, head) score tile in shared memory, so
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
#include "masked_flash.cuh"

using namespace nvcuda;

// ---------------------------------------------------------------------------
// C[M, N] = bf16(A[M, K] @ W[K, N] + bias[N])  (+ resid[row % resid_rows, N]
// in bf16). A, W, C, resid row-major and contiguous; K % 8 == 0, N % 8 == 0.
// ---------------------------------------------------------------------------

constexpr int GBM = 128, GBN = 128, GBK = 32, GPAD = 8, GTHREADS = 256;

__global__ void __launch_bounds__(GTHREADS)
gemm_bias_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, const float* __restrict__ bias,
                 const bf16* __restrict__ resid, int resid_rows, bf16* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(128) bf16 As[2][GBM][GBK + GPAD];
  __shared__ __align__(128) bf16 Bs[2][GBK][GBN + GPAD];
  __shared__ __align__(128) float stage[GTHREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long bm = static_cast<long long>(blockIdx.x) * GBM;
  const int bn = blockIdx.y * GBN;
  const int wm = (warp >> 2) * 64;  // 2 warps along M
  const int wn = (warp & 3) * 32;   // 4 warps along N

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto load_tile = [&](int kt, int buf) {
    const int k0 = kt * GBK;
    for (int c = tid; c < GBM * GBK / 8; c += GTHREADS) {
      int r = c / (GBK / 8), col = (c % (GBK / 8)) * 8;
      long long gr = bm + r;
      int gk = k0 + col;
      bool ok = gr < M && gk < K;
      cp_async16(&As[buf][r][col], ok ? A + gr * K + gk : A, ok);
    }
    for (int c = tid; c < GBK * GBN / 8; c += GTHREADS) {
      int r = c / (GBN / 8), col = (c % (GBN / 8)) * 8;
      int gk = k0 + r, gn = bn + col;
      bool ok = gk < K && gn < N;
      cp_async16(&Bs[buf][r][col], ok ? W + static_cast<long long>(gk) * N + gn : W, ok);
    }
    cp_async_commit();
  };

  const int nk = (K + GBK - 1) / GBK;
  load_tile(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_tile(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], &As[buf][wm + i * 16][kk], GBK + GPAD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[buf][kk][wn + j * 16], GBN + GPAD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* st = stage[warp];
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      long long gr = bm + wm + i * 16 + r;
      int gc = bn + wn + j * 16 + c0;
      if (gr < M) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          int col = gc + e;
          if (col < N) {
            bf16 o = __float2bfloat16(st[r * 16 + c0 + e] + bias[col]);
            if (resid != nullptr) {
              float rv = __bfloat162float(resid[(gr % resid_rows) * N + col]);
              o = __float2bfloat16(rv + __bfloat162float(o));
            }
            C[gr * N + col] = o;
          }
        }
      }
      __syncwarp();
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

extern "C" int btia_gemm_bias(const void* A, const void* W, const void* bias, const void* resid, int resid_rows,
                              void* C, int M, int N, int K, void* stream) {
  dim3 grid((M + GBM - 1) / GBM, (N + GBN - 1) / GBN);
  gemm_bias_kernel<<<grid, GTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(W), static_cast<const float*>(bias),
      static_cast<const bf16*>(resid), resid_rows, static_cast<bf16*>(C), M, N, K);
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
