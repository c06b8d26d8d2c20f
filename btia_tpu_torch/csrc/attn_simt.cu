// One attention kernel on the CUDA cores (FFMA, not the tensor cores), for
// the operands the tensor-core kernels do not take: f32 at any head width up
// to 1024, and bf16 at 256 < D <= 1024.
//
// Replaces, on those routes, btia_tpu/ops/fused_attn.py:_fused_kernel and
// _staticq_kernel (K1/K2's attention core), btia_tpu/ops/attention.py:
// _bshd_flash_kernel (K3), _fanout_kernel (K4) and _mha_kernel (K5), and
// btia_tpu/ops/bicross.py:_bicross_pallas's kernel (K6). The TPU kernels
// compute f32 operands in f32 at any head width; wgmma's f32 input type is
// TF32, which keeps about three decimal digits, so the f32 policy cannot run
// on the tensor cores and be held to the CPU's f32 at 1e-4. Every product
// here is an f32 FFMA; bf16 operands are widened on load, and the
// probabilities are rounded to the element type before PV, as the twins do.
//
// What bounds it on an H100: operations at the f32 CUDA-core rate
// (67 TFLOP/s), not bytes, at every call shape of the registered configs.
// The design is the simple one: a block of 128 threads takes 16 query rows
// of one (problem, batch row, head); the 16 scaled q rows stay in shared
// memory as f32 for the block's life, and so does the 16 x D f32 output
// accumulator, so D up to 1024 costs no registers. Keys come in tiles of 32
// with an online softmax (running max and sum per row). Each tile's scores
// are 4 a thread (a row's 8 threads hold its 32 keys), summed over D in
// chunks of 64 columns of K staged through shared memory; the tile's
// probabilities go to shared memory and V comes in the same 64-column
// chunks, each thread updating 8 accumulator elements. Operands are read
// through (batch, head, row) strides in elements, so one kernel serves K1's
// q and [k|v] rows where the GEMMs leave them, K2's shared query table
// (batch stride 0), K3's and K4's (B, S, H*D), K5's (B, H, S, D) views and
// K6's two directions (grid z picks the problem), with no copy; loads are
// scalar, so any D and any alignment is taken. Making it fast (register
// tiles, vector loads, a K/V ring) is later work.
//
// Two mask modes, each the reference's own:
// * mult_mask = 1 (K1, K2, K4): a -1e9 bias on masked keys before the max,
//   the mask applied AFTER exp2 and the denominator floored at 1e-30, so a
//   fully masked row gives 0 (btia_tpu/ops/fused_attn.py:262-271,
//   btia_tpu/ops/attention.py:399-412);
// * mult_mask = 0 (K3, K5, K6): an additive -1e9 bias, so a fully masked row
//   averages V over the real keys.
// Keys past Sk take no part in either. q is multiplied by qscale
// (scale*log2(e); 1 where the caller prescaled it, K1/K2) and rounded to the
// element type, as the twins do, then the softmax runs in exp2.

#include "common.cuh"

#include <math.h>

namespace {

constexpr int AS_THREADS = 128;
constexpr int AS_BQ = 16;  // query rows a block
constexpr int AS_BK = 32;  // keys a tile
constexpr int AS_DC = 64;  // head-width columns a chunk
constexpr int AS_MAX_D = 1024;

struct AsProblem {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const void* mask;        // (B, Sk) key mask, or null
  long long st[4][3];      // q, k, v, o: (batch, head, row) strides in elements
  int B, H, Sq, Sk;
  float qscale;
};

struct AsArgs {
  AsProblem p[2];
  int D;
  int mask_bytes;  // 1: bool read as bytes; 4: f32 {0, 1}
  int mult_mask;
};

template <typename T> __device__ __forceinline__ float as_load(const T* p);
template <> __device__ __forceinline__ float as_load<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float as_load<bf16>(const bf16* p) { return __bfloat162float(*p); }

template <typename T> __device__ __forceinline__ float as_round(float x);
template <> __device__ __forceinline__ float as_round<float>(float x) { return x; }
template <> __device__ __forceinline__ float as_round<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T> __device__ __forceinline__ void as_store(T* p, float x);
template <> __device__ __forceinline__ void as_store<float>(float* p, float x) { *p = x; }
template <> __device__ __forceinline__ void as_store<bf16>(bf16* p, float x) { *p = __float2bfloat16(x); }

// Shared memory, in floats: Qs (BQ x (D + 1)), Os (BQ x D), Ks
// (BK x (DC + 1)), Vs (BK x DC), Ps (BQ x BK), then the rows' alpha and sum.
__host__ __device__ inline int as_smem_floats(int D) {
  return AS_BQ * (D + 1) + AS_BQ * D + AS_BK * (AS_DC + 1) + AS_BK * AS_DC + AS_BQ * AS_BK + 2 * AS_BQ;
}

template <typename T>
__global__ void __launch_bounds__(AS_THREADS) attn_simt_kernel(const AsArgs args) {
  const AsProblem& P = args.p[blockIdx.z];
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * AS_BQ;
  if (bh >= P.B * P.H || q0 >= P.Sq) return;  // whole block: before any barrier
  const int b = bh / P.H, h = bh % P.H;
  const int D = args.D;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + AS_BQ * (D + 1);
  float* Ks = Os + AS_BQ * D;
  float* Vs = Ks + AS_BK * (AS_DC + 1);
  float* Ps = Vs + AS_BK * AS_DC;
  float* alpha_s = Ps + AS_BQ * AS_BK;
  float* l_s = alpha_s + AS_BQ;

  const T* q = static_cast<const T*>(P.q) + b * P.st[0][0] + h * P.st[0][1];
  const T* k = static_cast<const T*>(P.k) + b * P.st[1][0] + h * P.st[1][1];
  const T* v = static_cast<const T*>(P.v) + b * P.st[2][0] + h * P.st[2][1];
  T* o = static_cast<T*>(P.o) + b * P.st[3][0] + h * P.st[3][1];
  const long long qr = P.st[0][2], kr = P.st[1][2], vr = P.st[2][2], orow = P.st[3][2];

  // The block's q rows, scaled and rounded as the twins prescale q; rows
  // past Sq are 0 and never stored. The accumulator starts at 0.
  for (int e = tid; e < AS_BQ * D; e += AS_THREADS) {
    const int r = e / D, d = e - r * D;
    const int row = q0 + r;
    Qs[r * (D + 1) + d] = row < P.Sq ? as_round<T>(as_load<T>(q + row * qr + d) * P.qscale) : 0.f;
    Os[e] = 0.f;
  }

  // Scores: row sr, keys sc + 8 i (i < 4): a row's 8 threads are 8
  // neighbouring lanes of one warp.
  const int sr = tid >> 3, sc = tid & 7;
  float m_run = -INFINITY, l_run = 0.f;
  const unsigned char* mask_b = static_cast<const unsigned char*>(P.mask);
  const float* mask_f = static_cast<const float*>(P.mask);

  for (int k0 = 0; k0 < P.Sk; k0 += AS_BK) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < D; d0 += AS_DC) {
      __syncthreads();  // Qs/Os written (first pass), Ks free
      for (int e = tid; e < AS_BK * AS_DC; e += AS_THREADS) {
        const int j = e / AS_DC, dd = e - j * AS_DC;
        const int key = k0 + j, d = d0 + dd;
        Ks[j * (AS_DC + 1) + dd] = (key < P.Sk && d < D) ? as_load<T>(k + key * kr + d) : 0.f;
      }
      __syncthreads();
      const float* qrow = Qs + sr * (D + 1) + d0;
      const int dn = min(AS_DC, D - d0);
#pragma unroll 4
      for (int dd = 0; dd < dn; ++dd) {
        const float qv = qrow[dd];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i] = fmaf(qv, Ks[(sc + 8 * i) * (AS_DC + 1) + dd], s[i]);
      }
    }
    // Masks, the tile's max, the online update.
    float cm[4];
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + sc + 8 * i;
      if (key >= P.Sk) {
        s[i] = -INFINITY;
        cm[i] = 0.f;
        continue;
      }
      cm[i] = 1.f;
      if (P.mask != nullptr) {
        const long long at = static_cast<long long>(b) * P.Sk + key;
        cm[i] = args.mask_bytes == 1 ? (mask_b[at] ? 1.f : 0.f) : mask_f[at];
      }
      s[i] -= (1.f - cm[i]) * 1e9f;
      tmax = fmaxf(tmax, s[i]);
    }
#pragma unroll
    for (int o2 = 1; o2 < 8; o2 <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o2));
    const float m_new = fmaxf(m_run, tmax);  // finite: key k0 < Sk is in the tile
    const float alpha = exp2f(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p = exp2f(s[i] - m_new);
      if (args.mult_mask) p *= cm[i];
      psum += p;
      Ps[sr * AS_BK + sc + 8 * i] = as_round<T>(p);  // rounded for PV, as the twins
    }
#pragma unroll
    for (int o2 = 1; o2 < 8; o2 <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o2);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    if (sc == 0) alpha_s[sr] = alpha;

    // O = O * alpha + P V, in chunks of 64 columns.
    for (int d0 = 0; d0 < D; d0 += AS_DC) {
      __syncthreads();  // Ps / alpha written; Vs free
      for (int e = tid; e < AS_BK * AS_DC; e += AS_THREADS) {
        const int j = e / AS_DC, dd = e - j * AS_DC;
        const int key = k0 + j, d = d0 + dd;
        Vs[e] = (key < P.Sk && d < D) ? as_load<T>(v + key * vr + d) : 0.f;
      }
      __syncthreads();
      const int dn = min(AS_DC, D - d0);
      for (int e = tid; e < AS_BQ * AS_DC; e += AS_THREADS) {
        const int r = e / AS_DC, dd = e - r * AS_DC;
        if (dd >= dn) continue;
        float acc = Os[r * D + d0 + dd] * alpha_s[r];
        const float* prow = Ps + r * AS_BK;
#pragma unroll 8
        for (int j = 0; j < AS_BK; ++j) acc = fmaf(prow[j], Vs[j * AS_DC + dd], acc);
        Os[r * D + d0 + dd] = acc;
      }
    }
  }
  if (sc == 0) l_s[sr] = args.mult_mask ? fmaxf(l_run, 1e-30f) : l_run;
  __syncthreads();
  for (int e = tid; e < AS_BQ * D; e += AS_THREADS) {
    const int r = e / D, d = e - r * D;
    const int row = q0 + r;
    if (row < P.Sq) as_store<T>(o + row * orow + d, Os[e] / l_s[r]);
  }
}

template <typename T>
int attn_simt_launch(const AsArgs& args, int nprob, cudaStream_t stream) {
  const int smem = as_smem_floats(args.D) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(attn_simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int bh = 0, q_tiles = 0;
  for (int i = 0; i < nprob; ++i) {
    bh = max(bh, args.p[i].B * args.p[i].H);
    q_tiles = max(q_tiles, (args.p[i].Sq + AS_BQ - 1) / AS_BQ);
  }
  attn_simt_kernel<T><<<dim3(bh, q_tiles, nprob), AS_THREADS, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: q, k, v, o, mask of each problem (10 pointers; mask may be null);
// strides: q, k, v, o (batch, head, row) of each problem (24); dims: B, H,
// Sq, Sk of each problem (8); qscale: one a problem. nprob is 1 or 2 (K6's
// two directions); elem 0 is f32, 1 is bf16.
extern "C" int btia_attn_simt(const void* const* ptrs, const long long* strides, const int* dims,
                              const float* qscale, int nprob, int D, int mask_bytes, int mult_mask, int elem,
                              void* stream) {
  if (nprob < 1 || nprob > 2 || D < 1 || D > AS_MAX_D || (mask_bytes != 1 && mask_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  AsArgs args = {};
  args.D = D;
  args.mask_bytes = mask_bytes;
  args.mult_mask = mult_mask;
  for (int i = 0; i < nprob; ++i) {
    AsProblem& p = args.p[i];
    p.q = ptrs[5 * i];
    p.k = ptrs[5 * i + 1];
    p.v = ptrs[5 * i + 2];
    p.o = const_cast<void*>(ptrs[5 * i + 3]);
    p.mask = ptrs[5 * i + 4];
    for (int t = 0; t < 4; ++t)
      for (int a = 0; a < 3; ++a) p.st[t][a] = strides[12 * i + 3 * t + a];
    p.B = dims[4 * i];
    p.H = dims[4 * i + 1];
    p.Sq = dims[4 * i + 2];
    p.Sk = dims[4 * i + 3];
    p.qscale = qscale[i];
    if (p.B < 1 || p.H < 1 || p.Sq < 1 || p.Sk < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 0) return attn_simt_launch<float>(args, nprob, s);
  if (elem == 1) return attn_simt_launch<bf16>(args, nprob, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
