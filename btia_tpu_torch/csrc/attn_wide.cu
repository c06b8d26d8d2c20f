// Attention with bf16 heads wider than 256 (up to 1024) on the tensor cores:
// the wide-head route of all six attention entries.
//
// Replaces, on bf16 heads of 257-1024, btia_tpu/ops/fused_attn.py:
// _fused_kernel and _staticq_kernel (K1/K2's attention core),
// btia_tpu/ops/attention.py:_bshd_flash_kernel (K3), _fanout_kernel (K4)
// and _mha_kernel (K5), and btia_tpu/ops/bicross.py:_bicross_pallas's kernel
// (K6). The TPU kernels take any head width; the port's tensor-core kernels
// for those entries hold a head's whole output row in one warpgroup's
// registers, which stops at 256 columns (short_flash.cuh, flash_bshd.cu).
//
// What bounds it on an H100: at the least work, bytes and bf16 tensor-core
// operations about equally (K5 at 16 x 577 and D 1024: 76 MB against 22
// GFLOP). This kernel does more than the least work, because of the design
// below: each output slice recomputes the scores over the whole head, so
// (slices + 1) / 2 times the least tensor-core work (1.5x at D 384 and 512,
// 2x at 768, 2.5x at 1024). The score product is the bulk of it, and a
// 64 x 64 score tile on wgmma from shared memory runs near the SM's
// shared-memory bandwidth.
//
// * Work items. An item is (problem, batch row, head, 64-row q tile, output
//   slice of at most 256 columns); K6's two directions are two problems of
//   one launch. A persistent grid walks the items, the slices and q tiles of
//   one head together so that its K and V stay in L2.
// * The O slice (64 x 256 f32) lives in one consumer warpgroup's registers,
//   as short_flash.cuh's D = 256 instance does; the host balances the slices
//   (ops/attention.py:wide_plan: 192 or 256 columns).
// * Scores. S = Q K^T over the full head in 64-column blocks on wgmma
//   m64n64k16, accumulating in the 64 x 64 score tile. A producer warp loads
//   the item's Q (all of it: at most 128 KB at D 1024) once, each key tile's
//   K in 64-key x 64-column blocks through a ring as deep as shared memory
//   allows beside Q and V (4 stages at D 1024, up to 8 below), and its V
//   slice through a two-stage ring, all by TMA over 4-D tensor maps of the
//   (B, H, S, D) views with their own strides (128-byte swizzle; zero fill
//   past S and past the head's width), on mbarriers. Every K block is
//   re-read from L2 once a slice and a q tile, so what holds the loads back
//   is L2 latency and bandwidth. The next item's Q and K load while the
//   consumers finish this item.
// * Softmax and PV. The online softmax runs in registers (quad shuffles);
//   P, rounded to bf16, goes as wgmma's register A operand into
//   O_slice += P V_slice (m64n256k16 or n192). No product sits under a
//   branch of its own, and every wait is followed by its own wgmma fence:
//   ptxas otherwise serialises every wgmma of the kernel (its warning
//   C7520). Ring
//   positions are stepped, not divided by the ring's depth: in development
//   calls on an H100 the division, on the consumer's path between two
//   products, made the kernel 1.4x slower.
// * The key mask is read once a column into a table in shared memory.
// * The output is staged through the tile's V stage in the 128-byte swizzle
//   and stored in 16-byte vectors through o's strides: rows [0, Sq) and
//   columns [0, dw) of the slice.
// A head width that is not a multiple of 8 comes as one zero-padded copy
// (the host's), so that TMA rows are 16-byte multiples.
//
// Two mask modes, each the reference's own (ZERO = mult_mask):
// * K1, K2 and K4 (ZERO): a -1e9 bias on masked keys before the row max,
//   exp2 times the {0, 1} key mask, the denominator floored at 1e-30, the
//   division after PV; a fully masked row gives exactly 0.
// * K3, K5 and K6: a -1e9 bias on masked keys, keys past Sk excluded, the
//   division after PV; a fully masked row averages V over the Sk real keys.
// In both, q is multiplied by qscale (scale*log2(e)) in f32 and rounded to
// bf16 in shared memory (K1/K2 pass 1: q arrives in the log2 domain), and P
// is rounded to bf16 before PV, as the twins do.

#include "short_flash.cuh"  // hopper.cuh's blocks, sf_pv, sf_pack_bf16, sf_encode

namespace {

constexpr int AW_THREADS = 160;     // one consumer warpgroup + one producer warp
constexpr int AW_BN = 64;           // keys a tile
constexpr int AW_BLK = 64 * 128;    // a 64-row x 64-column bf16 block, 128-byte swizzled
constexpr int AW_MAX_KST = 8;       // K block stages, at most
constexpr int AW_VST = 2;           // V slice stages
constexpr int AW_SMEM_MAX = 232448;  // an H100 block's shared memory
constexpr int AW_MAX_D = 1024;

// Shared memory: the V ring (two slices of VB blocks), the K ring (kst
// blocks), Q (qb blocks: the head's width in 64-column blocks), the two
// tiles' key-column tables and the barriers (Q full and empty, each K
// stage's and each V stage's full and empty); 1 KB of slack aligns the base.
template <int SW>
struct AwLayout {
  static constexpr int VB = SW / 64;  // 64-column blocks of a V slice
  static constexpr int V_BYTES = VB * AW_BLK;
  static constexpr int K_OFF = AW_VST * V_BYTES;
  static __host__ __device__ int q_off(int kst) { return K_OFF + kst * AW_BLK; }
  static __host__ __device__ int col_off(int kst, int qb) { return q_off(kst) + qb * AW_BLK; }
  static __host__ __device__ int bar_off(int kst, int qb) { return col_off(kst, qb) + 2 * AW_BN * 4; }
  static __host__ __device__ int smem(int kst, int qb) {
    return bar_off(kst, qb) + 8 * (2 + 2 * kst + 2 * AW_VST) + 1024;
  }
  // The deepest K ring that fits beside Q and V.
  static int stages(int qb) {
    int kst = AW_MAX_KST;
    while (kst > 2 && smem(kst, qb) > AW_SMEM_MAX) --kst;
    return kst;
  }
};

struct AwProblem {
  const void* mask;  // (B, Sk) {0, 1}: f32 (mask_bytes 4) or bool (1); or null
  bf16* o;
  long long ob, oh, os;
  int B, H, Sq, Sk;
  int qbm, kbm, vbm;  // 1, or 0 where the operand is one batch row every item reads
  int q_tiles, items;
  float qscale;
};

struct AwParams {
  CUtensorMap qm[2], km[2], vm[2];
  AwProblem pr[2];
  int np, total, dw, qb, kst, sw, nslices, mask_bytes;
};

struct AwItem {
  int p, b, h, q0, v0;
};

// A position in a ring of n stages: the stage, and how many times the ring
// has wrapped (a stage's mbarrier phase). Stepped, not divided: a division
// by the runtime depth between two wgmma products stalls the tensor cores.
struct AwRing {
  int s = 0, r = 0;
  __device__ __forceinline__ void next(int n) {
    if (++s == n) s = 0, ++r;
  }
};

// Problem 0's items first; within a problem the q tile fastest, then the
// output slice, the head and the batch row.
__device__ __forceinline__ AwItem aw_decode(const AwParams& P, int it) {
  AwItem r;
  r.p = (P.np > 1 && it >= P.pr[0].items) ? 1 : 0;
  const AwProblem& pr = P.pr[r.p];
  int i = r.p ? it - P.pr[0].items : it;
  r.q0 = (i % pr.q_tiles) * 64;
  i /= pr.q_tiles;
  r.v0 = (i % P.nslices) * P.sw;
  i /= P.nslices;
  r.h = i % pr.H;
  r.b = i / pr.H;
  return r;
}

template <int SW, bool ZERO>
__global__ void __launch_bounds__(AW_THREADS, 1) attn_wide_kernel(const __grid_constant__ AwParams P) {
  using L = AwLayout<SW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int kst = P.kst;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L::bar_off(kst, P.qb));
  uint64_t* qempty = qfull + 1;
  uint64_t* kfull = qfull + 2;
  uint64_t* kempty = kfull + kst;
  uint64_t* vfull = kempty + kst;
  uint64_t* vempty = vfull + AW_VST;
  unsigned char* qs = smem + L::q_off(kst);
  float* cols = reinterpret_cast<float*>(smem + L::col_off(kst, P.qb));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, 4);
    for (int s = 0; s < kst; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], 4);
    }
    for (int s = 0; s < AW_VST; ++s) {
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {
    // Producer: one thread issues every load, in the consumers' order: an
    // item's Q, then per key tile its qb K blocks and its V slice.
    if (lane == 0) {
      for (int p = 0; p < P.np; ++p) {
        tma_prefetch_map(&P.qm[p]);
        tma_prefetch_map(&P.km[p]);
        tma_prefetch_map(&P.vm[p]);
      }
      int n = 0, vc = 0;
      AwRing kq;
      for (int it = blockIdx.x; it < P.total; it += gridDim.x, ++n) {
        const AwItem w = aw_decode(P, it);
        const AwProblem& pr = P.pr[w.p];
        if (n > 0) mbar_wait(qempty, (n - 1) & 1);
        mbar_expect_tx(qfull, P.qb * AW_BLK);
        for (int cb = 0; cb < P.qb; ++cb)
          tma_load_4d(qs + cb * AW_BLK, &P.qm[w.p], qfull, cb * 64, w.q0, w.h, w.b * pr.qbm);
        const int nkt = (pr.Sk + AW_BN - 1) / AW_BN;
        for (int kt = 0; kt < nkt; ++kt) {
          for (int c = 0; c < P.qb; ++c, kq.next(kst)) {
            if (kq.r > 0) mbar_wait(&kempty[kq.s], (kq.r - 1) & 1);
            mbar_expect_tx(&kfull[kq.s], AW_BLK);
            tma_load_4d(smem + L::K_OFF + kq.s * AW_BLK, &P.km[w.p], &kfull[kq.s], c * 64, kt * AW_BN, w.h,
                        w.b * pr.kbm);
          }
          const int u = vc % AW_VST;
          if (vc >= AW_VST) mbar_wait(&vempty[u], (vc / AW_VST - 1) & 1);
          // Blocks past the head's width are not loaded: their output
          // columns are computed from whatever the stage holds and never
          // stored.
          const int vb = min(L::VB, (P.dw - w.v0 + 63) / 64);
          mbar_expect_tx(&vfull[u], vb * AW_BLK);
          for (int cb = 0; cb < vb; ++cb)
            tma_load_4d(smem + u * L::V_BYTES + cb * AW_BLK, &P.vm[w.p], &vfull[u], w.v0 + cb * 64, kt * AW_BN, w.h,
                        w.b * pr.vbm);
          ++vc;
        }
      }
    }
    return;
  }

  // The consumer warpgroup: this thread holds score and output rows r0 and
  // r0 + 8 of the 64-row tile (wgmma's fragment layout, hopper.cuh).
  const int t = threadIdx.x;
  const int r0 = 16 * warp + lane / 4, qd = lane % 4;
  const uint32_t q_addr = smem_u32(qs);
  float acc_o[SW / 2], sc[AW_BN / 2];
  int n = 0, vc = 0, tc = 0;
  AwRing kq;
  for (int it = blockIdx.x; it < P.total; it += gridDim.x, ++n) {
    const AwItem w = aw_decode(P, it);
    const AwProblem& pr = P.pr[w.p];

    // Q into the log2 domain, rounded to bf16, in place (an elementwise
    // map, so the swizzle does not matter), then handed to the async proxy.
    mbar_wait(qfull, n & 1);
    if (pr.qscale != 1.f) {
      uint4* qv = reinterpret_cast<uint4*>(qs);
      for (int i = t; i < P.qb * AW_BLK / 16; i += 128) {
        uint4 x = qv[i];
        __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(hv[e]);
          hv[e] = __floats2bfloat162_rn(f.x * pr.qscale, f.y * pr.qscale);
        }
        qv[i] = x;
      }
      fence_proxy_async();
      named_barrier(1, 128);
    }

#pragma unroll
    for (int i = 0; i < SW / 2; ++i) acc_o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    const int nkt = (pr.Sk + AW_BN - 1) / AW_BN;
    for (int kt = 0; kt < nkt; ++kt, ++tc) {
      // The tile's key columns, one a thread: bias -1e9 on a masked key,
      // -inf past Sk, else 0. The mask's global load is issued here, before
      // the products, and its value goes to a shared table once a column.
      const int k0 = kt * AW_BN;
      float cbias = 0.f;
      if (t < AW_BN) {
        const int key = k0 + t;
        cbias = -INFINITY;
        if (key < pr.Sk) {
          const long long i = static_cast<long long>(w.b) * pr.Sk + key;
          const bool on = pr.mask == nullptr || (P.mask_bytes == 1 ? static_cast<const uint8_t*>(pr.mask)[i] != 0
                                                                   : static_cast<const float*>(pr.mask)[i] != 0.f);
          cbias = on ? 0.f : -1e9f;
        }
      }
      float* tab = cols + (tc & 1) * AW_BN;

      // S = Q K^T over the head's qb column blocks, one K block a stage;
      // a stage is released once the product after it has been issued.
      int prev = 0;  // the stage of the product before this one
      for (int c = 0; c < P.qb; ++c, prev = kq.s, kq.next(kst)) {
        mbar_wait(&kfull[kq.s], kq.r & 1);
        const uint32_t k_addr = smem_u32(smem + L::K_OFF + kq.s * AW_BLK);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16_ss_n64(sc, wgmma_desc_sw128(q_addr + c * AW_BLK + kk * 32, 16, 1024),
                            wgmma_desc_sw128(k_addr + kk * 32, 16, 1024), c > 0 || kk > 0);
        wgmma_commit();
        if (c == 0) {
          // Two tiles' tables alternate, so one barrier a tile orders these
          // writes after the previous tile's readers.
          if (t < AW_BN) tab[t] = cbias;
          named_barrier(1, 128);
        } else {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&kempty[prev]);
        }
      }
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) {
        mbar_arrive(&kempty[prev]);
        if (kt == nkt - 1) mbar_arrive(qempty);  // the item's last read of Q
      }
      // live: bit 2j + cc, whether column 8j + 2qd + cc is an unmasked key
      // (ZERO multiplies the exponentials by it).
      uint32_t live = 0u;
#pragma unroll
      for (int j = 0; j < AW_BN / 8; ++j) {
        const float2 e = *reinterpret_cast<const float2*>(tab + 8 * j + 2 * qd);
        sc[4 * j] += e.x;
        sc[4 * j + 1] += e.y;
        sc[4 * j + 2] += e.x;
        sc[4 * j + 3] += e.y;
        live |= (static_cast<uint32_t>(e.x == 0.f) | (static_cast<uint32_t>(e.y == 0.f) << 1)) << (2 * j);
      }

      // Online softmax, rows r0 (registers 4j, 4j+1) and r0 + 8 (4j+2, 4j+3).
      float x0 = m0, x1 = m1;
#pragma unroll
      for (int j = 0; j < AW_BN / 8; ++j) {
        x0 = fmaxf(x0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        x1 = fmaxf(x1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
      // finite: key k0 < Sk is in the tile, its bias 0 or -1e9
      const float alpha0 = exp2f(m0 - x0), alpha1 = exp2f(m1 - x1);
      m0 = x0;
      m1 = x1;

      uint32_t pa[AW_BN / 16][4];
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < AW_BN / 16; ++kk) {
        float e[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          e[r] = exp2f(sc[8 * kk + r] - ((r & 2) ? x1 : x0));
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
        for (int j = 0; j < SW / 8; ++j) {
          acc_o[4 * j] *= alpha0;
          acc_o[4 * j + 1] *= alpha0;
          acc_o[4 * j + 2] *= alpha1;
          acc_o[4 * j + 3] *= alpha1;
        }
      }

      // O_slice += P V_slice over the tile's keys in steps of 16 (V rows
      // 16kk.., 2 KB apart). V is MN-major: 1 KB between groups of eight
      // keys (SBO), 8 KB from one 64-column block to the next (LBO).
      const int u = vc % AW_VST;
      mbar_wait(&vfull[u], (vc / AW_VST) & 1);
      const uint32_t v_addr = smem_u32(smem + u * L::V_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < AW_BN / 16; ++kk)
        sf_pv<SW>(acc_o, pa[kk], wgmma_desc_sw128(v_addr + kk * 2048, AW_BLK, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_o);
      fence_regs(pa);
      ++vc;
      // The last tile's stage is kept: the output is staged through it.
      if (kt < nkt - 1 && lane == 0) mbar_arrive(&vempty[u]);
    }

    // The row sums live in four threads each; divide once (ZERO: by the sum
    // floored at 1e-30, so a row with no live key gives 0).
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = ZERO ? fmaxf(l0, 1e-30f) : l0, d1 = ZERO ? fmaxf(l1, 1e-30f) : l1;

    // Stage bf16(O) in the last tile's V stage (the 128-byte swizzle), then
    // store whole 16-byte chunks of rows.
    const int u = (vc - 1) % AW_VST;
    unsigned char* so = smem + u * L::V_BYTES;
    named_barrier(1, 128);  // every warp's products are done with the stage
#pragma unroll
    for (int j = 0; j < SW / 8; ++j) {
      unsigned char* box = so + (j / 8) * AW_BLK + qd * 4;
      const int sw = ((j % 8) ^ (r0 % 8)) * 16;  // rows r0 and r0 + 8 share r0 % 8
      *reinterpret_cast<__nv_bfloat162*>(box + r0 * 128 + sw) =
          __floats2bfloat162_rn(acc_o[4 * j] / d0, acc_o[4 * j + 1] / d0);
      *reinterpret_cast<__nv_bfloat162*>(box + (r0 + 8) * 128 + sw) =
          __floats2bfloat162_rn(acc_o[4 * j + 2] / d1, acc_o[4 * j + 3] / d1);
    }
    named_barrier(1, 128);
    constexpr int CH = SW / 8;  // 16-byte chunks a row
    bf16* ob = pr.o + w.b * pr.ob + w.h * pr.oh;
    for (int idx = t; idx < 64 * CH; idx += 128) {
      const int r = idx / CH, cc = idx % CH;
      const int q = w.q0 + r, col = w.v0 + 8 * cc;
      if (q >= pr.Sq || col >= P.dw) continue;
      const uint4 y = *reinterpret_cast<const uint4*>(so + (cc / 8) * AW_BLK + r * 128 + (((cc % 8) ^ (r % 8)) * 16));
      *reinterpret_cast<uint4*>(ob + q * pr.os + col) = y;
    }
    fence_proxy_async();  // this thread's use of the stage before TMA refills it
    __syncwarp();
    if (lane == 0) mbar_arrive(&vempty[u]);
  }
}

template <int SW, bool ZERO>
int aw_launch(AwParams& P, cudaStream_t stream) {
  using L = AwLayout<SW>;
  auto kernel = attn_wide_kernel<SW, ZERO>;
  P.kst = L::stages(P.qb);
  const int smem = L::smem(P.kst, P.qb);
  // The grid: resident blocks an SM times the SMs. Queried once an instance
  // (and again for another shared-memory size): host calls cost as much as
  // a short launch.
  static int sms = 0, last_smem = -1, per_sm = 0;
  cudaError_t e;
  if (sms == 0) {
    int dev = 0;
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, AW_SMEM_MAX)) != cudaSuccess)
      return static_cast<int>(e);
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(e);
  }
  if (smem != last_smem) {
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, AW_THREADS, smem)) != cudaSuccess)
      return static_cast<int>(e);
    last_smem = smem;
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = P.total < per_sm * sms ? P.total : per_sm * sms;
  kernel<<<grid, AW_THREADS, smem, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: q, k, v, o, mask of each problem (10 pointers; mask may be null);
// strides: q, k, v, o (batch, head, row) of each problem (24), in elements;
// dims: B, H, Sq, Sk of each problem (8); qscale: one a problem. Every
// operand is bf16 (B, H, S, dw) with its columns packed and 16-byte aligned,
// its strides multiples of 8; a batch stride of 0 on q, k or v reads one
// batch row for every batch row (K2's query table). dw: the head width, a
// multiple of 8 up to 1024. plan (the host's, ops/attention.py:wide_plan):
// the slice width (192 or 256) and the slices (covering [0, dw)). Returns 0,
// a CUDA error code (cudaErrorInvalidValue for arguments the kernel does not
// take), or 1000 + the CUresult of encoding a tensor map.
extern "C" int btia_attn_wide(const void* const* ptrs, const long long* strides, const int* dims,
                              const float* qscale, int nprob, int dw, int mask_bytes, int mult_mask, const int* plan,
                              void* stream) {
  const int sw = plan[0], nslices = plan[1];
  if (nprob < 1 || nprob > 2 || dw < 8 || dw % 8 != 0 || dw > AW_MAX_D || (mask_bytes != 1 && mask_bytes != 4) ||
      (sw != 192 && sw != 256) || nslices < 1 || nslices * sw < dw || (nslices - 1) * sw >= dw)
    return static_cast<int>(cudaErrorInvalidValue);
  AwParams P;
  memset(&P, 0, sizeof(P));
  P.np = nprob;
  P.dw = dw;
  P.qb = (dw + 63) / 64;
  P.sw = sw;
  P.nslices = nslices;
  P.mask_bytes = mask_bytes;
  long long total = 0;
  for (int i = 0; i < nprob; ++i) {
    AwProblem& pr = P.pr[i];
    const long long* st = strides + 12 * i;
    pr.B = dims[4 * i], pr.H = dims[4 * i + 1], pr.Sq = dims[4 * i + 2], pr.Sk = dims[4 * i + 3];
    if (pr.B < 1 || pr.H < 1 || pr.Sq < 1 || pr.Sk < 1) return static_cast<int>(cudaErrorInvalidValue);
    for (int a = 0; a < 4; ++a) {
      if (reinterpret_cast<uintptr_t>(ptrs[5 * i + a]) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
      for (int d = 0; d < 3; ++d)
        if (st[3 * a + d] % 8 != 0 || st[3 * a + d] < 0 || (d > 0 && st[3 * a + d] == 0))
          return static_cast<int>(cudaErrorInvalidValue);
    }
    if (st[9] == 0 && pr.B > 1) return static_cast<int>(cudaErrorInvalidValue);  // o has a row per batch row
    int* bm[3] = {&pr.qbm, &pr.kbm, &pr.vbm};
    CUtensorMap* maps[3] = {&P.qm[i], &P.km[i], &P.vm[i]};
    for (int a = 0; a < 3; ++a) {
      const int S = a == 0 ? pr.Sq : pr.Sk;
      SfOperand op{ptrs[5 * i + a], st[3 * a], st[3 * a + 1], st[3 * a + 2]};
      *bm[a] = op.b != 0;
      if (op.b == 0) {  // one batch row for all: a map of B = 1 (its stride any nonzero multiple of 16 bytes)
        const long long span = op.h * pr.H > op.s * S ? op.h * pr.H : op.s * S;
        op.b = span > dw ? span : dw;
      }
      const int err = sf_encode(maps[a], op, *bm[a] ? pr.B : 1, pr.H, S, dw, 64);
      if (err != 0) return err;
    }
    pr.o = static_cast<bf16*>(const_cast<void*>(ptrs[5 * i + 3]));
    pr.ob = st[9], pr.oh = st[10], pr.os = st[11];
    pr.mask = ptrs[5 * i + 4];
    pr.qscale = qscale[i];
    pr.q_tiles = (pr.Sq + 63) / 64;
    const long long items = static_cast<long long>(pr.B) * pr.H * pr.q_tiles * nslices;
    if (items > 0x3fffffff) return static_cast<int>(cudaErrorInvalidValue);
    pr.items = static_cast<int>(items);
    total += items;
  }
  if (total > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  P.total = static_cast<int>(total);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sw == 256) return mult_mask ? aw_launch<256, true>(P, s) : aw_launch<256, false>(P, s);
  return mult_mask ? aw_launch<192, true>(P, s) : aw_launch<192, false>(P, s);
}
