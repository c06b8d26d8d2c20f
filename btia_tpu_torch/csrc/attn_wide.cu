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
// What bounds it on an H100. At the least work, bytes and bf16 tensor-core
// operations about equally (K5 at 16 x 577 and D 1024: 76 MB against 22
// GFLOP, 23 and 22 us), bytes alone at the short shapes (K3 at 64 x 197 and
// D 1024: 103 MB, 31 us, against 10 GFLOP). A head's output row does not fit
// one warpgroup's registers, so the head is cut into column slices. The
// first design gave each slice a block of its own that recomputed the scores
// over the whole head ((slices + 1) / 2 times the least tensor-core work)
// and read every K block once a slice. This one computes each score once,
// across a thread block cluster, and what bounds it instead is the exchange
// of partial scores between the cluster's blocks: (slices - 1) x 16 KB out
// and in of every block a 64-key tile over the cluster network (48 KB at
// D 1024, for 4.2 MFLOP of the block's tensor-core work a tile), and each
// tile's steps in turn on one warpgroup.
//
// * A cluster of `nslices` blocks (2 at D 264-512, 3 at 513-768, 4 at
//   769-1024; ops/attention.py:wide_plan; a launch attribute, since the size
//   varies with the call) takes one work item: (problem, batch row, head,
//   64-row q tile); K6's two directions are two problems of one launch.
//   Block r owns the head's columns [r sw, (r + 1) sw) of Q, K, V and O
//   (sw = 192 or 256) and loads only those, by TMA over 4-D tensor maps of
//   the (B, H, S, D) views with their own strides (128-byte swizzle; zero
//   fill past S and past the head's width): Q (at most 32 KB), each key
//   tile's K in 64-key x 64-column blocks through a ring of two key tiles
//   where shared memory allows, and each key tile's V through a two-stage
//   ring. Every Q, K and V element is read from L2 once a q tile, not once a
//   slice. The producer warp issues tile kt + 1's K before tile kt's V: the
//   consumers take K a tile ahead of V.
// * Scores. Block r computes its partial S_r = Q_r K_r^T (64 x 64 f32) on
//   wgmma m64n64k16 and sends it into each peer's shared memory by st.async,
//   counted on the peer's mbarrier (complete_tx), as TMA counts its bytes:
//   with one peer the consumer warpgroup stores it itself; with two or three
//   it leaves it in an outgoing buffer and three exchange warps, one a peer,
//   store it, so that no consumer instruction waits on the network. Once a
//   block has every peer's partial it adds them and its own (from its
//   registers) in rank order, so every block holds the same S bit for bit
//   and computes the same softmax. A slot is written again only once its
//   receiver has said it has read it (an mbarrier arrival on the sender's
//   barrier, released at cluster scope: slow, so a warp of its own makes it).
//   The incoming partials are double-buffered where a K ring of two key
//   tiles still fits (all but 256 x 3 and 256 x 4).
// * Pipelining on one consumer warpgroup. Tile kt + 1's partial scores and
//   tile kt - 1's PV product are issued before the exchange of tile kt is
//   awaited; the sum and tile kt's online softmax (registers, quad shuffles)
//   run while they do. P, rounded to bf16, goes as wgmma's register A
//   operand into O_r += P V_r (m64n256k16 or n192) on the block's own slice.
//   No product sits under a branch (the loop is peeled: a zero P stands in
//   for tile -1's product, and the last tile has no next), and every wait
//   before a product is followed by its own wgmma fence: ptxas otherwise
//   serialises every wgmma of the kernel (C7520). A second consumer
//   warpgroup would need 384 threads, where ptxas gives at most 168
//   registers a thread against the O slice's 128 and two score tiles' 64.
// * The key mask is read once a column into a table in shared memory.
// * The output, O times one reciprocal a row, is staged in Q's blocks (the
//   128-byte swizzle) and stored in 16-byte vectors through o's strides: rows
//   [0, Sq) and the block's columns of [0, dw).
// * Before any block exits, the cluster meets at a barrier, so that no block
//   sends to or reads the shared memory of a peer that has finished.
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

constexpr int AW_THREADS = 256;             // one consumer warpgroup, a producer warp, three exchange warps
constexpr int AW_BN = 64;                   // keys a tile
constexpr int AW_BLK = 64 * 128;            // a 64-row x 64-column bf16 block, 128-byte swizzled
constexpr int AW_X_BYTES = 64 * AW_BN * 4;  // one block's partial scores of a tile (64 x 64 f32)
constexpr int AW_MAX_KST = 12;              // K block stages, at most
constexpr int AW_VST = 2;                   // V slice stages
constexpr int AW_SMEM_MAX = 232448;         // an H100 block's shared memory
constexpr int AW_MAX_D = 1024;
constexpr int AW_ARGS = 21;  // int64 a problem in btia_attn_wide's argument array

// Shared memory of a block of a cluster of N, with a slice of SW columns
// (VB 64-column blocks): the V ring (two stages of VB blocks), Q (VB
// blocks), this block's partial scores on their way out (one buffer, where
// the exchange warps send them: N > 2), the peers' partials (nb buffers of
// N - 1 slots), the K ring (kst blocks), the two tiles' key-column tables
// and the barriers (Q full; each K and V stage's full and empty; each
// partial buffer's full (in), written and sent (out), read (in) and free
// (out)); 1 KB of slack aligns the base.
constexpr int aw_out_buffers(int n) { return n > 2 ? 1 : 0; }
constexpr int aw_bar_off(int vb, int n, int nb, int kst) {
  return (AW_VST + 1) * vb * AW_BLK + (aw_out_buffers(n) + nb * (n - 1)) * AW_X_BYTES + kst * AW_BLK + 2 * AW_BN * 4;
}
constexpr int aw_smem(int vb, int n, int nb, int kst) {
  return aw_bar_off(vb, n, nb, kst) + 8 * (1 + 2 * kst + 2 * AW_VST + 9) + 1024;
}
// The deepest K ring that fits (at least one key tile's blocks).
constexpr int aw_stages(int vb, int n, int nb) {
  int kst = AW_MAX_KST;
  while (kst > vb && aw_smem(vb, n, nb, kst) > AW_SMEM_MAX) --kst;
  return kst;
}
// Two incoming buffers where a K ring of two key tiles still fits beside
// them, else one (at 256 x 3 and 256 x 4).
constexpr int aw_in_buffers(int vb, int n) { return aw_stages(vb, n, 2) >= 2 * vb ? 2 : 1; }

template <int SW, int N>
struct AwLayout {
  static constexpr int VB = SW / 64;
  static constexpr int NB = aw_in_buffers(VB, N);  // buffers of the peers' partials
  static constexpr int V_BYTES = VB * AW_BLK;
  static constexpr int Q_OFF = AW_VST * V_BYTES;
  static constexpr int OUT_OFF = Q_OFF + VB * AW_BLK;
  static constexpr int IN_OFF = OUT_OFF + aw_out_buffers(N) * AW_X_BYTES;
  static constexpr int K_OFF = IN_OFF + NB * (N - 1) * AW_X_BYTES;
  static constexpr int KST = aw_stages(VB, N, NB);
  static constexpr int COL_OFF = K_OFF + KST * AW_BLK;
  static constexpr int BAR_OFF = aw_bar_off(VB, N, NB, KST);
  static constexpr int SMEM = aw_smem(VB, N, NB, KST);
  static_assert(BAR_OFF == COL_OFF + 2 * AW_BN * 4 && SMEM <= AW_SMEM_MAX, "the wide kernel's shared memory");
  // Incoming buffer b's slot of the partial that sender rank s sends to
  // receiver rank r (a receiver keeps a slot for each of its N - 1 peers).
  static __device__ __forceinline__ int slot(int b, int s, int r) {
    return IN_OFF + (b * (N - 1) + (s < r ? s : s - 1)) * AW_X_BYTES;
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
  int np, total, dw, sw, mask_bytes;
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

// The block's partial S_r = Q_r K_r^T of one key tile (this thread's 32 of
// its 64 x 64 f32) over the slice's vb column blocks, one K block a ring
// stage: every stage is waited for first, so that no wait sits between two
// products; issued and committed, the caller waits and releases the stages.
template <int KST>
__device__ __forceinline__ void aw_scores(float (&s)[AW_BN / 2], uint32_t q_addr, unsigned char* kring,
                                          uint64_t* kfull, AwRing& kq, int vb) {
  AwRing w = kq;
  for (int c = 0; c < vb; ++c, w.next(KST)) mbar_wait(&kfull[w.s], w.r & 1);
  wgmma_fence();
  for (int c = 0; c < vb; ++c, kq.next(KST)) {
    const uint32_t k_addr = smem_u32(kring + kq.s * AW_BLK);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16_ss_n64(s, wgmma_desc_sw128(q_addr + c * AW_BLK + kk * 32, 16, 1024),
                        wgmma_desc_sw128(k_addr + kk * 32, 16, 1024), c > 0 || kk > 0);
  }
  wgmma_commit();
}

// Release the vb K stages a tile's scores read, the last at `end`.
template <int KST>
__device__ __forceinline__ void aw_release_k(uint64_t* kempty, const AwRing& end, int vb, bool lead) {
  int st = end.s;
  for (int c = 0; c < vb; ++c) {
    st = st == 0 ? KST - 1 : st - 1;
    mbar_arrive_if(&kempty[st], lead);
  }
}

// The consumer warpgroup's state and its step over one key tile. This
// thread holds score and output rows r0 and r0 + 8 of the 64-row tile
// (wgmma's fragment layout, hopper.cuh).
template <int SW, int N, bool ZERO>
struct AwConsumer {
  using L = AwLayout<SW, N>;
  static constexpr int KST = L::KST;
  unsigned char* smem;
  uint64_t *kfull, *kempty, *vfull, *vempty, *xfull, *xout, *xread, *xfree, *xsent;
  float* cols;
  const void* mask;
  int mask_bytes, Sk, b, rank, vb, t, lane, qd;
  uint32_t q_addr;
  float acc_o[SW / 2], sc[AW_BN / 2], sn[AW_BN / 2];  // O, tile kt's scores, tile kt + 1's partial
  uint32_t pa[AW_BN / 16][4];                         // tile kt - 1's P
  float m0, m1, l0, l1;
  AwRing kq, vq;

  // O_r += P V_r over a tile's keys in steps of 16 (V rows 16kk.., 2 KB
  // apart), V from the V ring's stage vq. V is MN-major: 1 KB between
  // groups of eight keys (SBO), 8 KB from one 64-column block to the next
  // (LBO). Issued and committed.
  __device__ __forceinline__ void pv() {
    const uint32_t v_addr = smem_u32(smem + vq.s * L::V_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < AW_BN / 16; ++kk)
      sf_pv<SW>(acc_o, pa[kk], wgmma_desc_sw128(v_addr + kk * 2048, AW_BLK, 1024));
    wgmma_commit();
  }

  // Tile kt: on entry sc holds its partial scores and pa tile kt - 1's P
  // (zeros at kt = 0: the product before the first adds nothing). The
  // partial goes to the peers; tile kt + 1's partial (NEXT) and tile
  // kt - 1's PV product are issued; meanwhile the peers' partials of tile kt
  // land, are added in rank order, and tile kt's softmax runs. No product
  // sits under a branch: ptxas otherwise serialises them (C7520).
  template <bool NEXT>
  __device__ __forceinline__ void tile(int kt) {
    const int xb = kt & 1;
    // The tile's key columns into table xb, one a thread: bias -1e9 on a
    // masked key, -inf past Sk, else 0 (tile kt - 2's readers have passed
    // tile kt - 1's barriers).
    if (t < AW_BN) {
      const int key = kt * AW_BN + t;
      float cbias = -INFINITY;
      if (key < Sk) {
        const long long i = static_cast<long long>(b) * Sk + key;
        const bool on = mask == nullptr || (mask_bytes == 1 ? static_cast<const uint8_t*>(mask)[i] != 0
                                                            : static_cast<const float*>(mask)[i] != 0.f);
        cbias = on ? 0.f : -1e9f;
      }
      cols[xb * AW_BN + t] = cbias;
    }

    // This block's partial to the peers, each thread its fragment as eight
    // 16-byte vectors (a peer's thread t reads the same rows and columns at
    // the same place). With one peer (16 KB) the consumers store it into the
    // peer's slot themselves, by st.async counted on the peer's xfull, once
    // the peer has read what tile kt - 2 left there (xfree[xb], arrived on by
    // the peer's exchange warp); with two or three (32 or 48 KB, whose
    // stores wait on the cluster network) they leave it in the outgoing
    // buffer, once the exchange warps have read tile kt - 1's, and the
    // exchange warps send it on.
    if constexpr (N == 2) {
      if (kt >= 2) mbar_wait_cluster(&xfree[xb], ((kt >> 1) - 1) & 1);
      const int r = 1 - rank, ib = L::NB == 2 ? xb : 0;
      const uint32_t dst = mapa_shared(smem_u32(smem + L::slot(ib, rank, r)) + t * 16, r);
      const uint32_t bar = mapa_shared(smem_u32(&xfull[ib]), r);
#pragma unroll
      for (int j = 0; j < AW_BN / 8; ++j)
        st_async_f4(dst + j * 128 * 16, make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]), bar);
    } else {
      if (kt >= 1) mbar_wait(xsent, (kt - 1) & 1);
      float4* out = reinterpret_cast<float4*>(smem + L::OUT_OFF) + t;
#pragma unroll
      for (int j = 0; j < AW_BN / 8; ++j)
        out[j * 128] = make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]);
      __syncwarp();
      mbar_arrive_if(&xout[xb], lane == 0);
    }

    // Tile kt + 1's partial scores and tile kt - 1's PV product (at kt = 0
    // a zero P over tile 0's V).
    mbar_wait(&vfull[vq.s], vq.r & 1);
    fence_regs(acc_o);
    fence_regs(pa);
    fence_regs(sn);
    if constexpr (NEXT) aw_scores<KST>(sn, q_addr, smem + L::K_OFF, kfull, kq, vb);
    pv();

    // S = the sum of every rank's partial in rank order (this block's from
    // its registers), so that every block of the cluster holds the same S
    // bit for bit; into sc, one 16-byte group at a time.
    const int ib = L::NB == 2 ? xb : 0;  // the incoming buffer
    mbar_expect_tx_if(&xfull[ib], (N - 1) * AW_X_BYTES, t == 0);
    mbar_wait_cluster(&xfull[ib], (L::NB == 2 ? kt >> 1 : kt) & 1);
    named_barrier(1, 128);  // the key-column table is written
#pragma unroll
    for (int j = 0; j < AW_BN / 8; ++j) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < N; ++r) {
        // Rank r's partial: this block's own, or the slot rank r filled (a
        // valid slot is read, and not used, at r == rank).
        const bool own = r == rank;
        const float4 v = reinterpret_cast<const float4*>(smem + L::slot(ib, r, own ? (r + 1) % N : rank))[j * 128 + t];
        a.x += own ? sc[4 * j] : v.x;
        a.y += own ? sc[4 * j + 1] : v.y;
        a.z += own ? sc[4 * j + 2] : v.z;
        a.w += own ? sc[4 * j + 3] : v.w;
      }
      sc[4 * j] = a.x, sc[4 * j + 1] = a.y, sc[4 * j + 2] = a.z, sc[4 * j + 3] = a.w;
    }
    // This warp has read the peers' partials: the exchange warp tells the
    // peers (an arrival released at cluster scope is slow).
    __syncwarp();
    mbar_arrive_if(&xread[xb], lane == 0);

    // live: bit 2j + cc, whether column 8j + 2qd + cc is an unmasked key
    // (ZERO multiplies the exponentials by it).
    const float* tab = cols + xb * AW_BN;
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
    // finite: key kt * 64 < Sk is in the tile, its bias 0 or -1e9
    const float alpha0 = exp2f(m0 - x0), alpha1 = exp2f(m1 - x1);
    m0 = x0;
    m1 = x1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < AW_BN / 2; ++i) {
      // Register i: column group i / 4, pair member i % 2, row r0 + 8 (i & 2).
      float e = exp2f(sc[i] - ((i & 2) ? x1 : x0));
      if (ZERO && !((live >> (2 * (i >> 2) + (i & 1))) & 1u)) e = 0.f;
      sc[i] = e;
      if (i & 2)
        s1 += e;
      else
        s0 += e;
    }

    // Tile kt + 1's scores and tile kt - 1's PV product are done: release
    // their stages (tile 0's V stays for tile 0's own product), rescale O
    // and take tile kt's P.
    wgmma_wait<0>();
    fence_regs(acc_o);
    fence_regs(pa);
    fence_regs(sn);
    if constexpr (NEXT) aw_release_k<KST>(kempty, kq, vb, lane == 0);
    if (kt > 0) {
      mbar_arrive_if(&vempty[vq.s], lane == 0);
      vq.next(AW_VST);
    }
    l0 = l0 * alpha0 + s0;
    l1 = l1 * alpha1 + s1;
    if (alpha0 != 1.f || alpha1 != 1.f) {  // a row's max moved (no product is in flight)
#pragma unroll
      for (int j = 0; j < SW / 8; ++j) {
        acc_o[4 * j] *= alpha0;
        acc_o[4 * j + 1] *= alpha0;
        acc_o[4 * j + 2] *= alpha1;
        acc_o[4 * j + 3] *= alpha1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < AW_BN / 16; ++kk) {
      pa[kk][0] = sf_pack_bf16(sc[8 * kk], sc[8 * kk + 1]);      // row r0,     keys 16kk + 2qd, +1
      pa[kk][1] = sf_pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);  // row r0 + 8, the same keys
      pa[kk][2] = sf_pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);  // row r0,     keys 16kk + 8 + 2qd, +1
      pa[kk][3] = sf_pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);  // row r0 + 8
    }
    if constexpr (NEXT) {
#pragma unroll
      for (int i = 0; i < AW_BN / 2; ++i) sc[i] = sn[i];
    }
  }
};

template <int SW, int N, bool ZERO>
__global__ void __launch_bounds__(AW_THREADS, 1) attn_wide_kernel(const __grid_constant__ AwParams P) {
  using L = AwLayout<SW, N>;
  constexpr int KST = L::KST;
  extern __shared__ unsigned char smem_raw[];
  // The same offset in every block of the cluster: mapa maps it to the peer's.
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* kfull = qfull + 1;
  uint64_t* kempty = kfull + KST;
  uint64_t* vfull = kempty + KST;
  uint64_t* vempty = vfull + AW_VST;
  uint64_t* xfull = vempty + AW_VST;  // [in buffer]: the peers' partials have landed here
  uint64_t* xout = xfull + 2;         // [out buffer]: the consumers have written this block's
  uint64_t* xread = xout + 2;         // [tile & 1]: the consumers have read the peers'
  uint64_t* xfree = xread + 2;        // [tile & 1]: every peer has read what this block sent
  uint64_t* xsent = xfree + 2;        // the exchange warps have read the outgoing buffer
  unsigned char* qs = smem + L::Q_OFF;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rank = static_cast<int>(cluster_rank());

  // The cluster's item: problem 0's first; within a problem the q tile
  // fastest, then the head and the batch row.
  int it = blockIdx.x / N;
  const int p = (P.np > 1 && it >= P.pr[0].items) ? 1 : 0;
  const AwProblem& pr = P.pr[p];
  if (p) it -= P.pr[0].items;
  const int q0 = (it % pr.q_tiles) * 64;
  it /= pr.q_tiles;
  const int h = it % pr.H, b = it / pr.H;
  const int c0 = rank * P.sw;                         // this block's first column
  const int vb = min(L::VB, (P.dw - c0 + 63) / 64);  // its 64-column blocks (the last slice may be narrower)
  const int nkt = (pr.Sk + AW_BN - 1) / AW_BN;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < KST; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], 4);
    }
    for (int s = 0; s < AW_VST; ++s) {
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], 4);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&xfull[s], 1);
      mbar_init(&xout[s], 4);
      mbar_init(&xread[s], 4);
      mbar_init(&xfree[s], N - 1);
    }
    mbar_init(xsent, N - 1);
    mbar_fence_init();
  }
  __syncthreads();
  // Every block's barriers are initialised before a peer sends to them: the
  // consumers and the exchange warps wait for this arrival first.
  cluster_arrive();

  if (warp == 4) {
    // Producer: one thread issues every load, in the consumers' order: Q,
    // then the key tiles' vb K blocks and V slices.
    if (lane == 0) {
      tma_prefetch_map(&P.qm[p]);
      tma_prefetch_map(&P.km[p]);
      tma_prefetch_map(&P.vm[p]);
      mbar_expect_tx(qfull, vb * AW_BLK);
      for (int cb = 0; cb < vb; ++cb)
        tma_load_4d(qs + cb * AW_BLK, &P.qm[p], qfull, c0 + cb * 64, q0, h, b * pr.qbm);
      // Tile kt + 1's K before tile kt's V: the consumers take K a tile
      // ahead of V, and a V stage frees only when its PV product is done.
      AwRing kq, vq;
      for (int kt = -1; kt < nkt; ++kt) {
        if (kt + 1 < nkt) {
          for (int c = 0; c < vb; ++c, kq.next(KST)) {
            if (kq.r > 0) mbar_wait(&kempty[kq.s], (kq.r - 1) & 1);
            mbar_expect_tx(&kfull[kq.s], AW_BLK);
            tma_load_4d(smem + L::K_OFF + kq.s * AW_BLK, &P.km[p], &kfull[kq.s], c0 + c * 64, (kt + 1) * AW_BN, h,
                        b * pr.kbm);
          }
        }
        if (kt < 0) continue;
        // Blocks past the slice's width are not loaded: their output
        // columns are computed from whatever the stage holds and never
        // stored.
        if (vq.r > 0) mbar_wait(&vempty[vq.s], (vq.r - 1) & 1);
        mbar_expect_tx(&vfull[vq.s], vb * AW_BLK);
        for (int cb = 0; cb < vb; ++cb)
          tma_load_4d(smem + vq.s * L::V_BYTES + cb * AW_BLK, &P.vm[p], &vfull[vq.s], c0 + cb * 64, kt * AW_BN, h,
                      b * pr.vbm);
        vq.next(AW_VST);
      }
    }
    __syncwarp();
    cluster_wait();
  } else if (warp >= 5) {
    // The exchange warps, warp 5 + e for the e-th peer r: tile kt's partial
    // goes from the outgoing buffer into peer r's slot, 16 bytes a lane at a
    // time by st.async (counted on the peer's xfull), once the consumers
    // have written it and peer r has read what the slot held before (then
    // the buffer may take the next tile's: xsent). Warp
    // 5's lane r then, once the consumers have read the peers' partials of
    // tile kt, tells peer r its slot here is free. The stores run at the
    // cluster network's rate and an arrival released at cluster scope is
    // slow: both kept off the consumers' path.
    cluster_wait();  // the peers' barriers are initialised
    const int e = warp - 5, r = e < rank ? e : e + 1;
    const bool sends = N > 2 && e < N - 1;  // with one peer the consumers send
    const uint32_t dst = mapa_shared(smem_u32(smem + L::slot(0, rank, sends ? r : 0)), sends ? r : 0) + lane * 16;
    const uint32_t full = mapa_shared(smem_u32(xfull), sends ? r : 0);
    const uint32_t freed = mapa_shared(smem_u32(xfree), lane < N ? lane : 0);
    for (int kt = 0; kt < nkt && (sends || e == 0); ++kt) {
      const int xb = kt & 1, ib = L::NB == 2 ? xb : 0;
      if (sends) {
        mbar_wait(&xout[xb], (kt >> 1) & 1);
        if (kt >= L::NB) mbar_wait_cluster(&xfree[(kt - L::NB) & 1], ((kt - L::NB) >> 1) & 1);
        const float4* src = reinterpret_cast<const float4*>(smem + L::OUT_OFF) + lane;
        const uint32_t d = dst + ib * (N - 1) * AW_X_BYTES, bar = full + ib * 8;
#pragma unroll 8
        for (int i = 0; i < AW_X_BYTES / 16 / 32; ++i) st_async_f4(d + i * 32 * 16, src[i * 32], bar);
        __syncwarp();
        mbar_arrive_if(xsent, lane == 0);  // the outgoing buffer may take the next tile's
      }
      if (e == 0) {
        mbar_wait(&xread[xb], (kt >> 1) & 1);
        mbar_arrive_remote_if(freed + xb * 8, lane < N && lane != rank);
      }
    }
  } else {
    // The consumer warpgroup.
    AwConsumer<SW, N, ZERO> c;
    c.smem = smem, c.kfull = kfull, c.kempty = kempty, c.vfull = vfull, c.vempty = vempty;
    c.xfull = xfull, c.xout = xout, c.xread = xread, c.xfree = xfree, c.xsent = xsent;
    c.cols = reinterpret_cast<float*>(smem + L::COL_OFF);
    c.mask = pr.mask, c.mask_bytes = P.mask_bytes, c.Sk = pr.Sk, c.b = b, c.rank = rank, c.vb = vb;
    const int t = threadIdx.x, r0 = 16 * warp + lane / 4, qd = lane % 4;
    c.t = t, c.lane = lane, c.qd = qd, c.q_addr = smem_u32(qs);

    // Q into the log2 domain, rounded to bf16, in place (an elementwise
    // map, so the swizzle does not matter), then handed to the async proxy.
    mbar_wait(qfull, 0);
    if (pr.qscale != 1.f) {
      uint4* qv = reinterpret_cast<uint4*>(qs);
      for (int i = t; i < vb * AW_BLK / 16; i += 128) {
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
    for (int i = 0; i < SW / 2; ++i) c.acc_o[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < AW_BN / 16; ++kk) c.pa[kk][0] = c.pa[kk][1] = c.pa[kk][2] = c.pa[kk][3] = 0u;
    c.m0 = c.m1 = -INFINITY, c.l0 = c.l1 = 0.f;
    // Tile 0's partial scores, then the tiles; the last without a next.
    aw_scores<KST>(c.sc, c.q_addr, smem + L::K_OFF, kfull, c.kq, vb);
    wgmma_wait<0>();
    fence_regs(c.sc);
    aw_release_k<KST>(kempty, c.kq, vb, lane == 0);
    cluster_wait();  // the peers' barriers are initialised
    for (int kt = 0; kt < nkt - 1; ++kt) c.template tile<true>(kt);
    c.template tile<false>(nkt - 1);
    // The last tile's PV product.
    mbar_wait(&vfull[c.vq.s], c.vq.r & 1);
    fence_regs(c.acc_o);
    fence_regs(c.pa);
    c.pv();
    wgmma_wait<0>();
    fence_regs(c.acc_o);
    fence_regs(c.pa);

    // The row sums live in four threads each; one reciprocal a row (ZERO:
    // of the sum floored at 1e-30, so a row with no live key gives 0).
    float l0 = c.l0, l1 = c.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / (ZERO ? fmaxf(l0, 1e-30f) : l0), i1 = 1.f / (ZERO ? fmaxf(l1, 1e-30f) : l1);

    // Stage bf16(O) in Q's blocks (no product reads them any more; the
    // 128-byte swizzle), then store whole 16-byte chunks of rows.
#pragma unroll
    for (int j = 0; j < SW / 8; ++j) {
      unsigned char* box = qs + (j / 8) * AW_BLK;
      *reinterpret_cast<__nv_bfloat162*>(box + swz_frag(r0, j % 8, qd)) =
          __floats2bfloat162_rn(c.acc_o[4 * j] * i0, c.acc_o[4 * j + 1] * i0);
      *reinterpret_cast<__nv_bfloat162*>(box + swz_frag(r0 + 8, j % 8, qd)) =
          __floats2bfloat162_rn(c.acc_o[4 * j + 2] * i1, c.acc_o[4 * j + 3] * i1);
    }
    named_barrier(1, 128);
    constexpr int CH = SW / 8;  // 16-byte chunks a row
    bf16* ob = pr.o + b * pr.ob + h * pr.oh;
    for (int idx = t; idx < 64 * CH; idx += 128) {
      const int r = idx / CH, cc = idx % CH;
      const int q = q0 + r, col = c0 + 8 * cc;
      if (q >= pr.Sq || col >= P.dw) continue;
      const uint4 y = *reinterpret_cast<const uint4*>(qs + (cc / 8) * AW_BLK + r * 128 + (((cc % 8) ^ (r % 8)) * 16));
      *reinterpret_cast<uint4*>(ob + q * pr.os + col) = y;
    }
  }
  // No block leaves while a peer may still send to it or arrive on its
  // barriers.
  cluster_arrive();
  cluster_wait();
}

template <int SW, int N, bool ZERO>
int aw_launch(const AwParams& P, cudaStream_t stream) {
  using L = AwLayout<SW, N>;
  auto kernel = attn_wide_kernel<SW, N, ZERO>;
  static bool sized = false;  // once an instance: a host call costs as much as a short launch
  cudaError_t e;
  if (!sized) {
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM)) != cudaSuccess)
      return static_cast<int>(e);
    sized = true;
  }
  // The cluster size varies with the call (the head's slices), so it is a
  // launch attribute, not __cluster_dims__.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(P.total) * N, 1, 1);
  cfg.blockDim = dim3(AW_THREADS, 1, 1);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {const_cast<AwParams*>(&P)};
  if ((e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args)) != cudaSuccess)
    return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The instances: (slice width, cluster size) as ops/attention.py:wide_plan
// gives them, 192 x 2 (D 264-384), 256 x 2 (392-512), 192 x 3 (520-576),
// 256 x 3 (584-768) and 256 x 4 (776-1024).
template <bool ZERO>
int aw_dispatch(const AwParams& P, int nslices, cudaStream_t stream) {
  if (P.sw == 192 && nslices == 2) return aw_launch<192, 2, ZERO>(P, stream);
  if (P.sw == 256 && nslices == 2) return aw_launch<256, 2, ZERO>(P, stream);
  if (P.sw == 192 && nslices == 3) return aw_launch<192, 3, ZERO>(P, stream);
  if (P.sw == 256 && nslices == 3) return aw_launch<256, 3, ZERO>(P, stream);
  if (P.sw == 256 && nslices == 4) return aw_launch<256, 4, ZERO>(P, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// args: AW_ARGS int64 a problem: the device pointers of q, k, v, o and the
// mask (0: none); the (batch, head, row) strides of q, k, v and o, in
// elements; B, H, Sq, Sk. qscale0 / qscale1: each problem's q scale. Every
// operand is bf16 (B, H, S, dw) with its columns packed and 16-byte aligned,
// its strides multiples of 8; a batch stride of 0 on q, k or v reads one
// batch row for every batch row (K2's query table). dw: the head width, a
// multiple of 8 up to 1024. The plan (the host's, ops/attention.py:
// wide_plan): the slice width sw (192 or 256) and the slices (2 to 4: the
// cluster's blocks; (nslices - 1) sw < dw <= nslices sw). Returns 0, a CUDA
// error code (cudaErrorInvalidValue for arguments the kernel does not take),
// or 1000 + the CUresult of encoding a tensor map.
extern "C" int btia_attn_wide(const long long* args, int nprob, float qscale0, float qscale1, int dw, int sw,
                              int nslices, int mask_bytes, int mult_mask, void* stream) {
  if (nprob < 1 || nprob > 2 || dw < 8 || dw % 8 != 0 || dw > AW_MAX_D || (mask_bytes != 1 && mask_bytes != 4) ||
      (sw != 192 && sw != 256) || nslices < 2 || nslices * sw < dw || (nslices - 1) * sw >= dw)
    return static_cast<int>(cudaErrorInvalidValue);
  AwParams P;
  memset(&P, 0, sizeof(P));
  P.np = nprob;
  P.dw = dw;
  P.sw = sw;
  P.mask_bytes = mask_bytes;
  long long total = 0;
  for (int i = 0; i < nprob; ++i) {
    AwProblem& pr = P.pr[i];
    const long long* a = args + AW_ARGS * i;
    const long long* st = a + 5;
    if (a[17] < 1 || a[18] < 1 || a[19] < 1 || a[20] < 1 || a[17] > 0x7fffffff || a[18] > 0x7fffffff ||
        a[19] > 0x7fffffff || a[20] > 0x7fffffff)
      return static_cast<int>(cudaErrorInvalidValue);
    pr.B = static_cast<int>(a[17]), pr.H = static_cast<int>(a[18]), pr.Sq = static_cast<int>(a[19]);
    pr.Sk = static_cast<int>(a[20]);
    for (int op = 0; op < 4; ++op) {
      if (a[op] % 16 != 0 || a[op] == 0) return static_cast<int>(cudaErrorInvalidValue);
      for (int d = 0; d < 3; ++d)
        if (st[3 * op + d] % 8 != 0 || st[3 * op + d] < 0 || (d > 0 && st[3 * op + d] == 0))
          return static_cast<int>(cudaErrorInvalidValue);
    }
    if (st[9] == 0 && pr.B > 1) return static_cast<int>(cudaErrorInvalidValue);  // o has a row per batch row
    int* bm[3] = {&pr.qbm, &pr.kbm, &pr.vbm};
    CUtensorMap* maps[3] = {&P.qm[i], &P.km[i], &P.vm[i]};
    for (int op = 0; op < 3; ++op) {
      const int S = op == 0 ? pr.Sq : pr.Sk;
      SfOperand t{reinterpret_cast<const void*>(a[op]), st[3 * op], st[3 * op + 1], st[3 * op + 2]};
      *bm[op] = t.b != 0;
      if (t.b == 0) {  // one batch row for all: a map of B = 1 (its stride any nonzero multiple of 16 bytes)
        const long long span = t.h * pr.H > t.s * S ? t.h * pr.H : t.s * S;
        t.b = span > dw ? span : dw;
      }
      const int err = sf_encode(maps[op], t, *bm[op] ? pr.B : 1, pr.H, S, dw, 64);
      if (err != 0) return err;
    }
    pr.o = reinterpret_cast<bf16*>(a[3]);
    pr.ob = st[9], pr.oh = st[10], pr.os = st[11];
    pr.mask = reinterpret_cast<const void*>(a[4]);
    pr.qscale = i == 0 ? qscale0 : qscale1;
    pr.q_tiles = (pr.Sq + 63) / 64;
    const long long items = static_cast<long long>(pr.B) * pr.H * pr.q_tiles;
    if (items * nslices > 0x3fffffff) return static_cast<int>(cudaErrorInvalidValue);
    pr.items = static_cast<int>(items);
    total += items;
  }
  if (total * nslices > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  P.total = static_cast<int>(total);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mult_mask ? aw_dispatch<true>(P, nslices, s) : aw_dispatch<false>(P, nslices, s);
}
