// K8 on Hopper: y = act((int8(x) @ w_i8) * sx * ws + b), the fused int8 FFN
// matrix product of int8 serving, as two kernels behind one entry.
//
// Replaces btia_tpu/ops/quant.py:87 _int8_mm_kernel (pallas_call at
// quant.py:162, entry int8_matmul_fused), reached from every Mlp's fc1 and
// fc2 under DTypePolicy.int8 in a deterministic forward. The wrappers are
// btia_tpu_torch/ops/quant.py:int8_matmul_fused (the ops API),
// int8_matmul_nk (the model's road, on the weight prepared once per
// version) and int8_matmul_row_parallel (fc2 under a model axis).
//
// What it computes, as the TPU kernel does: per row of x (bf16, M x K),
// sx = max(amax|x|, 1e-8) * f32(1/127) and xi = round_half_even(x * (1/sx))
// with no clip; the exact int32 product xi @ w_i8; then, in f32 and without
// contraction into FMAs, (acc * sx) * ws[n] + b[n], an optional tanh-GELU,
// and one rounding to the output type (bf16, or f32).
//
// What bounds it on an H100: at the int8 serve step of streaming_vitl
// (M = 9,232 to 131,072 rows, K and N 768 to 4096) each call does 2*M*K*N
// int8 operations, 18.1 T a step, against 1,979 TOPS dense int8: ~9.2 ms a
// step, operation-bound at every site except the AD head's two (M 131,072,
// 768 <-> 1536), which are bound by their bytes (bf16 x in, bf16 y out).
//
// Design. The TPU kernel walks a sequential grid and quantizes each (TM, K)
// block of x once, at the first N tile, into VMEM scratch that the later N
// tiles reuse. Hopper's blocks run in parallel with nothing carried between
// them, so each row's scale needs its whole row first:
//
// (a) quant_rows_kernel: one warp per row reads x once in 16-byte vectors
//     held in registers, takes the amax with a warp reduction, and writes xi
//     (M, K) int8 and sx (M,) f32 to scratch the wrapper allocates. Bound by
//     bytes: 3 per element (at ~0.9 of that bound on the card). Instantiated
//     for rows of up to 256 V elements (V = 1 ... 16, K <= 4096: every FFN
//     width of the registered configs); a wider row takes
//     quant_rows_loop_kernel, which reads it twice, the second time from
//     cache. An Mlp runs it on fc1's input only: fc1's GEMM also takes the
//     amax of each row of its bf16 output (AMAX), and fc2's GEMM quantizes
//     that output itself at those amaxes (A16), so the hidden rows are not
//     written and read again as int8 between the two products.
// (b) int8_gemm_kernel, the second design (the first ran one block per 128
//     x 128 tile, drained its products before an epilogue that overlapped
//     nothing but a second block's, and computed the GELU with tanhf):
//     * persistent: one block an SM walks 128 x 256 output tiles (tile =
//       blockIdx.x + i * gridDim.x, N tiles fastest, so the blocks at work
//       share the rows of x in L2 and the weight, at most 4 MB, stays
//       there; grid from ops/quant.py:int8_plan);
//     * warp-specialised: a producer warpgroup gives up its registers
//       (setmaxnreg) and one thread keeps a ring of 48 KB stages full with
//       TMA (one 128-column K chunk of the tile's 128 rows of xi and of the
//       weight's 256 (N, K) rows, 128-byte swizzle, both K-major, the only
//       layout int8 wgmma takes); two consumer warpgroups of 64 rows issue
//       wgmma m64n256k32 s32.s8.s8 with one chunk's products in flight
//       (wgmma_wait<1>);
//     * A16 (fc2 of an Mlp): the ring holds bf16 x (two 64-column boxes a
//       chunk, three 64 KB stages) and the consumers make each 32-column
//       slice's int8 fragment in registers (wgmma's A-in-registers form),
//       at 1/sx of the row's amax, rounding as (a) does, just before its
//       product; one chunk in flight a warpgroup, the other's products
//       covering the conversion. The 168 registers a thread has under a
//       384-thread launch leave ptxas short (C7512: it serialises this
//       instance's products), and this GEMM takes ~1.6x the int8-A one,
//       but less than (a)'s pass plus that GEMM at every fc2 site;
//     * the epilogue: f32 arithmetic in registers, the GELU as y / (1 +
//       exp(-2u)), u = sqrt(2/pi) (y + 0.044715 y^3), the same function as
//       0.5 y (1 + tanh(u)), with ex2.approx and one approximate division
//       (a few f32 ulps; tanh.approx's absolute error of ~5e-4 would be
//       many bf16 steps of a small output), the activation fixed at compile
//       time; bf16 out in 64 x 64 boxes in the 128-byte swizzle that leave
//       by TMA store, which clips rows past M and columns past N, while the
//       producer loads the next tile; AMAX: a quad's maxima of its rows,
//       one atomic max each on the bits of the non-negative floats. f32 and
//       int32 outputs (the ops API's f32, the raw accumulators of the
//       row-parallel road) and a bf16 N % 8 != 0 (no tensor map) are
//       stored from registers.
//     What did not pay (compare_kernels.py k8 on the card): ping-pong
//     consumers on 64 x 256 tiles of their own (the epilogue overlapped,
//     but twice the weight's bytes from L2 per operation: 1.03x slower with
//     the GELU, 1.2x without); the activation as a runtime argument (the
//     GELU sites 1.3x slower); f32(int32) on the integer and FMA units
//     instead of the conversion unit (the epilogue is issue-bound: 1.08x);
//     288 threads with a producer warp (still 168 registers a thread:
//     three warps share a sub-partition's register file).
//     K % 16 == 0 is the only shape rule (the tensor map's row stride); TMA
//     zero-fills a K tail past a chunk and rows past M and N, and zeros add
//     nothing.
// (c) int8_dequant_kernel: (b)'s epilogue alone, on int32 accumulators that
//     the row-parallel road summed over the model group.

#include "common.cuh"
#include "hopper.cuh"

__device__ __forceinline__ float dequant(int acc, float s, float w, float b, bool has_bias, int act) {
  float v = __fmul_rn(__fmul_rn(static_cast<float>(acc), s), w);
  if (has_bias) v = __fadd_rn(v, b);
  return act == 1 ? gelu_tanh(v) : v;
}

__device__ __forceinline__ unsigned quant4(__nv_bfloat162 lo, __nv_bfloat162 hi, float inv) {
  float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  unsigned q0 = static_cast<unsigned>(__float2int_rn(__fmul_rn(a.x, inv))) & 0xffu;
  unsigned q1 = static_cast<unsigned>(__float2int_rn(__fmul_rn(a.y, inv))) & 0xffu;
  unsigned q2 = static_cast<unsigned>(__float2int_rn(__fmul_rn(b.x, inv))) & 0xffu;
  unsigned q3 = static_cast<unsigned>(__float2int_rn(__fmul_rn(b.y, inv))) & 0xffu;
  return q0 | (q1 << 8) | (q2 << 16) | (q3 << 24);
}

// ---------------------------------------------------------------------------
// (a) Row quantization: one warp per row, 8 rows per block.
// ---------------------------------------------------------------------------

constexpr int QR_ROWS = 8;

__device__ __forceinline__ float amax8(const uint4& v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
  }
  return m;
}

__device__ __forceinline__ void store_q8(int8_t* dst, const uint4& v, float inv) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  *reinterpret_cast<uint2*>(dst) = make_uint2(quant4(h[0], h[1], inv), quant4(h[2], h[3], inv));
}

__device__ __forceinline__ float row_scale(float amax, float* inv) {
  const float s = fmaxf(amax, 1e-8f) * (1.0f / 127.0f);
  *inv = 1.0f / s;  // IEEE division: no --use_fast_math
  return s;
}

// K <= 256 * V: the row stays in registers between the amax and the writes.
template <int V>
__global__ void __launch_bounds__(32 * QR_ROWS)
quant_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xi, float* __restrict__ sx, int M, int K) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * QR_ROWS + threadIdx.x / 32;
  if (row >= M) return;
  const bf16* xr = x + row * K;
  uint4 v[V];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = (i * 32 + lane) * 8;
    v[i] = c < K ? *reinterpret_cast<const uint4*>(xr + c) : make_uint4(0u, 0u, 0u, 0u);
    amax = fmaxf(amax, amax8(v[i]));
  }
  float inv;
  const float s = row_scale(warp_max(amax), &inv);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = (i * 32 + lane) * 8;
    if (c < K) store_q8(xi + row * K + c, v[i], inv);
  }
  if (lane == 0) sx[row] = s;
}

// Any K: two passes over the row (the second from the cache).
__global__ void __launch_bounds__(32 * QR_ROWS)
quant_rows_loop_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xi, float* __restrict__ sx, int M, int K) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * QR_ROWS + threadIdx.x / 32;
  if (row >= M) return;
  const bf16* xr = x + row * K;
  float amax = 0.f;
  for (int c = lane * 8; c < K; c += 256) amax = fmaxf(amax, amax8(*reinterpret_cast<const uint4*>(xr + c)));
  float inv;
  const float s = row_scale(warp_max(amax), &inv);
  for (int c = lane * 8; c < K; c += 256) store_q8(xi + row * K + c, *reinterpret_cast<const uint4*>(xr + c), inv);
  if (lane == 0) sx[row] = s;
}

// ---------------------------------------------------------------------------
// (b) The persistent, warp-specialised int8 wgmma GEMM with the epilogue.
// ---------------------------------------------------------------------------

constexpr int G_BM = 128, G_BN = 256, G_BK = 128;  // tile rows, columns; K elements a stage
constexpr int G_B_BYTES = G_BN * G_BK;              // 32 KB of the weight a stage
constexpr int G_OUT_BLK = 64 * 128;                 // one 64 x 64 bf16 output box
constexpr int G_THREADS = 384;  // 2 consumer warpgroups + 1 producer warpgroup
// Output modes: bf16 by TMA store; bf16, f32 or int32 (the raw
// accumulators) from registers.
constexpr int OUT_BF16_TMA = 0, OUT_BF16 = 1, OUT_F32 = 2, OUT_S32 = 3;

// A16: the A operand is bf16 x, quantized by the consumers on its way from
// shared memory into wgmma's registers, instead of the row quantization's
// int8 xi read from shared memory by wgmma.
template <bool A16>
struct K8Layout {
  static constexpr int A_BYTES = G_BM * G_BK * (A16 ? 2 : 1);  // bf16: two boxes of 64 columns
  static constexpr int STAGES = A16 ? 3 : 4;
  static constexpr int STAGE_BYTES = A_BYTES + G_B_BYTES;
  static constexpr int OUT_OFF = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = OUT_OFF + 2 * 2 * G_OUT_BLK;  // two boxes a consumer warpgroup
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;  // barriers; slack to align the base to 1 KB
};

template <int OUT>
__device__ __forceinline__ void store_direct(void* y, long long off, int acc0, int acc1, float s, float w0, float w1,
                                             float b0, float b1, bool has_bias, int act, bool two, bool vec) {
  if constexpr (OUT == OUT_S32) {
    int* p = static_cast<int*>(y) + off;
    if (two && vec) *reinterpret_cast<int2*>(p) = make_int2(acc0, acc1);
    else {
      p[0] = acc0;
      if (two) p[1] = acc1;
    }
  } else {
    const float v0 = dequant(acc0, s, w0, b0, has_bias, act), v1 = dequant(acc1, s, w1, b1, has_bias, act);
    if constexpr (OUT == OUT_F32) {
      float* p = static_cast<float*>(y) + off;
      if (two && vec) *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      else {
        p[0] = v0;
        if (two) p[1] = v1;
      }
    } else {
      bf16* p = static_cast<bf16*>(y) + off;
      if (two && vec) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
      else {
        p[0] = __float2bfloat16(v0);
        if (two) p[1] = __float2bfloat16(v1);
      }
    }
  }
}

// Four bf16 (a row's 8 bytes) quantized at 1/s as quant4 does, round half
// to even through the 1.5 * 2^23 trick (|x / s| <= 127: the low byte of
// the sum's bits is the int8), packed four to a register.
__device__ __forceinline__ uint32_t quant4_bf16(uint2 v, float inv) {
  const float f0 = __uint_as_float(v.x << 16), f1 = __uint_as_float(v.x & 0xffff0000u);
  const float f2 = __uint_as_float(v.y << 16), f3 = __uint_as_float(v.y & 0xffff0000u);
  const uint32_t q0 = __float_as_uint(__fadd_rn(__fmul_rn(f0, inv), 12582912.f));
  const uint32_t q1 = __float_as_uint(__fadd_rn(__fmul_rn(f1, inv), 12582912.f));
  const uint32_t q2 = __float_as_uint(__fadd_rn(__fmul_rn(f2, inv), 12582912.f));
  const uint32_t q3 = __float_as_uint(__fadd_rn(__fmul_rn(f3, inv), 12582912.f));
  return __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040), 0x5410);
}

// A16: this thread's A fragment of 32-column slice kk of a K chunk (rows
// ra and ra + 8 of the tile, wgmma's register layout for s8: columns 4 qd
// .. +3 and 16 + 4 qd .. +3), read from the chunk's two 64-column bf16
// boxes in the 128-byte swizzle (ra % 8 == lane / 4) and quantized.
__device__ __forceinline__ void load_a16(uint32_t (&a)[4], const unsigned char* st, int kk, int ra, int qd, float inv0,
                                         float inv1) {
  const int sw = ra % 8, c = (kk % 2) * 4 + qd / 2;
  const unsigned char* r0p = st + (kk / 2) * (G_BM * 128) + ra * 128 + (qd % 2) * 8;
  const unsigned char* r1p = r0p + 8 * 128;
  a[0] = quant4_bf16(*reinterpret_cast<const uint2*>(r0p + ((c ^ sw) * 16)), inv0);
  a[1] = quant4_bf16(*reinterpret_cast<const uint2*>(r1p + ((c ^ sw) * 16)), inv1);
  a[2] = quant4_bf16(*reinterpret_cast<const uint2*>(r0p + (((c + 2) ^ sw) * 16)), inv0);
  a[3] = quant4_bf16(*reinterpret_cast<const uint2*>(r1p + (((c + 2) ^ sw) * 16)), inv1);
}

// One K chunk's four products, B the chunk's (N, K) weight rows; A int8
// from shared memory, or (A16) each 32-column slice's fragment made just
// before its product. `first`: the chunk overwrites the accumulators.
template <bool A16>
__device__ __forceinline__ void chunk_products(int (&acc)[G_BN / 2], uint32_t (&a)[4][4], const unsigned char* st,
                                               uint32_t a_addr, uint32_t b_addr, int ra, int qd, float inv0,
                                               float inv1, bool first) {
#pragma unroll
  for (int kk = 0; kk < G_BK / 32; ++kk) {
    const uint64_t db = wgmma_desc_sw128(b_addr + kk * 32, 16, 1024);
    if constexpr (A16) {
      load_a16(a[kk], st, kk, ra, qd, inv0, inv1);
      fence_regs(a);
      wgmma_fence();
      wgmma_s8_rs_n256(acc, a[kk], db, !(first && kk == 0));
    } else {
      wgmma_s8_ss_n256(acc, wgmma_desc_sw128(a_addr + kk * 32, 16, 1024), db, !(first && kk == 0));
    }
  }
}

// ACT: 0 or 1 fixed at compile time (the bf16 TMA-store instances), or -1:
// the `act` argument (the others). A16: see K8Layout; a_scale is then each
// row's amax, of which the kernel takes sx, else sx itself. AMAX: also
// write each row's amax |y| of the bf16 output into row_amax (zeroed by the
// caller; atomic max on the bits of non-negative floats).
template <int OUT, int ACT, bool A16, bool AMAX>
__global__ void __launch_bounds__(G_THREADS, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                 const __grid_constant__ CUtensorMap cmap, const float* __restrict__ a_scale,
                 const float* __restrict__ ws, const float* __restrict__ bias, void* __restrict__ y,
                 float* __restrict__ row_amax, int M, int N, int K, int act_arg, int tiles_n, int tiles) {
  using L = K8Layout<A16>;
  const int act = ACT >= 0 ? ACT : act_arg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + L::STAGES;
  const int nk = (K + G_BK - 1) / G_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg == 2) {
    // Producer: one thread keeps the ring full across the block's tiles;
    // the ring's stage and parity run on from one tile to the next.
    setmaxnreg_dec<40>();
    if (t == 0) {
      tma_prefetch_map(&amap);
      tma_prefetch_map(&bmap);
      int s = 0, phase = 0, it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int bm = (tile / tiles_n) * G_BM, bn = (tile % tiles_n) * G_BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          if (it >= L::STAGES) mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full[s], L::STAGE_BYTES);
          unsigned char* st = smem + s * L::STAGE_BYTES;
          tma_load_2d(st, &amap, &full[s], kt * G_BK, bm);
          if constexpr (A16) tma_load_2d(st + G_BM * 128, &amap, &full[s], kt * G_BK + 64, bm);
          tma_load_2d(st + L::A_BYTES, &bmap, &full[s], kt * G_BK, bn);
          if (++s == L::STAGES) s = 0, phase ^= 1;
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
  const int ra = 64 * wg + r0;  // the tile row of this thread's first A fragment row
  unsigned char* out_box = smem + L::OUT_OFF + wg * 2 * G_OUT_BLK;
  const int a_off = wg * 64 * G_BK;
  const bool has_bias = bias != nullptr;
  int s = 0, phase = 0;
  int acc[G_BN / 2];
  uint32_t a[4][4];  // A16: a chunk's fragments (made while the other warpgroup's products run)
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float inv0 = 0.f, inv1 = 0.f;
    if constexpr (A16) {
      const int g0 = (tile / tiles_n) * G_BM + ra;
      row_scale(g0 < M ? a_scale[g0] : 0.f, &inv0);
      row_scale(g0 + 8 < M ? a_scale[g0 + 8] : 0.f, &inv1);
    }

    // Each chunk's products are issued before the previous chunk's are
    // waited for and its stage released. Under A16 the previous chunk's
    // products (which read the same fragment registers) are waited for
    // first, and each 32-column slice's fragment is made just before its
    // product; the other warpgroup's products keep the tensor cores busy
    // meanwhile.
    int prev = s;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[s], phase);
      const unsigned char* st = smem + s * L::STAGE_BYTES;
      if (A16 && kt > 0) {
        wgmma_wait<0>();
        mbar_arrive_if(&empty[prev], lane == 0);
      }
      const uint32_t a_addr = smem_u32(st) + a_off, b_addr = smem_u32(st) + L::A_BYTES;
      if (!A16) wgmma_fence();
      chunk_products<A16>(acc, a, st, a_addr, b_addr, ra, qd, inv0, inv1, kt == 0);
      wgmma_commit();
      if (!A16 && kt > 0) {
        wgmma_wait<1>();
        mbar_arrive_if(&empty[prev], lane == 0);  // this warp has finished reading the previous stage
      }
      prev = s;
      if (++s == L::STAGES) s = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive_if(&empty[prev], lane == 0);

    const int bm = (tile / tiles_n) * G_BM, bn = (tile % tiles_n) * G_BN;
    const int grow = bm + 64 * wg;  // the warpgroup's first output row
    const int g0 = grow + r0, g1 = g0 + 8;
    float s0 = g0 < M ? a_scale[g0] : 0.f, s1 = g1 < M ? a_scale[g1] : 0.f;
    if constexpr (A16) {
      float inv;
      s0 = row_scale(s0, &inv);
      s1 = row_scale(s1, &inv);
    }

    if constexpr (OUT == OUT_BF16_TMA) {
      // 64 x 64 boxes in two buffers in turn, out by TMA store.
      float m0 = 0.f, m1 = 0.f;  // AMAX: the rows' amax of the rounded output
#pragma unroll
      for (int c = 0; c < G_BN / 64; ++c) {
        const int col0 = bn + 64 * c;
        unsigned char* box = out_box + (c & 1) * G_OUT_BLK;
        // The store issued from this box two boxes ago has finished reading it.
        if (t == 0) bulk_wait_read<1>();
        named_barrier(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int jn = 8 * c + jj, col = col0 + 8 * jj + 2 * qd;
          float2 w = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
          if (col < N) {  // N % 8 == 0 here: col + 1 < N too
            w = make_float2(ws[col], ws[col + 1]);
            if (has_bias) b = make_float2(bias[col], bias[col + 1]);
          }
          const __nv_bfloat162 y0 = __floats2bfloat162_rn(dequant(acc[4 * jn], s0, w.x, b.x, has_bias, act),
                                                          dequant(acc[4 * jn + 1], s0, w.y, b.y, has_bias, act));
          const __nv_bfloat162 y1 = __floats2bfloat162_rn(dequant(acc[4 * jn + 2], s1, w.x, b.x, has_bias, act),
                                                          dequant(acc[4 * jn + 3], s1, w.y, b.y, has_bias, act));
          *reinterpret_cast<__nv_bfloat162*>(box + swz_frag(r0, jj, qd)) = y0;
          *reinterpret_cast<__nv_bfloat162*>(box + swz_frag(r0 + 8, jj, qd)) = y1;
          if constexpr (AMAX) {
            const float2 f0 = __bfloat1622float2(y0), f1 = __bfloat1622float2(y1);
            m0 = fmaxf(m0, fmaxf(fabsf(f0.x), fabsf(f0.y)));
            m1 = fmaxf(m1, fmaxf(fabsf(f1.x), fabsf(f1.y)));
          }
        }
        fence_proxy_async();
        named_barrier(1 + wg, 128);
        if (t == 0) {
          if (grow < M && col0 < N) tma_store_2d(&cmap, box, col0, grow);
          bulk_commit();
        }
      }
      if constexpr (AMAX) {
        // The four threads of a quad hold the same two rows.
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
        }
        if (qd == 0 && g0 < M) atomicMax(reinterpret_cast<int*>(row_amax + g0), __float_as_int(m0));
        if (qd == 0 && g1 < M) atomicMax(reinterpret_cast<int*>(row_amax + g1), __float_as_int(m1));
      }
    } else {
      const bool vec = (N % 2) == 0;
#pragma unroll
      for (int jn = 0; jn < G_BN / 8; ++jn) {
        const int col = bn + 8 * jn + 2 * qd;
        if (col >= N) continue;
        const bool two = col + 1 < N;
        const float w0 = ws[col], w1 = two ? ws[col + 1] : 0.f;
        const float b0 = has_bias ? bias[col] : 0.f, b1 = has_bias && two ? bias[col + 1] : 0.f;
        if (g0 < M)
          store_direct<OUT>(y, static_cast<long long>(g0) * N + col, acc[4 * jn], acc[4 * jn + 1], s0, w0, w1, b0, b1,
                            has_bias, act, two, vec);
        if (g1 < M)
          store_direct<OUT>(y, static_cast<long long>(g1) * N + col, acc[4 * jn + 2], acc[4 * jn + 3], s1, w0, w1, b0,
                            b1, has_bias, act, two, vec);
      }
    }
  }
  if (OUT == OUT_BF16_TMA && t == 0) bulk_wait<0>();  // the stores have left shared memory before the block does
}

template <int OUT, int ACT, bool A16, bool AMAX>
static int launch_gemm(const void* a, const void* a_scale, const void* w, const void* ws, const void* bias, void* y,
                       void* row_amax, int M, int N, int K, int act, int grid, cudaStream_t stream) {
  using L = K8Layout<A16>;
  const uint64_t adims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t bdims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(N)};
  const uint64_t astride[1] = {static_cast<uint64_t>(A16 ? 2 * K : K)}, bstride[1] = {static_cast<uint64_t>(K)};
  const uint32_t abox[2] = {A16 ? 64u : static_cast<uint32_t>(G_BK), G_BM}, bbox[2] = {G_BK, G_BN};
  CUtensorMap am, bm, cm;
  int err = encode_map(&am, A16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a, adims,
                       astride, abox);
  if (err == 0) err = encode_map(&bm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, bdims, bstride, bbox);
  if (err == 0 && OUT == OUT_BF16_TMA) {
    const uint64_t cdims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(M)};
    const uint64_t cstride[1] = {2ull * N};
    const uint32_t cbox[2] = {64, 64};
    err = encode_map(&cm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, y, cdims, cstride, cbox);
  } else {
    cm = am;  // not read
  }
  if (err != 0) return err;
  auto kernel = int8_gemm_kernel<OUT, ACT, A16, AMAX>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_n = (N + G_BN - 1) / G_BN, tiles = ((M + G_BM - 1) / G_BM) * tiles_n;
  kernel<<<grid < tiles ? grid : tiles, G_THREADS, L::SMEM, stream>>>(
      am, bm, cm, static_cast<const float*>(a_scale), static_cast<const float*>(ws), static_cast<const float*>(bias),
      y, static_cast<float*>(row_amax), M, N, K, act, tiles_n, tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// (c) The epilogue alone, on int32 accumulators.
// ---------------------------------------------------------------------------

template <typename OutT>
__global__ void __launch_bounds__(256)
int8_dequant_kernel(const int* __restrict__ acc, const float* __restrict__ amax, const float* __restrict__ ws,
                    const float* __restrict__ bias, OutT* __restrict__ y, int M, int N, int act) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(M) * N) return;
  const int row = static_cast<int>(i / N), col = static_cast<int>(i % N);
  const bool has_bias = bias != nullptr;
  float inv;
  const float v = dequant(acc[i], row_scale(amax[row], &inv), ws[col], has_bias ? bias[col] : 0.f, has_bias, act);
  if constexpr (sizeof(OutT) == 4) y[i] = v;
  else y[i] = __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// C interface. Each returns 0, a CUDA error code (cudaGetLastError() after
// the launch), or 1000 + the CUresult of encoding a tensor map.
// ---------------------------------------------------------------------------

// x: (M, K) bf16, 16-byte aligned; xi: (M, K) int8; sx: (M,) f32. K % 16 == 0.
extern "C" int btia_int8_quant_rows(const void* x, void* xi, void* sx, int M, int K, void* stream) {
  if (M < 1 || K < 16 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + QR_ROWS - 1) / QR_ROWS), block(32 * QR_ROWS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  int8_t* qp = static_cast<int8_t*>(xi);
  float* sp = static_cast<float*>(sx);
  const int v = (K + 255) / 256;
  if (v <= 1) quant_rows_kernel<1><<<grid, block, 0, s>>>(xp, qp, sp, M, K);
  else if (v <= 2) quant_rows_kernel<2><<<grid, block, 0, s>>>(xp, qp, sp, M, K);
  else if (v <= 3) quant_rows_kernel<3><<<grid, block, 0, s>>>(xp, qp, sp, M, K);
  else if (v <= 4) quant_rows_kernel<4><<<grid, block, 0, s>>>(xp, qp, sp, M, K);
  else if (v <= 6) quant_rows_kernel<6><<<grid, block, 0, s>>>(xp, qp, sp, M, K);
  else if (v <= 8) quant_rows_kernel<8><<<grid, block, 0, s>>>(xp, qp, sp, M, K);
  else if (v <= 12) quant_rows_kernel<12><<<grid, block, 0, s>>>(xp, qp, sp, M, K);
  else if (v <= 16) quant_rows_kernel<16><<<grid, block, 0, s>>>(xp, qp, sp, M, K);
  else quant_rows_loop_kernel<<<grid, block, 0, s>>>(xp, qp, sp, M, K);
  return static_cast<int>(cudaGetLastError());
}

// a: (M, K), int8 xi (a_bf16 0: a_scale its rows' sx (M,) f32) or bf16 x
// (a_bf16 1: a_scale its rows' amax (M,) f32, from which the kernel takes
// sx and quantizes x as btia_int8_quant_rows would); w: (N, K) int8; each
// 16-byte aligned. ws: (N,) f32; bias: (N,) f32 or null; y: (M, N) bf16
// (out 0), f32 (1) or int32 (2: the raw accumulators; ws, bias and act
// unused). row_amax: null, or (M,) f32 zeroed, into which the amax |y| of
// each row of the bf16 output is taken (out 0, act 1, a_bf16 0). act: 0
// none, 1 tanh-GELU. K % 16 == 0, M, N >= 1; a_bf16 takes out 0 (act 0)
// or 2. grid: the persistent grid's blocks (ops/quant.py:int8_plan), at
// least 1 (at most one a tile is launched).
extern "C" int btia_int8_gemm(const void* a, const void* a_scale, int a_bf16, const void* w, const void* ws,
                              const void* bias, void* y, void* row_amax, int M, int N, int K, int act, int out,
                              int grid, void* stream) {
  if (K % 16 != 0 || M < 1 || N < 1 || grid < 1 || out < 0 || out > 2 || act < 0 || act > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tma_out = out == 0 && N % 8 == 0;  // bf16 rows of 16-byte multiples leave by TMA store
  if (row_amax != nullptr && !(tma_out && act == 1 && !a_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  if (a_bf16 && !((tma_out && act == 0) || out == 2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_bf16)
    return out == 2 ? launch_gemm<OUT_S32, -1, true, false>(a, a_scale, w, ws, bias, y, nullptr, M, N, K, act, grid, s)
                    : launch_gemm<OUT_BF16_TMA, 0, true, false>(a, a_scale, w, ws, bias, y, nullptr, M, N, K, act,
                                                                grid, s);
  if (tma_out) {
    if (row_amax != nullptr)
      return launch_gemm<OUT_BF16_TMA, 1, false, true>(a, a_scale, w, ws, bias, y, row_amax, M, N, K, act, grid, s);
    return act ? launch_gemm<OUT_BF16_TMA, 1, false, false>(a, a_scale, w, ws, bias, y, nullptr, M, N, K, act, grid, s)
               : launch_gemm<OUT_BF16_TMA, 0, false, false>(a, a_scale, w, ws, bias, y, nullptr, M, N, K, act, grid,
                                                            s);
  }
  if (out == 0) return launch_gemm<OUT_BF16, -1, false, false>(a, a_scale, w, ws, bias, y, nullptr, M, N, K, act, grid, s);
  if (out == 1) return launch_gemm<OUT_F32, -1, false, false>(a, a_scale, w, ws, bias, y, nullptr, M, N, K, act, grid, s);
  return launch_gemm<OUT_S32, -1, false, false>(a, a_scale, w, ws, bias, y, nullptr, M, N, K, act, grid, s);
}

// acc: (M, N) int32; amax: (M,) f32, the rows' amax, from which sx is taken
// as btia_int8_quant_rows takes it; ws: (N,) f32; bias: (N,) f32 or null;
// y: (M, N) bf16 (out 0) or f32 (1). act as btia_int8_gemm's.
extern "C" int btia_int8_dequant(const void* acc, const void* amax, const void* ws, const void* bias, void* y, int M,
                                 int N, int act, int out, void* stream) {
  if (M < 1 || N < 1 || out < 0 || out > 1 || act < 0 || act > 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(M) * N;
  const dim3 grid(static_cast<unsigned>((n + 255) / 256));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ap = static_cast<const int*>(acc);
  const float *mp = static_cast<const float*>(amax), *wp = static_cast<const float*>(ws),
              *bp = static_cast<const float*>(bias);
  if (out == 1) int8_dequant_kernel<float><<<grid, 256, 0, s>>>(ap, mp, wp, bp, static_cast<float*>(y), M, N, act);
  else int8_dequant_kernel<bf16><<<grid, 256, 0, s>>>(ap, mp, wp, bp, static_cast<bf16*>(y), M, N, act);
  return static_cast<int>(cudaGetLastError());
}
