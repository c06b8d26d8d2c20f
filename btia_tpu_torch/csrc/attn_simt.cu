// Attention on the CUDA cores (FFMA), for f32 operands at any head width up
// to 1024: the f32 route of all six attention entries.
//
// Replaces, on f32 operands, btia_tpu/ops/fused_attn.py:_fused_kernel and
// _staticq_kernel (K1/K2's attention core), btia_tpu/ops/attention.py:
// _bshd_flash_kernel (K3), _fanout_kernel (K4) and _mha_kernel (K5), and
// btia_tpu/ops/bicross.py:_bicross_pallas's kernel (K6). The TPU kernels
// compute f32 operands in f32; wgmma's f32 input type is TF32, which keeps
// about three decimal digits, so the f32 policy cannot run on the tensor
// cores and be held to the CPU's f32 at 1e-4. Every product here is an f32
// FFMA. (bf16 heads wider than 256 run on the tensor cores, attn_wide.cu.)
//
// What bounds it on an H100: operations at the f32 CUDA-core rate
// (67 TFLOP/s: 128 FFMA a clock an SM) at every call shape of the registered
// configs except the shortest. An FFMA loop that reads its operands from
// shared memory is held back by the SM's shared-memory bandwidth (128 bytes
// a clock, one 16-byte load a clock for eight threads) before it reaches
// that rate, so the design is about loads per FFMA:
//
// * A block of 128 threads (8 x 16) takes 64 query rows (32 where every
//   Sq <= 32) of one (problem, batch row, head, output slice), and loops
//   over key tiles of 64 with an online softmax.
// * Register tiles. A thread holds an 8 x 4 (or 4 x 4) tile of the scores
//   S = Q K^T (rows ty + 8 i, keys tx + 16 j), summed over d in steps of 4
//   from q and k rows in shared memory: one 16-byte load a row and a key per
//   step, 12 loads for 128 FFMAs, each warp's loads two rows and sixteen
//   keys wide, so half the shared-memory bandwidth serves the full FFMA
//   rate. The softmax's row max is a four-step shuffle among the row's 16
//   threads; the row sums stay per thread until the end.
// * O stays in registers: the thread's 8 x 4 (or x 8) output tile
//   accumulates P V with P read back from shared memory (stored key-major,
//   each thread's rows together: one 16-byte load for four rows) and V rows
//   from the key tile. Nothing of O goes to shared memory per key tile.
// * Loads. Each key tile comes in panels of 64 keys x 64 columns (K's
//   columns, then V's), each filled by cp.async into a two-stage ring, so
//   panel i + 1 loads while panel i computes. 16-byte copies where the
//   bases and strides allow (the host checks: ptrs 16-byte aligned, every
//   stride and D multiples of 4), 4-byte copies otherwise; both paths in one
//   kernel. Past Sq, Sk and D the copies zero-fill.
// * Heads up to 128 keep the block's q rows in shared memory for its life.
//   A wider head (no registered config has one) is split over the grid in
//   output slices of 128 columns; each block streams q through the ring with
//   k and recomputes S over the whole width, so a slice costs its own PV
//   and all of QK^T.
//
// Operands are read through (batch, head, row) strides in elements, so one
// kernel serves K1's q and [k|v] rows where the GEMMs leave them, K2's shared
// query table (batch stride 0), K3's and K4's (B, S, H*D), K5's (B, H, S, D)
// views and K6's two directions (two problems of one launch), with no copy.
//
// Two mask modes, each the reference's own:
// * mult_mask = 1 (K1, K2, K4): a -1e9 bias on masked keys before the max,
//   the mask applied AFTER exp2 and the denominator floored at 1e-30, so a
//   fully masked row gives 0 (btia_tpu/ops/fused_attn.py:262-271,
//   btia_tpu/ops/attention.py:399-412);
// * mult_mask = 0 (K3, K5, K6): an additive -1e9 bias, so a fully masked row
//   averages V over the real keys.
// Keys past Sk take no part in either. q is multiplied by qscale
// (scale*log2(e); 1 where the caller prescaled it, K1/K2), as the twins do,
// then the softmax runs in exp2.

#include "common.cuh"

#include <math.h>

namespace {

constexpr int AS_THREADS = 128;  // 8 x 16: rows by ty, keys and output columns by tx
constexpr int AS_BK = 64;        // keys a tile
constexpr int AS_LD = 64 + 4;    // floats a panel row: 64 columns, padded so 16-byte rows cover every bank
constexpr int AS_MAX_D = 1024;
constexpr int AS_ARGS = 21;  // int64 a problem in btia_attn_simt's argument array (attn_wide.cu's AW_ARGS)

struct AsProblem {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  const void* mask;    // (B, Sk) key mask, or null
  long long st[4][3];  // q, k, v, o: (batch, head, row) strides in elements
  int B, H, Sq, Sk;
  float qscale;
  int q_tiles, items;
};

struct AsArgs {
  AsProblem p[2];
  int np, D;
  int mask_bytes;  // 1: bool read as bytes; 4: f32 {0, 1}
  int mult_mask;
  int slice_w, nslices;  // output columns a block, and slices a head
  int vec;               // 16-byte copies and stores
};

// BQ query rows a block; DV output columns a block (64 or 128); QRES: the q
// rows stay in shared memory (D <= DV), else they stream with k.
template <int BQ, int DV, bool QRES>
struct AsLayout {
  static constexpr int TM = BQ / 8;                  // rows a thread
  static constexpr int NV = DV / 64;                 // 64-column output chunks a thread
  static constexpr int QLD = QRES ? DV + 4 : AS_LD;  // floats a resident q row
  static constexpr int Q_FLOATS = QRES ? BQ * QLD : 0;
  // A stage: a K panel (after a q panel when q streams), or a V panel.
  static constexpr int STAGE = (QRES ? AS_BK : BQ + AS_BK) * AS_LD;
  static constexpr int PLD = BQ + 4;  // P, key-major: floats a key
  static constexpr int SMEM = (Q_FLOATS + 2 * STAGE + AS_BK * PLD) * 4;
  static constexpr int MIN_BLOCKS = DV == 64 ? 3 : 2;
};

// Copy rows [0, n_rows) x columns [c0, c0 + 64) of a row-major f32 matrix
// (row stride rs elements) into a panel of ROWS rows of LD floats, zero past
// n_rows and past column D. Thread tid takes the same elements in as_scale.
template <int ROWS, int LD>
__device__ __forceinline__ void as_panel(float* dst, const float* src, long long rs, int n_rows, int c0, int D,
                                         int vec, int tid) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < ROWS * 16 / AS_THREADS; ++i) {
      const int e = tid + i * AS_THREADS, r = e >> 4, c = (e & 15) * 4;
      const bool ok = r < n_rows && c0 + c < D;
      cp_async16(dst + r * LD + c, ok ? src + r * rs + c0 + c : src, ok ? 16 : 0);
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < ROWS * 64 / AS_THREADS; ++i) {
      const int e = tid + i * AS_THREADS, r = e >> 6, c = e & 63;
      const bool ok = r < n_rows && c0 + c < D;
      cp_async4(dst + r * LD + c, ok ? src + r * rs + c0 + c : src, ok ? 4 : 0);
    }
  }
}

// Multiply the q elements this thread copied (as_panel's mapping) by f:
// after cp_async_wait they are visible to this thread, and the barrier that
// follows publishes the scaled values.
template <int ROWS, int LD>
__device__ __forceinline__ void as_scale(float* dst, float f, int vec, int tid) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < ROWS * 16 / AS_THREADS; ++i) {
      const int e = tid + i * AS_THREADS;
      float4* x = reinterpret_cast<float4*>(dst + (e >> 4) * LD + (e & 15) * 4);
      float4 y = *x;
      y.x *= f, y.y *= f, y.z *= f, y.w *= f;
      *x = y;
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < ROWS * 64 / AS_THREADS; ++i) {
      const int e = tid + i * AS_THREADS;
      dst[(e >> 6) * LD + (e & 63)] *= f;
    }
  }
}

// oc[i][e] += sum over keys j < jn of P[j][row i] * V[j][column e]: the
// thread's P values at pb + j * PLD (its TM rows together), its four V
// columns at vb + j * AS_LD.
template <int TM, int PLD>
__device__ __forceinline__ void as_pv(float (&oc)[TM][4], const float* pb, const float* vb, int jn) {
#pragma unroll 4
  for (int j = 0; j < jn; ++j) {
    const float4 vv = *reinterpret_cast<const float4*>(vb + j * AS_LD);
#pragma unroll
    for (int a = 0; a < TM / 4; ++a) {
      const float4 pp = *reinterpret_cast<const float4*>(pb + j * PLD + 4 * a);
      const float pr[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        oc[4 * a + r][0] = fmaf(pr[r], vv.x, oc[4 * a + r][0]);
        oc[4 * a + r][1] = fmaf(pr[r], vv.y, oc[4 * a + r][1]);
        oc[4 * a + r][2] = fmaf(pr[r], vv.z, oc[4 * a + r][2]);
        oc[4 * a + r][3] = fmaf(pr[r], vv.w, oc[4 * a + r][3]);
      }
    }
  }
}

template <int BQ, int DV, bool QRES>
__global__ void __launch_bounds__(AS_THREADS, (AsLayout<BQ, DV, QRES>::MIN_BLOCKS))
attn_simt_kernel(const __grid_constant__ AsArgs A) {
  using L = AsLayout<BQ, DV, QRES>;
  constexpr int TM = L::TM, NV = L::NV;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* stages = smem + L::Q_FLOATS;
  float* Ps = stages + 2 * L::STAGE;

  // The block's item: problem, then batch row and head, output slice, q
  // tile (fastest: the blocks of one head run together and share its K/V in
  // L2).
  int it = blockIdx.x;
  const int pi = (A.np > 1 && it >= A.p[0].items) ? 1 : 0;
  const AsProblem& P = A.p[pi];
  if (pi) it -= A.p[0].items;
  const int qt = it % P.q_tiles;
  it /= P.q_tiles;
  const int sl = it % A.nslices;
  it /= A.nslices;
  const int b = it / P.H, h = it % P.H;
  const int q0 = qt * BQ, v0 = sl * A.slice_w;
  const int D = A.D, tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const float* q = P.q + b * P.st[0][0] + h * P.st[0][1] + q0 * P.st[0][2];
  const float* k = P.k + b * P.st[1][0] + h * P.st[1][1];
  const float* v = P.v + b * P.st[2][0] + h * P.st[2][1];
  const long long qr = P.st[0][2], kr = P.st[1][2], vr = P.st[2][2];
  const int nq = min(BQ, P.Sq - q0);
  const int col_end = min(D, v0 + A.slice_w);
  const int nc = (D + 63) / 64;               // score panels a key tile
  const int nv = (col_end - v0 + 63) / 64;    // V panels a key tile (<= NV)
  const int per_tile = nc + nv;
  const int steps = ((P.Sk + AS_BK - 1) / AS_BK) * per_tile;

  // Step s loads panel s % per_tile of key tile s / per_tile into stage s % 2.
  auto issue = [&](int s) {
    const int kt = s / per_tile, sub = s - kt * per_tile;
    const int k0 = kt * AS_BK, nk = min(AS_BK, P.Sk - k0);
    float* st = stages + (s & 1) * L::STAGE;
    if (sub < nc) {
      if (!QRES) as_panel<BQ, AS_LD>(st, q, qr, nq, sub * 64, D, A.vec, tid);
      as_panel<AS_BK, AS_LD>(st + (QRES ? 0 : BQ * AS_LD), k + k0 * kr, kr, nk, sub * 64, D, A.vec, tid);
    } else {
      as_panel<AS_BK, AS_LD>(st, v + k0 * vr, vr, nk, v0 + (sub - nc) * 64, D, A.vec, tid);
    }
    cp_async_commit();
  };

  if (QRES) {
#pragma unroll
    for (int c = 0; c < DV / 64; ++c) as_panel<BQ, L::QLD>(Qs + c * 64, q, qr, nq, c * 64, D, A.vec, tid);
    cp_async_commit();
  }
  issue(0);

  float o[NV][TM][4], s[TM][4], m_run[TM], l_run[TM], cm[4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][i][e] = 0.f;
  }
  const unsigned char* mask_b = static_cast<const unsigned char*>(P.mask);
  const float* mask_f = static_cast<const float*>(P.mask);

  for (int step = 0; step < steps; ++step) {
    const int kt = step / per_tile, sub = step - kt * per_tile;
    const int k0 = kt * AS_BK;
    float* stg = stages + (step & 1) * L::STAGE;
    cp_async_wait<0>();  // this step's panel (and, first, the resident q rows)
    if (P.qscale != 1.f) {
      if (QRES && step == 0) {
#pragma unroll
        for (int c = 0; c < DV / 64; ++c) as_scale<BQ, L::QLD>(Qs + c * 64, P.qscale, A.vec, tid);
      } else if (!QRES && sub < nc) {
        as_scale<BQ, AS_LD>(stg, P.qscale, A.vec, tid);
      }
    }
    __syncthreads();  // the panel is visible; every thread is done with step - 1's stage
    if (step + 1 < steps) issue(step + 1);

    if (sub < nc) {
      if (sub == 0) {
        // The tile's keys of this thread, their masks loaded now and used
        // after the products.
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          cm[j] = 0.f;
          if (key < P.Sk) {
            const long long at = static_cast<long long>(b) * P.Sk + key;
            cm[j] = P.mask == nullptr ? 1.f : A.mask_bytes == 1 ? (mask_b[at] ? 1.f : 0.f) : mask_f[at];
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
      const float* qb = QRES ? Qs + sub * 64 : stg;
      const float* kb = QRES ? stg : stg + BQ * AS_LD;
      constexpr int QLD = QRES ? L::QLD : AS_LD;
      const int dn = min(64, (D - sub * 64 + 3) & ~3);
#pragma unroll 2
      for (int dd = 0; dd < dn; dd += 4) {
        float4 kv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(kb + (tx + 16 * j) * AS_LD + dd);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qb + (ty + 8 * i) * QLD + dd);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
          }
        }
      }
      if (sub == nc - 1) {
        // Masks, the online softmax update, P to shared memory (key-major,
        // the thread's TM rows together) and O rescaled.
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = k0 + tx + 16 * j < P.Sk;
#pragma unroll
          for (int i = 0; i < TM; ++i) s[i][j] = in ? s[i][j] - (1.f - cm[j]) * 1e9f : -INFINITY;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
          for (int w = 1; w < 16; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
          const float m_new = fmaxf(m_run[i], mx);  // finite: key k0 < Sk is in the tile
          const float alpha = exp2f(m_run[i] - m_new);
          m_run[i] = m_new;
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float e = exp2f(s[i][j] - m_new);
            if (A.mult_mask) e *= cm[j];
            s[i][j] = e;
            ps += e;
          }
          l_run[i] = l_run[i] * alpha + ps;
#pragma unroll
          for (int c = 0; c < NV; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[c][i][e] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int a = 0; a < TM / 4; ++a)
            *reinterpret_cast<float4*>(Ps + (tx + 16 * j) * L::PLD + ty * TM + 4 * a) =
                make_float4(s[4 * a][j], s[4 * a + 1][j], s[4 * a + 2][j], s[4 * a + 3][j]);
      }
    } else {
      // O[:, chunk] += P V over the tile's live keys; each branch names its
      // chunk's array, so o stays in registers.
      const int jn = min(AS_BK, P.Sk - k0);
      const float* pb = Ps + ty * TM;
      const float* vb = stg + tx * 4;
      if (sub == nc)
        as_pv<TM, L::PLD>(o[0], pb, vb, jn);
      else
        as_pv<TM, L::PLD>(o[NV - 1], pb, vb, jn);
    }
  }

  // The row sums live in the row's 16 threads; divide once and store the
  // slice's columns [v0, col_end) of rows [q0, Sq).
  float* ob = P.o + b * P.st[3][0] + h * P.st[3][1];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int w = 1; w < 16; w <<= 1) l += __shfl_xor_sync(0xffffffffu, l, w);
    if (A.mult_mask) l = fmaxf(l, 1e-30f);
    const int row = q0 + ty + 8 * i;
    if (row >= P.Sq) continue;
    float* orow = ob + row * P.st[3][2];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = v0 + c * 64 + tx * 4;
      if (col >= col_end) continue;
      const float4 y = make_float4(o[c][i][0] / l, o[c][i][1] / l, o[c][i][2] / l, o[c][i][3] / l);
      if (A.vec) {
        *reinterpret_cast<float4*>(orow + col) = y;
      } else {
        const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < col_end) orow[col + e] = ys[e];
      }
    }
  }
}

template <int BQ, int DV, bool QRES>
int as_launch(const AsArgs& args, long long total, cudaStream_t stream) {
  using L = AsLayout<BQ, DV, QRES>;
  auto kernel = attn_simt_kernel<BQ, DV, QRES>;
  static bool configured = false;  // once an instance: host calls cost as much as a short launch
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  kernel<<<static_cast<unsigned>(total), AS_THREADS, L::SMEM, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int BQ>
int as_dispatch(const AsArgs& args, long long total, cudaStream_t stream) {
  if (args.nslices > 1) return as_launch<BQ, 128, false>(args, total, stream);
  if (args.slice_w == 64) return as_launch<BQ, 64, true>(args, total, stream);
  return as_launch<BQ, 128, true>(args, total, stream);
}

}  // namespace

// args: AS_ARGS int64 a problem, the array attn_wide.cu's entry reads: the
// device pointers of q, k, v, o and the mask (0: none); the (batch, head,
// row) strides of q, k, v and o, in elements, the columns packed; B, H, Sq,
// Sk. qscale0 / qscale1: each problem's q scale. nprob is 1 or 2 (K6's two
// directions). plan (the host's, ops/attention.py:simt_plan): query rows a
// block (32 or 64), output columns a block (64 for D <= 64, else 128; a
// wider head is split into ceil(D / 128) slices) and the load path (1:
// 16-byte copies and stores, which needs 16-byte aligned pointers and
// strides and D multiples of 4; 0: 4-byte). Returns 0 or a CUDA error code
// (cudaErrorInvalidValue for arguments the kernel does not take, a plan
// among them).
extern "C" int btia_attn_simt(const long long* args_in, int nprob, float qscale0, float qscale1, int D,
                              int mask_bytes, int mult_mask, const int* plan, void* stream) {
  const int bq = plan[0], slice_w = plan[1], vec = plan[2];
  if (nprob < 1 || nprob > 2 || D < 1 || D > AS_MAX_D || (mask_bytes != 1 && mask_bytes != 4) ||
      (bq != 32 && bq != 64) || !(slice_w == 128 || (slice_w == 64 && D <= 64)) || (vec != 0 && vec != 1) ||
      (vec && D % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  AsArgs args = {};
  args.np = nprob;
  args.D = D;
  args.mask_bytes = mask_bytes;
  args.mult_mask = mult_mask;
  args.slice_w = slice_w;
  args.nslices = (D + slice_w - 1) / slice_w;
  args.vec = vec;
  long long total = 0;
  for (int i = 0; i < nprob; ++i) {
    AsProblem& p = args.p[i];
    const long long* a = args_in + AS_ARGS * i;
    p.q = reinterpret_cast<const float*>(a[0]);
    p.k = reinterpret_cast<const float*>(a[1]);
    p.v = reinterpret_cast<const float*>(a[2]);
    p.o = reinterpret_cast<float*>(a[3]);
    p.mask = reinterpret_cast<const void*>(a[4]);
    for (int t = 0; t < 4; ++t)
      for (int d = 0; d < 3; ++d) {
        p.st[t][d] = a[5 + 3 * t + d];
        if (vec && p.st[t][d] % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
      }
    if (vec)
      for (int t = 0; t < 4; ++t)
        if (a[t] % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    for (int d = 17; d < 21; ++d)
      if (a[d] < 1 || a[d] > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    p.B = static_cast<int>(a[17]), p.H = static_cast<int>(a[18]), p.Sq = static_cast<int>(a[19]);
    p.Sk = static_cast<int>(a[20]);
    p.qscale = i == 0 ? qscale0 : qscale1;
    p.q_tiles = (p.Sq + bq - 1) / bq;
    const long long items = static_cast<long long>(p.B) * p.H * p.q_tiles * args.nslices;
    if (items > 0x3fffffff) return static_cast<int>(cudaErrorInvalidValue);
    p.items = static_cast<int>(items);
    total += items;
  }
  if (total > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bq == 64 ? as_dispatch<64>(args, total, s) : as_dispatch<32>(args, total, s);
}
