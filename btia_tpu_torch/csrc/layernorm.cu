// K7 on Hopper: row LayerNorm with f32 statistics and the fast variance
// max(0, E[x^2] - E[x]^2), forward and backward.
//
// Replaces btia_tpu/ops/norms.py:_ln_kernel (wrapper _layernorm_pallas,
// behind the custom_vjp _layernorm_fast), and that custom_vjp's backward,
// _layernorm_fast_bwd (the vjp of _ln_exact, which XLA fuses on the TPU). The
// wrappers are btia_tpu_torch/ops/norms.py:_layernorm_cuda, behind the
// entries layernorm (every LayerNorm of the models) and layernorm_fast (the
// ops API), and _layernorm_bwd_cuda, behind layernorm_backward (the backward
// of both). K1's LayerNorm prologue and post-LN epilogue (ops/fused_attn.py)
// launch the same forward.
//
// What bounds it on an H100: a few operations per element over one read and
// one write of every row (the backward: two reads, x and the incoming
// gradient, and one write), so bytes. The serve step's largest site,
// 131072 x 768 bf16, moves ~0.4 GB: ~0.12 ms at 3.35 TB/s. The TPU kernel
// keeps a 512-row block in VMEM; here a row lives in registers, so no
// statistic or intermediate goes back to device memory. The design, for the
// card's memory system:
//
// - 16-byte accesses: a thread reads and writes 8 bf16 or 4 f32 values an
//   instruction wherever the width is a multiple of that and the pointers
//   are 16-byte aligned (every registered config's widths); other widths
//   take the same kernels one element at a time.
// - Persistent row groups: a group of 1-8 warps takes a row, sized so that
//   a thread holds at most 24 values (16 one at a time); the grid is one
//   wave (the blocks an SM holds, from the occupancy query, times the SMs)
//   and each group walks over rows, keeping its columns' scale and bias in
//   registers: read once a group, not once a row.
// - The next row in flight: a group issues the loads of its next row before
//   the reduction of the current one.
// - Rows wider than the register kernels hold (past 4096 columns, the TPU
//   kernel takes any width) go to two-read kernels of 512 threads a row:
//   the second read of an element mostly from L2, and by the thread that
//   first read it.
//
// x and y may be the same buffer: a thread writes only the elements it has
// read, after reading them, and a group's next row is another row.
//
// Forward arithmetic as the TPU kernel's: mean and mean of squares in f32,
// var = max(0, mean2 - mean^2), rsqrt(var + eps), then ((x - mean) * inv) *
// scale + bias in f32 without contraction into FMAs, cast to x's type (bf16
// or f32).
//
// Backward: from x, scale and the incoming gradient g, the vjp of that
// arithmetic (ops/norms.py:_ln_exact). A row's mean and inv are recomputed
// from x as the forward computes them, so the forward saves nothing. With
// gs = g * scale and xh = (x - mean) * inv,
//   dx = inv * (gs - mean(gs) - keep * xh * mean(gs * xh)),
// in f32, cast once; keep = (mean2 - mean^2 >= 0), torch.clamp_min's rule
// (its gradient passes where the input is at or above the bound): on rows
// where the clamp cuts the variance, the variance's path carries nothing.
// dscale = sum over rows of g * xh and dbias = sum of g, in f32: each thread
// adds its columns over its group's rows in registers, a block adds its
// groups' sums in shared memory in a fixed order and writes one partial row,
// and a second kernel adds the blocks' partial rows in a fixed order. No
// float atomics: two calls on the same inputs give the same bits.

#include "common.cuh"

namespace {

constexpr int LN_THREADS = 256;  // threads of the row kernels' blocks: 8 warps
constexpr int LN_WARPS = LN_THREADS / 32;
constexpr int LN_WIDE = 512;     // threads of the two-read kernels (a row a block)
constexpr int LN_MAX_DEVICES = 64;
constexpr int LN_NO_ROW_CFG = -1;  // the width is past the register kernels

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float ln_out(float x, float mean, float inv, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(x - mean, inv), scale), bias);
}

// A row's mean and inv from its sums; keep: the variance's clamp passes the
// gradient (mean2 - mean^2 >= 0), both rounded as _ln_exact rounds them.
struct RowStats {
  float mean, inv;
  bool keep;
};
__device__ __forceinline__ RowStats row_stats(float s, float s2, int D, float eps) {
  const float mean = s / D;
  const float d = __fsub_rn(s2 / D, __fmul_rn(mean, mean));
  return {mean, rsqrtf(fmaxf(0.f, d) + eps), d >= 0.f};
}

// VEC values of T moved by one instruction (16 bytes when VEC * sizeof(T) is).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// VEC f32 values from p, as 16-byte loads where VEC % 4 == 0 (p aligned).
template <int VEC>
__device__ __forceinline__ void load_f32(float (&d)[VEC], const float* p) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + k);
      d[k] = t.x;
      d[k + 1] = t.y;
      d[k + 2] = t.z;
      d[k + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) d[k] = p[k];
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float (&d)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) *reinterpret_cast<float4*>(p + k) = make_float4(d[k], d[k + 1], d[k + 2], d[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = d[k];
  }
}

// A thread's NPT packs of a row: packs gt + GT * i, those below nv.
template <typename T, int VEC, int NPT, int GT>
__device__ __forceinline__ void load_row(Pack<T, VEC> (&p)[NPT], const T* row, int gt, int nv) {
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int j = gt + GT * i;
    if (j < nv) p[i] = reinterpret_cast<const Pack<T, VEC>*>(row)[j];
  }
}

// a and b summed over the WPR warps of a row group (warps first .. first +
// WPR of the block). Above one warp through red, whose two buffers take
// turns (`phase`), so that one barrier a call keeps a fast warp's next
// write off a slow warp's read. The warps' sums are added in a fixed order.
template <int WPR, int NWARPS>
__device__ __forceinline__ void group_sum2(float& a, float& b, float (*red)[2][NWARPS], int& phase) {
  a = warp_sum(a);
  b = warp_sum(b);
  if constexpr (WPR > 1) {
    const int warp = threadIdx.x >> 5, first = warp - warp % WPR;
    if ((threadIdx.x & 31) == 0) {
      red[phase][0][warp] = a;
      red[phase][1][warp] = b;
    }
    __syncthreads();
    a = 0.f;
    b = 0.f;
#pragma unroll
    for (int w = 0; w < WPR; ++w) {
      a += red[phase][0][first + w];
      b += red[phase][1][first + w];
    }
    phase ^= 1;
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Rows of D = nv * VEC columns (D <= GT * NPT * VEC), a group of WPR warps a
// row, LN_THREADS / GT groups a block; the block walks rows base + group,
// base stepping by the grid's groups, every thread the same number of turns
// (the groups of a block share barriers when WPR > 1).
template <typename T, int VEC, int NPT, int WPR>
__global__ void __launch_bounds__(LN_THREADS, 2)
ln_rows_kernel(const T* x, T* y, const float* __restrict__ scale, const float* __restrict__ bias, int M, int D,
               float eps) {
  constexpr int GT = 32 * WPR, GPB = LN_THREADS / GT;
  using P = Pack<T, VEC>;
  __shared__ float red[2][2][LN_WARPS];
  const int grp = threadIdx.x / GT, gt = threadIdx.x % GT, nv = D / VEC;
  float sc[NPT][VEC], bi[NPT][VEC];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int j = gt + GT * i;
    if (j < nv) {
      load_f32<VEC>(sc[i], scale + j * VEC);
      load_f32<VEC>(bi[i], bias + j * VEC);
    }
  }
  const long long step = static_cast<long long>(gridDim.x) * GPB;
  long long r = static_cast<long long>(blockIdx.x) * GPB + grp;
  P cur[NPT], nxt[NPT];
  if (r < M) load_row<T, VEC, NPT, GT>(cur, x + r * D, gt, nv);
  int phase = 0;
  for (long long base = r - grp; base < M; base += step, r += step) {
    const bool live = r < M;
    if (r + step < M) load_row<T, VEC, NPT, GT>(nxt, x + (r + step) * D, gt, nv);
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      if (live && gt + GT * i < nv) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float v = to_f32<T>(cur[i].v[k]);
          s += v;
          s2 += v * v;
        }
      }
    }
    group_sum2<WPR, LN_WARPS>(s, s2, red, phase);
    if (live) {
      const RowStats st = row_stats(s, s2, D, eps);
      T* yr = y + r * D;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const int j = gt + GT * i;
        if (j < nv) {
          P o;
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            o.v[k] = from_f32<T>(ln_out(to_f32<T>(cur[i].v[k]), st.mean, st.inv, sc[i][k], bi[i][k]));
          reinterpret_cast<P*>(yr)[j] = o;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NPT; ++i) cur[i] = nxt[i];
  }
}

// A block a row for rows past the register kernels, any width: the row is
// read twice, each element by the same thread.
template <typename T, int VEC>
__global__ void __launch_bounds__(LN_WIDE)
ln_wide_kernel(const T* x, T* y, const float* __restrict__ scale, const float* __restrict__ bias, int D, float eps) {
  using P = Pack<T, VEC>;
  __shared__ float red[2][2][LN_WIDE / 32];
  const int nv = D / VEC;
  const P* xr = reinterpret_cast<const P*>(x + static_cast<long long>(blockIdx.x) * D);
  P* yr = reinterpret_cast<P*>(y + static_cast<long long>(blockIdx.x) * D);
  float s = 0.f, s2 = 0.f;
  for (int j = threadIdx.x; j < nv; j += LN_WIDE) {
    const P p = xr[j];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float v = to_f32<T>(p.v[k]);
      s += v;
      s2 += v * v;
    }
  }
  int phase = 0;
  group_sum2<LN_WIDE / 32, LN_WIDE / 32>(s, s2, red, phase);
  const RowStats st = row_stats(s, s2, D, eps);
  for (int j = threadIdx.x; j < nv; j += LN_WIDE) {
    const P p = xr[j];
    float sc[VEC], bi[VEC];
    load_f32<VEC>(sc, scale + j * VEC);
    load_f32<VEC>(bi, bias + j * VEC);
    P o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<T>(ln_out(to_f32<T>(p.v[k]), st.mean, st.inv, sc[k], bi[k]));
    yr[j] = o;
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// The row kernels' layout (as ln_rows_kernel). dx may be null (x needs no
// gradient); part null when neither dscale nor dbias is wanted, else the
// block's partial row part[blockIdx.x] = (sum g * xh | sum g) over its rows.
template <typename T, int VEC, int NPT, int WPR>
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ scale,
                   T* __restrict__ dx, float* __restrict__ part, int M, int D, float eps) {
  constexpr int GT = 32 * WPR, GPB = LN_THREADS / GT, COLS = GT * NPT * VEC;
  using P = Pack<T, VEC>;
  __shared__ float red[2][2][LN_WARPS];
  __shared__ __align__(16) float cols[GPB > 1 ? GPB / 2 : 1][2][GPB > 1 ? COLS : 1];
  const int grp = threadIdx.x / GT, gt = threadIdx.x % GT, nv = D / VEC;
  float sc[NPT][VEC], ags[NPT][VEC], agb[NPT][VEC];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    if (gt + GT * i < nv) load_f32<VEC>(sc[i], scale + (gt + GT * i) * VEC);
#pragma unroll
    for (int k = 0; k < VEC; ++k) ags[i][k] = agb[i][k] = 0.f;
  }
  const long long step = static_cast<long long>(gridDim.x) * GPB;
  long long r = static_cast<long long>(blockIdx.x) * GPB + grp;
  P cx[NPT], cg[NPT], nx[NPT], ng[NPT];
  if (r < M) {
    load_row<T, VEC, NPT, GT>(cx, x + r * D, gt, nv);
    load_row<T, VEC, NPT, GT>(cg, g + r * D, gt, nv);
  }
  int phase = 0;
  for (long long base = r - grp; base < M; base += step, r += step) {
    const bool live = r < M;
    if (r + step < M) {
      load_row<T, VEC, NPT, GT>(nx, x + (r + step) * D, gt, nv);
      load_row<T, VEC, NPT, GT>(ng, g + (r + step) * D, gt, nv);
    }
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      if (live && gt + GT * i < nv) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float v = to_f32<T>(cx[i].v[k]);
          s += v;
          s2 += v * v;
        }
      }
    }
    group_sum2<WPR, LN_WARPS>(s, s2, red, phase);
    const RowStats st = row_stats(s, s2, D, eps);
    float a = 0.f, b = 0.f;  // sum gs, sum gs * xh
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      if (live && gt + GT * i < nv) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float gs = to_f32<T>(cg[i].v[k]) * sc[i][k];
          a += gs;
          b += gs * __fmul_rn(to_f32<T>(cx[i].v[k]) - st.mean, st.inv);
        }
      }
    }
    group_sum2<WPR, LN_WARPS>(a, b, red, phase);
    if (live) {
      const float ma = a / D, mb = st.keep ? b / D : 0.f;
      T* dxr = dx ? dx + r * D : nullptr;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const int j = gt + GT * i;
        if (j < nv) {
          P o;
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float gv = to_f32<T>(cg[i].v[k]);
            const float xh = __fmul_rn(to_f32<T>(cx[i].v[k]) - st.mean, st.inv);
            o.v[k] = from_f32<T>(st.inv * (gv * sc[i][k] - ma - xh * mb));
            ags[i][k] += gv * xh;
            agb[i][k] += gv;
          }
          if (dxr) reinterpret_cast<P*>(dxr)[j] = o;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      cx[i] = nx[i];
      cg[i] = ng[i];
    }
  }
  if (!part) return;
  // The block's groups' column sums, pairwise in a fixed order: at each
  // level the upper half of the groups hands its sums to the lower half.
  if constexpr (GPB > 1) {
#pragma unroll
    for (int h = GPB / 2; h >= 1; h >>= 1) {
      if (grp >= h && grp < 2 * h) {
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          const int c = (gt + GT * i) * VEC;
          store_f32<VEC>(&cols[grp - h][0][c], ags[i]);
          store_f32<VEC>(&cols[grp - h][1][c], agb[i]);
        }
      }
      __syncthreads();
      if (grp < h) {
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          const int c = (gt + GT * i) * VEC;
          float us[VEC], ub[VEC];
          load_f32<VEC>(us, &cols[grp][0][c]);
          load_f32<VEC>(ub, &cols[grp][1][c]);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            ags[i][k] += us[k];
            agb[i][k] += ub[k];
          }
        }
      }
      __syncthreads();
    }
  }
  if (grp != 0) return;
  float* pr = part + static_cast<long long>(blockIdx.x) * 2 * D;
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int j = gt + GT * i;
    if (j < nv) {
      store_f32<VEC>(pr + j * VEC, ags[i]);
      store_f32<VEC>(pr + D + j * VEC, agb[i]);
    }
  }
}

// A block a row for rows past the register kernels, walking rows by the
// grid: three reads of a row (sums of x; sums of gs and gs * xh; dx), each
// element by the same thread. The block's partial row is kept in device
// memory (mostly L2), each element added by the thread that owns it.
template <typename T, int VEC>
__global__ void __launch_bounds__(LN_WIDE)
ln_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ scale,
                   T* __restrict__ dx, float* __restrict__ part, int M, int D, float eps) {
  using P = Pack<T, VEC>;
  __shared__ float red[2][2][LN_WIDE / 32];
  const int nv = D / VEC;
  float* pr = part ? part + static_cast<long long>(blockIdx.x) * 2 * D : nullptr;
  int phase = 0;
  for (long long r = blockIdx.x; r < M; r += gridDim.x) {
    const P* xr = reinterpret_cast<const P*>(x + r * D);
    const P* gr = reinterpret_cast<const P*>(g + r * D);
    float s = 0.f, s2 = 0.f;
    for (int j = threadIdx.x; j < nv; j += LN_WIDE) {
      const P p = xr[j];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float v = to_f32<T>(p.v[k]);
        s += v;
        s2 += v * v;
      }
    }
    group_sum2<LN_WIDE / 32, LN_WIDE / 32>(s, s2, red, phase);
    const RowStats st = row_stats(s, s2, D, eps);
    float a = 0.f, b = 0.f;
    for (int j = threadIdx.x; j < nv; j += LN_WIDE) {
      const P p = xr[j], q = gr[j];
      float sc[VEC];
      load_f32<VEC>(sc, scale + j * VEC);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float gs = to_f32<T>(q.v[k]) * sc[k];
        a += gs;
        b += gs * __fmul_rn(to_f32<T>(p.v[k]) - st.mean, st.inv);
      }
    }
    group_sum2<LN_WIDE / 32, LN_WIDE / 32>(a, b, red, phase);
    const float ma = a / D, mb = st.keep ? b / D : 0.f;
    const bool first = r == blockIdx.x;
    for (int j = threadIdx.x; j < nv; j += LN_WIDE) {
      const P p = xr[j], q = gr[j];
      float sc[VEC], ps[VEC], pb[VEC];
      load_f32<VEC>(sc, scale + j * VEC);
      if (pr && !first) {
        load_f32<VEC>(ps, pr + j * VEC);
        load_f32<VEC>(pb, pr + D + j * VEC);
      }
      P o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float gv = to_f32<T>(q.v[k]);
        const float xh = __fmul_rn(to_f32<T>(p.v[k]) - st.mean, st.inv);
        o.v[k] = from_f32<T>(st.inv * (gv * sc[k] - ma - xh * mb));
        ps[k] = first ? gv * xh : ps[k] + gv * xh;
        pb[k] = first ? gv : pb[k] + gv;
      }
      if (dx) reinterpret_cast<P*>(dx + r * D)[j] = o;
      if (pr) {
        store_f32<VEC>(pr + j * VEC, ps);
        store_f32<VEC>(pr + D + j * VEC, pb);
      }
    }
  }
}

// dscale, dbias = the column sums of the blocks' partial rows (nblk, 2D):
// a block takes 32 of the 2D columns, its warp w the partial rows w, w + 8,
// ..., then warp 0 adds the eight warps' sums in order.
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_cols_kernel(const float* __restrict__ part, int nblk, int D, float* __restrict__ dscale,
                   float* __restrict__ dbias) {
  __shared__ float red[LN_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < 2 * D)
    for (int b = warp; b < nblk; b += LN_WARPS) s += part[static_cast<long long>(b) * 2 * D + c];
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || c >= 2 * D) return;
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < LN_WARPS; ++w) t += red[w][lane];
  if (c < D)
    dscale[c] = t;
  else
    dbias[c - D] = t;
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The blocks of `kernel` that one wave holds (resident blocks an SM times
// the SMs), cached per device in `cache` (one array per kernel instance).
static int wave_blocks(const void* kernel, int threads, int* cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  int* slot = dev >= 0 && dev < LN_MAX_DEVICES ? &cache[dev] : nullptr;
  if (slot && *slot) return *slot;
  int sms = 1, per_sm = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const int blocks = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  if (slot) *slot = blocks;
  return blocks;
}

template <int N, int W>
struct RowCfg {
  static constexpr int npt = N, wpr = W;
};

// f(RowCfg<values a thread in packs, warps a row>) for rows of nv packs of
// VEC elements; LN_NO_ROW_CFG past the register kernels. A thread holds at
// most 24 elements (16 one at a time), the group is as narrow as that
// allows.
template <int VEC, typename F>
static int with_row_cfg(int nv, F&& f) {
  if constexpr (VEC == 8) {
    if (nv <= 32) return f(RowCfg<1, 1>{});
    if (nv <= 64) return f(RowCfg<2, 1>{});
    if (nv <= 96) return f(RowCfg<3, 1>{});
    if (nv <= 128) return f(RowCfg<2, 2>{});
    if (nv <= 256) return f(RowCfg<2, 4>{});
    if (nv <= 512) return f(RowCfg<2, 8>{});
  } else if constexpr (VEC == 4) {
    if (nv <= 32) return f(RowCfg<1, 1>{});
    if (nv <= 64) return f(RowCfg<2, 1>{});
    if (nv <= 128) return f(RowCfg<4, 1>{});
    if (nv <= 192) return f(RowCfg<6, 1>{});
    if (nv <= 256) return f(RowCfg<4, 2>{});
    if (nv <= 512) return f(RowCfg<4, 4>{});
    if (nv <= 1024) return f(RowCfg<4, 8>{});
  } else {
    if (nv <= 512) return f(RowCfg<16, 1>{});
    if (nv <= 1024) return f(RowCfg<16, 2>{});
    if (nv <= 2048) return f(RowCfg<16, 4>{});
    if (nv <= 4096) return f(RowCfg<16, 8>{});
  }
  return LN_NO_ROW_CFG;
}

static bool aligned16(const void* a, const void* b, const void* c, const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(c) |
           reinterpret_cast<uintptr_t>(d)) & 15) == 0;
}

template <typename T, int VEC, int NPT, int WPR>
static int fwd_rows(const T* x, T* y, const float* sc, const float* bi, int M, int D, float eps, cudaStream_t s) {
  constexpr int GPB = LN_THREADS / (32 * WPR);
  static int cache[LN_MAX_DEVICES];
  const auto kernel = ln_rows_kernel<T, VEC, NPT, WPR>;
  const long long need = (static_cast<long long>(M) + GPB - 1) / GPB;
  const int wave = wave_blocks(reinterpret_cast<const void*>(kernel), LN_THREADS, cache);
  kernel<<<static_cast<int>(need < wave ? need : wave), LN_THREADS, 0, s>>>(x, y, sc, bi, M, D, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
static int fwd(const void* x, void* y, const float* sc, const float* bi, int M, int D, float eps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int code = with_row_cfg<VEC>(D / VEC, [&](auto c) {
    using C = decltype(c);
    return fwd_rows<T, VEC, C::npt, C::wpr>(xt, yt, sc, bi, M, D, eps, s);
  });
  if (code != LN_NO_ROW_CFG) return code;
  ln_wide_kernel<T, VEC><<<M, LN_WIDE, 0, s>>>(xt, yt, sc, bi, D, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_fwd(const void* x, void* y, const float* sc, const float* bi, int M, int D, float eps,
                      cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (D % VEC == 0 && aligned16(x, y, sc, bi)) return fwd<T, VEC>(x, y, sc, bi, M, D, eps, s);
  return fwd<T, 1>(x, y, sc, bi, M, D, eps, s);
}

struct BwdArgs {
  const void *x, *g;
  const float* scale;
  void* dx;
  float *dscale, *dbias, *part;
  int part_rows, M, D;
  float eps;
  cudaStream_t stream;
};

// The partial rows' column sums, after a row kernel of nblk blocks.
static int bwd_cols(const BwdArgs& a, int nblk) {
  const int err = static_cast<int>(cudaGetLastError());
  if (err || !a.part) return err;
  ln_bwd_cols_kernel<<<(2 * a.D + 31) / 32, LN_THREADS, 0, a.stream>>>(a.part, nblk, a.D, a.dscale, a.dbias);
  return static_cast<int>(cudaGetLastError());
}

// The row kernel's grid, the one rule that also sizes the partial rows: one
// wave, no more blocks than the rows need. With `plan` it is returned and
// nothing is launched; else it is launched, unless the caller gave fewer
// partial rows than it has blocks.
template <typename T, int VEC, int NPT, int WPR>
static int bwd_rows(const BwdArgs& a, bool plan) {
  constexpr int GPB = LN_THREADS / (32 * WPR);
  static int cache[LN_MAX_DEVICES];
  const auto kernel = ln_bwd_rows_kernel<T, VEC, NPT, WPR>;
  const long long need = (static_cast<long long>(a.M) + GPB - 1) / GPB;
  const int wave = wave_blocks(reinterpret_cast<const void*>(kernel), LN_THREADS, cache);
  const int grid = static_cast<int>(need < wave ? need : wave);
  if (plan) return grid;
  if (a.part && a.part_rows < grid) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, LN_THREADS, 0, a.stream>>>(static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.scale,
                                             static_cast<T*>(a.dx), a.part, a.M, a.D, a.eps);
  return bwd_cols(a, grid);
}

template <typename T, int VEC>
static int bwd(const BwdArgs& a, bool plan) {
  const int code = with_row_cfg<VEC>(a.D / VEC, [&](auto c) {
    using C = decltype(c);
    return bwd_rows<T, VEC, C::npt, C::wpr>(a, plan);
  });
  if (code != LN_NO_ROW_CFG) return code;
  static int cache[LN_MAX_DEVICES];
  const auto kernel = ln_bwd_wide_kernel<T, VEC>;
  const int wave = wave_blocks(reinterpret_cast<const void*>(kernel), LN_WIDE, cache);
  const int grid = a.M < wave ? a.M : wave;
  if (plan) return grid;
  if (a.part && a.part_rows < grid) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, LN_WIDE, 0, a.stream>>>(static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.scale,
                                          static_cast<T*>(a.dx), a.part, a.M, a.D, a.eps);
  return bwd_cols(a, grid);
}

template <typename T>
static int launch_bwd(const BwdArgs& a, bool plan) {
  constexpr int VEC = 16 / sizeof(T);
  if (a.D % VEC == 0 && aligned16(a.x, a.g, a.scale, a.dx)) return bwd<T, VEC>(a, plan);
  return bwd<T, 1>(a, plan);
}

}  // namespace

// x, y: (M, D) row-major, bf16 (is_f32 == 0) or f32; y may be x. scale,
// bias: (D,) f32, any D >= 1. Returns a CUDA error code.
extern "C" int btia_layernorm(const void* x, void* y, const void* scale, const void* bias, int M, int D, float eps,
                              int is_f32, void* stream) {
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f32 ? launch_fwd<float>(x, y, sc, bi, M, D, eps, s) : launch_fwd<bf16>(x, y, sc, bi, M, D, eps, s);
}

// The partial rows that btia_layernorm_bwd needs for these arguments (its
// row kernel's blocks: one wave, no more than the rows need), >= 1; 0 for
// M or D below 1.
extern "C" int btia_layernorm_bwd_parts(const void* x, const void* g, const void* scale, const void* dx, int M, int D,
                                        int is_f32) {
  if (M < 1 || D < 1) return 0;
  const BwdArgs a{x, g, static_cast<const float*>(scale), const_cast<void*>(dx), nullptr, nullptr, nullptr, 0, M, D,
                  0.f, nullptr};
  return is_f32 ? launch_bwd<float>(a, true) : launch_bwd<bf16>(a, true);
}

// K7's backward. x, g: (M, D) row-major, bf16 (is_f32 == 0) or f32; scale
// (D,) f32. Writes dx (x's type; skipped when null) and, when dscale and
// dbias are given (both or neither), their f32 sums over the rows, through
// part: a scratch of part_rows x 2D floats, part_rows at least what
// btia_layernorm_bwd_parts returns for the same arguments (the same
// arguments give the same bits). Launches the row kernel and, with dscale,
// the column kernel. Returns a CUDA error code.
extern "C" int btia_layernorm_bwd(const void* x, const void* g, const void* scale, void* dx, void* dscale,
                                  void* dbias, void* part, int part_rows, int M, int D, float eps, int is_f32,
                                  void* stream) {
  const bool params = dscale != nullptr;
  if (M < 1 || D < 1 || params != (dbias != nullptr) || (params && (!part || part_rows < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{x, g, static_cast<const float*>(scale), dx, static_cast<float*>(dscale),
                  static_cast<float*>(dbias), params ? static_cast<float*>(part) : nullptr, part_rows, M, D, eps,
                  static_cast<cudaStream_t>(stream)};
  return is_f32 ? launch_bwd<float>(a, false) : launch_bwd<bf16>(a, false);
}
