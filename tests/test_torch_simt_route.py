"""The f32 and wide-head routes of K1-K6: which kernel each entry picks, and
the host code of the CUDA-core kernels (``csrc/attn_simt.cu``,
``csrc/gemm_f32.cu``) and of the wide-head tensor-core kernel
(``csrc/attn_wide.cu``), on the CPU.

The choice: bf16 at the widths a tensor-core kernel is built for goes
there; bf16 from 257 to 1024 to the wide-head kernel; f32 at any head width
up to 1024 to the CUDA-core kernel; anything else raises before a kernel is
built.

The host code: every CUDA half (K1/K2's chain, K3, K4, K5, K6) runs on CPU
tensors against a stand-in for the kernel library that reads and writes
the tensors' memory through the pointers, strides and shapes it is handed,
refuses the arguments its C entry refuses (a plan, a load path or a TMA
layout the kernel does not take), writes only the output slices the plan
names, and computes what the kernels compute (the attention with its two
mask modes, the f32 GEMM with its bias and residual rows, K7's LayerNorm).
So a wrong stride, pointer offset, mask mode, scale or plan shows as a
wrong number or an error, held against the plain twin: fp32 within 1e-5 of
the largest magnitude (one sum order apart), bf16 within 1/32 of it (the
chip's bound for these kernels: the two round the probabilities after sums
taken in another order). The stand-in also records every call, which
shows that no f32 operand reaches a bf16 entry or is cast to bf16 on the
way. The kernels' own arithmetic is held to the twins on the card
(``chip_smoke.py`` phase 2c).
"""

import ctypes

import numpy as np
import pytest
import torch

from btia_tpu_torch.ops import _native
from btia_tpu_torch.ops import attention as A
from btia_tpu_torch.ops import bicross as BX
from btia_tpu_torch.ops import fused_attn as FA
from btia_tpu_torch.ops import gemm as G
from btia_tpu_torch.ops.norms import _ln_exact

F32, BF16 = torch.float32, torch.bfloat16
PREDICATES = {"K1/K2 core": FA.core_takes, "K3": A.k3_takes, "K4": A.k4_takes, "K5": A.k5_takes,
              "K6": BX.k6_takes}


@pytest.mark.parametrize("entry", list(PREDICATES))
@pytest.mark.parametrize("D", [8, 32, 64, 96, 100, 128, 192, 256, 264, 320, 384, 512, 768, 1024, 1032, 2048])
def test_route_by_dtype_and_head_width(entry, D):
    takes = PREDICATES[entry]
    bf16 = A.attention_route(BF16, D, takes)
    assert bf16 == ("wgmma" if takes(D) else "wide" if 256 < D <= 1024 else None)
    assert A.attention_route(F32, D, takes) == ("simt" if D <= 1024 else None)
    assert A.attention_route(torch.float16, D, takes) is None
    assert A.attention_route(F32, D + 0.5, takes) is None  # heads that do not divide the width


def _no_build(monkeypatch):
    monkeypatch.setattr(_native, "lib", lambda: pytest.fail("a kernel was built"))


@pytest.mark.parametrize("dt", [F32, BF16])
def test_cuda_wrappers_raise_above_1024_before_building(dt, monkeypatch):
    _no_build(monkeypatch)
    H, D = 1, 1032
    x = torch.zeros(2, 4, H * D, dtype=dt)
    with pytest.raises(ValueError, match="K3 kernel takes head widths .* up to 1024"):
        A._bshd_flash_cuda(x, x, x, None, H)
    with pytest.raises(ValueError, match="K4 kernel takes head widths .* up to 1024"):
        A._fanout_cuda(x, x, x, torch.ones(2, 4), H)
    with pytest.raises(ValueError, match="attention core takes head widths .* up to 1024"):
        FA._core_cuda(x.view(8, D), torch.zeros(8, 2 * D, dtype=dt), None, 2, 4, 4, H)
    b = torch.zeros(2, H, 4, D, dtype=dt)
    with pytest.raises(ValueError, match="K5 kernel takes head widths .* up to 1024"):
        A._mha_bhsd_cuda(b, b, b, None)
    with pytest.raises(ValueError, match="K6 kernel takes head widths .* up to 1024"):
        BX._bicross_cuda(b, b, b, b, b, b, None)


def test_f32_cpu_tensors_take_the_plain_twins(monkeypatch):
    """On the CPU an f32 site takes its twin whatever the width, and counts
    no launch of any kernel."""
    _no_build(monkeypatch)
    rng = np.random.RandomState(0)
    H, D = 1, 320
    q, k, v = (torch.from_numpy(rng.randn(2, 5, H * D).astype(np.float32)) for _ in range(3))
    counters = (A.bshd_flash_attention, A.simt_attention, A.wide_attention, G.gemm_f32)
    before = [f.launches for f in counters]
    out = A.bshd_flash_attention(q, k, v, None, H)
    torch.testing.assert_close(out, A._bshd_flash_plain(q, k, v, None, H), atol=0, rtol=0)
    assert [f.launches for f in counters] == before


# ---------------------------------------------------------------------------
# The host code against a stand-in for the kernel library
# ---------------------------------------------------------------------------


def _view(ptr, dtype, shape, strides):
    """The tensor at host address `ptr` with `shape` and element `strides`,
    aliasing that memory (writes go through)."""
    extent = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    size = torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_char * (extent * size)).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).as_strided(shape, strides)


def _round(x, dtype):
    return x.to(dtype).float()


INVALID = 1  # cudaErrorInvalidValue, the C entries' code for arguments they do not take


class _FakeLib:
    """Computes, on the host, what the C entries of the f32 and wide-head
    routes and K7 compute, reading and writing through the arguments they
    are given, after the checks the C entries make; records each call. Any
    other entry fails the test."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _attend(ptrs, strides, dims, qscale, p, D, mask_bytes, mult, dt, slices):
        """Problem p of an attention call, its output written only in the
        (first column, columns) slices given."""
        B, H, Sq, Sk = dims[4 * p: 4 * p + 4]
        st = [strides[12 * p + 3 * i: 12 * p + 3 * i + 3] for i in range(4)]
        q, k, v, o = (_view(ptrs[5 * p + i], dt, (B, H, n, D), (*st[i], 1))
                      for i, n in enumerate((Sq, Sk, Sk, Sq)))
        s = _round(q.float() * qscale[p], dt) @ k.float().transpose(-1, -2)
        mptr = ptrs[5 * p + 4]
        cm = torch.ones(B, Sk)
        if mptr:
            cm = _view(mptr, torch.uint8 if mask_bytes == 1 else F32, (B, Sk), (Sk, 1)).float()
            cm = (cm != 0).float() if mask_bytes == 1 else cm
        s = s - (1 - cm[:, None, None, :]) * 1e9
        e = torch.exp2(s - s.amax(-1, keepdim=True))
        if mult:
            e = e * cm[:, None, None, :]
        den = e.sum(-1, keepdim=True)
        out = ((_round(e, dt) @ v.float()) / (torch.clamp_min(den, 1e-30) if mult else den)).to(dt)
        for c0, w in slices:
            o[..., c0:c0 + w] = out[..., c0:c0 + w]

    @staticmethod
    def problems(args, nprob):
        """Both entries' argument array, ATTEND_ARGS int64 a problem (q, k,
        v, o, mask pointers; q, k, v, o strides; B, H, Sq, Sk), read back
        into the (pointers, strides, dims) lists ``_attend`` takes."""
        a = [args[i] for i in range(A.ATTEND_ARGS * nprob)]
        ptrs, strides, dims = [], [], []
        for p in range(nprob):
            x = a[A.ATTEND_ARGS * p: A.ATTEND_ARGS * (p + 1)]
            ptrs += x[:5]
            strides += x[5:17]
            dims += x[17:21]
        return ptrs, strides, dims

    def btia_attn_simt(self, args, nprob, qs0, qs1, D, mask_bytes, mult, plan, stream):
        bq, slice_w, vec = plan[:3]
        self.calls.append(("btia_attn_simt", F32, nprob, D, mult, (bq, slice_w, vec)))
        if bq not in (32, 64) or not (slice_w == 128 or (slice_w == 64 and D <= 64)):
            return INVALID
        ptrs, strides, dims = self.problems(args, nprob)
        if vec and (D % 4 or any(strides[i] % 4 for i in range(12 * nprob))
                    or any(ptrs[5 * p + i] % 16 for p in range(nprob) for i in range(4))):
            return INVALID
        for p in range(nprob):
            self._attend(ptrs, strides, dims, (qs0, qs1), p, D, mask_bytes, mult, F32, _slices(D, slice_w))
        return 0

    def btia_attn_wide(self, args, nprob, qs0, qs1, dw, sw, n, mask_bytes, mult, stream):
        """The cluster entry, on the f32 entry's argument array."""
        self.calls.append(("btia_attn_wide", BF16, nprob, dw, mult, (sw, n)))
        if dw % 8 or sw not in (192, 256) or not 2 <= n <= 4 or not (n - 1) * sw < dw <= n * sw:
            return INVALID
        ptrs, strides, dims = self.problems(args, nprob)
        for p in range(nprob):
            st = strides[12 * p: 12 * p + 12]
            if any(ptrs[5 * p + i] % 16 or not ptrs[5 * p + i] for i in range(4)) or any(x % 8 or x < 0 for x in st) \
                    or min(st[1], st[2], st[4], st[5], st[7], st[8], st[10], st[11]) == 0 \
                    or (st[9] == 0 and dims[4 * p] > 1):
                return INVALID
            self._attend(ptrs, strides, dims, (qs0, qs1), p, dw, mask_bytes, mult, BF16, _slices(dw, sw, n))
        return 0

    def btia_gemm_f32(self, a, w, bias, resid, resid_rows, c, M, N, K, tile, vec, stream):
        self.calls.append(("btia_gemm_f32", M, N, K, resid is not None, tile))
        if tile not in (0, 1, 2) or (vec and (N % 4 or any(x % 16 for x in (w, bias, resid or 0, c)))):
            return INVALID
        y = _view(a, F32, (M, K), (K, 1)) @ _view(w, F32, (K, N), (N, 1)) + _view(bias, F32, (N,), (1,))
        if resid is not None:
            y = y + _view(resid, F32, (resid_rows, N), (N, 1)).repeat(-(-M // resid_rows), 1)[:M]
        _view(c, F32, (M, N), (N, 1)).copy_(y)
        return 0

    def btia_layernorm(self, x, out, scale, bias, rows, D, eps, elem, stream):
        dt = (BF16, F32)[elem]
        self.calls.append(("btia_layernorm", dt, rows, D))
        xs = _view(x, dt, (rows, D), (D, 1)).clone()
        y = _ln_exact(xs, _view(scale, F32, (D,), (1,)), _view(bias, F32, (D,), (1,)), eps)
        _view(out, dt, (rows, D), (D, 1)).copy_(y)
        return 0

    def __getattr__(self, name):
        pytest.fail(f"{name} was called on the CUDA-core route")


@pytest.fixture
def fake_lib(monkeypatch):
    """CPU tensors through the CUDA halves: the device checks pass, the
    dtype and layout checks stay, the library is the stand-in."""
    lib = _FakeLib()

    def require(t, what, dtype=BF16, contiguous=True):
        if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)) or (contiguous and not t.is_contiguous()):
            raise ValueError(f"{what}: {t.dtype}, contiguous={t.is_contiguous()}")

    monkeypatch.setattr(_native, "lib", lambda: lib)
    monkeypatch.setattr(_native, "require", require)
    monkeypatch.setattr(_native, "stream", lambda t: 0)
    return lib


def _close(got, want, dt):
    got, want = (torch.as_tensor(x).float() for x in (got, want))
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= (1e-5 if dt == F32 else 1 / 32) * scale, (err, scale)


def _rand(rng, *shape, dt=F32, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dt)


def _mask(rng, B, S):
    m = torch.from_numpy(rng.rand(B, S) > 0.3)
    m[0] = False  # a fully masked row
    m[1] = True
    return m


# f32: the packed 16-byte path, heads of 96 and 48 on one slice, D = 50 on
# the 4-byte path, D = 200 in two slices; bf16 on the wide-head kernel, D
# = 300 through its padded copy.
CASES = [(F32, 2, 64), (F32, 1, 96), (F32, 2, 48), (F32, 1, 50), (F32, 1, 200), (BF16, 1, 384), (BF16, 2, 320),
         (BF16, 1, 300)]


def _entry(dt):
    return "btia_attn_simt" if dt == F32 else "btia_attn_wide"


@pytest.mark.parametrize("dt,H,D", CASES)
def test_k3_k4_host_code(dt, H, D, fake_lib):
    rng = np.random.RandomState(D)
    q, k, v = _rand(rng, 3, 17, H * D, dt=dt), _rand(rng, 3, 40, H * D, dt=dt), _rand(rng, 3, 40, H * D, dt=dt)
    m = _mask(rng, 3, 40)
    _close(A._bshd_flash_cuda(q, k, v, m, H), A._bshd_flash_plain(q, k, v, m, H), dt)
    cm = m.float()
    _close(A._fanout_cuda(q, k, v, cm, H), A._fanout_plain(q, k, v, cm, H), dt)
    assert [c[0] for c in fake_lib.calls] == [_entry(dt)] * 2
    assert [c[4] for c in fake_lib.calls] == [0, 1]  # K3 additive, K4 after exp2
    assert all(c[1] == dt for c in fake_lib.calls)


@pytest.mark.parametrize("dt,H,D", CASES)
def test_k5_k6_host_code_on_strided_views(dt, H, D, fake_lib):
    """K5 on (B, S, H, D) buffers read as (B, H, S, D) views with k and v
    broadcast over the batch (stride 0); K6's two directions in one call."""
    rng = np.random.RandomState(D + 1)
    q = _rand(rng, 3, 17, H, D, dt=dt).transpose(1, 2)
    k = _rand(rng, 1, 40, H, D, dt=dt).transpose(1, 2).expand(3, H, 40, D)
    v = _rand(rng, 1, 40, H, D, dt=dt).transpose(1, 2).expand(3, H, 40, D)
    m = _mask(rng, 3, 40)
    _close(A._mha_bhsd_cuda(q, k, v, m), A._mha_bhsd_plain(q, k, v, m), dt)
    img = [_rand(rng, 3, H, 23, D, dt=dt) for _ in range(3)]
    txt = [_rand(rng, 3, 11, H, D, dt=dt).transpose(1, 2) for _ in range(3)]
    tm = _mask(rng, 3, 11)
    got = BX._bicross_cuda(*img, *txt, tm)
    want = BX._bicross_plain(*img, *txt, tm)
    for g, w in zip(got, want):
        _close(g, w, dt)
    assert [(c[0], c[2]) for c in fake_lib.calls] == [(_entry(dt), 1), (_entry(dt), 2)]


def _site_weights(rng, din, hd, dout):
    mk = lambda *s: _rand(rng, *s, scale=0.05)
    return [mk(din, hd), mk(hd), mk(din, hd), mk(hd), mk(din, hd), mk(hd), mk(hd, dout), mk(dout)]


def _ln(rng, d, eps):
    return (1 + _rand(rng, d, scale=0.1), _rand(rng, d, scale=0.1), eps)


@pytest.mark.parametrize("H,D", [(2, 64), (1, 128)])
def test_k1_f32_chain_host_code(H, D, fake_lib):
    """K1's f32 chain (LN prologue, q and [k|v] f32 GEMMs, the CUDA-core core
    reading the GEMM outputs through their strides, the out-projection with
    the residual rows, the post-LN) against ``_fused_dense_plain``; nothing
    goes near a bf16 entry, and the prepared weights stay f32."""
    rng = np.random.RandomState(H * D)
    din = 128
    x_q, x_kv = _rand(rng, 4, 9, din), _rand(rng, 4, 13, din)
    m = _mask(rng, 4, 13)
    w = _site_weights(rng, din, H * D, din)
    lns = dict(q_ln=_ln(rng, din, 1e-6), kv_ln=_ln(rng, din, 1e-6), residual=True, post_ln=_ln(rng, din, 1e-12))
    got = FA._fused_dense_cuda(x_q, x_kv, m, *w, H, **lns)
    want = FA._fused_dense_plain(x_q, x_kv, m, *w, H, **lns)
    _close(got, want, F32)
    names = [c[0] for c in fake_lib.calls]
    assert names == ["btia_layernorm", "btia_layernorm", "btia_gemm_f32", "btia_gemm_f32", "btia_attn_simt",
                     "btia_gemm_f32", "btia_layernorm"]
    assert fake_lib.calls[4][1:5] == (F32, 1, D, 1)  # one problem, after-exp2 mask
    assert [c[4] for c in fake_lib.calls if c[0] == "btia_gemm_f32"] == [False, False, True]
    prepared = FA._dense_weights(*w, H, F32)
    assert all(t.dtype == F32 for t in prepared)


def test_k2_f32_chain_host_code(fake_lib):
    """K2's f32 chain: one shared query table (batch stride 0) for every
    batch row, the residual repeating every K rows."""
    rng = np.random.RandomState(5)
    H, D, din, K = 2, 64, 128, 6
    queries, x_kv = _rand(rng, K, din), _rand(rng, 4, 13, din)
    m = _mask(rng, 4, 13)
    w = _site_weights(rng, din, H * D, din)
    kv_ln = _ln(rng, din, 1e-6)
    got = FA._static_q_cuda(queries, x_kv, m, *w, H, kv_ln, True)
    want = FA._static_q_plain(queries, x_kv, m, *w, H, kv_ln, True)
    _close(got, want, F32)
    assert [c[0] for c in fake_lib.calls] == ["btia_layernorm", "btia_gemm_f32", "btia_attn_simt", "btia_gemm_f32"]


@pytest.mark.parametrize("q_shared", [False, True])
def test_core_bf16_wide_host_code(q_shared, fake_lib):
    """K1/K2's core at bf16 D = 384 on the wide-head kernel, against
    ``attend_log2``: q rows already in the log2 domain (scale 1), K2's
    shared table read through a batch stride of 0, two slices of 192."""
    rng = np.random.RandomState(6)
    B, Sq, Sk, H, D = 3, 5, 7, 1, 384
    q = _rand(rng, Sq if q_shared else B * Sq, H * D, dt=BF16)
    kv = _rand(rng, B * Sk, 2 * H * D, dt=BF16)
    m = _mask(rng, B, Sk)
    got = FA._core_cuda(q, kv, m, B, Sq, Sk, H, q_shared=q_shared)
    qb = q[None].expand(B, Sq, H * D) if q_shared else q.view(B, Sq, H * D)
    want = A.attend_log2(qb, kv[:, :H * D].reshape(B, Sk, -1), kv[:, H * D:].reshape(B, Sk, -1), m.float(), H)
    _close(got.view(B, Sq, -1), want, BF16)
    assert fake_lib.calls == [("btia_attn_wide", BF16, 1, D, 1, (192, 2))]
    assert not got.view(B, Sq, -1)[0].float().any()  # the fully masked row gives 0


# ---------------------------------------------------------------------------
# The host-side plans: output slices, the GEMM's tile, the load paths
# ---------------------------------------------------------------------------


def _slices(width, slice_w, n=None):
    """The (first column, columns) of each output slice as the kernels
    number them: slice i starts at i * slice_w (ceil(width / slice_w) of
    them, or n)."""
    n = -(-width // slice_w) if n is None else n
    return [(i * slice_w, min(slice_w, width - i * slice_w)) for i in range(n)]


def _covers_once(slices, width):
    cols = torch.zeros(width, dtype=torch.int64)
    for c0, w in slices:
        assert w >= 1
        cols[c0:c0 + w] += 1
    return bool((cols == 1).all()) and sum(w for _, w in slices) == width


@pytest.mark.parametrize("D", [257, 260, 264, 300, 320, 383, 384, 385, 511, 512, 513, 640, 700, 768, 769, 777,
                               1000, 1020, 1024])
def test_wide_slices_cover_every_column_once(D):
    """The wide kernel's slices of a head padded to a multiple of 8: every
    column of [0, dw) once, each slice at most 256 columns and its width a
    multiple of 64, as few slices as 256-column ones would take."""
    dw = A._round8(D)
    sw, n = A.wide_plan(dw)
    slices = _slices(dw, sw, n)
    assert sw in (192, 256) and len(slices) == n == -(-dw // 256)
    assert (n - 1) * sw < dw <= n * sw
    assert _covers_once(slices, dw) and dw >= D


def test_wide_slices_every_width():
    for D in range(257, 1025):
        dw = A._round8(D)
        sw, n = A.wide_plan(dw)
        assert _covers_once(_slices(dw, sw, n), dw) and (n - 1) * sw < dw <= n * sw <= n * 256, D


def _specs(problems):
    """(q, k, v, o, mask, qscale) problems of (B, H, S, D) views with their
    operands as the launchers take them (``attention.operand``)."""
    return [(*map(A.operand, p[:4]), *p[4:]) for p in problems]


@pytest.mark.parametrize("D", [1, 4, 50, 63, 64, 65, 96, 128, 129, 200, 256, 300, 1000, 1024])
def test_simt_slices_cover_every_column_once(D):
    """The f32 kernel's slices: one of 64 columns up to D 64, of 128 above;
    a head wider than 128 splits over the grid, every column once."""
    x = torch.zeros(2, 1, 3, D)
    bq, slice_w, _ = A.simt_plan(_specs([(x, x, x, x, None, 1.0)]), D)
    assert slice_w == (64 if D <= 64 else 128) and bq == 32
    assert _covers_once(_slices(D, slice_w), D)


def test_simt_query_rows_a_block():
    """32 query rows a block only where every problem's Sq <= 32 (K6's two
    directions decide together)."""
    a, b = torch.zeros(2, 1, 32, 64), torch.zeros(2, 1, 50, 64)
    assert A.simt_plan(_specs([(a, a, a, a, None, 1.0)]), 64)[0] == 32
    assert A.simt_plan(_specs([(b, a, a, b, None, 1.0)]), 64)[0] == 64
    assert A.simt_plan(_specs([(a, b, b, a, None, 1.0), (b, a, a, b, None, 1.0)]), 64)[0] == 64


# (name, M, K, N, expected block tile): chip_smoke.py's f32 GEMM sites
# (vqa_rad_lstm's BTIA site, streaming_vitl's serve step of 64 pairs), and
# grids at the edges of two blocks an SM (264 on the H100's 132 SMs).
GEMM_TILES = [("lstm_i2t_q", 3136, 512, 512, (64, 64)), ("lstm_i2t_kv", 2048, 512, 1024, (64, 64)),
              ("vitl_text_kv", 2048, 768, 1536, (128, 64)), ("vitl_text_out", 2048, 768, 768, (64, 64)),
              ("vitl_head_kv", 5248, 768, 1536, (128, 128)), ("serve_text_kv", 65536, 768, 1536, (128, 128)),
              ("just_under", 128 * 22, 64, 128 * 11, (128, 64)), ("just_at", 128 * 24, 64, 128 * 11, (128, 128)),
              ("small", 100, 64, 64, (64, 64))]


@pytest.mark.parametrize("name,M,K,N,tile", GEMM_TILES)
def test_gemm_f32_tile_by_shape(name, M, K, N, tile, fake_lib):
    """The largest of 128 x 128, 128 x 64 and 64 x 64 whose grid gives the
    H100's 132 SMs two blocks each, else 64 x 64; the wrapper hands the
    choice to the C entry."""
    assert G.GEMM_F32_TILES[G.gemm_f32_tile(M, N)] == tile
    rng = np.random.RandomState(M % 97)
    a, w, b = _rand(rng, 8, K), _rand(rng, K, N), _rand(rng, N)
    G.gemm_f32(a, w, b)
    assert fake_lib.calls[-1][5] == G.gemm_f32_tile(8, N) == 2  # the call's own shape decides


def _packed(D, H=2, off=0, B=2, S=5):
    """(B, H, S, D) views of a packed (B, S, H*D) f32 buffer, starting `off`
    elements in."""
    buf = torch.zeros(B * S * H * D + off)
    return buf[off:].view(B, S, H * D).unflatten(2, (H, D)).transpose(1, 2)


@pytest.mark.parametrize("D,H,off,vec", [
    (64, 2, 0, 1),    # packed, aligned
    (64, 2, 4, 1),    # an offset of 16 bytes
    (64, 2, 2, 0),    # an offset of 8 bytes: misaligned
    (50, 1, 0, 0),    # D % 4 != 0
    (48, 3, 0, 1),    # H * D = 144, strides multiples of 4
    (6, 3, 0, 0),     # row stride 18
])
def test_simt_load_path_by_alignment(D, H, off, vec):
    """16-byte copies only where every pointer is 16-byte aligned and every
    stride and D are multiples of 4 elements; otherwise 4-byte copies."""
    x = _packed(D, H, off)
    assert A.simt_plan(_specs([(x, x, x, _packed(D, H), None, 1.0)]), D)[2] == vec


def test_simt_load_path_k1_value_rows():
    """K1's v rows start HD elements into each [k|v] row: 16-byte aligned
    only where HD % 4 == 0."""
    for hd, vec in ((128, 1), (130, 0)):
        kv = torch.zeros(3 * 7, 2 * hd)
        k = kv.as_strided((3, 1, 7, hd), (7 * 2 * hd, hd, 2 * hd, 1))
        v = kv.as_strided((3, 1, 7, hd), (7 * 2 * hd, hd, 2 * hd, 1), hd)
        q = torch.zeros(3, 1, 5, hd)
        assert A.simt_plan(_specs([(q, k, v, q, None, 1.0)]), hd)[2] == vec, hd


def test_wide_operand_reads_in_place_or_copies():
    """TMA reads a bf16 view in place where its base is 16-byte aligned and
    its strides are multiples of 8; a shared (batch stride 0) table keeps
    its stride; a misaligned view or a width that is not a multiple of 8
    is copied (padded to dw). ``_wide_read`` gives the tensor, the pointer
    and the strides the kernel reads it through."""
    buf = torch.zeros(2 * 5 * 2 * 384 + 8, dtype=BF16)
    x = buf[:-8].view(2, 5, 2 * 384).unflatten(2, (2, 384)).transpose(1, 2)
    y, ptr, st = A._wide_read(A.operand(x), 384)
    assert y is x and ptr == x.data_ptr() and st == list(x.stride()[:3])
    shared = torch.zeros(1, 2, 5, 384, dtype=BF16).expand(4, 2, 5, 384)
    y, ptr, st = A._wide_read(A.operand(shared), 384)
    assert ptr == shared.data_ptr() and st[0] == 0
    odd = buf[4:-4].view(2, 5, 2 * 384).unflatten(2, (2, 384)).transpose(1, 2)  # 8 bytes off
    y, ptr, st = A._wide_read(A.operand(odd), 384)
    assert ptr == y.data_ptr() and ptr % 16 == 0 and torch.equal(y, odd)
    narrow = torch.randn(2, 2, 5, 300).to(BF16)
    y, ptr, st = A._wide_read(A.operand(narrow), 304)
    assert y.shape[3] == 304 and torch.equal(y[..., :300], narrow) and not y[..., 300:].any()
    assert all(s % 8 == 0 and s > 0 for s in st)


@pytest.mark.parametrize("entry", ["btia_attn_simt", "btia_attn_wide", "btia_gemm_f32"])
def test_launch_error_raises(entry, fake_lib, monkeypatch):
    """A non-zero code from a C entry raises; nothing falls back to a twin."""
    monkeypatch.setattr(_FakeLib, entry, lambda self, *a: INVALID)
    rng = np.random.RandomState(1)
    with pytest.raises(RuntimeError, match=f"{entry}: CUDA error {INVALID}"):
        if entry == "btia_gemm_f32":
            G.gemm_f32(_rand(rng, 4, 8), _rand(rng, 8, 8), _rand(rng, 8))
        else:
            dt, D = (F32, 64) if entry == "btia_attn_simt" else (BF16, 384)
            q = _rand(rng, 2, 3, D, dt=dt)
            A._bshd_flash_cuda(q, q, q, None, 1)
