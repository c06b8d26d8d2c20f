"""The f32 and wide-head routes of K1-K6: which kernel each entry picks, and
the host code of the two CUDA-core kernels (``csrc/attn_simt.cu``,
``csrc/gemm_f32.cu``), on the CPU.

The choice: bf16 at the widths a tensor-core kernel is built for goes
there; f32 at any head width up to 1024, and bf16 from 257 to 1024, go to
the CUDA-core kernel; anything else raises before a kernel is built.

The host code: every CUDA half (K1/K2's chain, K3, K4, K5, K6) runs on CPU
tensors against a stand-in for the kernel library that reads and writes
the tensors' memory through the pointers, strides and shapes it is handed,
and computes what the kernels compute (the CUDA-core attention with its two
mask modes, the f32 GEMM with its bias and residual rows, K7's LayerNorm).
So a wrong stride, pointer offset, mask mode or scale shows as a wrong
number, held against the plain twin: fp32 within 1e-5 of the largest
magnitude (one sum order apart), bf16 within 1/32 of it (the chip's bound
for these kernels: the two round the probabilities after sums taken in
another order). The stand-in also records every call, which shows that no
f32 operand reaches a bf16 entry or is cast to bf16 on the way. The
kernels' own arithmetic is held to the twins on the card
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
from btia_tpu_torch.ops.norms import _ln_exact

F32, BF16 = torch.float32, torch.bfloat16
PREDICATES = {"K1/K2 core": FA.core_takes, "K3": A.k3_takes, "K4": A.k4_takes, "K5": A.k5_takes,
              "K6": BX.k6_takes}


@pytest.mark.parametrize("entry", list(PREDICATES))
@pytest.mark.parametrize("D", [8, 32, 64, 96, 100, 128, 192, 256, 264, 320, 384, 512, 768, 1024, 1032, 2048])
def test_route_by_dtype_and_head_width(entry, D):
    takes = PREDICATES[entry]
    bf16 = A.attention_route(BF16, D, takes)
    assert bf16 == ("wgmma" if takes(D) else "simt" if 256 < D <= 1024 else None)
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
    before = (A.bshd_flash_attention.launches, A.simt_attention.launches, FA.gemm_f32.launches)
    out = A.bshd_flash_attention(q, k, v, None, H)
    torch.testing.assert_close(out, A._bshd_flash_plain(q, k, v, None, H), atol=0, rtol=0)
    assert (A.bshd_flash_attention.launches, A.simt_attention.launches, FA.gemm_f32.launches) == before


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


class _FakeLib:
    """Computes, on the host, what the C entries of the CUDA-core route and
    K7 compute, reading and writing through the arguments they are given;
    records each call. Any other entry fails the test."""

    def __init__(self):
        self.calls = []

    def btia_attn_simt(self, ptrs, strides, dims, qscale, nprob, D, mask_bytes, mult, elem, stream):
        dt = (F32, BF16)[elem]
        self.calls.append(("btia_attn_simt", dt, nprob, D, mult))
        for p in range(nprob):
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
            out = (_round(e, dt) @ v.float()) / (torch.clamp_min(den, 1e-30) if mult else den)
            o.copy_(out.to(dt))
        return 0

    def btia_gemm_f32(self, a, w, bias, resid, resid_rows, c, M, N, K, stream):
        self.calls.append(("btia_gemm_f32", M, N, K, resid is not None))
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


CASES = [(F32, 2, 64), (F32, 1, 96), (F32, 2, 48), (BF16, 1, 384), (BF16, 2, 320)]


@pytest.mark.parametrize("dt,H,D", CASES)
def test_k3_k4_host_code(dt, H, D, fake_lib):
    rng = np.random.RandomState(D)
    q, k, v = _rand(rng, 3, 17, H * D, dt=dt), _rand(rng, 3, 40, H * D, dt=dt), _rand(rng, 3, 40, H * D, dt=dt)
    m = _mask(rng, 3, 40)
    _close(A._bshd_flash_cuda(q, k, v, m, H), A._bshd_flash_plain(q, k, v, m, H), dt)
    cm = m.float()
    _close(A._fanout_cuda(q, k, v, cm, H), A._fanout_plain(q, k, v, cm, H), dt)
    assert [c[0] for c in fake_lib.calls] == ["btia_attn_simt"] * 2
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
    assert [(c[0], c[2]) for c in fake_lib.calls] == [("btia_attn_simt", 1), ("btia_attn_simt", 2)]


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
    assert fake_lib.calls[4][1:] == (F32, 1, D, 1)  # one problem, after-exp2 mask
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
    """K1/K2's core at bf16 D = 384 on the CUDA-core kernel, against
    ``attend_log2``: q rows already in the log2 domain (scale 1)."""
    rng = np.random.RandomState(6)
    B, Sq, Sk, H, D = 3, 5, 7, 1, 384
    q = _rand(rng, Sq if q_shared else B * Sq, H * D, dt=BF16)
    kv = _rand(rng, B * Sk, 2 * H * D, dt=BF16)
    m = _mask(rng, B, Sk)
    got = FA._core_cuda(q, kv, m, B, Sq, Sk, H, q_shared=q_shared)
    qb = q[None].expand(B, Sq, H * D) if q_shared else q.view(B, Sq, H * D)
    want = A.attend_log2(qb, kv[:, :H * D].reshape(B, Sk, -1), kv[:, H * D:].reshape(B, Sk, -1), m.float(), H)
    _close(got.view(B, Sq, -1), want, BF16)
    assert fake_lib.calls == [("btia_attn_simt", BF16, 1, D, 1)]
    assert not got.view(B, Sq, -1)[0].float().any()  # the fully masked row gives 0
