"""Head widths 128, 192 and 256 in the attention kernels K1/K2 (their
core), K3 and K4, and the head-width predicates of their CUDA wrappers.

The twins at D = 128 (and, in bf16, 192 and 256) run against the JAX
Pallas kernels in interpret mode on the CPU, as ``tests/test_ops.py`` runs
them, on the same numpy inputs. Tolerances as ``test_torch_kernels.py``:
fp32 2e-5 absolute; bf16 3e-2 absolute, one bf16 step at the outputs'
magnitude, since f32 sums taken in another order can flip a bf16 rounding.

The route tests replace every attention road of both packages with a stub
that records its name and returns zeros, so they compare decisions, not
numbers: over a grid of (Sq, Sk, H, D) the port takes the reference's road
at every head width. The predicates (``k3_takes``, ``k4_takes``,
``k5_takes``, ``core_takes``) say which widths each CUDA kernel is built for
(64 to 256 for K1-K4, the multiples of 8 up to 128 for K5); every width the
reference sends to K1-K4 up to 256 is one of them, and the CUDA wrappers
raise on the others.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btia_tpu.ops import attention as JA
from btia_tpu.ops import fused_attn as JFA
from btia_tpu_torch.ops import attention as A
from btia_tpu_torch.ops import fused_attn as FA

DTYPES = {"fp32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
WIDE = (192, 256)  # the widest tiles K1-K4 are built for


@pytest.fixture
def restore_switches():
    jax_impl, port_impl = JA.get_attention_impl(), A.get_attention_impl()
    yield
    JA.set_attention_impl(jax_impl)
    A.set_attention_impl(port_impl)


def _j(x, dt=jnp.float32):
    return None if x is None else jnp.asarray(x, dt)


def _t(x, dt=torch.float32):
    return None if x is None else torch.from_numpy(np.asarray(x)).to(dt)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=atol, rtol=0)


def _weights(rng, din, hd, dout):
    mk = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)
    return [mk(din, hd), mk(hd), mk(din, hd), mk(hd), mk(din, hd), mk(hd), mk(hd, dout), mk(dout)]


def _ln(rng, d, eps):
    return ((1.0 + 0.1 * rng.randn(d)).astype(np.float32), (0.1 * rng.randn(d)).astype(np.float32), eps)


def _mask(rng, B, Sk, dead_row=None):
    m = rng.rand(B, Sk) > 0.3
    m[:, 0] = True
    if dead_row is not None:
        m[dead_row] = False
    return m


# ---------------------------------------------------------------------------
# The twins at D = 128, 192 and 256 against the Pallas kernels
# ---------------------------------------------------------------------------

K1_SITES = {
    # name: (Sq, Sk, self-attention, pre-LNs, residual, post-LN eps)
    "bert": (32, 32, True, False, True, 1e-12),
    "btia": (50, 32, False, True, True, None),
    "tiled": (197, 32, False, True, False, None),  # Sq > 128: the tiled core
}


@pytest.mark.parametrize("site,dtype,D", [(s, dt, 128) for s in sorted(K1_SITES) for dt in sorted(DTYPES)]
                         + [(s, "bf16", d) for s in ("bert", "tiled") for d in WIDE])
def test_k1_matches_pallas(site, dtype, D):
    jdt, tdt, atol = DTYPES[dtype]
    Sq, Sk, self_attn, pre_ln, residual, post_eps = K1_SITES[site]
    rng = np.random.RandomState(31)
    B, H, Din = 3, 1, 128
    Sk = Sq if self_attn else Sk
    w = _weights(rng, Din, H * D, Din)
    x_q = rng.randn(B, Sq, Din).astype(np.float32)
    x_kv = x_q if self_attn else rng.randn(B, Sk, Din).astype(np.float32)
    mask = _mask(rng, B, Sk, dead_row=1)
    q_ln, kv_ln = (_ln(rng, Din, 1e-6), _ln(rng, Din, 1e-6)) if pre_ln else (None, None)
    post_ln = _ln(rng, Din, post_eps) if post_eps else None
    jln = lambda ln: None if ln is None else (_j(ln[0]), _j(ln[1]), ln[2])
    tln = lambda ln: None if ln is None else (_t(ln[0]), _t(ln[1]), ln[2])
    ref = JFA.fused_dense_attention(
        _j(x_q, jdt), _j(x_kv, jdt), jnp.asarray(mask), *map(_j, w), H, interpret=True,
        q_ln=jln(q_ln), kv_ln=jln(kv_ln), residual=residual, post_ln=jln(post_ln),
    )
    assert FA.core_admits(Sq, Sk, D)
    out = FA.fused_dense_attention(
        _t(x_q, tdt), _t(x_kv, tdt), torch.from_numpy(mask), *map(_t, w), H, interpret=True,
        q_ln=tln(q_ln), kv_ln=tln(kv_ln), residual=residual, post_ln=tln(post_ln),
    )
    assert out.dtype == tdt and out.shape == (B, Sq, Din)
    _close(out.float(), ref, atol)


@pytest.mark.parametrize("dtype,D", [(dt, 128) for dt in sorted(DTYPES)] + [("bf16", d) for d in WIDE])
def test_k2_matches_pallas(dtype, D):
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.RandomState(32)
    B, K, Sk, H, Din = 3, 8, 82, 1, 128
    w = _weights(rng, Din, H * D, Din)
    queries = (rng.randn(K, Din) * 0.05).astype(np.float32)
    x_kv = rng.randn(B, Sk, Din).astype(np.float32)
    mask = _mask(rng, B, Sk, dead_row=2)
    kv_ln = _ln(rng, Din, 1e-6)
    ref = JFA.fused_static_q_attention(
        _j(queries, jdt), _j(x_kv, jdt), jnp.asarray(mask), *map(_j, w), H,
        interpret=True, kv_ln=(_j(kv_ln[0]), _j(kv_ln[1]), kv_ln[2]), residual=True,
    )
    out = FA.fused_static_q_attention(
        _t(queries, tdt), _t(x_kv, tdt), torch.from_numpy(mask), *map(_t, w), H, interpret=True,
        kv_ln=(_t(kv_ln[0]), _t(kv_ln[1]), kv_ln[2]), residual=True,
    )
    assert out.dtype == tdt and out.shape == (B, K, Din)
    _close(out.float(), ref, atol)


K3_SHAPES = {
    # name: (B, Sq, Sk, H, masked); Sq*Sk above 32768, the long road
    "vit_h6": (1, 197, 197, 6, False),
    "head_masked": (2, 300, 129, 2, True),
}


@pytest.mark.parametrize("shape,dtype,D", [(s, dt, 128) for s in sorted(K3_SHAPES) for dt in sorted(DTYPES)]
                         + [("head_masked", "bf16", d) for d in WIDE])
def test_k3_matches_pallas(shape, dtype, D, restore_switches):
    jdt, tdt, atol = DTYPES[dtype]
    B, Sq, Sk, H, masked = K3_SHAPES[shape]
    rng = np.random.RandomState(33)
    q, k, v = (rng.randn(B, S, H * D).astype(np.float32) for S in (Sq, Sk, Sk))
    mask = _mask(rng, B, Sk) if masked else None
    ref = JA._bshd_mha(_j(q, jdt), _j(k, jdt), _j(v, jdt), None if mask is None else jnp.asarray(mask), H, True)
    tmask = None if mask is None else torch.from_numpy(mask)
    out = A.bshd_flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), tmask, H)
    assert out.dtype == tdt and out.shape == (B, Sq, H * D)
    _close(out.float(), ref, atol)
    # mha_bshd takes K3 at this width, as the reference does.
    routed = A.mha_bshd(*(_t(x, tdt).reshape(B, -1, H, D) for x in (q, k, v)), tmask)
    torch.testing.assert_close(routed.reshape(B, Sq, H * D), out, rtol=0, atol=0)


K4_SHAPES = {
    # name: (B, Sq, Sk, H)
    "square": (5, 16, 16, 2),
    "long_q": (3, 70, 9, 1),
    "long_kv": (4, 7, 70, 2),
}


@pytest.mark.parametrize("shape,dtype,D", [(s, dt, 128) for s in sorted(K4_SHAPES) for dt in sorted(DTYPES)]
                         + [("long_kv", "bf16", d) for d in WIDE])
def test_k4_matches_pallas(shape, dtype, D):
    jdt, tdt, atol = DTYPES[dtype]
    B, Sq, Sk, H = K4_SHAPES[shape]
    rng = np.random.RandomState(34)
    q, k, v = (rng.randn(B, S, H * D).astype(np.float32) for S in (Sq, Sk, Sk))
    cm = (rng.rand(B, Sk) > 0.3).astype(np.float32)
    cm[:, 0] = 1.0
    cm[1] = 0.0  # a fully masked row: 0 on both sides
    ref = JA._fanout_mha(*(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(cm), H, True)
    out = A.fanout_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), torch.from_numpy(cm), H)
    assert out.dtype == tdt and out.shape == (B, Sq, H * D)
    _close(out.float(), ref, atol)
    assert not out[1].any()


# ---------------------------------------------------------------------------
# The predicates against the reference's routes
# ---------------------------------------------------------------------------

HEAD_WIDTHS = (32, 48, 64, 96, 128, 192, 256)


def _stub_roads(monkeypatch):
    """Replace both packages' attention roads with recorders that return
    zeros of the road's output shape; returns (reference roads, port roads)."""
    jtook, ttook = [], []

    def jstub(road, shape_of):
        return lambda *a, **k: jtook.append(road) or jnp.zeros(shape_of(*a), a[0].dtype)

    def tstub(road, shape_of):
        return lambda *a, **k: ttook.append(road) or torch.zeros(shape_of(*a), dtype=a[0].dtype)

    same = lambda q, *a: q.shape
    monkeypatch.setattr(JA, "_bshd_mha", jstub("k3", same))
    monkeypatch.setattr(JA, "_mha", jstub("k5", same))
    monkeypatch.setattr(JA, "_fanout_mha", jstub("k4", same))
    monkeypatch.setattr(A, "bshd_flash_attention", tstub("k3", same))
    monkeypatch.setattr(A, "mha_bhsd_attention", tstub("k5", same))
    monkeypatch.setattr(A, "fanout_attention", tstub("k4", same))
    return jtook, ttook


TAKES = {"k3": A.k3_takes, "k4": A.k4_takes, "k5": A.k5_takes}


def _route(monkeypatch, B, Sq, Sk, H, Dh):
    jtook, ttook = _stub_roads(monkeypatch)
    q = np.zeros((B, Sq, H, Dh), np.float32)
    k = np.zeros((B, Sk, H, Dh), np.float32)
    JA.set_attention_impl("pallas")
    JA.mha_bshd(_j(q), _j(k), _j(k), None)
    A.mha_bshd(_t(q), _t(k), _t(k), None)
    return (jtook or ["einsum"])[0], (ttook or ["einsum"])[0]


@pytest.mark.parametrize("Dh", HEAD_WIDTHS)
def test_long_road_predicates_match_reference(Dh, monkeypatch, restore_switches):
    """Long score tiles (Sq*Sk > 32768): K3 where D % 64 == 0 and
    H*D % 128 == 0, else K5, in both packages at every width; K3's CUDA
    kernel is built for every width that reaches it here."""
    for Sq, Sk in ((200, 200), (577, 577), (2048, 17)):
        for H in (1, 2, 3):
            ref, port = _route(monkeypatch, 1, Sq, Sk, H, Dh)
            assert port == ref, (Sq, Sk, H, Dh, ref, port)
            if port == "k3":
                assert TAKES[port](Dh)
            assert A.k3_takes(Dh) == (Dh % 64 == 0 and Dh <= 256)


@pytest.mark.parametrize("Dh", HEAD_WIDTHS + (320,))
def test_short_road_predicates_match_reference(Dh, monkeypatch, restore_switches):
    """Short score tiles: K4 at a batch of 64 or more where D % 64 == 0,
    else the einsum road, in both packages at every width; K4's CUDA kernel
    is built for the multiples of 64 up to 256."""
    for B in (8, 63, 64):
        for Sq, Sk in ((8, 8), (32, 197), (128, 256)):
            ref, port = _route(monkeypatch, B, Sq, Sk, 1, Dh)
            assert port == ref, (B, Sq, Sk, Dh, ref, port)
            if port in TAKES:
                assert TAKES[port](Dh) == (Dh <= 256)
            assert A.k4_takes(Dh) == (Dh % 64 == 0 and Dh <= 256)


def _sds(*shape):
    """A shape without data: the gates read only shapes (nothing is run)."""
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _reference_fuses(monkeypatch, Sq, Sk, H, HD, B=64, din_q=128, din_kv=128, dout=128):
    """Whether the reference's fused_dense_attention takes its Pallas road
    for this site with the Pallas backend forced on (nothing is run)."""
    took = []
    monkeypatch.setattr(JFA, "_resolved_impl", lambda: "pallas")
    monkeypatch.setattr(JFA, "_fused_site", lambda *a: took.append("fused"))
    monkeypatch.setattr(JFA, "_unfused_site", lambda *a: took.append("unfused"))
    ln = (_sds(din_q), _sds(din_q), 1e-6)
    JFA.fused_dense_attention(_sds(B, Sq, din_q), _sds(B, Sk, din_kv), None, _sds(din_q, HD), _sds(HD),
                              _sds(din_kv, HD), _sds(HD), _sds(din_kv, HD), _sds(HD), _sds(HD, dout),
                              _sds(dout), H, q_ln=ln, residual=dout == din_q)
    return took == ["fused"]


def _reference_static_q_fuses(monkeypatch, K, Sk, H, HD, B=64, din_q=128, din_kv=128, dout=128):
    """The same for the reference's fused_static_q_attention (K2)."""
    took = []
    monkeypatch.setattr(JFA, "_resolved_impl", lambda: "pallas")
    monkeypatch.setattr(JFA, "_staticq_site", lambda *a: took.append("fused"))
    monkeypatch.setattr(JFA, "_staticq_unfused_site", lambda *a: took.append("unfused"))
    ln = (_sds(din_kv), _sds(din_kv), 1e-6)
    JFA.fused_static_q_attention(_sds(K, din_q), _sds(B, Sk, din_kv), None, _sds(din_q, HD), _sds(HD),
                                 _sds(din_kv, HD), _sds(HD), _sds(din_kv, HD), _sds(HD), _sds(HD, dout),
                                 _sds(dout), H, kv_ln=ln, residual=dout == din_q)
    return took == ["fused"]


# (H, HD, B, (din_q, din_kv, dout)): head widths 128 to 384 at a batch of 64;
# the batch floor; q, kv and output widths and head widths that are not
# multiples of 128 (96, and H = 3 heads of 64), and 640, which is.
GATE_CASES = (
    [(h, hd, 64, (128, 128, 128))
     for h, hd in ((1, 128), (2, 256), (3, 384), (1, 256), (2, 384), (4, 768), (3, 768), (1, 384))]
    + [(2, 256, b, (128, 128, 128)) for b in (1, 32, 63, 128)]
    + [(1, 128, 64, w) for w in ((96, 128, 128), (640, 128, 128), (128, 96, 128), (128, 640, 128),
                                 (128, 128, 96), (128, 128, 640))]
    + [(1, 96, 64, (128, 128, 128)), (10, 640, 64, (128, 128, 128)), (3, 192, 64, (128, 128, 128)),
       (1, 64, 32, (640, 96, 640))]
)
GATE_SQ, GATE_SK = (1, 32, 50, 64, 82, 128, 129, 197, 256, 577), (1, 32, 64, 129, 197, 229, 577)


@pytest.mark.parametrize("H,HD,B,widths", GATE_CASES)
def test_core_gate_matches_reference(H, HD, B, widths, monkeypatch, restore_switches):
    """The fused sites' gate is the reference's over a grid of (Sq, Sk) at
    D = 128, 192 and 256 (one to four heads) and at D = 384, where the
    reference fuses too and the port's core, built up to 256, raises on
    the card; at batches below and above the floor of 64, and at q, kv,
    head and output widths that are and are not multiples of 128. The
    port once dropped the floor and the width gates and fused every such
    site."""
    din_q, din_kv, dout = widths
    Dh = HD // H
    A.set_attention_impl("pallas")
    for sq in GATE_SQ:
        for sk in GATE_SK:
            ref = _reference_fuses(monkeypatch, sq, sk, H, HD, B, din_q, din_kv, dout)
            port = FA._fuses(B, sq, sk, H, din_q, din_kv, HD, dout)
            assert port == ref, (B, sq, sk, H, HD, widths, ref, port)
            assert FA._fuses(B, sq, sk, H, din_q, din_kv, HD, dout, interpret=True)
    assert FA.core_takes(Dh) == (Dh in (64, 128, 192, 256))
    A.set_attention_impl("xla")
    assert not FA._fuses(B, 32, 32, H, din_q, din_kv, HD, dout)
    with FA.disable_fused():
        assert not FA._fuses(B, 32, 32, H, din_q, din_kv, HD, dout, interpret=True)


@pytest.mark.parametrize("H,HD,B,widths", GATE_CASES)
def test_static_q_gate_matches_reference(H, HD, B, widths, monkeypatch, restore_switches):
    """K2's gate is the reference's (``fused_attn.py:933-941``): the query
    table's K rows as Sq, x_kv's batch, the same width gates."""
    din_q, din_kv, dout = widths
    A.set_attention_impl("pallas")
    for k in (8, 64, 128, 577):
        for sk in GATE_SK:
            ref = _reference_static_q_fuses(monkeypatch, k, sk, H, HD, B, din_q, din_kv, dout)
            assert FA._fuses(B, k, sk, H, din_q, din_kv, HD, dout) == ref, (B, k, sk, H, HD, widths, ref)


@pytest.mark.parametrize("Dh", [32, 96, 320, 384])
def test_cuda_wrappers_raise_through_the_predicates(Dh, monkeypatch):
    """The CUDA halves of K1/K2's core, K3 and K4 refuse a bf16 head width
    their tensor-core predicate refuses at or below 256 (D = 32, 96), before
    any kernel is built or launched; above 256 (D = 320, 384) they take the
    wide route, the wide-head kernel, which refuses these CPU tensors before
    anything is built."""
    H = 2
    x = torch.zeros(1, 4, H * Dh, dtype=torch.bfloat16)
    widths = r"\(64, 128, 192, 256\)"
    monkeypatch.setattr(A._native, "lib", lambda: pytest.fail("a kernel was built"))
    wide = Dh > 256
    match = (lambda what: r"the CUDA kernel takes a .*CUDA tensor, got torch.bfloat16 on cpu") if wide else (
        lambda what: what + " takes head widths " + widths)
    with pytest.raises(ValueError, match=match("K3 kernel")):
        A._bshd_flash_cuda(x, x, x, None, H)
    with pytest.raises(ValueError, match=match("K4 kernel")):
        A._fanout_cuda(x, x, x, torch.ones(1, 4), H)
    with pytest.raises(ValueError, match=match("attention core")):
        FA._core_cuda(x.view(4, H * Dh), torch.zeros(4, 2 * H * Dh, dtype=torch.bfloat16), None, 1, 4, 4, H)
    assert not (A.k3_takes(Dh) or A.k4_takes(Dh) or FA.core_takes(Dh))
    for takes in (A.k3_takes, A.k4_takes, FA.core_takes):
        assert A.attention_route(torch.bfloat16, Dh, takes) == ("wide" if wide else None)
