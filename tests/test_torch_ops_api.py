"""The port's ops API against the JAX package's: ``mha`` and K5, ``bicross_*``
and K6, the attention switch, ``disable_fused`` and the routing of
``mha_bshd``.

The JAX kernels run in interpret mode on the CPU, as ``tests/test_ops.py``
runs them; the port's kernel entries take their plain PyTorch twins for CPU
tensors. Both sides get the same numpy inputs.

Tolerances as ``test_torch_kernels.py``: fp32 2e-5 absolute; bf16 3e-2
absolute, one bf16 step at the outputs' magnitude, since f32 sums taken in
another order can flip a bf16 rounding. Backward passes against ``jax.vjp``
in fp32 at 1e-4. Rows whose every key is masked are left out of the
comparisons with the Pallas K5/K6: the TPU kernel pads the keys to a
multiple of 128 with -1e9 and there averages V over the padded count, the
port over the real keys, as ``mha_reference`` (pinned below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btia_tpu.ops import attention as JA
from btia_tpu.ops import bicross as JB
from btia_tpu.ops import fused_attn as JFA
from btia_tpu_torch.ops import _native
from btia_tpu_torch.ops import attention as A
from btia_tpu_torch.ops import bicross as BX
from btia_tpu_torch.ops import fused_attn as FA

DTYPES = {"fp32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


@pytest.fixture
def restore_switches():
    """Every test that sets a switch restores both packages' switches."""
    jax_impl, port_impl = JA.get_attention_impl(), A.get_attention_impl()
    yield
    JA.set_attention_impl(jax_impl)
    A.set_attention_impl(port_impl)
    assert FA._ENABLED and JFA._ENABLED


def _bhsd(rng, B, H, S, D):
    return rng.randn(B, H, S, D).astype(np.float32)


def _live_mask(rng, B, Sk):
    m = rng.rand(B, Sk) > 0.3
    m[:, 0] = True  # every row keeps a live key
    return m


def _j(x, dt=jnp.float32):
    return None if x is None else jnp.asarray(x, dt)


def _t(x, dt=torch.float32):
    return None if x is None else torch.from_numpy(np.asarray(x)).to(dt)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=atol, rtol=0)


def test_exports_match_the_reference_package():
    import btia_tpu.ops as jops
    import btia_tpu_torch.ops as tops

    names = {n for n in dir(jops) if not n.startswith("_") and callable(getattr(jops, n))}
    assert "fused_mesh" in names and names <= set(dir(tops))


# ---------------------------------------------------------------------------
# K5: mha(impl="pallas")
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "dense"])
@pytest.mark.parametrize("D", [16, 48, 64, 96])
def test_k5_twin_matches_pallas(D, masked, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.RandomState(D)
    B, H, Sq, Sk = 2, 2, 40, 70
    q, k, v = _bhsd(rng, B, H, Sq, D), _bhsd(rng, B, H, Sk, D), _bhsd(rng, B, H, Sk, D)
    mask = _live_mask(rng, B, Sk) if masked else None
    ref = JA.mha(_j(q, jdt), _j(k, jdt), _j(v, jdt), _j(mask, bool), impl="pallas", interpret=True)
    before = A.mha_bhsd_attention.launches
    out = A.mha(_t(q, tdt), _t(k, tdt), _t(v, tdt), _t(mask, torch.bool), impl="pallas")
    assert A.mha_bhsd_attention.launches == before  # CPU: the plain twin
    assert out.dtype == tdt and out.shape == (B, H, Sq, D)
    _close(out.float(), ref, atol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", [100, 136, 192, 256])
def test_k5_twin_matches_pallas_at_wide_heads(D, dtype):
    """K5 takes every head width up to 256 on the card (the reference pads
    any width: to D when D % 64 == 0, else to a multiple of 128); its twin
    matches the Pallas kernel at widths past the old limit of 128 and at
    one that is not a multiple of 8 (the wrapper's padded copy)."""
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.RandomState(D + 1)
    B, H, Sq, Sk = 2, 2, 40, 70
    q, k, v = _bhsd(rng, B, H, Sq, D), _bhsd(rng, B, H, Sk, D), _bhsd(rng, B, H, Sk, D)
    mask = _live_mask(rng, B, Sk)
    ref = JA.mha(_j(q, jdt), _j(k, jdt), _j(v, jdt), _j(mask, bool), impl="pallas", interpret=True)
    out = A.mha(_t(q, tdt), _t(k, tdt), _t(v, tdt), _t(mask, torch.bool), impl="pallas")
    assert out.dtype == tdt and out.shape == (B, H, Sq, D)
    _close(out.float(), ref, atol)


def test_k5_and_k6_width_predicates():
    """k5_takes and k6_takes: every width up to 256 (each kernel's four
    templates pad D to a multiple of 64 in shared memory, and the wrapper
    pads a width that is not a multiple of 8)."""
    for D in range(1, 400):
        assert A.k5_takes(D) == (D <= 256), D
        assert BX.k6_takes(D) == (D <= 256), D
    assert [D for D in (8, 40, 96, 100, 136, 192, 200, 256, 257) if A.k5_takes(D)] == [
        8, 40, 96, 100, 136, 192, 200, 256]


def test_k5_fully_masked_row_averages_the_real_keys():
    """The port's K5 (twin and kernel alike) gives a row whose every key is
    masked the mean of V over the Sk real keys, as mha_reference does; the
    TPU kernel averages over Sk rounded up to 128 (zero padded values)."""
    rng = np.random.RandomState(3)
    B, H, Sq, Sk, D = 2, 2, 8, 50, 32
    q, k, v = _bhsd(rng, B, H, Sq, D), _bhsd(rng, B, H, Sk, D), _bhsd(rng, B, H, Sk, D)
    mask = _live_mask(rng, B, Sk)
    mask[1] = False
    out = A.mha_bhsd_attention(_t(q), _t(k), _t(v), _t(mask, torch.bool))
    _close(out[1], np.broadcast_to(v[1].mean(axis=1, keepdims=True), (H, Sq, D)), 2e-5)
    _close(out[1], A.mha_reference(_t(q), _t(k), _t(v), _t(mask, torch.bool))[1], 2e-5)
    pal = JA.mha(_j(q), _j(k), _j(v), _j(mask, bool), impl="pallas", interpret=True)
    _close(np.asarray(pal)[1], v[1].sum(axis=1, keepdims=True).repeat(Sq, 1) / 128, 2e-5)
    _close(out[0], pal[0], 2e-5)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "dense"])
def test_k5_backward_matches_jax_vjp(masked):
    rng = np.random.RandomState(11)
    B, H, Sq, Sk, D = 2, 2, 24, 40, 48
    q, k, v = _bhsd(rng, B, H, Sq, D), _bhsd(rng, B, H, Sk, D), _bhsd(rng, B, H, Sk, D)
    mask = _live_mask(rng, B, Sk) if masked else None
    g = rng.randn(B, H, Sq, D).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: JA.mha(a, b, c, _j(mask, bool), impl="pallas", interpret=True),
                     _j(q), _j(k), _j(v))
    want = vjp(_j(g))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = A.mha(*leaves, _t(mask, torch.bool), impl="pallas")
    got = torch.autograd.grad(out, leaves, _t(g))
    for a, b in zip(got, want):
        _close(a, b, 1e-4)


@pytest.mark.parametrize("impl", ["packed", "xla"])
def test_mha_plain_roads_match_reference(impl):
    rng = np.random.RandomState(12)
    B, H, Sq, Sk, D = 2, 4, 7, 11, 16
    q, k, v = _bhsd(rng, B, H, Sq, D), _bhsd(rng, B, H, Sk, D), _bhsd(rng, B, H, Sk, D)
    mask = rng.rand(B, Sk) > 0.3
    out = A.mha(_t(q), _t(k), _t(v), _t(mask, torch.bool), impl=impl)
    _close(out, A.mha_reference(_t(q), _t(k), _t(v), _t(mask, torch.bool)), 1e-5)
    _close(out, JA.mha_reference(_j(q), _j(k), _j(v), _j(mask, bool)), 2e-5)
    _close(out, JA.mha(_j(q), _j(k), _j(v), _j(mask, bool), impl=impl), 2e-5)


def test_mha_auto_small_tile_rule(monkeypatch, restore_switches):
    """impl=None: the plain road up to a 32768 score tile, K5 above it,
    unless the switch says "xla" (attention.py:740-746)."""
    calls = []
    real = A._mha_bhsd_plain
    monkeypatch.setattr(A, "_mha_bhsd_plain", lambda *a: calls.append(a[0].shape) or real(*a))
    small = torch.zeros(1, 1, 128, 8), torch.zeros(1, 1, 256, 8)  # 32768: not above
    big = torch.zeros(1, 1, 129, 8), torch.zeros(1, 1, 256, 8)
    for impl in ("auto", "pallas", "xla"):
        A.set_attention_impl(impl)
        for q, k in (small, big):
            A.mha(q, k, k)
    assert calls == [big[0].shape, big[0].shape]
    with pytest.raises(ValueError, match="unknown attention impl"):
        A.set_attention_impl("triton")


# ---------------------------------------------------------------------------
# K6: bicross_attention(impl="pallas")
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,D", [("fp32", 64), ("bf16", 64), ("fp32", 48),
                                     *((dt, D) for D in (136, 192, 256) for dt in ("fp32", "bf16"))])
def test_k6_twin_matches_pallas(dtype, D):
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.RandomState(13)
    B, H, Ni, Nt = 3, 2, 50, 20
    img = [_bhsd(rng, B, H, Ni, D) for _ in range(3)]
    txt = [_bhsd(rng, B, H, Nt, D) for _ in range(3)]
    mask = _live_mask(rng, B, Nt)
    ri, rt = JB.bicross_attention(*(_j(x, jdt) for x in img + txt), _j(mask, bool),
                                  impl="pallas", interpret=True)
    before = BX.bicross_bhsd_attention.launches
    oi, ot = BX.bicross_attention(*(_t(x, tdt) for x in img + txt), _t(mask, torch.bool), impl="pallas")
    assert BX.bicross_bhsd_attention.launches == before
    assert oi.dtype == ot.dtype == tdt and oi.shape == (B, H, Ni, D) and ot.shape == (B, H, Nt, D)
    _close(oi.float(), ri, atol)
    _close(ot.float(), rt, atol)


def test_k6_backward_matches_jax_vjp():
    rng = np.random.RandomState(14)
    B, H, Ni, Nt, D = 2, 2, 30, 12, 32
    arrays = [_bhsd(rng, B, H, n, D) for n in (Ni, Ni, Ni, Nt, Nt, Nt)]
    mask = _live_mask(rng, B, Nt)
    gi, gt = rng.randn(B, H, Ni, D).astype(np.float32), rng.randn(B, H, Nt, D).astype(np.float32)
    _, vjp = jax.vjp(lambda *xs: JB.bicross_attention(*xs, _j(mask, bool), impl="pallas", interpret=True),
                     *map(_j, arrays))
    want = vjp((_j(gi), _j(gt)))
    leaves = [_t(x).requires_grad_(True) for x in arrays]
    oi, ot = BX.bicross_attention(*leaves, _t(mask, torch.bool), impl="pallas")
    got = torch.autograd.grad((oi, ot), leaves, (_t(gi), _t(gt)))
    for a, b in zip(got, want):
        _close(a, b, 1e-4)


def test_bicross_reference_and_auto_road():
    """bicross_reference is mha_reference in each direction; impl=None at a
    pooled shape (Ni*Nt <= 32768) takes it, as the reference does."""
    rng = np.random.RandomState(15)
    B, H, Ni, Nt, D = 2, 2, 50, 32, 16
    arrays = [_bhsd(rng, B, H, n, D) for n in (Ni, Ni, Ni, Nt, Nt, Nt)]
    mask = _live_mask(rng, B, Nt)
    ri, rt = JB.bicross_reference(*map(_j, arrays), _j(mask, bool))
    oi, ot = BX.bicross_reference(*map(_t, arrays), _t(mask, torch.bool))
    _close(oi, ri, 2e-5)
    _close(ot, rt, 2e-5)
    ai, at = BX.bicross_attention(*map(_t, arrays), _t(mask, torch.bool))
    assert torch.equal(ai, oi) and torch.equal(at, ot)


def test_bicross_bshd_long_tile_takes_k6(monkeypatch):
    rng = np.random.RandomState(16)
    B, Ni, Nt, H, D = 2, 300, 120, 2, 32  # 36000 > 32768
    img = [rng.randn(B, Ni, H, D).astype(np.float32) for _ in range(3)]
    txt = [rng.randn(B, Nt, H, D).astype(np.float32) for _ in range(3)]
    mask = _live_mask(rng, B, Nt)
    calls = []
    real = BX._bicross_plain
    monkeypatch.setattr(BX, "_bicross_plain", lambda *a: calls.append(1) or real(*a))
    oi, ot = BX.bicross_bshd(*map(_t, img + txt), _t(mask, torch.bool))
    assert calls == [1] and oi.shape == (B, Ni, H, D) and ot.shape == (B, Nt, H, D)
    t = lambda x: np.swapaxes(x, 1, 2)
    ri, rt = JB.bicross_reference(*(_j(t(x)) for x in img + txt), _j(mask, bool))
    _close(oi, t(np.asarray(ri)), 2e-5)
    _close(ot, t(np.asarray(rt)), 2e-5)
    ji, jt = JB.bicross_bshd(*map(_j, img + txt), _j(mask, bool))  # JAX on the CPU: the XLA road
    _close(oi, ji, 2e-5)
    _close(ot, jt, 2e-5)


# ---------------------------------------------------------------------------
# mha_bshd: the port's route equals the reference's
# ---------------------------------------------------------------------------

ROUTE_GRID = {
    # name: (B, Sq, Sk, H, D, road)
    "long_d64_h2": (2, 256, 256, 2, 64, "k3"),
    "long_d64_h3": (1, 256, 200, 3, 64, "k5"),  # H*D % 128 != 0
    "long_d48": (2, 256, 200, 2, 48, "k5"),
    "long_d96": (1, 300, 229, 2, 96, "k5"),
    "short_b64": (64, 8, 12, 2, 64, "k4"),
    "short_b64_d32": (64, 8, 12, 2, 32, "einsum"),
    "short_b4_d48": (4, 16, 24, 2, 48, "einsum"),
    "edge_32768": (2, 128, 256, 1, 128, "einsum"),
    "long_d128_h1": (1, 300, 229, 1, 128, "k3"),
    "long_d128_h3": (1, 200, 180, 3, 128, "k3"),
    "short_b64_d128": (64, 8, 12, 1, 128, "k4"),
    "short_b4_d128": (4, 40, 50, 2, 128, "einsum"),
    "long_d192_h2": (1, 200, 180, 2, 192, "k3"),
    "long_d192_h1": (1, 200, 180, 1, 192, "k5"),  # H*D % 128 != 0
    "long_d256_h1": (1, 200, 180, 1, 256, "k3"),
    "short_b64_d256": (64, 8, 12, 1, 256, "k4"),
    "long_d136_h2": (1, 260, 229, 2, 136, "k5"),  # D % 64 != 0, above K5's old 128
    "long_d200_h1": (1, 200, 180, 1, 200, "k5"),
}


def _spy_roads(monkeypatch, module, names):
    took = []
    for road, attr in names.items():
        real = getattr(module, attr)
        monkeypatch.setattr(module, attr, lambda *a, _r=real, _road=road, **kw: took.append(_road) or _r(*a, **kw))
    return took


@pytest.mark.parametrize("case", sorted(ROUTE_GRID))
def test_mha_bshd_route_matches_reference(case, monkeypatch, restore_switches):
    """The port once sent every long tile to K3, whose CUDA kernel took
    only D = 64; the reference sends D % 64 != 0 or H*D % 128 != 0 to K5,
    and every other multiple of 64 (128, 192, 256 here) to K3 (long tiles)
    and K4 (short ones at a batch of 64).
    Here both packages, with the reference's switch on its kernels
    (interpret mode), take the same road and agree."""
    B, Sq, Sk, H, D, road = ROUTE_GRID[case]
    rng = np.random.RandomState(17)
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for S in (Sq, Sk, Sk))
    mask = _live_mask(rng, B, Sk)
    jtook = _spy_roads(monkeypatch, JA, {"k3": "_bshd_mha", "k5": "_mha", "k4": "_fanout_mha"})
    ttook = _spy_roads(monkeypatch, A, {"k3": "bshd_flash_attention", "k5": "mha_bhsd_attention",
                                        "k4": "fanout_attention"})
    JA.set_attention_impl("pallas")
    ref = JA.mha_bshd(_j(q), _j(k), _j(v), _j(mask, bool), interpret=True)
    out = A.mha_bshd(_t(q), _t(k), _t(v), _t(mask, torch.bool))
    assert jtook == ttook == ([] if road == "einsum" else [road])
    assert out.shape == (B, Sq, H, D)
    _close(out, ref, 2e-5)


def test_mha_bshd_long_road_d96_bf16_matches_pallas(restore_switches):
    """At D = 96 the long road is K5 in both packages: bf16 outputs agree
    within one bf16 step (K3's twin divides before PV and would not)."""
    rng = np.random.RandomState(18)
    B, Sq, Sk, H, D = 1, 260, 229, 2, 96
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for S in (Sq, Sk, Sk))
    mask = _live_mask(rng, B, Sk)
    JA.set_attention_impl("pallas")
    ref = JA.mha_bshd(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16), _j(mask, bool),
                      interpret=True)
    out = A.mha_bshd(_t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16),
                     _t(mask, torch.bool))
    assert out.dtype == torch.bfloat16
    _close(out.float(), ref, 3e-2)


def test_mha_bshd_xla_switch_takes_the_einsum_road(monkeypatch, restore_switches):
    took = _spy_roads(monkeypatch, A, {"k3": "bshd_flash_attention", "k5": "mha_bhsd_attention",
                                       "k4": "fanout_attention"})
    A.set_attention_impl("xla")
    rng = np.random.RandomState(19)
    for B, S, H, D in ((2, 200, 2, 64), (2, 200, 3, 48), (64, 8, 2, 64)):
        q = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32))
        out = A.mha_bshd(q, q, q)
        ref = A.mha_reference(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2)).transpose(1, 2)
        _close(out, ref, 2e-5)
    assert took == []


# ---------------------------------------------------------------------------
# The switches on a small model
# ---------------------------------------------------------------------------

SMALL = {
    "model.image_encoder": "vit_test", "model.bert_layers": 2, "model.bert_hidden": 128,
    "model.bert_heads": 2, "model.hidden_dim": 128, "model.num_heads": 2, "model.btia_layers": 1,
    "model.answer_vocab_size": 64, "model.num_answer_queries": 8,
}


@pytest.fixture(scope="module")
def small_model():
    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.models.model import build_model

    model = build_model(get_config("streaming_vitl", **SMALL).model, device="cpu", seed=0)
    assert model.policy.compute_dtype == torch.bfloat16
    rng = np.random.RandomState(20)
    images = torch.from_numpy(rng.randint(0, 256, (2, 96, 96, 3)).astype(np.uint8))
    # 2 images x 32 questions: 64 question rows, the fused sites' batch floor.
    qids = np.zeros((2, 32, 32), np.int64)
    for i in range(2):
        for j in range(32):
            n = rng.randint(3, 33)
            qids[i, j, :n] = rng.randint(1, 500, n)
    return model, images, torch.from_numpy(qids)


def _forward_recording(monkeypatch, model, images, qids):
    """The model's logits, and the kernel entries whose route ran (on the
    CPU: their plain twins)."""
    entries = []
    real = _native.route
    monkeypatch.setattr(_native, "route", lambda e, *a: entries.append(e.__name__) or real(e, *a))
    with torch.inference_mode():
        logits = model.answer_questions(model.encode_image(images), qids)
    monkeypatch.setattr(_native, "route", real)
    return logits, entries


@pytest.mark.parametrize("road", ["xla", "disable_fused"])
def test_switches_route_a_small_model_to_the_plain_road(road, small_model, monkeypatch, restore_switches):
    model, images, qids = small_model
    auto, auto_entries = _forward_recording(monkeypatch, model, images, qids)
    assert {"fused_dense_attention", "fused_static_q_attention"} <= set(auto_entries)
    if road == "xla":
        A.set_attention_impl("xla")
        out, entries = _forward_recording(monkeypatch, model, images, qids)
        # No attention entry: only the LayerNorms' own (K7 on the card).
        assert set(entries) == {"layernorm"}
    else:
        with FA.disable_fused():
            out, entries = _forward_recording(monkeypatch, model, images, qids)
        assert not {"fused_dense_attention", "fused_static_q_attention"} & set(entries)
    assert out.shape == auto.shape == (2, 32, 64) and bool(torch.isfinite(out).all())
    _close(out, auto, 1e-2)


def test_disable_fused_is_authoritative_over_the_switch(monkeypatch, restore_switches):
    """Inside disable_fused() the fused entries take the unfused road even
    with the switch on the kernels and interpret=True (which forces the
    fused road at this batch of 3, under the floor of 64), and the context
    restores on exit."""
    rng = np.random.RandomState(21)
    B, S, Din, H = 3, 8, 128, 2
    w = [torch.from_numpy((rng.randn(*s) * 0.05).astype(np.float32))
         for s in ((Din, 128), (128,)) * 3 + ((128, Din), (Din,))]
    x = torch.from_numpy(rng.randn(B, S, Din).astype(np.float32))
    took = []
    real = FA._fused_dense_plain
    monkeypatch.setattr(FA, "_fused_dense_plain", lambda *a: took.append(1) or real(*a))
    A.set_attention_impl("pallas")
    fused = FA.fused_dense_attention(x, x, None, *w, H, interpret=True)
    with FA.disable_fused():
        assert not FA._ENABLED
        unfused = FA.fused_dense_attention(x, x, None, *w, H, interpret=True)
        with pytest.raises(RuntimeError):
            with FA.disable_fused():
                raise RuntimeError
        assert not FA._ENABLED
    assert FA._ENABLED and took == [1]
    _close(unfused, fused, 2e-5)


# ---------------------------------------------------------------------------
# No quiet fallback
# ---------------------------------------------------------------------------


def test_k5_k6_entries_have_no_fallback():
    """K5 and K6 take their twins only for a CPU tensor; any other device
    launches the kernel (CUDA) or raises."""
    t = torch.empty(1, 2, 8, 16, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        A.mha_bhsd_attention(t, t, t)
    with pytest.raises(ValueError, match="unsupported device"):
        BX.bicross_bhsd_attention(t, t, t, t, t, t)
    assert A.mha_bhsd_attention.launches == 0 and BX.bicross_bhsd_attention.launches == 0
    # The CUDA halves refuse, through their predicates, a width no kernel
    # takes (above 1024), before anything is built or launched; from 257 to
    # 1024 (and in f32) they take the CUDA-core kernel, which refuses a CPU
    # tensor, also before anything is built.
    with pytest.raises(ValueError, match=r"K5 kernel takes head widths up to 256 in bf16.*D = 1032"):
        A._mha_bhsd_cuda(*(torch.zeros(1, 2, 8, 1032),) * 3, None)
    for D in (264, 320):
        x = torch.zeros(1, 2, 8, D)
        with pytest.raises(ValueError, match="the CUDA kernel takes a torch.float32 CUDA tensor, got torch.float32 on cpu"):
            BX._bicross_cuda(x, x, x, x, x, x, None)
        with pytest.raises(ValueError, match="the CUDA kernel takes a torch.float32 CUDA tensor, got torch.float32 on cpu"):
            A._mha_bhsd_cuda(x, x, x, None)
    x = torch.zeros(1, 2, 8, 1040, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"K6 kernel takes head widths up to 256 in bf16.*D = 1040"):
        BX._bicross_cuda(x, x, x, x, x, x, None)
