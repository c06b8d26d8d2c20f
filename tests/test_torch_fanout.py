"""K4 (the batch fan-out attention) and the fused sites' shape gate.

K4's plain twin against the JAX Pallas kernel ``_fanout_mha`` in interpret
mode, on the same numpy inputs, with fully masked rows (both sides give
exactly 0 there: the mask multiplies exp2, the denominator is floored at
1e-30). Tolerances as ``test_torch_kernels.py``: fp32 2e-5 absolute; bf16
3e-2 absolute, one bf16 step at the outputs' magnitude, since f32 sums in
another order can flip a bf16 rounding.

The host side of K4's CUDA kernel (``csrc/short_flash.cuh``, which runs on
the card only) is held here too: the (batch, head, row) strides the wrapper
hands it address the twin's head view, and the planner's work items
(``short_plan``, decoded as the kernel decodes them by ``short_items``)
store every (problem, b, h, q row) exactly once, at K4's and K6's main-path
shapes, ragged Sq and the wide templates.

The routing tests hold ``mha_bshd`` to the reference's roads, and the gate
test holds the port's ``core_admits`` to the reference's own gate, read off
``btia_tpu.ops.fused_attn.fused_dense_attention`` by recording which road it
takes with the Pallas backend forced on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btia_tpu.ops import fused_attn as JFA
from btia_tpu.ops.attention import _fanout_mha
from btia_tpu_torch.ops import attention as A
from btia_tpu_torch.ops.fused_attn import core_admits

DTYPES = {"fp32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
SHAPES = {
    # name: (B, Sq, Sk, H)
    "square": (5, 16, 16, 2),
    "long_q": (3, 40, 9, 2),
    "long_kv": (4, 7, 70, 3),
    # Sq ragged against the kernel's 64-row tiles (two tiles, the second
    # of 5 rows), with a fully masked row.
    "ragged_q": (3, 69, 9, 2),
}


def _inputs(B, Sq, Sk, H, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, S, H * 64).astype(np.float32) for S in (Sq, Sk, Sk))
    cm = (rng.rand(B, Sk) > 0.3).astype(np.float32)
    cm[:, 0] = 1.0
    cm[1] = 0.0  # a fully masked row
    return q, k, v, cm


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_k4_twin_matches_pallas(shape, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    B, Sq, Sk, H = SHAPES[shape]
    q, k, v, cm = _inputs(B, Sq, Sk, H, seed=5)
    ref = _fanout_mha(*(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(cm), H, True)
    before = A.fanout_attention.launches
    out = A.fanout_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), torch.from_numpy(cm), H)
    assert A.fanout_attention.launches == before  # CPU: plain twin
    assert out.dtype == tdt and out.shape == (B, Sq, H * 64)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=atol, rtol=0)
    assert not out[1].any() and not np.asarray(ref)[1].any()


def test_k4_matches_reference_attention_on_live_rows():
    """Away from fully masked rows K4 is ordinary masked softmax attention."""
    B, Sq, Sk, H = 3, 12, 20, 2
    q, k, v, cm = _inputs(B, Sq, Sk, H, seed=6)
    t = lambda x: torch.from_numpy(x)
    out = A.fanout_attention(t(q), t(k), t(v), t(cm), H)
    split = lambda x, S: t(x).reshape(B, S, H, 64).transpose(1, 2)
    bias = torch.where(t(cm) > 0, 0.0, -1e9)[:, None, None, :]
    ref = torch.softmax(split(q, Sq) @ split(k, Sk).transpose(-1, -2) / 8.0 + bias, -1) @ split(v, Sk)
    ref = ref.transpose(1, 2).reshape(B, Sq, H * 64)
    live = [0, 2]
    np.testing.assert_allclose(out[live].numpy(), ref[live].numpy(), atol=2e-5, rtol=0)


@pytest.mark.parametrize("B,S,H,D", [(3, 7, 2, 64), (2, 33, 12, 64), (1, 5, 4, 192)])
def test_k4_strides_address_the_head_view(B, S, H, D):
    """The (batch, head, row) strides K4's wrapper hands its kernel read a
    packed (B, S, H*D) tensor as the twin's (B, S, H, D) view transposed to
    (B, H, S, D): the same elements, with no copy."""
    x = torch.arange(B * S * H * D, dtype=torch.float32).reshape(B, S, H * D)
    view = torch.as_strided(x, (B, H, S, D), (*A.fanout_strides(x, H), 1))
    assert torch.equal(view, x.view(B, S, H, D).transpose(1, 2))
    assert view.data_ptr() == x.data_ptr()


# (name, problems (B, H, Sq, Sk), head width): the pooled K6 shape, K6's
# long tile, K4's serve and train shapes, ragged Sq and the wide templates.
PLANS = {
    "k6_pooled": ([(2048, 12, 50, 32), (2048, 12, 32, 50)], 64),
    "k6_long": ([(16, 12, 577, 64), (16, 12, 64, 577)], 64),
    "k4_bert": ([(2048, 12, 32, 32)], 64),
    "k4_t2i": ([(2048, 12, 32, 50)], 64),
    "k4_head": ([(2048, 12, 64, 82)], 64),
    "k4_train_i2t_d192": ([(64, 4, 197, 32)], 192),
    "k4_train_t2i": ([(64, 12, 32, 197)], 64),
    "ragged": ([(67, 3, 69, 9), (5, 3, 9, 69)], 136),
    "tiny_rows": ([(9, 2, 3, 5)], 256),
}


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "one_row_a_tile"])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_short_plan_covers_every_row_once(name, pack):
    """The short-sequence kernel's items (short_plan, decoded as the kernel
    decodes them by short_items) store each (problem, b, h, q row) exactly
    once, and every plan is one the kernel takes (sf_plan_ok)."""
    shapes, dw = PLANS[name]
    plan = A.short_plan(shapes, dw, pack)
    bn = plan[0]
    assert bn in (32, 64)
    for p, ((B, H, Sq, Sk), rows) in enumerate(zip(shapes, A.short_items(shapes, plan))):
        n_pack, q_span, k_span, groups, q_tiles = plan[1 + 5 * p: 6 + 5 * p]
        assert groups * n_pack >= B
        if n_pack == 1:
            assert (q_span, k_span) == (64, bn) and q_tiles * 64 >= Sq
        else:
            assert pack and Sq <= 32 and q_tiles == 1
            assert q_span % 8 == 0 and k_span % 8 == 0 and q_span >= Sq and k_span >= Sk
            assert n_pack * q_span <= 64 and n_pack * k_span <= bn
        flat = (rows[:, 0] * H + rows[:, 1]) * Sq + rows[:, 2]
        assert rows.shape[0] == B * H * Sq
        assert torch.equal(torch.bincount(flat, minlength=B * H * Sq), torch.ones(B * H * Sq, dtype=torch.int64))
    if name == "k4_bert" and pack:
        assert plan == [64, 2, 32, 32, 1024, 1]  # two batch rows a 64-row tile


@pytest.mark.parametrize("B,D,road", [(64, 64, "fanout"), (96, 128, "fanout"), (63, 64, "einsum"),
                                      (64, 32, "einsum"), (8, 64, "einsum")])
def test_mha_bshd_routes_short_sequences(monkeypatch, B, D, road):
    calls = []
    real = A.fanout_attention

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(A, "fanout_attention", spy)
    rng = np.random.RandomState(7)
    Sq, Sk, H = 6, 10, 2
    q, k, v = (torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32)) for S in (Sq, Sk, Sk))
    mask = torch.from_numpy(rng.rand(B, Sk) > 0.2)
    mask[:, 0] = True
    out = A.mha_bshd(q, k, v, mask)
    assert len(calls) == (road == "fanout")
    # Both roads compute the same attention on rows with a live key.
    ref = torch.softmax(
        torch.einsum("bqhd,bkhd->bhqk", q, k) / D**0.5
        + torch.where(mask, 0.0, -1e9)[:, None, None, :], -1,
    )
    ref = torch.einsum("bhqk,bkhd->bqhd", ref, v)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=0)


def test_mha_bshd_long_sequences_take_k3(monkeypatch):
    calls = []
    monkeypatch.setattr(A, "fanout_attention", lambda *a: calls.append(a))
    q = torch.zeros(64, 200, 2, 64)
    k = torch.zeros(64, 200, 2, 64)
    out = A.mha_bshd(q, k, k)  # 200 * 200 > 32768: K3's road, whatever the batch
    assert not calls and out.shape == q.shape


def _reference_fuses(monkeypatch, Sq, Sk, H, HD=128, B=64):
    """Whether the reference's fused_dense_attention takes its Pallas road
    for this shape with the Pallas backend forced on (nothing is run)."""
    took = []
    monkeypatch.setattr(JFA, "_resolved_impl", lambda: "pallas")
    monkeypatch.setattr(JFA, "_fused_site", lambda *a: took.append("fused"))
    monkeypatch.setattr(JFA, "_unfused_site", lambda *a: took.append("unfused"))
    x_q, x_kv = jnp.zeros((B, Sq, 128)), jnp.zeros((B, Sk, 128))
    w, b = jnp.zeros((128, HD)), jnp.zeros((HD,))
    ln = (jnp.ones((128,)), jnp.zeros((128,)), 1e-6)
    JFA.fused_dense_attention(x_q, x_kv, None, w, b, w, b, w, b, jnp.zeros((HD, 128)),
                              jnp.zeros((128,)), H, q_ln=ln, residual=True)
    return took == ["fused"]


GATE_SEQS = (1, 16, 32, 50, 64, 82, 128, 129, 197, 256, 577)


@pytest.mark.parametrize("head_dim", [64, 32])
def test_core_admits_every_shape_the_reference_fuses(monkeypatch, head_dim):
    """The port's K1/K2 core once refused Sq or Sk above 128 on the card
    while the reference fused them: (197, 32) and (32, 197) are the BTIA
    sites of vqa_med_full and pathvqa_vit. Now the gate is the reference's
    over the whole grid."""
    H = 128 // head_dim
    for sq in GATE_SEQS:
        for sk in GATE_SEQS:
            ref = _reference_fuses(monkeypatch, sq, sk, H)
            assert core_admits(sq, sk, head_dim) == ref, (sq, sk, head_dim, ref)
    assert core_admits(197, 32, 64) and core_admits(32, 197, 64) and core_admits(256, 128, 64)
    assert not core_admits(577, 577, 64) and not core_admits(2048, 229, 64)
