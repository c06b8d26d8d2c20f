"""The backward passes of the port's four autograd Functions against
``jax.vjp`` of their JAX counterparts.

K1 (``_fused`` / ``_fused_site``) and K2 (``_staticq`` / ``_staticq_site``)
run with ``interpret=True``; their ``custom_vjp`` recomputes the unfused road,
as the port's Functions do. K3 is held to ``_bshd_mha`` and K4 to
``_fanout_mha``. Both sides get the same numpy inputs and the same output
cotangent, in fp32. Each gradient must agree to 1e-4 of its own largest
magnitude: both sides compute the same f32 products, summed in another
order. The one exception is the key-projection bias bk: it adds the same
q.bk to every score of a row, which the softmax ignores, so its gradient is
0 in exact arithmetic and both sides return rounding noise; there both sides
must stay below 1e-4 of the largest gradient of the case.

The ``b64`` K1 case runs at batch 64, where the port's backward recomputes
its attention through K4's twin while the reference on the CPU takes its
einsum road: the two agree wherever a row has a live key, and every row here
has one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btia_tpu.ops import fused_attn as JFA
from btia_tpu.ops.attention import _bshd_mha, _fanout_mha
from btia_tpu_torch.ops import attention as A
from btia_tpu_torch.ops import fused_attn as FA

RTOL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    """The suite runs several workers on one host; two threads each keep
    these CPU-bound tests from oversubscribing it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, want, name):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= RTOL * scale, f"{name}: max abs err {err} > {RTOL} x {scale}"


def _port_grads(fn, inputs, cot):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    out.backward(torch.from_numpy(cot))
    return out, [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]


def _jax_grads(fn, inputs, cot):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in inputs))
    return out, vjp(jnp.asarray(cot))


def _check(name, port_fn, jax_fn, inputs, out_shape, rng, zero_grad=None):
    cot = rng.randn(*out_shape).astype(np.float32)
    out, got = _port_grads(port_fn, inputs, cot)
    ref_out, want = _jax_grads(jax_fn, inputs, cot)
    _close(out, ref_out, f"{name} output")
    largest = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == zero_grad:
            noise = max(float(g.abs().max()), float(np.abs(np.asarray(w)).max()))
            assert noise <= RTOL * largest, f"{name} grad {i} (bk): {noise} vs {largest}"
        else:
            _close(g, w, f"{name} grad {i}")


def _weights(rng, din, hd, dout):
    mk = lambda *s: (rng.randn(*s) * 0.1).astype(np.float32)
    return [mk(din, hd), mk(hd), mk(din, hd), mk(hd), mk(din, hd), mk(hd), mk(hd, dout), mk(dout)]


def _ln(rng, d):
    return [(1.0 + 0.1 * rng.randn(d)).astype(np.float32), (0.1 * rng.randn(d)).astype(np.float32)]


def _mask(rng, B, Sk, dead_row=None):
    m = rng.rand(B, Sk) > 0.3
    m[:, 0] = True
    if dead_row is not None:
        m[dead_row] = False
    return m


K1_CASES = {
    # name: (B, Sq, Sk, q_ln, kv_ln, residual, post_ln, dead_row)
    "plain": (3, 8, 12, False, False, False, False, 1),
    "bert": (3, 10, 10, False, False, True, True, 2),
    "btia": (2, 14, 6, True, True, True, False, None),
    "b64": (64, 6, 5, True, True, True, False, None),
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_backward_matches_jax_vjp(case):
    B, Sq, Sk, q_ln, kv_ln, residual, post_ln, dead = K1_CASES[case]
    rng = np.random.RandomState(11)
    H, Din = 2, 128
    self_attn = case == "bert"
    Sk = Sq if self_attn else Sk
    w = _weights(rng, Din, H * 64, Din)
    x_q = rng.randn(B, Sq, Din).astype(np.float32)
    x_kv = rng.randn(B, Sk, Din).astype(np.float32)
    mask = _mask(rng, B, Sk, dead)
    lns = [_ln(rng, Din) if on else None for on in (q_ln, kv_ln, post_ln)]
    eps = (1e-6, 1e-6, 1e-12)
    tm, jm = torch.from_numpy(mask), jnp.asarray(mask)
    site = JFA.SiteCfg(q_ln_eps=eps[0] if q_ln else 0.0, kv_ln_eps=eps[1] if kv_ln else 0.0,
                       residual=residual, post_ln_eps=eps[2] if post_ln else 0.0)
    plain = site == JFA.SiteCfg()
    ln_in = [a for ln in lns if ln is not None for a in ln]
    kv_in = () if self_attn else (x_kv,)
    inputs = [x_q, *kv_in, *w, *ln_in]

    def unpack(args):
        xq, rest = args[0], list(args[1:])
        xkv = xq if self_attn else rest.pop(0)
        return xq, xkv, rest[:8], rest[8:]

    def port_fn(*args):
        xq, xkv, ws, ln_t = unpack(args)
        it = iter(ln_t)
        tl = [(next(it), next(it), e) if ln is not None else None for ln, e in zip(lns, eps)]
        return FA.fused_dense_attention(xq, xkv, tm, *ws, H, interpret=True, q_ln=tl[0], kv_ln=tl[1],
                                        residual=residual, post_ln=tl[2])

    def jax_fn(*args):
        xq, xkv, ws, ln_t = unpack(args)
        if plain:
            return JFA._fused(xq, xkv, jm, *ws, H, True)
        it = iter(ln_t)
        d = JFA._ln_dummy()
        full = [a for ln in lns for a in ((next(it), next(it)) if ln is not None else (d, d))]
        return JFA._fused_site(xq, xkv, jm, *ws, *full, H, True, site)

    _check(f"K1 {case}", port_fn, jax_fn, inputs, (B, Sq, Din), rng, zero_grad=len(kv_in) + 4)


@pytest.mark.parametrize("site", ["plain", "head"])
def test_k2_backward_matches_jax_vjp(site):
    rng = np.random.RandomState(12)
    B, K, Sk, H, Din = 3, 8, 20, 2, 128
    w = _weights(rng, Din, H * 64, Din)
    queries = (rng.randn(K, Din) * 0.5).astype(np.float32)
    x_kv = rng.randn(B, Sk, Din).astype(np.float32)
    mask = _mask(rng, B, Sk, dead_row=1)
    tm, jm = torch.from_numpy(mask), jnp.asarray(mask)
    head = site == "head"
    lnp = _ln(rng, Din) if head else []
    inputs = [queries, x_kv, *w, *lnp]

    def port_fn(qs, xkv, *rest):
        kv_ln = (rest[8], rest[9], 1e-6) if head else None
        return FA.fused_static_q_attention(qs, xkv, tm, *rest[:8], H, interpret=True, kv_ln=kv_ln,
                                           residual=head)

    def jax_fn(qs, xkv, *rest):
        if not head:
            return JFA._staticq(qs, xkv, jm, *rest, H, True)
        cfg = JFA.SiteCfg(kv_ln_eps=1e-6, residual=True)
        return JFA._staticq_site(qs, xkv, jm, *rest, H, True, cfg)

    _check(f"K2 {site}", port_fn, jax_fn, inputs, (B, K, Din), rng, zero_grad=5)


@pytest.mark.parametrize("masked", [False, True])
def test_k3_backward_matches_jax_vjp(masked):
    rng = np.random.RandomState(13)
    B, Sq, Sk, H = 2, 190, 180, 2
    q, k, v = (rng.randn(B, S, H * 64).astype(np.float32) for S in (Sq, Sk, Sk))
    mask = _mask(rng, B, Sk) if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    _check(
        "K3", lambda q, k, v: A.bshd_flash_attention(q, k, v, tm, H),
        lambda q, k, v: _bshd_mha(q, k, v, jm, H, True), [q, k, v], (B, Sq, H * 64), rng,
    )


def test_k4_backward_matches_jax_vjp():
    rng = np.random.RandomState(14)
    B, Sq, Sk, H = 5, 12, 9, 2
    q, k, v = (rng.randn(B, S, H * 64).astype(np.float32) for S in (Sq, Sk, Sk))
    cm = _mask(rng, B, Sk, dead_row=3).astype(np.float32)
    _check(
        "K4", lambda q, k, v: A.fanout_attention(q, k, v, torch.from_numpy(cm), H),
        lambda q, k, v: _fanout_mha(q, k, v, jnp.asarray(cm), H, True), [q, k, v],
        (B, Sq, H * 64), rng,
    )


def test_key_mask_gets_no_gradient():
    rng = np.random.RandomState(15)
    B, S, H, Din = 2, 6, 2, 128
    w = [torch.from_numpy(a).requires_grad_(True) for a in _weights(rng, Din, H * 64, Din)]
    x = torch.from_numpy(rng.randn(B, S, Din).astype(np.float32)).requires_grad_(True)
    cm = torch.ones(B, S, requires_grad=True)
    FA.fused_dense_attention(x, x, cm > 0, *w, H).sum().backward()
    A.fanout_attention(x, x, x, cm, H).sum().backward()
    assert cm.grad is None and x.grad is not None and all(t.grad is not None for t in w)
