"""LayerNorm: K7's plain twin against the JAX Pallas kernel ``_ln_kernel`` in
interpret mode, its Function's backward against the reference's custom_vjp,
the backward kernel's plain twin ``_ln_exact_vjp`` against ``jax.vjp`` of the
reference's ``_ln_exact``, and ``layernorm(fast=...)`` parity with the
reference.

Tolerances as ``test_torch_kernels.py``: fp32 2e-5 absolute; bf16 3e-2
absolute (one bf16 step at outputs of magnitude up to ~4, where f32 sums in
another order can flip a rounding); the backward at 1e-4. The backward twin
against ``jax.vjp``: each row of dx within 1e-4 of that row's largest
magnitude, in bf16 plus one bf16 step at the element's magnitude (both sides
compute in f32 in another order, then round once); dscale and dbias within
1e-4 of their largest magnitude.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btia_tpu.ops import norms as JN
from btia_tpu_torch.ops import _native
from btia_tpu_torch.ops import norms as N

DTYPES = {"fp32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(rng, M, D):
    x = (rng.randn(M, D) * 2 + 0.5).astype(np.float32)
    return x, (1 + 0.2 * rng.randn(D)).astype(np.float32), (0.1 * rng.randn(D)).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
# 4097, 6144 and 8192: rows wider than the 4096 a block of registers holds,
# which K7 reads twice (any width, as the TPU kernel).
@pytest.mark.parametrize("D", [64, 768, 1024, 4097, 6144, 8192])
def test_k7_twin_matches_pallas(D, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.RandomState(D)
    x, scale, bias = _inputs(rng, 37, D)  # 37 rows: a ragged 40-row block on the TPU side
    ref = JN._layernorm_pallas(jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias), 1e-6,
                               interpret=True)
    before = N.layernorm_fast.launches
    out = N.layernorm_fast(torch.from_numpy(x).to(tdt), torch.from_numpy(scale), torch.from_numpy(bias), 1e-6)
    assert N.layernorm_fast.launches == before  # CPU: the plain twin
    assert out.dtype == tdt and out.shape == x.shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=atol, rtol=0)


def test_k7_keeps_leading_axes():
    rng = np.random.RandomState(1)
    x, scale, bias = _inputs(rng, 2 * 3 * 5, 48)
    t = lambda a: torch.from_numpy(a)
    out = N.layernorm_fast(t(x).reshape(2, 3, 5, 48), t(scale), t(bias), 1e-12)
    assert out.shape == (2, 3, 5, 48)
    np.testing.assert_array_equal(out.reshape(30, 48).numpy(), N.layernorm(t(x), t(scale), t(bias), 1e-12).numpy())


@pytest.mark.parametrize("D", [64, 768])
def test_k7_backward_matches_the_reference_vjp(D):
    rng = np.random.RandomState(2)
    x, scale, bias = _inputs(rng, 9, D)
    g = rng.randn(9, D).astype(np.float32)
    want = JN._layernorm_fast_bwd(1e-6, (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)), jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    out = N.layernorm_fast(*leaves, 1e-6)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)
    # Only x needs a gradient: the others get None.
    xg = torch.from_numpy(x).requires_grad_(True)
    out = N.layernorm_fast(xg, torch.from_numpy(scale), torch.from_numpy(bias), 1e-6)
    (dx,) = torch.autograd.grad(out, [xg], torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want[0]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("fast", [False, True])
def test_layernorm_ignores_fast_as_the_reference(fast):
    rng = np.random.RandomState(3)
    x, scale, bias = _inputs(rng, 6, 96)
    ref = JN.layernorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-6, fast=fast)
    t = lambda a: torch.from_numpy(a)
    out = N.layernorm(t(x), t(scale), t(bias), 1e-6, fast=fast)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    assert torch.equal(out, N.layernorm(t(x), t(scale), t(bias), 1e-6, fast=not fast))


@pytest.mark.parametrize("mixed", [True, False], ids=["bf16", "fp32"])
def test_layernorm_module_passes_fast_as_the_reference(mixed, monkeypatch):
    """The model's LayerNorm passes fast = (compute dtype is bf16), as
    btia_tpu/models/layers.py:260-261 does, and routes by device through
    ``layernorm``'s own entry: on a CPU tensor the plain formula, bit for
    bit, with no launch counted (on a CUDA tensor K7)."""
    from btia_tpu_torch.core.dtypes import DTypePolicy
    from btia_tpu_torch.models import layers

    seen, routed = [], []
    real_ln, real_route = layers.layernorm, _native.route
    monkeypatch.setattr(layers, "layernorm", lambda *a, **kw: seen.append(kw.get("fast")) or real_ln(*a, **kw))
    monkeypatch.setattr(_native, "route", lambda e, *a: routed.append(e.__name__) or real_route(e, *a))
    cd = torch.bfloat16 if mixed else torch.float32
    policy = DTypePolicy(compute_dtype=cd)
    ln = layers.LayerNorm(32, policy, device="cpu")
    with torch.no_grad():
        ln.scale.fill_(1.0)
        ln.bias.zero_()
    x = torch.randn(4, 32)
    before = N.layernorm.launches
    out = ln(x)
    assert seen == [mixed] and routed == ["layernorm"] and out.dtype == cd
    assert N.layernorm.launches == before
    assert torch.equal(out, N._ln_exact(x, ln.scale, ln.bias, ln.eps).to(cd))


def test_k7_entry_has_no_fallback():
    x = torch.empty(4, 16, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        N.layernorm_fast(x, torch.empty(16, device="meta"), torch.empty(16, device="meta"))
    assert N.layernorm_fast.launches == 0


def _bf16_steps(ref):
    """One bf16 step at each element's magnitude."""
    mag = np.maximum(np.abs(ref), 1e-30)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _fast_var(row, tdt):
    """mean2 - mean^2 of a row, as ``_ln_exact`` rounds it."""
    x32 = torch.from_numpy(np.asarray(row, np.float32)).to(tdt).float()
    return ((x32 * x32).mean() - x32.mean() * x32.mean()).item()


def _rows_close(got, want, bf16):
    """Each row within 1e-4 of its own largest magnitude (plus one bf16 step
    at each element in bf16): a row where the variance clamp binds has dx of
    order 1 / sqrt(eps), which would hide the other rows' errors."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = 1e-4 * np.abs(want).max(-1, keepdims=True) + (_bf16_steps(want) if bf16 else 0.0)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", [48, 768, 1500, 6144])
def test_backward_twin_matches_jax_vjp(D, dtype):
    """``_ln_exact_vjp`` (the backward kernel's plain twin) against the
    reference's ``_layernorm_fast_bwd``: ``jax.vjp`` of ``_ln_exact``. Nine
    random rows and two constant rows (0.5 and -2.0, whose f32 sums are
    exact in any order), where mean2 - mean^2 is 0 and the variance's clamp
    binds."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.RandomState(D + 1)
    x, scale, bias = _inputs(rng, 11, D)
    x[9], x[10] = 0.5, -2.0
    g = rng.randn(11, D).astype(np.float32)
    xt, gt = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    assert _fast_var(x[9], tdt) == _fast_var(x[10], tdt) == 0.0
    want = JN._layernorm_fast_bwd(1e-6, (jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias)),
                                  jnp.asarray(g, jdt))
    before = N.layernorm_backward.launches
    got = N.layernorm_backward(xt, torch.from_numpy(scale), torch.from_numpy(bias), gt, 1e-6)
    assert N.layernorm_backward.launches == before  # CPU: the plain twin
    assert got[0].dtype == tdt and got[1].dtype == got[2].dtype == torch.float32
    _rows_close(got[0].float().numpy(), np.asarray(want[0], np.float32), dtype == "bf16")
    for a, b in zip(got[1:], want[1:]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * np.abs(b).max(), rtol=0)


def _kernel_dx(x, scale, g, eps, clamp_rule=True):
    """dx as ``csrc/layernorm.cu``'s backward computes it, in f64 from the
    twin's f32 statistics: inv * (gs - mean(gs) - keep * xh * mean(gs * xh)),
    gs = g * scale, xh = (x - mean) * inv, keep = (mean2 - mean^2 >= 0)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    d = (x32 * x32).mean(-1, keepdim=True) - mean * mean
    inv = torch.rsqrt(torch.clamp_min(d, 0.0) + eps).double()
    xh = (x32 - mean).double() * inv
    gs = g.double() * scale.double()
    keep = (d >= 0).double() if clamp_rule else torch.ones_like(d, dtype=torch.float64)
    return inv * (gs - gs.mean(-1, keepdim=True) - keep * xh * (gs * xh).mean(-1, keepdim=True))


def test_backward_kernel_arithmetic_follows_the_twins_clamp():
    """The backward kernel's closed form against the twin's autograd, f32:
    random rows, a constant row (the clamp at its bound, mean2 - mean^2 = 0)
    and rows of 1000 + 0.01 noise whose f32 sums round mean2 - mean^2 below
    0. There ``torch.clamp_min`` passes no gradient to the variance, and xh
    is of order 10, so a closed form without the clamp's rule (keep = 1)
    would miss by far more than the tolerance: each row within 1e-4 of its
    largest magnitude."""
    rng = np.random.RandomState(11)
    x, scale, _ = _inputs(rng, 8, 768)
    x[5] = 0.5
    rows = 1000 + 0.01 * rng.randn(16, 768)
    x[6:] = [r for r in rows if _fast_var(r, torch.float32) < 0][:2]
    assert _fast_var(x[5], torch.float32) == 0.0
    xt, st = torch.from_numpy(x), torch.from_numpy(scale)
    g = torch.from_numpy(rng.randn(8, 768).astype(np.float32))
    want = N._ln_exact_vjp(xt, st, torch.zeros(768), g, 1e-6)[0].numpy()
    _rows_close(_kernel_dx(xt, st, g, 1e-6).float().numpy(), want, False)
    off = np.abs(_kernel_dx(xt, st, g, 1e-6, clamp_rule=False).numpy() - want)[6:]
    assert (off.max(-1) > 1e-2 * np.abs(want[6:]).max(-1)).all()


@pytest.mark.parametrize("needs", [(True, True, True), (True, False, False), (False, True, True),
                                   (True, True, False)])
def test_function_backward_on_cpu_is_the_twin_bit_for_bit(needs):
    """``_LayerNormFast.backward`` on CPU tensors returns ``_ln_exact_vjp``'s
    gradients bit for bit, None where ``needs_input_grad`` asks for none, and
    None for eps; no launch is counted."""
    rng = np.random.RandomState(5)
    x, scale, bias = (torch.from_numpy(a) for a in _inputs(rng, 13, 768))
    x = x.to(torch.bfloat16)
    g = torch.from_numpy(rng.randn(13, 768).astype(np.float32)).to(torch.bfloat16)
    ctx = SimpleNamespace(saved_tensors=(x, scale, bias), eps=1e-6, needs_input_grad=(*needs, False))
    before = N.layernorm_backward.launches
    got = N._LayerNormFast.backward(ctx, g)
    want = N._ln_exact_vjp(x, scale, bias, g, 1e-6, needs)
    assert N.layernorm_backward.launches == before and len(got) == 4 and got[3] is None
    for a, b, need in zip(got, want, needs):
        assert (a is None) == (b is None) == (not need)
        assert a is None or torch.equal(a, b)
    leaves = [t.clone().requires_grad_(need) for t, need in zip((x, scale, bias), needs)]
    auto = torch.autograd.grad(N._ln_exact(*leaves, 1e-6), [t for t in leaves if t.requires_grad], g)
    assert all(torch.equal(a, b) for a, b in zip(auto, [t for t in got[:3] if t is not None]))
