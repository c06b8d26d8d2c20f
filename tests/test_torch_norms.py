"""LayerNorm: K7's plain twin against the JAX Pallas kernel ``_ln_kernel`` in
interpret mode, its Function's backward against the reference's custom_vjp,
and ``layernorm(fast=...)`` parity with the reference.

Tolerances as ``test_torch_kernels.py``: fp32 2e-5 absolute; bf16 3e-2
absolute (one bf16 step at outputs of magnitude up to ~4, where f32 sums in
another order can flip a rounding); the backward at 1e-4.
"""

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
