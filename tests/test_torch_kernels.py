"""Plain twins of the port's kernels K1-K3 against the JAX Pallas kernels.

The JAX kernels run in interpret mode on the CPU, as ``tests/test_ops.py``
runs them; the port's entry points take their plain PyTorch twins for CPU
tensors. Both sides get the same numpy inputs. Fully masked rows are
included for K1/K2: both sides must give exactly 0 attention there (mask
applied after exp, denominator floored at 1e-30).

Both sides pass ``interpret=True``: at these small batches the gate (a
batch of 64 or more) sends a site to the unfused road in both packages, and
the argument forces the fused one, the kernels' (here their twins').

Tolerances: fp32 2e-5 absolute (as test_ops.py). bf16: both sides round at
the same points, but f32 sums taken in another order can flip a value across
a bf16 rounding boundary, one bf16 step (2^-8 relative) at the outputs'
magnitude (~1-4 here), so bf16 is held to 3e-2 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btia_tpu.ops import fused_attn as JFA
from btia_tpu.ops.attention import _bshd_mha
from btia_tpu_torch.ops import fused_attn as FA
from btia_tpu_torch.ops.attention import bshd_flash_attention, mha_bshd

DTYPES = {"fp32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, 3e-2)}


def _weights(rng, din, hd, dout):
    mk = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)
    return [mk(din, hd), mk(hd), mk(din, hd), mk(hd), mk(din, hd), mk(hd), mk(hd, dout), mk(dout)]


def _ln(rng, d, eps):
    return ((1.0 + 0.1 * rng.randn(d)).astype(np.float32),
            (0.1 * rng.randn(d)).astype(np.float32), eps)


def _mask(rng, B, Sk, dead_row):
    m = rng.rand(B, Sk) > 0.3
    m[:, 0] = True
    m[dead_row] = False
    return m


def _j(x, dt=jnp.float32):
    return jnp.asarray(x, dt)


def _t(x, dt=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dt)


def _jln(ln):
    return None if ln is None else (_j(ln[0]), _j(ln[1]), ln[2])


def _tln(ln):
    return None if ln is None else (_t(ln[0]), _t(ln[1]), ln[2])


SITES = {
    # name: (Sq, Sk, self-attention, q_ln eps, kv_ln eps, residual, post_ln eps)
    "plain": (16, 24, False, None, None, False, None),
    "bert": (32, 32, True, None, None, True, 1e-12),
    "btia": (50, 32, False, 1e-6, 1e-6, True, None),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("site", sorted(SITES))
def test_k1_fused_dense_matches_pallas(site, dtype):
    _, jdt, tdt, atol = DTYPES[dtype]
    Sq, Sk, self_attn, q_eps, kv_eps, residual, post_eps = SITES[site]
    rng = np.random.RandomState(1)
    B, H, Din = 5, 2, 128
    Sk = Sq if self_attn else Sk
    w = _weights(rng, Din, H * 64, Din)
    x_q = rng.randn(B, Sq, Din).astype(np.float32)
    x_kv = x_q if self_attn else rng.randn(B, Sk, Din).astype(np.float32)
    mask = _mask(rng, B, Sk, dead_row=3)
    q_ln = _ln(rng, Din, q_eps) if q_eps else None
    kv_ln = _ln(rng, Din, kv_eps) if kv_eps else None
    post_ln = _ln(rng, Din, post_eps) if post_eps else None
    ref = JFA.fused_dense_attention(
        _j(x_q, jdt), _j(x_kv, jdt), jnp.asarray(mask), *map(_j, w), H,
        interpret=True, q_ln=_jln(q_ln), kv_ln=_jln(kv_ln), residual=residual,
        post_ln=_jln(post_ln),
    )
    before = FA.fused_dense_attention.launches
    out = FA.fused_dense_attention(
        _t(x_q, tdt), _t(x_kv, tdt), torch.from_numpy(mask), *map(_t, w), H, interpret=True,
        q_ln=_tln(q_ln), kv_ln=_tln(kv_ln), residual=residual, post_ln=_tln(post_ln),
    )
    assert FA.fused_dense_attention.launches == before  # CPU: plain twin
    assert out.dtype == tdt and out.shape == (B, Sq, Din)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=atol, rtol=0
    )


def test_k1_fully_masked_row_attends_to_nothing():
    """With no residual or LN, a fully masked row is exactly the output
    projection's bias (attention 0), in both packages."""
    rng = np.random.RandomState(2)
    B, S, H, Din = 3, 8, 2, 128
    w = _weights(rng, Din, H * 64, Din)
    x = rng.randn(B, S, Din).astype(np.float32)
    mask = _mask(rng, B, S, dead_row=1)
    out = FA.fused_dense_attention(_t(x), _t(x), torch.from_numpy(mask), *map(_t, w), H, interpret=True)
    np.testing.assert_array_equal(out[1].numpy(), np.broadcast_to(w[7], (S, Din)))
    ref = JFA.fused_dense_attention(_j(x), _j(x), jnp.asarray(mask), *map(_j, w), H, interpret=True)
    np.testing.assert_allclose(np.asarray(ref)[1], out[1].numpy(), atol=2e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k2_static_q_matches_pallas(dtype):
    _, jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.RandomState(3)
    B, K, Sk, H, Din = 5, 8, 82, 2, 128
    w = _weights(rng, Din, H * 64, Din)
    queries = (rng.randn(K, Din) * 0.05).astype(np.float32)
    x_kv = rng.randn(B, Sk, Din).astype(np.float32)
    mask = _mask(rng, B, Sk, dead_row=2)
    kv_ln = _ln(rng, Din, 1e-6)
    ref = JFA.fused_static_q_attention(
        _j(queries, jdt), _j(x_kv, jdt), jnp.asarray(mask), *map(_j, w), H,
        interpret=True, kv_ln=_jln(kv_ln), residual=True,
    )
    out = FA.fused_static_q_attention(
        _t(queries, tdt), _t(x_kv, tdt), torch.from_numpy(mask), *map(_t, w), H, interpret=True,
        kv_ln=_tln(kv_ln), residual=True,
    )
    assert out.dtype == tdt and out.shape == (B, K, Din)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=atol, rtol=0
    )


K3_SHAPES = {
    # name: (B, Sq, Sk, H, masked)
    "vitl": (1, 577, 577, 16, False),
    "ragged": (2, 200, 171, 2, True),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(K3_SHAPES))
def test_k3_bshd_flash_matches_pallas(shape, dtype):
    _, jdt, tdt, atol = DTYPES[dtype]
    B, Sq, Sk, H, masked = K3_SHAPES[shape]
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(B, S, H * 64).astype(np.float32) for S in (Sq, Sk, Sk))
    mask = _mask(rng, B, Sk, dead_row=[]) if masked else None
    ref = _bshd_mha(
        _j(q, jdt), _j(k, jdt), _j(v, jdt), None if mask is None else jnp.asarray(mask), H, True
    )
    tmask = None if mask is None else torch.from_numpy(mask)
    out = bshd_flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), tmask, H)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=atol, rtol=0
    )
    # mha_bshd routes this long score tile to K3.
    routed = mha_bshd(*(_t(x, tdt).reshape(B, -1, H, 64) for x in (q, k, v)), tmask)
    np.testing.assert_array_equal(routed.reshape(B, Sq, H * 64).float().numpy(), out.float().numpy())
