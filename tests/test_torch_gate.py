"""The fused sites' gate at small batch, against the JAX package's.

The reference fuses a K1/K2 site only at a batch of 64 or more (and at
widths that are multiples of 128), unless the caller passes
``interpret=True`` (``btia_tpu/ops/fused_attn.py:933-941, 1027-1035``).
The two roads differ on a row whose every key is masked: the fused kernel
applies the mask after exp, so the row attends to nothing (0), while the
unfused road's -1e9 bias gives it the mean of V. The port once fused at any
batch and so gave 0 where the reference gives mean(V).

Both packages run with their switch on the kernels ("pallas"); the JAX
kernels run in interpret mode on the CPU and the port takes its plain twins.
fp32 throughout; tolerance 2e-5 absolute, as ``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btia_tpu.ops import attention as JA
from btia_tpu.ops import fused_attn as JFA
from btia_tpu_torch.ops import attention as A
from btia_tpu_torch.ops import fused_attn as FA

B, H, DIN, DEAD = 5, 2, 128, 3


@pytest.fixture
def kernels_on():
    jax_impl, port_impl = JA.get_attention_impl(), A.get_attention_impl()
    JA.set_attention_impl("pallas")
    A.set_attention_impl("pallas")
    yield
    JA.set_attention_impl(jax_impl)
    A.set_attention_impl(port_impl)


def _weights(rng):
    mk = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)
    return [mk(DIN, H * 64), mk(H * 64), mk(DIN, H * 64), mk(H * 64), mk(DIN, H * 64), mk(H * 64),
            mk(H * 64, DIN), mk(DIN)]


def _mask(rng, Sk):
    m = rng.rand(B, Sk) > 0.3
    m[:, 0] = True
    m[DEAD] = False  # an all-PAD row
    return m


def _roads(monkeypatch):
    """Record the port's fused twins as they run."""
    took = []
    for name in ("_fused_dense_plain", "_static_q_plain"):
        real = getattr(FA, name)
        monkeypatch.setattr(FA, name, lambda *a, _r=real, _n=name: took.append(_n) or _r(*a))
    return took


def _site(rng, kind):
    """(port call, reference call, x_kv, weights) for a K1 or K2 site with an
    all-PAD row; each call takes interpret."""
    w = _weights(rng)
    tw, jw = [torch.from_numpy(a) for a in w], [jnp.asarray(a) for a in w]
    if kind == "k2":
        queries = (rng.randn(8, DIN) * 0.5).astype(np.float32)
        x_kv = rng.randn(B, 20, DIN).astype(np.float32)
        m = _mask(rng, 20)
        port = lambda interpret: FA.fused_static_q_attention(
            torch.from_numpy(queries), torch.from_numpy(x_kv), torch.from_numpy(m), *tw, H, interpret=interpret)
        ref = lambda interpret: JFA.fused_static_q_attention(
            jnp.asarray(queries), jnp.asarray(x_kv), jnp.asarray(m), *jw, H, interpret=interpret)
        return port, ref, x_kv, w
    x_q = rng.randn(B, 6, DIN).astype(np.float32)
    x_kv = rng.randn(B, 12, DIN).astype(np.float32)
    m = _mask(rng, 12)
    port = lambda interpret: FA.fused_dense_attention(
        torch.from_numpy(x_q), torch.from_numpy(x_kv), torch.from_numpy(m), *tw, H, interpret=interpret)
    ref = lambda interpret: JFA.fused_dense_attention(
        jnp.asarray(x_q), jnp.asarray(x_kv), jnp.asarray(m), *jw, H, interpret=interpret)
    return port, ref, x_kv, w


@pytest.mark.parametrize("kind", ["k1", "k2"])
def test_all_pad_row_below_the_batch_floor_matches_reference(kind, kernels_on, monkeypatch):
    """At B = 5 both packages take the unfused road, and the all-PAD row is
    the mean of V through the output projection in both."""
    port, ref, x_kv, w = _site(np.random.RandomState(41), kind)
    took = _roads(monkeypatch)
    out = port(False).numpy()
    assert took == []  # the unfused road: no fused twin ran
    np.testing.assert_allclose(out, np.asarray(ref(False)), atol=2e-5, rtol=0)
    wq, bq, wk, bk, wv, bv, wo, bo = w
    mean_v = (x_kv[DEAD] @ wv + bv).mean(axis=0)
    np.testing.assert_allclose(out[DEAD], np.broadcast_to(mean_v @ wo + bo, out[DEAD].shape), atol=2e-5)


@pytest.mark.parametrize("kind", ["k1", "k2"])
def test_interpret_forces_the_fused_road_at_small_batch(kind, kernels_on, monkeypatch):
    """interpret=True takes the fused road below the floor in both packages
    (the port's twin here, its kernel chain on the card): the all-PAD row
    attends to nothing and is the output projection's bias."""
    port, ref, _, w = _site(np.random.RandomState(42), kind)
    took = _roads(monkeypatch)
    out = port(True).numpy()
    assert took == ["_static_q_plain" if kind == "k2" else "_fused_dense_plain"]
    np.testing.assert_allclose(out, np.asarray(ref(True)), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(out[DEAD], np.broadcast_to(w[7], out[DEAD].shape))
