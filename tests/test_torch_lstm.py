"""The port's LSTM question encoder against the JAX package's, on the CPU.

Flax initialises the encoder (and a lone reverse layer); the weight bridge
carries the parameters across; both are fed the same numpy token ids and
masks: right padding (ids > 0, the default mask) and explicit masks with
holes inside a row, where a masked step carries h and c through.

Tolerances: fp32 within 1e-5 absolute (outputs are tanh-bounded, |h| < 1;
the two sum the gate products in another order). bf16 within 1e-2
absolute: h and c round to bf16 at every step on both sides, but XLA keeps
a fused chain of elementwise gate operations in f32 where PyTorch rounds
after each operation, so the carries drift by a few bf16 steps over 20
steps (observed 2e-3 to 4e-3). The gate order is pinned against ``nn.LSTM`` (cuDNN's layout, on the
CPU its reference kernel) on unmasked rows in fp32, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from btia_tpu.core.dtypes import default_policy as jax_policy
from btia_tpu.models.lstm import LSTMLayer as JaxLSTMLayer
from btia_tpu.models.lstm import LSTMQuestionEncoder as JaxEncoder
from btia_tpu_torch.convert.from_jax import load_jax_params
from btia_tpu_torch.core.dtypes import default_policy
from btia_tpu_torch.models.layers import Dropout
from btia_tpu_torch.models.lstm import LSTMLayer, LSTMQuestionEncoder

V, E, H, S, B = 60, 24, 16, 20, 5


def _ids(rng):
    """Right-padded rows of 1..S real tokens; row 0 full, row 1 one token."""
    ids = np.zeros((B, S), np.int32)
    for i, n in enumerate([S, 1] + list(rng.randint(2, S, B - 2))):
        ids[i, :n] = rng.randint(1, V, n)
    return ids


def _holes(rng):
    m = rng.rand(B, S) > 0.35
    m[0] = True
    m[1] = False  # a row of no real step: h stays 0
    return m


def _encoder_pair(mixed, bidirectional=True):
    jm = JaxEncoder(vocab_size=V, embed_dim=E, hidden=H, bidirectional=bidirectional, policy=jax_policy(mixed))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.ones((1, S), jnp.int32))["params"]
    tm = LSTMQuestionEncoder(V, E, H, bidirectional, default_policy(mixed), device="cpu")
    load_jax_params(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("mixed,tol", [(False, 1e-5), (True, 1e-2)], ids=["fp32", "bf16"])
@pytest.mark.parametrize("holes", [False, True], ids=["right_padding", "holes"])
def test_bilstm_matches_jax(mixed, tol, holes):
    jm, params, tm = _encoder_pair(mixed)
    rng = np.random.RandomState(7)
    ids = _ids(rng)
    mask = _holes(rng) if holes else None
    fn = jax.jit(lambda p, i, m: jm.apply({"params": p}, i, m))
    want, want_mask = fn(params, ids, None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got, got_mask = tm(torch.from_numpy(ids).long(), None if mask is None else torch.from_numpy(mask))
    assert got.shape == (B, S, 2 * H) and got.dtype == (torch.bfloat16 if mixed else torch.float32)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=0)


def test_masked_steps_carry_the_state():
    """A masked step's output is the carried h, in both directions; a row
    with no real step stays at 0."""
    _, _, tm = _encoder_pair(False)
    rng = np.random.RandomState(8)
    ids, mask = _ids(rng), _holes(rng)
    with torch.no_grad():
        out, _ = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    fwd, bwd = out[..., :H], out[..., H:]
    for b in range(B):
        for t in range(S):
            if mask[b, t]:
                continue
            prev = fwd[b, t - 1] if t > 0 else torch.zeros(H)
            nxt = bwd[b, t + 1] if t < S - 1 else torch.zeros(H)
            assert torch.equal(fwd[b, t], prev) and torch.equal(bwd[b, t], nxt), (b, t)
    assert not out[1].any()


@pytest.mark.parametrize("mixed,tol", [(False, 1e-5), (True, 1e-2)], ids=["fp32", "bf16"])
def test_reverse_layer_matches_jax(mixed, tol):
    jm = JaxLSTMLayer(hidden=H, policy=jax_policy(mixed), reverse=True)
    rng = np.random.RandomState(9)
    x = rng.randn(B, S, E).astype(np.float32)
    mask = _holes(rng)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, S, E)), jnp.ones((1, S), bool))["params"]
    tm = LSTMLayer(E, H, default_policy(mixed), reverse=True, device="cpu")
    load_jax_params(tm, params)
    want = jax.jit(lambda p, x, m: jm.apply({"params": p}, x, m))(params, x, mask)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=0)
    # Scanned from the end: the last step sees only its own input.
    with torch.no_grad():
        alone = tm(torch.from_numpy(x[:, -1:]), None)
    full = tm(torch.from_numpy(x), None).detach()
    torch.testing.assert_close(full[:, -1], alone[:, 0], atol=1e-6, rtol=0)


def test_gate_order_matches_nn_lstm():
    """(i, f, g, o), ``ih`` with its bias and ``hh_bias`` apart: the port's
    parameters laid into ``nn.LSTM`` (weights transposed, the reverse
    direction under its ``_reverse`` names) give the same states on rows
    with no padding."""
    torch.manual_seed(0)
    tm = LSTMQuestionEncoder(V, E, H, True, default_policy(False), device="cpu")
    with torch.no_grad():
        for p in tm.parameters():
            p.normal_(0, 0.3)
    ref = nn.LSTM(E, H, batch_first=True, bidirectional=True)
    with torch.no_grad():
        for layer, sfx in ((tm.fwd, ""), (tm.bwd, "_reverse")):
            getattr(ref, "weight_ih_l0" + sfx).copy_(layer.ih.kernel.T)
            getattr(ref, "bias_ih_l0" + sfx).copy_(layer.ih.bias)
            getattr(ref, "weight_hh_l0" + sfx).copy_(layer.hh_kernel.T)
            getattr(ref, "bias_hh_l0" + sfx).copy_(layer.hh_bias)
        ids = torch.from_numpy(np.random.RandomState(10).randint(1, V, (B, S))).long()
        got, _ = tm(ids)
        want, _ = ref(tm.word_embed(ids, torch.float32))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_embedding_dropout_draws_from_the_generator():
    """Train-time dropout on the embeddings: the same generator seed gives
    the same states, another seed other states, and no dropout none."""
    _, _, tm = _encoder_pair(False)
    ids = torch.from_numpy(_ids(np.random.RandomState(11))).long()
    run = lambda seed: tm(ids, drop=Dropout(0.5, torch.Generator().manual_seed(seed)), train=True)[0]
    with torch.no_grad():
        a, b, c, plain = run(1), run(1), run(2), tm(ids)[0]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, plain)
