"""``model.remat`` in the port: each ViT block and each BTIA layer is
rematerialised in the backward pass (``torch.utils.checkpoint``), where the
reference's ``nn.remat`` sits (``btia_tpu/models/vit.py:117``,
``btia_tpu/models/btia.py:146``).

A small ``vqa_med_full`` (vit_test, 2 BERT layers at width 64, 2 BTIA
layers), fp32:

* at dropout 0.1 the gradients with remat equal those without within 1e-6
  of the largest gradient: the recompute replayed the forward's dropout
  masks from the step's ``torch.Generator``, and left the generator where
  the forward left it;
* the negative control: with the generator's state not restored for the
  recompute, the gradients differ by more than that bound;
* at dropout 0 the port's remat gradients match ``jax.grad`` of the JAX
  package's model with ``model.remat=True`` on the same weights, each to
  1e-4 of its own largest magnitude (``tests/test_torch_grad.py``'s
  tolerance), the attention key biases (0 in exact arithmetic) to 1e-4 of
  the largest gradient of all;
* without autograd, a remat forward is the plain forward.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btia_tpu.configs import get_config as jax_get_config
from btia_tpu.models.model import build_model as jax_build_model
from btia_tpu.train.steps import cross_entropy as jax_cross_entropy
from btia_tpu_torch.configs import get_config
from btia_tpu_torch.convert.from_jax import flatten_params, load_jax_params
from btia_tpu_torch.models import layers
from btia_tpu_torch.models.model import build_model
from btia_tpu_torch.train.steps import cross_entropy, dropout_generator

SMALL = {
    "model.image_encoder": "vit_test",
    "model.bert_layers": 2,
    "model.bert_hidden": 64,
    "model.bert_heads": 2,
    "model.hidden_dim": 64,
    "model.num_heads": 2,
    "model.btia_layers": 2,
    "model.answer_vocab_size": 32,
    "model.mixed_precision": False,
}
B, L = 4, 16


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batch():
    rng = np.random.RandomState(0)
    ids = np.zeros((B, L), np.int32)
    for i in range(B):
        k = rng.randint(4, L)
        ids[i, :k] = rng.randint(1, 500, k)
    return (rng.randint(0, 256, (B, 96, 96, 3)).astype(np.uint8), ids,
            rng.randint(0, 32, B).astype(np.int32))


def _port_grads(remat, dropout, params=None):
    cfg = get_config("vqa_med_full", **SMALL, **{"model.remat": remat, "model.dropout": dropout})
    model = build_model(cfg.model, device="cpu", seed=3)
    if params is not None:
        load_jax_params(model, params)
    images, ids, labels = _batch()
    gen = dropout_generator(0, 5, "cpu")
    logits = model(torch.from_numpy(images), torch.from_numpy(ids).long(), train=True, generator=gen)
    loss = cross_entropy(logits, torch.from_numpy(labels).long())
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return float(loss.detach()), grads, gen.get_state()


def _largest(grads):
    return max(float(g.abs().max()) for g in grads.values())


def test_remat_replays_dropout_masks():
    loss0, g0, gen0 = _port_grads(False, 0.1)
    loss1, g1, gen1 = _port_grads(True, 0.1)
    assert loss0 == loss1
    assert torch.equal(gen0, gen1)  # the generator ends where the plain forward left it
    big = _largest(g0)
    for name in g0:
        err = float((g0[name] - g1[name]).abs().max())
        assert err <= 1e-6 * big, (name, err, big)


def test_remat_without_replay_is_detected(monkeypatch):
    """The negative control: a recompute that draws from wherever the
    generator stands gives other masks, and the check above catches it."""
    _, g0, _ = _port_grads(False, 0.1)
    monkeypatch.setattr(layers, "_replayed", lambda gen, state: contextlib.nullcontext())
    _, g1, _ = _port_grads(True, 0.1)
    big = _largest(g0)
    worst = max(float((g0[n] - g1[n]).abs().max()) for n in g0)
    assert worst > 1e-6 * big, (worst, big)


def test_remat_gradients_match_jax_remat():
    jcfg = jax_get_config("vqa_med_full", **SMALL, **{"model.remat": True, "model.dropout": 0.0})
    jm = jax_build_model(jcfg.model)
    images, ids, labels = _batch()
    key = jax.random.PRNGKey(0)
    params = jm.init({"params": key, "dropout": key}, images[:2], ids[:2])["params"]

    def loss_fn(p):
        logits = jm.apply({"params": p}, images, ids, train=True, rngs={"dropout": key})
        return jax_cross_entropy(logits, jnp.asarray(labels))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss, grads, _ = _port_grads(True, 0.0, params)
    assert abs(loss - float(jloss)) <= 1e-4 * abs(float(jloss))
    want = flatten_params(jgrads)
    assert set(want) == set(grads)
    largest = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        err = float(np.abs(grads[name].numpy() - w).max())
        if name.endswith("k_proj.bias"):
            assert err <= 1e-4 * largest, (name, err, largest)
        else:
            assert err <= 1e-4 * float(np.abs(w).max()), (name, err, float(np.abs(w).max()))


def test_remat_forward_without_autograd_is_plain():
    cfg = get_config("vqa_med_full", **SMALL)
    plain = build_model(cfg.model, device="cpu", seed=3)
    cfg_r = get_config("vqa_med_full", **SMALL, **{"model.remat": True})
    rem = build_model(cfg_r.model, device="cpu", seed=3)
    assert rem.image_encoder.remat and rem.btia.remat and not plain.btia.remat
    images, ids, _ = _batch()
    with torch.no_grad():
        a = plain(torch.from_numpy(images), torch.from_numpy(ids).long())
        b = rem(torch.from_numpy(images), torch.from_numpy(ids).long())
    assert torch.equal(a, b)
