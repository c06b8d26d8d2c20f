"""The three configurations of the ResNet / LSTM / mlp-head slice against the
JAX package, on the CPU: ``tiny_test`` as registered, and ``vqa_rad_lstm``
and ``slake_bert`` at reduced depth (``resnet_tiny``, one BTIA layer, one
BERT layer) and widths that still pass K1's gate (batch 64, widths of 128,
two heads of 64), with the JAX kernels in Pallas's TPU interpret mode and
the port on its plain twins.

Flax initialises each model (parameters and BatchNorm statistics); the
weight bridge (``load_jax_variables``) carries both across. fp32 and
dropout 0 throughout, so the two packages compute the same function:
logits, losses and gradient norms within 1e-4 of their magnitude (the
goldens' fp32 tolerance) and the BatchNorm statistics within 1e-5 of their
largest magnitude. The parameters after the steps are held through Adam's
update, which scales each element's gradient to a step of about the
learning rate whatever its size: an element whose gradient is a
near-cancelling difference (a query bias shifts a row's scores together,
which the softmax nearly removes; a BatchNorm bias ahead of a convolution
and another BatchNorm shifts what that BatchNorm subtracts again) gets a
step of rounding noise on each side. So the weights' update, port minus
JAX over all of them, is held within 2 % of the update's L2 norm
(observed 0.3 % to 0.7 %), and the parameters that start at 0 (the
biases, among them the attention key biases, whose gradient is 0 in exact
arithmetic) are held to Adam's bound of about the learning rate a step, as
``test_torch_train.py`` holds the key biases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from btia_tpu.configs import get_config as jax_get_config
from btia_tpu.data.vocab import AnswerVocab as JaxAnswerVocab
from btia_tpu.data.vocab import WordVocab as JaxWordVocab
from btia_tpu.data.wordpiece import WordPieceTokenizer as JaxWordPiece
from btia_tpu.infer.predict import Predictor as JaxPredictor
from btia_tpu.models.model import build_model as jax_build_model
from btia_tpu.ops import attention as JA
from btia_tpu.parallel.mesh import MeshConfig, make_mesh
from btia_tpu.train import steps as JS
from btia_tpu_torch.configs import get_config
from btia_tpu_torch.convert.from_jax import flatten_params, load_jax_variables
from btia_tpu_torch.data.vocab import AnswerVocab, WordVocab
from btia_tpu_torch.data.wordpiece import WordPieceTokenizer
from btia_tpu_torch.infer.predict import Predictor
from btia_tpu_torch.models.model import build_model
from btia_tpu_torch.ops import attention as A
from btia_tpu_torch.ops import fused_attn as FA
from btia_tpu_torch.train import steps as S

CORPUS = ["is the lung normal", "what organ is shown", "is there a fracture",
          "which side is the lesion on", "does the chest x ray show pleural effusion"]
ANSWERS = ["yes", "no", "lung", "left", "right", "brain"]
_GATED = {"model.image_encoder": "resnet_tiny", "model.hidden_dim": 128, "model.num_heads": 2,
          "model.btia_layers": 1, "model.answer_vocab_size": 64, "model.max_question_len": 12}
CASES = {
    "tiny_test": {},
    "vqa_rad_lstm": {**_GATED, "model.lstm_hidden": 64, "model.word_embed_dim": 32,
                     "model.question_vocab_size": 128},
    "slake_bert": {**_GATED, "model.bert_layers": 1, "model.bert_hidden": 128, "model.bert_heads": 2},
}
COMMON = {"model.mixed_precision": False, "model.dropout": 0.0, "train.warmup_steps": 2, "train.lr": 1e-3}


@pytest.fixture(autouse=True)
def _kernels_interpreted():
    """The reference's switch on its kernels, run in Pallas's TPU interpret
    mode; few threads, since the suite runs several workers on one host."""
    impl, threads = JA.get_attention_impl(), torch.get_num_threads()
    JA.set_attention_impl("pallas")
    torch.set_num_threads(2)
    with pltpu.force_tpu_interpret_mode():
        yield
    JA.set_attention_impl(impl)
    torch.set_num_threads(threads)


def _text(name):
    if name == "slake_bert":
        return JaxWordPiece.toy_vocab(CORPUS), WordPieceTokenizer.toy_vocab(CORPUS)
    return JaxWordVocab.build(CORPUS), WordVocab.build(CORPUS)


def _pair(name):
    over = {**CASES[name], **COMMON}
    jcfg, tcfg = jax_get_config(name, **over), get_config(name, **over)
    jm = jax_build_model(jcfg.model)
    mesh = make_mesh(MeshConfig(1, 1), devices=jax.devices()[:1])
    jstate = JS.create_state(jm, jcfg, mesh, steps_per_epoch=10)
    tm = build_model(tcfg.model, device="cpu")
    load_jax_variables(tm, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    return (jm, jcfg, mesh, jstate), S.create_state(tm, tcfg, steps_per_epoch=10), tcfg


def _batch(rng, B, cfg, vocab):
    L = cfg.model.max_question_len
    ids = np.asarray([vocab.encode(CORPUS[i % len(CORPUS)], L) for i in rng.randint(0, 50, B)], np.int32)
    size = max(256, cfg.model.image_size)
    return dict(images=rng.randint(0, 256, (B, size, size, 3)).astype(np.uint8), question_ids=ids,
                answer_ids=rng.randint(0, cfg.model.answer_vocab_size, B).astype(np.int32),
                valid=np.ones(B, bool))


def _t(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v) for k, v in batch.items()}


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * max(scale, 1e-6), (err, scale)


def _batch_size(name):
    return 8 if name == "tiny_test" else 64


@pytest.mark.parametrize("name", list(CASES))
def test_eval_forward_matches_jax(name, monkeypatch):
    (jm, jcfg, mesh, jstate), state, tcfg = _pair(name)
    B = _batch_size(name)
    batch = _batch(np.random.RandomState(1), B, tcfg, _text(name)[1])
    fused = []
    real = FA._fused_dense_plain
    monkeypatch.setattr(FA, "_fused_dense_plain", lambda *a: fused.append(1) or real(*a))
    fn = lambda v, i, q: jm.apply(v, i, q)
    want = jax.jit(fn)(jstate.variables(), batch["images"], batch["question_ids"])
    with torch.no_grad():
        got = state.model(*(_t(batch)[k] for k in ("images", "question_ids")))
    assert got.shape == (B, tcfg.model.answer_vocab_size)
    _close(got, want)
    # Both sides fused their K1 sites at batch 64 (the reference through its
    # Pallas kernel), neither below it.
    jaxpr = str(jax.make_jaxpr(fn)(jstate.variables(), batch["images"], batch["question_ids"]))
    assert ("pallas_call" in jaxpr) == (B >= 64) == bool(fused)


@pytest.mark.parametrize("name", list(CASES))
def test_train_steps_match_jax(name):
    """Two steps (the learning rate is 0 at step 0, the BatchNorm statistics
    move at both): loss, accuracy, gradient norm, then every parameter and
    every running statistic."""
    (jm, jcfg, mesh, jstate), state, tcfg = _pair(name)
    B = _batch_size(name)
    jstep = JS.make_train_step(jm, jcfg, mesh)
    step = S.make_train_step(state.model, tcfg)
    rng = np.random.RandomState(2)
    vocab = _text(name)[1]
    stats0 = flatten_params(jstate.batch_stats)
    params0 = flatten_params(jstate.params)
    for _ in range(2):
        batch = _batch(rng, B, tcfg, vocab)
        jstate, jmet = jstep(jstate, batch)
        state, met = step(state, _t(batch))
        for k in ("loss", "grad_norm", "accuracy"):
            want = float(jmet[k])
            assert abs(float(met[k]) - want) <= 1e-4 * max(abs(want), 1e-6), (k, float(met[k]), want)
    own = dict(state.model.named_parameters())
    diff, moved = 0.0, 0.0
    for key, want in flatten_params(jstate.params).items():
        got = own[key].detach().numpy()
        if key.endswith("k_proj.bias") or not params0[key].any():
            # At most about lr a step on each side (the first at lr 0).
            bound = 1.1 * COMMON["train.lr"]
            assert np.abs(got).max() <= bound and np.abs(np.asarray(want)).max() <= bound, key
            continue
        before = params0[key]
        if got.ndim == 4:  # conv kernels: HWIO on the JAX side
            want, before = want.transpose(3, 2, 0, 1), before.transpose(3, 2, 0, 1)
        diff += float(((got - want).astype(np.float64) ** 2).sum())
        moved += float(((want - before).astype(np.float64) ** 2).sum())
    assert (diff / moved) ** 0.5 <= 2e-2
    buffers = dict(state.model.named_buffers())
    stats = flatten_params(jstate.batch_stats)
    assert sorted(stats) == sorted(buffers) and stats
    for key, want in stats.items():
        _close(buffers[key], want, 1e-5)
    assert all(np.abs(stats[k] - stats0[k]).max() > 0 for k in stats)


@pytest.mark.parametrize("name", list(CASES))
def test_predictor_matches_jax(name):
    """The Predictor over the same weights and running statistics: buckets
    of 1-8 questions (under the batch floor, so unfused in both)."""
    (jm, jcfg, mesh, jstate), state, tcfg = _pair(name)
    jtext, ttext = _text(name)
    jp = JaxPredictor(jm, jstate.variables(), jtext, JaxAnswerVocab(ANSWERS), jcfg)
    tp = Predictor(state.model, None, ttext, AnswerVocab(ANSWERS), tcfg, device="cpu")
    image = np.random.RandomState(3).randint(0, 256, (300, 280, 3)).astype(np.uint8)
    ref = jp.predict_batch(image, CORPUS[:3])
    out = tp.predict_batch(image, CORPUS[:3])
    assert out.shape == ref.shape == (3, tcfg.model.answer_vocab_size)
    _close(out, ref)
    assert tp.predict_answers(image, CORPUS) == jp.predict_answers(image, CORPUS)


def test_pooled_resnet_grid_has_no_cls_token():
    """``image_pool_grid`` on a ResNet pools every grid token (no CLS token
    is split off, as the reference: ``model.py:119-121``): resnet_xsmall's
    16 x 16 grid at 128 px to 4 x 4 tokens, against the JAX package."""
    over = {"model.image_encoder": "resnet_xsmall", "model.image_pool_grid": 4, "model.hidden_dim": 64,
            "model.num_heads": 2, "model.btia_layers": 1, "model.answer_vocab_size": 32,
            "model.lstm_hidden": 32, "model.word_embed_dim": 32, "model.question_vocab_size": 128,
            "model.mixed_precision": False}
    jcfg, tcfg = jax_get_config("tiny_test", **over), get_config("tiny_test", **over)
    jm = jax_build_model(jcfg.model)
    key = jax.random.PRNGKey(4)
    variables = jax.jit(jm.init)({"params": key, "dropout": key}, jnp.zeros((1, 128, 128, 3), jnp.uint8),
                                 jnp.ones((1, 12), jnp.int32))
    tm = build_model(tcfg.model, device="cpu")
    load_jax_variables(tm, variables)
    images = np.random.RandomState(5).randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    want = jax.jit(lambda v, x: jm.apply(v, x, method="encode_image"))(variables, images)
    with torch.no_grad():
        got = tm.encode_image(torch.from_numpy(images))
    assert got.shape == want.shape == (2, 16, 64)
    _close(got, want)


def test_tiny_test_runs_with_the_kernels_switched_off():
    """tiny_test's widths pass no gate: the switch changes nothing."""
    (jm, jcfg, mesh, jstate), state, tcfg = _pair("tiny_test")
    batch = _t(_batch(np.random.RandomState(6), 4, tcfg, _text("tiny_test")[1]))
    with torch.no_grad():
        a = state.model(batch["images"], batch["question_ids"])
        A.set_attention_impl("xla")
        try:
            b = state.model(batch["images"], batch["question_ids"])
        finally:
            A.set_attention_impl("auto")
    assert torch.equal(a, b)


def test_tiny_test_checkpoint_carries_batchnorm_statistics(tmp_path):
    """tiny_test through the port's Trainer on the synthetic corpus: the
    train steps move the BatchNorm statistics, the checkpoint carries them,
    and ``Predictor.from_checkpoint`` serves with them (eval mode: the
    running statistics, so one image's logits do not depend on the batch)."""
    from btia_tpu_torch.train.trainer import Trainer

    cfg = get_config("tiny_test", **{"data.data_dir": str(tmp_path / "data"), "train.epochs": 1})
    trainer = Trainer(cfg, tmp_path / "run", device="cpu")
    before = {n: b.clone() for n, b in trainer.model.named_buffers()}
    trainer.fit()
    after = dict(trainer.model.named_buffers())
    assert before and all(not torch.equal(before[n], after[n]) for n in before)
    pred = Predictor.from_checkpoint(tmp_path / "run", best=False, device="cpu")
    for n, b in pred.model.named_buffers():
        assert torch.equal(b, after[n]), n
    image = np.random.RandomState(7).randint(0, 256, (120, 90, 3)).astype(np.uint8)
    one = pred.predict_batch(image, CORPUS[:1])
    many = pred.predict_batch(image, CORPUS)
    np.testing.assert_allclose(one[0], many[0], atol=1e-5, rtol=0)
    assert len(pred.predict_answers(image, CORPUS)) == len(CORPUS)
