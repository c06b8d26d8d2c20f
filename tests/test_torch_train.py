"""The port's training surface against the JAX package, on the CPU.

A small ``vqa_med_full`` (vit_test, 2 BERT layers at width 128 with 2 heads,
one BTIA layer at 128 with 2 heads, 64 answers), fp32 and dropout 0, is
initialised in flax and bridged into ``btia_tpu_torch``; three
``make_train_step`` steps run in each package on the same numpy batches.
The learning rate is 0 at step 0, so three steps are taken. The batch-64
case has head width 64 in BERT and BTIA, so the port's backward passes
recompute their attention through K4's twin.

Losses must agree to 1e-4 relative, and every parameter to 1e-4 of its own
largest magnitude, except the attention key biases: their gradient is 0 in
exact arithmetic (a constant added to a row of scores), Adam scales the
rounding noise on both sides to steps of about the learning rate, so they
are held only to that bound.

The rest of the surface (optimizer, label smoothing, eval, dropout,
``steps_per_call``, checkpoint, resume, preemption) is checked on the port,
against optax and the JAX eval step where the reference is a function.
"""

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from btia_tpu.configs import get_config as jax_get_config
from btia_tpu.models.model import build_model as jax_build_model
from btia_tpu.parallel.mesh import MeshConfig, make_mesh
from btia_tpu.train import steps as JS
from btia_tpu_torch.configs import get_config
from btia_tpu_torch.convert.from_jax import flatten_params, load_jax_params
from btia_tpu_torch.data.synthetic import generate_synthetic_vqa_med
from btia_tpu_torch.models.model import BTIAADNet, build_model
from btia_tpu_torch.train import steps as S
from btia_tpu_torch.train.checkpoint import Checkpointer
from btia_tpu_torch.train.trainer import Trainer

SMALL = {
    "model.image_encoder": "vit_test",
    "model.bert_layers": 2,
    "model.bert_hidden": 128,
    "model.bert_heads": 2,
    "model.hidden_dim": 128,
    "model.num_heads": 2,
    "model.btia_layers": 1,
    "model.answer_vocab_size": 64,
    "model.mixed_precision": False,
    "model.dropout": 0.0,
    "train.warmup_steps": 2,
    "train.lr": 1e-3,
}
L = 32


@pytest.fixture(autouse=True)
def _few_threads():
    """The suite runs several workers on one host; two threads each keep
    these CPU-bound tests from oversubscribing it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batch(rng, B):
    ids = np.zeros((B, L), np.int32)
    for i in range(B):
        k = rng.randint(3, 12)
        ids[i, :k] = rng.randint(1, 500, k)
    return dict(
        images=rng.randint(0, 256, (B, 256, 256, 3)).astype(np.uint8), question_ids=ids,
        answer_ids=rng.randint(0, 64, B).astype(np.int32), valid=np.ones(B, bool),
    )


def _t(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}


def _pair(**over):
    """The JAX model, config, mesh and state, and the port's state and
    config on the same weights."""
    jcfg = jax_get_config("vqa_med_full", **SMALL, **over)
    tcfg = get_config("vqa_med_full", **SMALL, **over)
    jm = jax_build_model(jcfg.model)
    mesh = make_mesh(MeshConfig(1, 1), devices=jax.devices()[:1])
    jstate = JS.create_state(jm, jcfg, mesh, steps_per_epoch=10)
    tm = build_model(tcfg.model, device="cpu")
    load_jax_params(tm, jstate.params)
    return (jm, jcfg, mesh, jstate), S.create_state(tm, tcfg, steps_per_epoch=10), tcfg


@pytest.mark.parametrize("B", [8, 64])
def test_three_train_steps_match_jax(B):
    (jm, jcfg, mesh, jstate), state, tcfg = _pair()
    before = flatten_params(jstate.params)
    jstep = JS.make_train_step(jm, jcfg, mesh)
    step = S.make_train_step(state.model, tcfg)
    rng = np.random.RandomState(B)
    for _ in range(3):
        batch = _batch(rng, B)
        jstate, jmet = jstep(jstate, batch)
        state, met = step(state, _t(batch))
        for k in ("loss", "grad_norm", "accuracy"):
            want = float(jmet[k])
            assert abs(float(met[k]) - want) <= 1e-4 * max(abs(want), 1e-6), (k, float(met[k]), want)
    assert state.step == 3
    own = dict(state.model.named_parameters())
    for name, want in flatten_params(jstate.params).items():
        got = own[name].detach().numpy()
        if name.endswith("k_proj.bias"):
            # A zero gradient in exact arithmetic: both sides move by at most
            # about lr per step (Adam normalises the noise).
            bound = 3 * 1.1 * SMALL["train.lr"]
            assert np.abs(got - before[name]).max() <= bound and np.abs(want - before[name]).max() <= bound
            continue
        err = np.abs(got - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err, np.abs(want).max())


def test_eval_predictions_match_jax():
    (jm, jcfg, mesh, jstate), state, tcfg = _pair()
    batch = _batch(np.random.RandomState(3), 8)
    batch["answer_ids"][:2] = 0  # out-of-vocabulary references are never correct
    batch["valid"][-1] = False
    limit = 40
    want = jax.device_get(JS.make_eval_step(jm, jcfg, mesh, vocab_size=limit)(jstate, batch))
    got = S.make_eval_step(state.model, tcfg, vocab_size=limit)(state, _t(batch))
    np.testing.assert_array_equal(got["preds"].numpy(), want["preds"])
    np.testing.assert_array_equal(got["correct"].numpy(), want["correct"])
    assert ((got["preds"] >= 1) & (got["preds"] < limit)).all()


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(smoothing, masked):
    rng = np.random.RandomState(4)
    logits = (rng.randn(6, 11) * 3).astype(np.float32)
    labels = rng.randint(0, 11, 6).astype(np.int32)
    valid = np.array([1, 1, 0, 1, 0, 1], bool) if masked else None
    want = JS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if valid is None else jnp.asarray(valid), smoothing)
    got = S.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels).long(),
                          None if valid is None else torch.from_numpy(valid), smoothing)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


class _Toy(nn.Module):
    """Three parameter groups under the model's top-level names."""

    def __init__(self, params):
        super().__init__()
        for top, value in params.items():
            sub = nn.Module()
            sub.w = nn.Parameter(torch.from_numpy(value.copy()))
            self.add_module(top, sub)


@pytest.mark.parametrize("encoder_lr_scale", [1.0, 0.1])
def test_optimizer_matches_optax(encoder_lr_scale):
    """clip_by_global_norm (hit on the large steps), AdamW with decay on
    every parameter, the warmup-cosine schedule (lr 0 at step 0) and the
    encoder group, against the reference's own optax chain."""
    cfg = get_config("vqa_med_full", **{"train.encoder_lr_scale": encoder_lr_scale,
                                        "train.warmup_steps": 3, "train.epochs": 2,
                                        "train.weight_decay": 0.05, "train.lr": 1e-2})
    jcfg = jax_get_config("vqa_med_full", **{"train.encoder_lr_scale": encoder_lr_scale,
                                             "train.warmup_steps": 3, "train.epochs": 2,
                                             "train.weight_decay": 0.05, "train.lr": 1e-2})
    rng = np.random.RandomState(5)
    init = {k: rng.randn(7, 3).astype(np.float32) for k in ("image_encoder", "question_encoder", "head")}
    toy = _Toy(init)
    opt = S.Optimizer(toy, cfg, steps_per_epoch=4)
    tx = JS.make_optimizer(jcfg, steps_per_epoch=4)
    params = {k: {"w": jnp.asarray(v)} for k, v in init.items()}
    opt_state = tx.init(params)
    for i in range(8):
        scale = 50.0 if i % 3 == 1 else 0.05  # global norm above and below 1.0
        grads = {k: rng.randn(7, 3).astype(np.float32) * scale for k in init}
        for k, g in grads.items():
            getattr(toy, k).w.grad = torch.from_numpy(g.copy())
        norm = opt.step()
        assert abs(float(norm) - float(optax.global_norm(grads))) <= 1e-5 * float(norm)
        updates, opt_state = tx.update({k: {"w": jnp.asarray(g)} for k, g in grads.items()},
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        for k in init:
            got, want = getattr(toy, k).w.detach().numpy(), np.asarray(params[k]["w"])
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            if i == 0:
                np.testing.assert_array_equal(got, init[k])  # lr 0 at step 0
    enc = np.abs(toy.image_encoder.w.detach().numpy() - init["image_encoder"]).mean()
    head = np.abs(toy.head.w.detach().numpy() - init["head"]).mean()
    assert (enc < 0.5 * head) == (encoder_lr_scale < 1.0)


def test_schedule_matches_optax():
    ours = S.warmup_cosine(2e-4, 10, 50, 2e-6)
    ref = optax.warmup_cosine_decay_schedule(0.0, 2e-4, 10, 50, 2e-6)
    for count in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80):
        assert abs(ours(count) - float(ref(count))) <= 1e-6 * 2e-4, count


def _small_model(dropout):
    cfg = get_config("vqa_med_full", **dict(SMALL, **{"model.dropout": dropout}))
    return build_model(cfg.model, device="cpu", seed=1)


def test_dropout_masks_follow_seed_and_step():
    model = _small_model(0.1)
    b = _t(_batch(np.random.RandomState(6), 4))
    run = lambda step, train=True: model(b["images"], b["question_ids"], train=train,
                                         generator=S.dropout_generator(0, step, "cpu"))
    with torch.no_grad():
        a, again, other, other_seed = run(5), run(5), run(6), model(
            b["images"], b["question_ids"], train=True, generator=S.dropout_generator(1, 5, "cpu"))
        det = run(5, train=False)
    assert torch.equal(a, again)
    assert not torch.equal(a, other) and not torch.equal(a, other_seed)
    assert not torch.equal(a, det)
    with pytest.raises(ValueError, match="Generator"):
        model(b["images"], b["question_ids"], train=True)
    with torch.no_grad():  # dropout 0: train=True is the deterministic forward
        m0 = _small_model(0.0)
        assert torch.equal(m0(b["images"], b["question_ids"], train=True),
                           m0(b["images"], b["question_ids"]))


def test_remat_is_not_ported():
    """``model.remat`` is no longer refused: the model builds with its ViT
    blocks and BTIA layers rematerialised (held to the reference in
    ``tests/test_torch_remat.py``)."""
    cfg = get_config("vqa_med_full", **{"model.remat": True})
    model = BTIAADNet(cfg.model, device="meta")
    assert model.image_encoder.remat and model.btia.remat


# ---------------------------------------------------------------------------
# Trainer, checkpoint, resume
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def med_cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("vqa_med")
    generate_synthetic_vqa_med(root, num_images=8)  # 16 pairs per split
    return get_config("vqa_med_full", **dict(SMALL, **{
        "model.dropout": 0.1, "data.data_dir": str(root), "data.num_workers": 1,
        "train.batch_size": 4, "train.eval_batch_size": 8, "train.epochs": 2, "train.log_every": 1,
        "train.steps_per_call": 1,
    }))


def _params(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_fit_evaluate_and_checkpoint(med_cfg, tmp_path):
    trainer = Trainer(med_cfg, tmp_path / "run", device="cpu")
    history = trainer.fit()
    assert len(history) == 2 and trainer.state.step == 8
    assert all(np.isfinite(r["train_loss"]) and "val_accuracy" in r for r in history)
    metrics = trainer.evaluate("test")
    assert 0.0 <= metrics["accuracy"] <= 1.0 and "bleu" in metrics
    again = Trainer(med_cfg, tmp_path / "run", device="cpu")
    assert again.resume_if_available() and again.state.step == 8
    _assert_same(_params(trainer), _params(again))


def test_steps_per_call_matches_single_steps(med_cfg, tmp_path):
    single = Trainer(med_cfg, tmp_path / "single", device="cpu")
    single.fit(epochs=1)
    chunked_cfg = dataclasses.replace(med_cfg, train=dataclasses.replace(med_cfg.train, steps_per_call=3))
    chunked = Trainer(chunked_cfg, tmp_path / "chunked", device="cpu")
    chunked.fit(epochs=1)  # one 3-step call and one single step
    assert single.state.step == chunked.state.step == 4
    _assert_same(_params(single), _params(chunked))


def test_preemption_then_resume_is_bit_identical(med_cfg, tmp_path):
    """A SIGTERM mid-epoch saves durably and returns; a restart resumes at
    the saved step and ends where the uninterrupted run ends, dropout masks,
    batch order and Adam moments included."""
    straight = Trainer(med_cfg, tmp_path / "straight", device="cpu")
    straight.fit()
    cut = Trainer(med_cfg, tmp_path / "cut", device="cpu")
    cut._preempted = True  # as the SIGTERM handler would set
    assert cut.fit() == []
    assert cut.state.step == 1 and cut.ckpt.latest_step() == 1
    resumed = Trainer(med_cfg, tmp_path / "cut", device="cpu")
    assert resumed.resume_if_available() and resumed.state.step == 1
    resumed.fit()
    assert resumed.state.step == straight.state.step == 8
    _assert_same(_params(straight), _params(resumed))


def test_sigterm_handler_requests_a_save_and_return(med_cfg, tmp_path):
    trainer = Trainer(med_cfg, tmp_path / "run", device="cpu")
    before = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        trainer.install_preemption_handler()
        os.kill(os.getpid(), signal.SIGTERM)
        assert trainer._preempted
        assert trainer.fit() == [] and trainer.ckpt.latest_step() == 1
    finally:
        for sig, handler in before.items():
            signal.signal(sig, handler)


def test_best_survives_rotation(med_cfg, tmp_path):
    trainer = Trainer(med_cfg, tmp_path / "run", device="cpu")
    state = trainer.state
    ckpt = Checkpointer(tmp_path / "ck", max_to_keep=2)
    for step, metric in [(1, 0.9), (2, 0.5), (3, 0.4), (4, 0.3)]:
        state.step = step
        with torch.no_grad():
            state.model.head.answer_bias.fill_(step)
        ckpt.save(state, metric=metric)
    assert ckpt.latest_step() == 4
    assert sorted(p.name for p in ckpt.directory.glob("step_*.pt")) == ["step_3.pt", "step_4.pt"]
    assert ckpt.restore(state, best=True).step == 1
    assert float(state.model.head.answer_bias.detach()[0]) == 1.0
    assert ckpt.restore(state).step == 4
    assert float(state.model.head.answer_bias.detach()[0]) == 4.0


def test_async_save_snapshots_at_call_time(med_cfg, tmp_path):
    trainer = Trainer(med_cfg, tmp_path / "run", device="cpu")
    state = trainer.state
    snapshot = _params(trainer)
    ckpt = Checkpointer(tmp_path / "ck_async")
    state.step = 7
    ckpt.save(state)  # returns before the file is written
    with torch.no_grad():
        for p in state.model.parameters():
            p.fill_(-1.0)
    state.step = 0
    assert ckpt.restore(state).step == 7
    _assert_same(snapshot, _params(trainer))
