"""The port's model against the JAX package at one set of weights.

A small ``streaming_vitl`` (vit_test, 2 BERT layers at width 128, one BTIA
layer, 8 answer queries over 64 answers) is initialised in flax, bridged into
``btia_tpu_torch`` and both are fed the same numpy inputs. On the CPU the JAX
model takes its unfused road (additive-bias softmax) while the port takes the
plain twins of K1-K3 (mask after exp); the two agree except on question rows
that are all PAD, so every question here has at least one real token.

fp32 logits must agree to 1e-4 (the goldens' tolerance). bf16: the port folds
scale*log2(e) into wq before rounding it to bf16 (as the fused TPU kernels
do) while the JAX unfused road scales the scores, and the two round the
GELU, LayerNorm and projection outputs at different points, so bf16 logits
(magnitude ~0.5 here) are held to 1e-2 absolute; the observed gap is ~2e-3.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btia_tpu.configs import get_config as jax_get_config
from btia_tpu.models.model import build_model as jax_build_model
from btia_tpu_torch.configs import get_config
from btia_tpu_torch.configs.config import Config
from btia_tpu_torch.convert.from_jax import flatten_params, load_jax_params
from btia_tpu_torch.models.model import BTIAADNet, build_model

SMALL = {
    "model.image_encoder": "vit_test",
    "model.bert_layers": 2,
    "model.bert_hidden": 128,
    "model.bert_heads": 2,
    "model.hidden_dim": 128,
    "model.num_heads": 2,
    "model.btia_layers": 1,
    "model.answer_vocab_size": 64,
    "model.num_answer_queries": 8,
    "model.mixed_precision": False,
}
L = 32


def _qids(rng, n):
    """Question rows with 3..L real tokens, then PAD."""
    ids = np.zeros((n, L), np.int32)
    for i in range(n):
        k = rng.randint(3, L + 1)
        ids[i, :k] = rng.randint(1, 500, k)
    return ids


def _setup(mixed: bool):
    over = dict(SMALL, **{"model.mixed_precision": mixed})
    cfg = jax_get_config("streaming_vitl", **over)
    jm = jax_build_model(cfg.model)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(jm.init)(
        {"params": key, "dropout": key},
        jnp.zeros((1, 96, 96, 3), jnp.uint8), jnp.ones((1, L), jnp.int32),
    )
    tcfg = get_config("streaming_vitl", **over)
    tm = build_model(tcfg.model, device="cpu")
    load_jax_params(tm, variables["params"])
    return _Jitted(jm), variables, tm


class _Jitted:
    """``model.apply(variables, *args, method=...)``, jitted per method
    (eager flax dispatch is several times slower on the CPU)."""

    def __init__(self, model):
        self.model = model
        self._fns = {}

    def apply(self, variables, *args, method="__call__"):
        if method not in self._fns:
            self._fns[method] = jax.jit(
                lambda v, *a: self.model.apply(v, *a, method=method)
            )
        return self._fns[method](variables, *args)


@pytest.fixture(scope="module")
def fp32_pair():
    return _setup(mixed=False)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    return dict(
        images=rng.randint(0, 256, (2, 120, 120, 3)).astype(np.uint8),
        qids=_qids(rng, 2 * 3).reshape(2, 3, L),
        unique=_qids(rng, 4),
        qmap=rng.randint(0, 4, (2, 3)).astype(np.int32),
        pair_img=np.array([0, 1, 1, 0, 1], np.int32),
        pair_q=np.array([3, 0, 2, 2, 1], np.int32),
    )


def _t(x):
    """numpy -> torch; integer ids and indices as int64."""
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype.kind == "i" else x)


def _close(a, b, atol):
    np.testing.assert_allclose(
        np.asarray(a, np.float32), np.asarray(b, np.float32), atol=atol, rtol=0
    )


class TestEntryPointsFp32:
    def test_encode_image(self, fp32_pair, inputs):
        jm, v, tm = fp32_pair
        ref = jm.apply(v, inputs["images"], method="encode_image")
        with torch.no_grad():
            out = tm.encode_image(_t(inputs["images"]))
        assert out.shape == ref.shape == (2, 50, 128)
        _close(out, ref, 1e-4)

    def test_encode_question(self, fp32_pair, inputs):
        jm, v, tm = fp32_pair
        ids = inputs["unique"]
        ref, ref_mask = jm.apply(v, ids, method="encode_question")
        with torch.no_grad():
            out, mask = tm.encode_question(_t(ids))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
        _close(out, ref, 1e-4)

    def test_answer_questions(self, fp32_pair, inputs):
        jm, v, tm = fp32_pair
        img = jm.apply(v, inputs["images"], method="encode_image")
        ref = jm.apply(v, img, inputs["qids"], method="answer_questions")
        with torch.no_grad():
            out = tm.answer_questions(tm.encode_image(_t(inputs["images"])), _t(inputs["qids"]))
        assert out.shape == (2, 3, 64) and out.dtype == torch.float32
        _close(out, ref, 1e-4)

    def test_answer_questions_indexed(self, fp32_pair, inputs):
        jm, v, tm = fp32_pair
        img = jm.apply(v, inputs["images"], method="encode_image")
        ref = jm.apply(
            v, img, inputs["unique"], inputs["qmap"], method="answer_questions_indexed"
        )
        with torch.no_grad():
            out = tm.answer_questions_indexed(
                tm.encode_image(_t(inputs["images"])), _t(inputs["unique"]), _t(inputs["qmap"])
            )
        _close(out, ref, 1e-4)

    def test_answer_pairs(self, fp32_pair, inputs):
        jm, v, tm = fp32_pair
        img = jm.apply(v, inputs["images"], method="encode_image")
        ref = jm.apply(
            v, img, inputs["unique"], inputs["pair_img"], inputs["pair_q"],
            method="answer_pairs",
        )
        with torch.no_grad():
            out = tm.answer_pairs(
                tm.encode_image(_t(inputs["images"])), _t(inputs["unique"]),
                _t(inputs["pair_img"]), _t(inputs["pair_q"]),
            )
        assert out.shape == (5, 64)
        _close(out, ref, 1e-4)

    def test_call(self, fp32_pair, inputs):
        jm, v, tm = fp32_pair
        qids = inputs["qids"][:, 0]
        ref = jm.apply(v, inputs["images"], qids)
        with torch.no_grad():
            out = tm(_t(inputs["images"]), _t(qids))
        _close(out, ref, 1e-4)


def test_bf16_answer_questions(inputs):
    jm, v, tm = _setup(mixed=True)
    assert tm.policy.compute_dtype == torch.bfloat16
    img = jm.apply(v, inputs["images"], method="encode_image")
    ref = jm.apply(v, img, inputs["qids"], method="answer_questions")
    with torch.no_grad():
        out = tm.answer_questions(tm.encode_image(_t(inputs["images"])), _t(inputs["qids"]))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    _close(out, ref, 1e-2)


class TestWeightBridge:
    def test_consumes_every_key(self, fp32_pair):
        _, v, tm = fp32_pair
        flat = flatten_params(v["params"])
        assert set(flat) == set(dict(tm.named_parameters()))
        for name, p in tm.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), flat[name])

    @pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
    def test_raises_on_mismatch(self, fp32_pair, fault):
        _, v, tm = fp32_pair
        flat = flatten_params(v["params"])
        name = "head.answer_bias"
        if fault == "missing":
            del flat[name]
        elif fault == "extra":
            flat["head.not_a_param"] = np.zeros(3, np.float32)
        else:
            flat[name] = np.zeros(7, np.float32)
        tree = {}
        for k, a in flat.items():
            node = tree
            *scopes, leaf = k.split(".")
            for s in scopes:
                node = node.setdefault(s, {})
            node[leaf] = a
        with pytest.raises((KeyError, ValueError)):
            load_jax_params(tm, tree)

    def test_full_config_key_set(self, fp32_pair):
        """The full-width streaming_vitl tree (built on the meta device)
        has the small config's keys with every layer index expanded to the
        full depth, at the registered widths."""
        _, v, _ = fp32_pair
        cfg = get_config("streaming_vitl").model
        full = {n: tuple(p.shape) for n, p in BTIAADNet(cfg, device="meta").named_parameters()}
        generic = lambda keys: {re.sub(r"(block|layer)\d+", r"\1#", k) for k in keys}
        assert generic(full) == generic(flatten_params(v["params"]))
        count = lambda pat: len({re.match(pat, k).group(0) for k in full if re.match(pat, k)})
        assert count(r"image_encoder\.block\d+") == 24
        assert count(r"question_encoder\.layer\d+") == 12
        assert count(r"btia\.layer\d+") == 4
        assert full["image_encoder.patch_embed.kernel"] == (14 * 14 * 3, 1024)
        assert full["image_encoder.pos_embed"] == (1, 577, 1024)
        assert full["image_encoder.block23.mlp.fc1.kernel"] == (1024, 4096)
        assert full["question_encoder.word_embed.embedding"] == (30522, 768)
        assert full["btia.layer3.i2t_q_proj.kernel"] == (768, 768)
        assert full["head.answer_queries"] == (64, 768)
        assert full["head.answer_table"] == (2048, 768)


def test_config_json_round_trips_between_packages():
    for name in ("streaming_vitl", "tiny_test", "vqa_med_full"):
        jc = jax_get_config(name)
        tc = Config.from_json(jc.to_json())
        assert tc.to_json() == jc.to_json()
        assert jax_get_config(name).from_json(get_config(name).to_json()) == jc


@pytest.mark.parametrize("name", ["vqa_rad_lstm", "slake_bert", "tiny_test", "streaming_vitl",
                                  "pathvqa_vit", "vqa_med_full"])
def test_unported_configs_raise(name):
    """Every registered config builds (on ``meta``: shapes only), with
    ``model.remat`` too, which no option refuses any more: its ViT blocks
    and BTIA layers rematerialised, a ResNet not."""
    model = BTIAADNet(get_config(name).model, device="meta")
    assert type(model.head).__name__ == ("ADHead" if get_config(name).model.head == "ad" else "SimpleClassifier")
    remat = BTIAADNet(get_config(name, **{"model.remat": True}).model, device="meta")
    assert remat.btia.remat and getattr(remat.image_encoder, "remat", True)
    assert not model.btia.remat
