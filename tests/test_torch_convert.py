"""Reference-PyTorch checkpoint -> the port (``btia_tpu_torch/convert/
convert.py``), mirroring ``tests/test_convert.py``.

The JAX package's torch oracle (``btia_tpu.convert.torch_ref``) gives the
reference-layout state_dict. It goes through the JAX package's
``convert_state_dict`` into the flax model and through the port's into the
port's model; at fp32 the two models' logits agree within 1e-4, for the
three model families of ``test_convert.py``, and the port's
``verify_parity`` against the torch oracle passes at 2e-4. The
``NAME_OVERRIDES`` and torchvision-downsample rehearsals, the missing key,
the shape mismatch and the leftover parameter are held as there.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from btia_tpu.configs.config import ModelConfig
from btia_tpu.convert import convert as JC
from btia_tpu.convert.torch_ref import build_torch_model
from btia_tpu.models.model import build_model as jax_build_model
from btia_tpu_torch.configs.config import ModelConfig as PortModelConfig
from btia_tpu_torch.convert import convert as C
from btia_tpu_torch.models.model import build_model

TINY_LSTM = ModelConfig(
    image_encoder="resnet_tiny",
    question_encoder="lstm",
    hidden_dim=64,
    num_heads=4,
    btia_layers=1,
    head="mlp",
    answer_vocab_size=16,
    question_vocab_size=120,
    word_embed_dim=24,
    lstm_hidden=32,
    max_question_len=10,
    mixed_precision=False,
)
FAMILIES = {
    # ResNet + LSTM + BTIA + classifier
    "resnet_lstm_mlp": TINY_LSTM,
    # BERT + BTIA + per-answer AD head
    "bert_ad_head": dataclasses.replace(TINY_LSTM, question_encoder="bert", head="ad", bert_layers=2,
                                        bert_hidden=32, bert_heads=2, bert_vocab_size=100),
    # factorized AD head + token pooling
    "factorized_ad_head_and_pooling": dataclasses.replace(TINY_LSTM, head="ad", num_answer_queries=8,
                                                          image_pool_grid=1),
}


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _probes(cfg, B=2):
    rng = np.random.RandomState(0)
    ingest = max(96, cfg.image_size)
    images = rng.randint(0, 255, (B, ingest, ingest, 3)).astype(np.uint8)
    vocab = cfg.question_vocab_size if cfg.question_encoder == "lstm" else cfg.bert_vocab_size
    qids = rng.randint(1, vocab, (B, cfg.max_question_len)).astype(np.int32)
    qids[:, -3:] = 0  # padding and masking
    return images, qids


def _port_model(cfg: ModelConfig, seed=7):
    return build_model(PortModelConfig(**dataclasses.asdict(cfg)), device="cpu", seed=seed)


def _port_logits(model, images, qids):
    with torch.no_grad():
        return model(torch.from_numpy(images), torch.from_numpy(qids).long()).numpy()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_and_jax_conversions_agree(family):
    cfg = FAMILIES[family]
    torch_model = build_torch_model(cfg, seed=0)
    sd = torch_model.state_dict()
    images, qids = _probes(cfg)
    jm = jax_build_model(cfg)
    key = jax.random.PRNGKey(0)
    template = jax.jit(jm.init)({"params": key, "dropout": key}, images, qids)
    variables = JC.convert_state_dict(sd, template)
    want = np.asarray(jax.jit(lambda v, i, q: jm.apply(v, i, q, train=False))(variables, images, qids))
    model = C.convert_state_dict(sd, _port_model(cfg))
    got = _port_logits(model, images, qids)
    assert np.abs(got - want).max() <= 1e-4, np.abs(got - want).max()
    assert C.verify_parity(torch_model, model, images, qids, atol=2e-4) < 2e-4


def test_port_params_from_torch():
    torch_model = build_torch_model(TINY_LSTM, seed=0)
    model = C.port_params_from_torch(torch_model, _port_model(TINY_LSTM))
    images, qids = _probes(TINY_LSTM)
    assert C.verify_parity(torch_model, model, images, qids) < 2e-4


def _pick_kernels(model, sd):
    """One Linear and one Conv kernel, renamed in `sd` as an unknown
    reference might name them -> NAME_OVERRIDES absorbing the renames."""
    overrides, picked = {}, {"linear": False, "conv": False}
    for name, _ in model.named_parameters():
        path = tuple(name.split("."))
        default_key, kind = C._torch_key(path)
        if kind != "kernel" or default_key not in sd:
            continue
        tag = {2: "linear", 4: "conv"}.get(sd[default_key].ndim)
        if tag and not picked[tag]:
            legacy = f"legacy.{tag}.weird_weight_name"
            sd[legacy] = sd.pop(default_key)
            overrides["/".join(path)] = legacy
            picked[tag] = True
    assert all(picked.values()), "expected both a Linear and a Conv kernel"
    return overrides


def test_name_overrides_rehearsal(monkeypatch):
    """Renamed keys fail loudly without NAME_OVERRIDES and pass the parity
    gate with them, the layout transpose applied to an overridden kernel."""
    torch_model = build_torch_model(TINY_LSTM, seed=0)
    model = _port_model(TINY_LSTM)
    sd = {k: v.detach().clone() for k, v in torch_model.state_dict().items()}
    overrides = _pick_kernels(model, sd)
    with pytest.raises(KeyError, match="NAME_OVERRIDES"):
        C.convert_state_dict(sd, model)
    monkeypatch.setattr(C, "NAME_OVERRIDES", overrides)
    C.convert_state_dict(sd, model)
    images, qids = _probes(TINY_LSTM)
    assert C.verify_parity(torch_model, model, images, qids) < 2e-4


def test_torchvision_downsample_rehearsal(monkeypatch):
    """torchvision names a projection shortcut ``downsample.0`` (conv) and
    ``downsample.1`` (BatchNorm, running statistics included): every such
    key renamed, absorbed by NAME_OVERRIDES alone, direct leaves and the
    BatchNorm buffers among them."""
    torch_model = build_torch_model(TINY_LSTM, seed=0)
    model = _port_model(TINY_LSTM)
    sd = {k: v.detach().clone() for k, v in torch_model.state_dict().items()}
    overrides = {}
    for name, _ in [*model.named_parameters(), *model.named_buffers()]:
        path = tuple(name.split("."))
        default_key, _ = C._torch_key(path)
        tv_key = default_key.replace("downsample_conv.", "downsample.0.").replace("downsample_bn.", "downsample.1.")
        if tv_key != default_key:
            sd[tv_key] = sd.pop(default_key)
            overrides["/".join(path)] = tv_key
    assert {p.rsplit("/", 1)[1] for p in overrides} >= {"kernel", "scale", "bias", "mean", "var"}
    with pytest.raises(KeyError):
        C.convert_state_dict(sd, model)
    monkeypatch.setattr(C, "NAME_OVERRIDES", overrides)
    C.convert_state_dict(sd, model)
    images, qids = _probes(TINY_LSTM)
    assert C.verify_parity(torch_model, model, images, qids) < 2e-4


def test_shape_mismatch_raises():
    torch_model = build_torch_model(TINY_LSTM, seed=0)
    model = _port_model(dataclasses.replace(TINY_LSTM, hidden_dim=32))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="shape mismatch"):
        C.port_params_from_torch(torch_model, model)
    # Nothing was written: every entry is checked before any is copied.
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_leftover_parameters_raise():
    sd = dict(build_torch_model(TINY_LSTM, seed=0).state_dict())
    sd["extra.weight"] = torch.zeros(3)
    sd["image_encoder.stem_bn.num_batches_tracked"] = torch.tensor(5)  # skipped, as torch writes it
    with pytest.raises(ValueError, match="unconverted torch parameters.*extra.weight"):
        C.convert_state_dict(sd, _port_model(TINY_LSTM))


def test_verify_parity_refuses_bf16_and_catches_a_difference():
    torch_model = build_torch_model(TINY_LSTM, seed=0)
    images, qids = _probes(TINY_LSTM)
    with pytest.raises(ValueError, match="fp32"):
        C.verify_parity(torch_model, _port_model(dataclasses.replace(TINY_LSTM, mixed_precision=True)),
                        images, qids)
    model = C.port_params_from_torch(torch_model, _port_model(TINY_LSTM))
    with torch.no_grad():
        model.head.fc_out.bias.add_(1e-3)
    with pytest.raises(AssertionError, match="parity failure"):
        C.verify_parity(torch_model, model, images, qids)
