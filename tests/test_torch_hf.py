"""The HF / torchvision weight maps of the port (``btia_tpu_torch/convert/
hf.py``), mirroring ``tests/test_hf_parity.py``: randomly initialised
``transformers`` BERT and ViT models go through the maps into the port's
encoders (``load_encoder_params``), whose features match HF's within that
file's tolerance (2e-4); a synthetic torchvision-named ResNet state_dict
maps to the JAX package's tree leaf for leaf and loads into a port model,
running statistics included; a missing leaf and a wrong shape raise."""

import numpy as np
import pytest
import torch
from torch import nn

transformers = pytest.importorskip("transformers")

from btia_tpu.convert import hf as JH
from btia_tpu.convert.torch_ref import TorchResNet
from btia_tpu.models.resnet import STAGE_SIZES
from btia_tpu_torch.configs import get_config
from btia_tpu_torch.convert import hf as H
from btia_tpu_torch.convert.from_jax import flatten_params
from btia_tpu_torch.core.dtypes import default_policy
from btia_tpu_torch.models.bert import BertQuestionEncoder, BertSpec
from btia_tpu_torch.models.model import build_model
from btia_tpu_torch.models.vit import ViT, ViTSpec

FP32 = default_policy(False)


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _holder(**encoders) -> nn.Module:
    m = nn.Module()
    for name, enc in encoders.items():
        m.add_module(name, enc)
    return m


def test_bert_feature_parity():
    from transformers import BertConfig, BertModel

    hf_cfg = BertConfig(vocab_size=120, hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=96, max_position_embeddings=64, hidden_act="gelu",
                        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = BertModel(hf_cfg).eval()
    ours = BertQuestionEncoder(BertSpec(vocab_size=120, dim=48, depth=2, num_heads=4, mlp_dim=96, max_len=64),
                               FP32, "cpu")
    H.load_encoder_params(_holder(question_encoder=ours), H.bert_params_from_hf(hf.state_dict()),
                          "question_encoder")
    ids = np.random.RandomState(0).randint(1, 120, (2, 10)).astype(np.int64)
    ids[:, 7:] = 0
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids),
                  attention_mask=torch.from_numpy((ids > 0).astype(np.int64))).last_hidden_state.numpy()
        got, _ = ours(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_vit_feature_parity():
    from transformers import ViTConfig, ViTModel

    hf_cfg = ViTConfig(image_size=32, patch_size=8, hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
                       intermediate_size=96, hidden_act="gelu", hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0, layer_norm_eps=1e-6)
    torch.manual_seed(0)
    hf = ViTModel(hf_cfg, add_pooling_layer=False).eval()
    ours = ViT(ViTSpec(image_size=32, patch_size=8, dim=48, depth=2, num_heads=4, mlp_ratio=2.0), FP32, "cpu")
    H.load_encoder_params(_holder(image_encoder=ours), {"params": H.vit_params_from_hf(hf.state_dict())},
                          "image_encoder")
    imgs = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        want = hf(pixel_values=torch.from_numpy(imgs).permute(0, 3, 1, 2)).last_hidden_state.numpy()
        got = ours(torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def _torchvision_state_dict():
    """torchvision's naming over the JAX package's torch ResNet (no
    torchvision here), with random running statistics."""
    g = torch.Generator().manual_seed(0)
    sd = {}
    for k, v in TorchResNet(STAGE_SIZES["resnet_tiny"]).state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            v = torch.rand(v.shape, generator=g) + 0.5
        parts = k.split(".")
        if parts[0] in ("stem_conv", "stem_bn"):
            sd[f"{ {'stem_conv': 'conv1', 'stem_bn': 'bn1'}[parts[0]] }.{parts[1]}"] = v
        else:
            stage, block = parts[0].replace("stage", "").split("_block")
            mod = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(parts[1], parts[1])
            sd[f"layer{stage}.{block}.{mod}." + ".".join(parts[2:])] = v
    sd["fc.weight"] = torch.zeros(10, 512)  # the classifier, which the map drops
    return sd


def test_torchvision_map_matches_jax_and_loads():
    sd = _torchvision_state_dict()
    got, want = H.resnet_params_from_torchvision(sd), JH.resnet_params_from_torchvision(sd)
    for coll in ("params", "batch_stats"):
        g, w = flatten_params(got[coll]), flatten_params(want[coll])
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    model = build_model(get_config("tiny_test").model, device="cpu")
    H.load_encoder_params(model, got, "image_encoder")
    enc = model.image_encoder
    np.testing.assert_array_equal(enc.stem_conv.kernel.detach().numpy(),
                                  got["params"]["stem_conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(enc.stem_bn.var.numpy(), got["batch_stats"]["stem_bn"]["var"])


def test_loader_refuses_a_missing_leaf_and_a_wrong_shape():
    model = build_model(get_config("tiny_test").model, device="cpu")
    tree = H.resnet_params_from_torchvision(_torchvision_state_dict())
    del tree["params"]["stem_bn"]["scale"]
    with pytest.raises(KeyError, match="stem_bn.scale"):
        H.load_encoder_params(model, tree, "image_encoder")
    tree = H.resnet_params_from_torchvision(_torchvision_state_dict())
    tree["params"]["stem_bn"]["scale"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="stem_bn.scale"):
        H.load_encoder_params(model, tree, "image_encoder")
    with pytest.raises(KeyError, match="unmapped"):
        H.bert_params_from_hf({"encoder.layer.0.unknown.weight": torch.zeros(2)})
