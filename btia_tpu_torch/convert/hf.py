"""Pretrained-encoder weight maps: HF BERT / ViT and torchvision ResNet ->
the port's encoders (the port of ``btia_tpu/convert/hf.py``).

The three maps return the reference's numpy trees, flax scope names and
layouts (a Dense ``kernel`` (in, out), a conv ``kernel`` HWIO), so a tree
made for the JAX package loads here unchanged. ``load_encoder_params`` puts
such a subtree into the matching encoder of a port model through the weight
bridge's name map (``convert/from_jax.py``), which turns conv kernels to
OIHW. No pretrained weights ship with the repository; the maps are held on
randomly initialised ``transformers`` models (``tests/test_torch_hf.py``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
from torch import nn

from btia_tpu_torch.convert.from_jax import _copy


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _set(tree: Dict, path: str, value: np.ndarray) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def bert_params_from_hf(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """HF BertModel state_dict → BertQuestionEncoder params subtree."""
    out: Dict[str, Any] = {}
    for key, t in state_dict.items():
        v = _np(t)
        if key.startswith("pooler."):
            continue
        if key == "embeddings.word_embeddings.weight":
            _set(out, "word_embed/embedding", v)
        elif key == "embeddings.position_embeddings.weight":
            _set(out, "pos_embed/embedding", v)
        elif key == "embeddings.token_type_embeddings.weight":
            _set(out, "type_embed/embedding", v)
        elif key == "embeddings.LayerNorm.weight":
            _set(out, "ln_embed/scale", v)
        elif key == "embeddings.LayerNorm.bias":
            _set(out, "ln_embed/bias", v)
        else:
            m = re.match(r"encoder\.layer\.(\d+)\.(.*)", key)
            if not m:
                raise KeyError(f"unmapped HF BERT key {key!r}")
            i, rest = m.group(1), m.group(2)
            prefix = f"layer{i}"
            table = {
                "attention.self.query": "attn/q_proj",
                "attention.self.key": "attn/k_proj",
                "attention.self.value": "attn/v_proj",
                "attention.output.dense": "attn/o_proj",
                "intermediate.dense": "mlp/fc1",
                "output.dense": "mlp/fc2",
            }
            ln_table = {
                "attention.output.LayerNorm": "ln_attn",
                "output.LayerNorm": "ln_mlp",
            }
            mapped = False
            for hf, ours in table.items():
                if rest == f"{hf}.weight":
                    _set(out, f"{prefix}/{ours}/kernel", v.T)
                    mapped = True
                elif rest == f"{hf}.bias":
                    _set(out, f"{prefix}/{ours}/bias", v)
                    mapped = True
            for hf, ours in ln_table.items():
                if rest == f"{hf}.weight":
                    _set(out, f"{prefix}/{ours}/scale", v)
                    mapped = True
                elif rest == f"{hf}.bias":
                    _set(out, f"{prefix}/{ours}/bias", v)
                    mapped = True
            if not mapped:
                raise KeyError(f"unmapped HF BERT key {key!r}")
    return out


def vit_params_from_hf(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """HF ViTModel state_dict → ViT params subtree."""
    out: Dict[str, Any] = {}
    for key, t in state_dict.items():
        v = _np(t)
        if key == "embeddings.cls_token":
            _set(out, "cls_token", v)
        elif key == "embeddings.position_embeddings":
            _set(out, "pos_embed", v)
        elif key == "embeddings.patch_embeddings.projection.weight":
            # Conv (D, C, P, P) → Dense kernel (P*P*C, D) matching the
            # (ph, pw, c)-ordered patchify reshape in models/vit.py.
            D = v.shape[0]
            _set(out, "patch_embed/kernel", v.transpose(2, 3, 1, 0).reshape(-1, D))
        elif key == "embeddings.patch_embeddings.projection.bias":
            _set(out, "patch_embed/bias", v)
        elif key == "layernorm.weight":
            _set(out, "ln_final/scale", v)
        elif key == "layernorm.bias":
            _set(out, "ln_final/bias", v)
        else:
            m = re.match(r"encoder\.layer\.(\d+)\.(.*)", key)
            if not m:
                raise KeyError(f"unmapped HF ViT key {key!r}")
            i, rest = m.group(1), m.group(2)
            prefix = f"block{i}"
            table = {
                "attention.attention.query": "attn/q_proj",
                "attention.attention.key": "attn/k_proj",
                "attention.attention.value": "attn/v_proj",
                "attention.output.dense": "attn/o_proj",
                "intermediate.dense": "mlp/fc1",
                "output.dense": "mlp/fc2",
            }
            ln_table = {
                "layernorm_before": "ln1",
                "layernorm_after": "ln2",
            }
            mapped = False
            for hf, ours in table.items():
                if rest == f"{hf}.weight":
                    _set(out, f"{prefix}/{ours}/kernel", v.T)
                    mapped = True
                elif rest == f"{hf}.bias":
                    _set(out, f"{prefix}/{ours}/bias", v)
                    mapped = True
            for hf, ours in ln_table.items():
                if rest == f"{hf}.weight":
                    _set(out, f"{prefix}/{ours}/scale", v)
                    mapped = True
                elif rest == f"{hf}.bias":
                    _set(out, f"{prefix}/{ours}/bias", v)
                    mapped = True
            if not mapped:
                raise KeyError(f"unmapped HF ViT key {key!r}")
    return out


def resnet_params_from_torchvision(
    state_dict: Mapping[str, Any],
) -> Dict[str, Dict[str, Any]]:
    """torchvision resnet50 state_dict → (params, batch_stats) subtrees."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def conv(path, v):
        _set(params, f"{path}/kernel", _np(v).transpose(2, 3, 1, 0))

    def bn(path, key, v):
        v = _np(v)
        if key == "weight":
            _set(params, f"{path}/scale", v)
        elif key == "bias":
            _set(params, f"{path}/bias", v)
        elif key == "running_mean":
            _set(stats, f"{path}/mean", v)
        elif key == "running_var":
            _set(stats, f"{path}/var", v)

    for key, t in state_dict.items():
        if key.startswith("fc."):
            continue  # classifier head not used — feature extractor [B:7]
        if key.endswith("num_batches_tracked"):
            continue
        if key.startswith("conv1."):
            conv("stem_conv", t)
        elif key.startswith("bn1."):
            bn("stem_bn", key.split(".", 1)[1], t)
        else:
            m = re.match(
                r"layer(\d+)\.(\d+)\.(conv\d|bn\d|downsample\.\d)\.(.*)", key
            )
            if not m:
                raise KeyError(f"unmapped torchvision key {key!r}")
            stage, block, mod, leaf = m.groups()
            base = f"stage{stage}_block{block}"
            if mod.startswith("conv"):
                conv(f"{base}/{mod}", t)
            elif mod.startswith("bn"):
                bn(f"{base}/{mod}", leaf, t)
            elif mod == "downsample.0":
                conv(f"{base}/downsample_conv", t)
            elif mod == "downsample.1":
                bn(f"{base}/downsample_bn", leaf, t)
    return {"params": params, "batch_stats": stats}


def load_encoder_params(model: nn.Module, subtree: Mapping, scope: str) -> nn.Module:
    """Load an encoder subtree (one of the maps' outputs) into
    ``model.<scope>`` (``image_encoder`` or ``question_encoder``): a bare
    params tree, or ``{"params": ..., "batch_stats": ...}``, whose
    ``batch_stats`` fill the BatchNorm buffers. Leaf by leaf: a missing or
    extra name raises ``KeyError``, a shape that differs ``ValueError``.
    Returns `model`."""
    encoder = getattr(model, scope)
    params = subtree["params"] if "params" in subtree else subtree
    _copy(dict(encoder.named_parameters()), params, f"encoder subtree {scope}")
    if "batch_stats" in subtree:
        _copy(dict(encoder.named_buffers()), subtree["batch_stats"], f"encoder subtree {scope} batch_stats")
    return model
