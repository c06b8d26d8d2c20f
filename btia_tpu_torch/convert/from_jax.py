"""Weight bridge: the JAX package's flax ``variables`` tree (``params`` and,
for a ResNet, ``batch_stats``) onto the port's module tree.

The port keeps the flax scope names and layouts: Dense ``kernel`` (in, out)
and ``bias``; ``nn.Embed`` ``embedding`` (vocab, dim); LayerNorm and
BatchNorm ``scale`` and ``bias``; the LSTM's ``hh_kernel`` (H, 4H) and
``hh_bias``; the ViT ``cls_token`` (1, 1, D) and ``pos_embed`` (1, N, D);
the head's ``answer_queries`` / ``answer_table`` / ``answer_weights`` (rows,
D) and ``answer_bias``. So the bridge joins each flax path with dots and
copies, with one rule that transposes: a 4-D conv ``kernel``, flax's HWIO
(kh, kw, in, out), becomes PyTorch's OIHW (out, in, kh, kw). ``batch_stats``
``mean`` and ``var`` go onto the BatchNorm buffers of the same path. Any key
missing on either side, or any shape that differs, raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def flatten_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """{"a": {"b": x}} -> {"a.b": np.asarray(x)}."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, path + "."))
        else:
            flat[path] = np.asarray(value)
    return flat


def _port_layout(name: str, a: np.ndarray) -> np.ndarray:
    """A flax array in the port's layout: HWIO conv kernels to OIHW."""
    if name.rsplit(".", 1)[-1] == "kernel" and a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    return a


@torch.no_grad()
def _copy(own: Dict[str, torch.Tensor], tree: Mapping, what: str) -> None:
    flat = flatten_params(tree)
    missing = sorted(set(own) - set(flat))
    unexpected = sorted(set(flat) - set(own))
    if missing or unexpected:
        raise KeyError(f"weight bridge ({what}): missing {missing}, unexpected {unexpected}")
    for name, t in own.items():
        src = _port_layout(name, flat[name])
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"weight bridge: {name} has shape {src.shape}, expected {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))


def load_jax_params(model: nn.Module, params: Mapping) -> None:
    """Copy a flax params tree (arrays convertible with ``np.asarray``) into
    `model`, which must have exactly the same parameters."""
    _copy(dict(model.named_parameters()), params, "params")


def load_jax_variables(model: nn.Module, variables: Mapping) -> None:
    """Copy a whole flax ``variables`` dict into `model`: ``params`` onto its
    parameters and ``batch_stats`` (absent or empty without a ResNet) onto
    its BatchNorm buffers, every buffer covered."""
    load_jax_params(model, variables["params"])
    _copy(dict(model.named_buffers()), variables.get("batch_stats", {}), "batch_stats")
