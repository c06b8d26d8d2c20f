"""Reference-PyTorch checkpoint -> the port's model (the port of
``btia_tpu/convert/convert.py``).

Structure-driven: the port's parameter and buffer names are the flax scope
paths joined with dots (``convert/from_jax.py``), so each is split at its
dots and the torch key derived from that path by the reference's rule.
Unexpected reference renames surface as missing-key errors, and the
``NAME_OVERRIDES`` table absorbs them without code changes.

Transforms, into the port's layouts:
    Dense   kernel (in, out)        <- torch Linear weight (out, in).T
    Conv    kernel (out, in, kh, kw) <- torch Conv2d weight, as it is
    BatchNorm scale/bias            <- weight/bias; buffers mean/var <- running_*
    LayerNorm scale/bias            <- weight/bias
    Embed   embedding               <- Embedding weight
    everything else                 <- same-named Parameter, same layout
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# torch-name overrides: flax path (the port's name with '/' for '.') ->
# torch key. Empty until real reference checkpoints reveal their naming.
NAME_OVERRIDES: Dict[str, str] = {}


def _torch_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """flax param path -> (torch key, transform kind)."""
    parts = [p for p in path if p != "LayerNorm_0"]
    leaf = parts[-1]
    base = ".".join(parts[:-1])
    joined = "/".join(path)
    if joined in NAME_OVERRIDES:
        # Only the name changes; the leaf kind keeps its layout transform.
        return NAME_OVERRIDES[joined], "kernel" if leaf == "kernel" else "direct"

    if leaf == "kernel":
        return f"{base}.weight", "kernel"
    if leaf == "scale":
        return f"{base}.weight", "direct"
    if leaf == "bias":
        return f"{base}.bias", "direct"
    if leaf == "embedding":
        return f"{base}.weight", "direct"
    if leaf == "mean":
        return f"{base}.running_mean", "direct"
    if leaf == "var":
        return f"{base}.running_var", "direct"
    # raw Parameters (cls_token, pos_embed, hh_kernel, answer_queries, ...)
    return f"{base}.{leaf}" if base else leaf, "direct"


def _transform(kind: str, value: np.ndarray, target_shape) -> np.ndarray:
    if kind == "kernel" and value.ndim == 2:  # Linear (out, in) -> (in, out)
        value = value.T
    # A conv kernel is OIHW on both sides.
    if tuple(value.shape) != tuple(target_shape):
        raise ValueError(
            f"shape mismatch after transform: torch {value.shape} vs port {tuple(target_shape)}"
        )
    return value


@torch.no_grad()
def convert_state_dict(state_dict: Mapping[str, Any], model: nn.Module) -> nn.Module:
    """Load a reference-PyTorch state_dict into the port's `model`: every
    parameter and buffer (BatchNorm running statistics) filled, every torch
    entry used (``num_batches_tracked`` aside). Checks every entry before it
    writes any. Returns `model`."""
    sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
          for k, v in state_dict.items()}
    targets = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    used, values = set(), {}
    for name, t in targets.items():
        path = tuple(name.split("."))
        key, kind = _torch_key(path)
        if key not in sd:
            raise KeyError(
                f"torch state_dict missing {key!r} (for flax {'/'.join(path)}); add a "
                f"NAME_OVERRIDES entry if the reference names this differently"
            )
        values[name] = _transform(kind, sd[key], t.shape)
        used.add(key)
    leftovers = {k for k in sd if k not in used and not k.endswith("num_batches_tracked")}
    if leftovers:
        raise ValueError(f"unconverted torch parameters: {sorted(leftovers)[:10]}")
    for name, t in targets.items():
        t.copy_(torch.from_numpy(np.ascontiguousarray(values[name])).to(t.dtype))
    return model


def port_params_from_torch(torch_model: nn.Module, model: nn.Module) -> nn.Module:
    return convert_state_dict(torch_model.state_dict(), model)


@torch.no_grad()
def verify_parity(torch_model: nn.Module, port_model: nn.Module, images_u8: np.ndarray,
                  question_ids: np.ndarray, atol: float = 2e-4) -> float:
    """Forward both models on the same probes (deterministic forward) and
    return max |delta logit|, raising if it is above `atol` (the reference's
    gate: below 2e-4 across the three model families). The port model must
    run the fp32 policy (``model.mixed_precision=False``): bf16 cannot meet
    a logit-level tolerance. It runs where it lives; the tests keep both on
    the CPU."""
    if port_model.policy.compute_dtype != torch.float32:
        raise ValueError("verify_parity needs the port model under the fp32 policy")
    qids = torch.from_numpy(question_ids.astype(np.int64))
    t_logits = torch_model(torch.from_numpy(images_u8), qids).numpy()
    dev = next(port_model.parameters()).device
    p_logits = port_model(torch.from_numpy(images_u8).to(dev), qids.to(dev), train=False).cpu().numpy()
    err = float(np.abs(t_logits - p_logits).max())
    if err > atol:
        raise AssertionError(f"logit parity failure: max|delta|={err:.2e} > atol={atol:.0e}")
    return err
