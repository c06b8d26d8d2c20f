"""Rule-based parameter and batch sharding (the port of
``btia_tpu/parallel/sharding.py``).

Parameters are mapped to specs by regex rules over their dotted names, in
one auditable place. A spec is a tuple with one entry per dim, the mesh axis
that dim is split over or None; ``()`` is replicated, as ``P()`` is.

TP layout (Megatron's column -> row pairing, one all-reduce per block). The
port's ``Dense.kernel`` is (in, out), as flax's, so the specs keep the
reference's dims:
  - attention q/k/v kernels and biases: the output (head) dim over 'model'
  - attention output kernel:            the input (head) dim; bias whole
  - MLP fc1 kernel and bias:            the output (hidden) dim
  - MLP fc2 kernel:                     the input (hidden) dim; bias whole
Everything else (LayerNorms, embeddings, convolutions, the answer tables,
BatchNorm's statistics) is replicated.

One leaf differs from the reference: the mlp answer head's ``head.fc1``
matches the fc1 rule, but no fc2 follows it (its output goes whole into
``fc_out``). The reference shards it and XLA gathers the output; here the
leaf stays whole.

Each rank of the mesh holds its own shards: ``shard_params`` slices them in
place and ``gather_state_dict`` joins them into the full state dict again.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from btia_tpu_torch.parallel.collectives import gather_dim
from btia_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

Spec = Tuple[Any, ...]

# (name regex, spec per ndim) — first match wins.
_TP_RULES = [
    (r"(q_proj|k_proj|v_proj|qkv)\.(kernel|bias)$", {2: (None, MODEL_AXIS), 1: (MODEL_AXIS,)}),
    (r"(o_proj|out_proj)\.kernel$", {2: (MODEL_AXIS, None)}),
    (r"fc1\.(kernel|bias)$", {2: (None, MODEL_AXIS), 1: (MODEL_AXIS,)}),
    (r"fc2\.kernel$", {2: (MODEL_AXIS, None)}),
]

# Leaves a rule matches that stay whole (see the module docstring).
_KEEP_WHOLE = (r"^head\.fc1\.",)


def spec_for(name: str, ndim: int, model_parallel: bool) -> Spec:
    if model_parallel and not any(re.search(p, name) for p in _KEEP_WHOLE):
        for pattern, by_rank in _TP_RULES:
            if re.search(pattern, name) and ndim in by_rank:
                return by_rank[ndim]
    return ()


def _state(model_or_state) -> Mapping[str, torch.Tensor]:
    return model_or_state.state_dict() if isinstance(model_or_state, nn.Module) else model_or_state


def param_shardings(model_or_state, mesh: Mesh, model_parallel: bool = False) -> Dict[str, Spec]:
    """The spec of every entry of a model's state dict (or of a state dict)."""
    return {name: spec_for(name, t.ndim, model_parallel) for name, t in _state(model_or_state).items()}


def sharded_dim(spec: Spec):
    """The dim a spec splits over 'model', or None."""
    return next((d for d, a in enumerate(spec) if a == MODEL_AXIS), None)


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh, name: str = "") -> torch.Tensor:
    """This rank's block of `t` under `spec` (a view; `t` when replicated)."""
    dim = sharded_dim(spec)
    tp = mesh.shape[MODEL_AXIS]
    if dim is None or tp == 1:
        return t
    if t.shape[dim] % tp:
        raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does not divide over model={tp}")
    size = t.shape[dim] // tp
    return t.narrow(dim, mesh.index(MODEL_AXIS) * size, size)


def _check_heads(model: nn.Module, tp: int) -> None:
    for name, mod in model.named_modules():
        heads = getattr(mod, "num_heads", None)
        if heads is not None and heads % tp:
            raise ValueError(f"{name or 'model'}: {heads} attention heads do not divide over model={tp}")


@torch.no_grad()
def shard_params(model: nn.Module, mesh: Mesh) -> Dict[str, Spec]:
    """Replace each TP parameter of `model` by this rank's shard, in place
    (the Parameter objects stay, their data shrinks). A model axis of 1, or
    a model this rank already sharded for the same axis, changes nothing.
    Returns the specs. Raises ValueError where the model axis does not
    divide a sharded width or a module's heads."""
    tp = mesh.shape[MODEL_AXIS]
    specs = param_shardings(model, mesh, tp > 1)
    placed = (tp, mesh.index(MODEL_AXIS))
    if tp == 1 or getattr(model, "_tp_shard", None) == placed:
        return specs
    if getattr(model, "_tp_shard", None) is not None:
        raise ValueError(f"model already holds the shard {model._tp_shard} of another model axis")
    _check_heads(model, tp)
    for name, p in model.named_parameters():
        if sharded_dim(specs[name]) is not None:
            p.data = shard_tensor(p.data, specs[name], mesh, name).clone()
    model._tp_shard = placed
    return specs


def shard_state_dict(state: Mapping[str, torch.Tensor], specs: Mapping[str, Spec],
                     mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's blocks of a full state dict."""
    return {k: shard_tensor(v, specs.get(k, ()), mesh, k) if isinstance(v, torch.Tensor) else v
            for k, v in state.items()}


def gather_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The full tensor from each model rank's block (collective over the
    model group)."""
    dim = sharded_dim(spec)
    if dim is None or mesh.shape[MODEL_AXIS] == 1:
        return t
    return gather_dim(t.contiguous(), MODEL_AXIS, mesh, dim)


def gather_state_dict(state: Mapping[str, torch.Tensor], specs: Mapping[str, Spec],
                      mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_state_dict``: the full state dict on every
    rank of the model group (collective: every rank calls it)."""
    return {k: gather_tensor(v, specs.get(k, ()), mesh) if isinstance(v, torch.Tensor) else v
            for k, v in state.items()}


def replicated(mesh: Mesh) -> Spec:
    return ()


def batch_sharding(mesh: Mesh) -> Spec:
    """Leading (batch) dim over 'data'."""
    return (DATA_AXIS,)


def _rows(x, mesh: Mesh, dim: int):
    dp = mesh.shape[DATA_AXIS]
    if dp == 1:
        return x
    n = x.shape[dim]
    if n % dp:
        raise ValueError(f"batch dim {dim} of size {n} does not divide over data={dp}")
    size = n // dp
    i = mesh.index(DATA_AXIS)
    if isinstance(x, np.ndarray):
        return np.take(x, np.arange(i * size, (i + 1) * size), axis=dim)
    return x.narrow(dim, i * size, size)


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of a global batch (a tensor or array, or a dict /
    list of them): the leading dim split over 'data' in rank order. Every
    rank of a data-parallel run builds the same global batch and keeps its
    own rows; model ranks of one data index keep the same rows."""
    return _tree_map(lambda x: _rows(x, mesh, 0), batch)


def shard_batch_local(local_batch: Any, mesh: Mesh) -> Any:
    """A batch whose rows are already this rank's (each process read its own
    share): returned as it is; the global batch is the data group's blocks
    in rank order."""
    return local_batch


def shard_chunk(chunk: Any, mesh: Mesh) -> Any:
    """This rank's rows of a stacked (K, B, ...) chunk for the K-step call:
    the K dim whole, B over 'data'."""
    return _tree_map(lambda x: _rows(x, mesh, 1), chunk)
