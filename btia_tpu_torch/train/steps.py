"""Train and eval steps (the port of ``btia_tpu/train/steps.py``), on one
device or over a (data, model) mesh.

The optimizer is the reference's optax chain, rebuilt term by term:
``clip_by_global_norm`` (scale by max_norm / norm only when norm >= max_norm,
no epsilon; not ``torch.nn.utils.clip_grad_norm_``), then AdamW with weight
decay on every parameter under a warmup-cosine schedule whose learning rate
is 0 at step 0, with the encoders in their own group at
``encoder_lr_scale`` x the learning rate. ``torch.optim.AdamW`` computes the
same update as optax's ``adamw`` (bias-corrected moments, decoupled decay
lr * wd * p), so it carries the moments.

A train step's forward runs with ``train=True``, so a ResNet's BatchNorm
normalises with the batch statistics and updates its running averages (the
buffers ``mean`` and ``var``) in place, as the reference's step returns the
new ``batch_stats`` (``steps.py:164-192``); the K-step call does so at every
step. The ResNet's parameters are in the encoder group, and weight decay
covers every parameter, BatchNorm's scale and bias too, as optax's
``adamw`` does. The state dict, and so a checkpoint, carries the running
statistics beside the parameters.

A step's dropout masks come from a ``torch.Generator`` seeded from
(train.seed, step), the counterpart of ``fold_in(rng, step)``: a resumed run
draws the masks the uninterrupted run drew.

While a profiler runs, a train step marks its parts with spans on the
calling thread (``utils/profiling.py::span``), keyed by the step's number:
``btia.train.forward|<step>`` (the dropout generator, the forward and the
loss), ``btia.train.backward|<step>`` (``loss.backward()``, which waits
while autograd's device thread launches the backward) and
``btia.train.optimizer|<step>`` (clipping, the data group's all-reduce,
AdamW, clearing the gradients).

Under a mesh (``mesh=``, ``parallel.make_mesh``) each rank is handed its
own rows of the global batch (``parallel.shard_batch``) and holds its TP
shards (``create_state`` places them), and the step runs inside
``fused_mesh(mesh)``, as the reference's does (``steps.py:147-153``). The
update equals the one-device step on the global batch: the gradients are
averaged over the data group (one all-reduce of the flattened gradients),
the global norm adds the replicated leaves' squares, counted once, to the
model group's sum of the sharded leaves' squares, and a ResNet's
BatchNorm takes the global batch's statistics. The loss and accuracy are
the global batch's; eval steps return every row's predictions to every
rank. A state dict (so a checkpoint) holds the gathered, whole state, and
loading one under a mesh slices it again. Dropout masks are not the
reference's global ones: a data rank draws from a generator of (seed,
step, data index), and the model ranks of one data index draw the same
masks, their hidden shards included.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from btia_tpu_torch.configs.config import Config
from btia_tpu_torch.models.model import BTIAADNet
from btia_tpu_torch.ops.answers import argmax_real
from btia_tpu_torch.ops.fused_attn import fused_mesh
from btia_tpu_torch.parallel.collectives import all_reduce_, gather_rows
from btia_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from btia_tpu_torch.parallel.sharding import (
    gather_state_dict, gather_tensor, shard_batch, shard_params, shard_state_dict, shard_tensor, sharded_dim,
)
from btia_tpu_torch.utils.profiling import span

_ENCODERS = ("image_encoder", "question_encoder")


def warmup_cosine(peak: float, warmup_steps: int, decay_steps: int,
                  end_value: float) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup, decay, end)``."""
    alpha = 0.0 if peak == 0.0 else end_value / peak
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak * count / warmup_steps
        t = min(count - warmup_steps, cos_steps)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / cos_steps)) + alpha)

    return schedule


class Optimizer:
    """clip_by_global_norm -> AdamW, one schedule per parameter group."""

    def __init__(self, model: BTIAADNet, cfg: Config, steps_per_epoch: int,
                 mesh: Optional[Mesh] = None, specs: Optional[Dict[str, tuple]] = None):
        t = cfg.train
        total = max(steps_per_epoch * t.epochs, t.warmup_steps + 1)
        groups: Dict[str, List[Tuple[str, torch.nn.Parameter]]] = {"encoder": [], "rest": []}
        for name, p in model.named_parameters():
            enc = t.encoder_lr_scale != 1.0 and name.split(".", 1)[0] in _ENCODERS
            groups["encoder" if enc else "rest"].append((name, p))
        peaks = {"encoder": t.lr * t.encoder_lr_scale, "rest": t.lr}
        names = [g for g in ("encoder", "rest") if groups[g]]
        # The i-th entry of the AdamW state is the i-th of these.
        self.names = [n for g in names for n, _ in groups[g]]
        self.params = [p for g in names for _, p in groups[g]]
        self.mesh = mesh
        specs = specs or {}
        self.sharded = [sharded_dim(specs.get(n, ())) is not None for n in self.names]
        self.schedules = [warmup_cosine(peaks[g], t.warmup_steps, total, peaks[g] * 0.01)
                          for g in names]
        self.max_norm = t.grad_clip
        self.adamw = torch.optim.AdamW(
            [{"params": [p for _, p in groups[g]]} for g in names], lr=0.0, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=t.weight_decay,
        )
        self.count = 0

    def step(self) -> torch.Tensor:
        """Clip the gradients in ``.grad``, apply one update, clear them.
        Returns the global norm of the unclipped gradients."""
        for p in self.params:
            if p.grad is None:  # an unused parameter: optax sees a zero gradient
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        mesh = self.mesh
        dp, tp = (1, 1) if mesh is None else (mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS])
        if dp > 1:  # the data group's mean, through one flat buffer
            flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), DATA_AXIS, mesh).div_(dp)
            torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)])
        if tp > 1:  # replicated leaves once, plus the model group's sharded ones
            sq = torch.stack(torch._foreach_norm(grads)).square()
            mask = torch.tensor(self.sharded, device=sq.device)
            sharded_sq = all_reduce_(sq[mask].sum().reshape(1), MODEL_AXIS, mesh)[0]
            norm = torch.sqrt(sq[~mask].sum() + sharded_sq)
        else:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
        torch._foreach_mul_(grads, scale)
        for group, schedule in zip(self.adamw.param_groups, self.schedules):
            group["lr"] = schedule(self.count)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])

    def map_moments(self, state: dict, fn) -> dict:
        """A state dict with fn(parameter name, tensor) applied to each
        AdamW moment (the per-parameter state tensors other than its step)."""
        adamw = dict(state["adamw"])
        adamw["state"] = {i: {k: fn(self.names[i], v) if k in ("exp_avg", "exp_avg_sq") else v
                              for k, v in st.items()} for i, st in adamw["state"].items()}
        return {**state, "adamw": adamw}


@dataclasses.dataclass
class TrainState:
    """The port's counterpart of the reference's TrainState. The model and
    optimizer are updated in place; ``step`` counts optimizer steps."""

    step: int
    model: BTIAADNet
    optimizer: Optimizer
    seed: int
    mesh: Optional[Mesh] = None
    specs: Optional[Dict[str, tuple]] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _tp(self) -> bool:
        return self.mesh is not None and self.mesh.shape[MODEL_AXIS] > 1

    def state_dict(self) -> dict:
        """The whole state: under a model axis the shards are gathered
        (collective: every rank of the mesh calls it)."""
        params, opt = self.model.state_dict(), self.optimizer.state_dict()
        if self._tp():
            params = gather_state_dict(params, self.specs, self.mesh)
            opt = self.optimizer.map_moments(
                opt, lambda n, t: gather_tensor(t, self.specs[n], self.mesh))
        return {"step": self.step, "seed": self.seed, "params": params, "opt_state": opt}

    def load_state_dict(self, state: dict) -> None:
        """Load a whole state, sliced to this rank's shards under a model axis."""
        self.step = int(state["step"])
        self.seed = int(state["seed"])
        params, opt = state["params"], state["opt_state"]
        if self._tp():
            params = shard_state_dict(params, self.specs, self.mesh)
            opt = self.optimizer.map_moments(
                opt, lambda n, t: shard_tensor(t, self.specs[n], self.mesh, n).clone())
        self.model.load_state_dict(params)
        self.optimizer.load_state_dict(opt)


def create_state(model: BTIAADNet, cfg: Config, steps_per_epoch: int = 100,
                 seed: Optional[int] = None, mesh: Optional[Mesh] = None) -> TrainState:
    """The train state of `model`; under a mesh its TP parameters are first
    sliced to this rank's shards (every rank builds the model from the same
    seed, so the shards are the whole model's)."""
    specs = shard_params(model, mesh) if mesh is not None else None
    return TrainState(
        step=0, model=model, optimizer=Optimizer(model, cfg, steps_per_epoch, mesh, specs),
        seed=cfg.train.seed if seed is None else seed, mesh=mesh, specs=specs,
    )


def dropout_generator(seed: int, step: int, device, stream: int = 0) -> torch.Generator:
    """The generator of one step's dropout masks: a function of (seed, step)
    only, as ``fold_in(rng, step)`` is; a data rank's `stream` (its data
    index, above 0) gives it masks of its own."""
    words = [seed, step] if stream == 0 else [seed, step, stream]
    hi, lo = (int(w) for w in np.random.SeedSequence(words).generate_state(2))
    return torch.Generator(device=device).manual_seed((hi & 0x7FFFFFFF) << 32 | lo)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: Optional[torch.Tensor] = None,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    num_classes = logits.shape[-1]
    onehot = torch.nn.functional.one_hot(labels.long(), num_classes).to(logits.dtype)
    if label_smoothing:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / num_classes
    losses = -(onehot * torch.log_softmax(logits, dim=-1)).sum(-1)
    if valid is not None:
        w = valid.to(losses.dtype)
        return (losses * w).sum() / torch.clamp_min(w.sum(), 1.0)
    return losses.mean()


def _data_mean(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A scalar's mean over the data group (each rank's of equal rows)."""
    if mesh is None or mesh.shape[DATA_AXIS] == 1:
        return t
    return all_reduce_(t.detach().float().reshape(1).clone(), DATA_AXIS, mesh)[0] / mesh.shape[DATA_AXIS]


def make_train_step(model: BTIAADNet, cfg: Config,
                    mesh: Optional[Mesh] = None) -> Callable[[TrainState, dict], Tuple[TrainState, dict]]:
    """One optimizer step on a batch dict of tensors on the model's device
    (``batch_to_device``; under a mesh, this rank's rows of it). Returns the
    state and {loss, accuracy, grad_norm} as 0-d tensors on the device, the
    global batch's under a mesh."""
    ls = cfg.train.label_smoothing
    stream = 0 if mesh is None or mesh.shape[DATA_AXIS] == 1 else mesh.index(DATA_AXIS) + 1

    def step(state: TrainState, batch: dict) -> Tuple[TrainState, dict]:
        n = state.step
        with fused_mesh(mesh):
            with span("btia.train.forward", n):
                gen = dropout_generator(state.seed, n, state.device, stream)
                logits = model(batch["images"], batch["question_ids"], train=True, generator=gen)
                labels = batch["answer_ids"]
                loss = cross_entropy(logits, labels, label_smoothing=ls)
            with span("btia.train.backward", n):
                loss.backward()
        with span("btia.train.optimizer", n):
            gnorm = state.optimizer.step()
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        state.step += 1
        return state, {"loss": _data_mean(loss.detach(), mesh), "accuracy": _data_mean(acc, mesh),
                       "grad_norm": gnorm}

    return step


def make_train_step_scan(model: BTIAADNet, cfg: Config,
                         mesh: Optional[Mesh] = None) -> Callable[[TrainState, dict], Tuple[TrainState, dict]]:
    """K optimizer steps per call on a chunk dict of (K, B, ...) tensors, the
    counterpart of the reference's ``lax.scan`` chunk: the same as K
    sequential ``make_train_step`` calls. Metrics are stacked (K,)."""
    step = make_train_step(model, cfg, mesh)

    def multi(state: TrainState, chunk: dict) -> Tuple[TrainState, dict]:
        rows = []
        for i in range(chunk["images"].shape[0]):
            state, m = step(state, {k: v[i] for k, v in chunk.items()})
            rows.append(m)
        return state, {k: torch.stack([m[k] for m in rows]) for k in rows[0]}

    return multi


def make_eval_step(model: BTIAADNet, cfg: Config, vocab_size: int = 0,
                   mesh: Optional[Mesh] = None) -> Callable[[TrainState, dict], dict]:
    """Predictions and correctness of a batch dict. Under a mesh it takes the
    global batch, splits its rows over 'data', and returns every row's
    results to every rank, so that the metrics are the data group's sums."""
    limit = vocab_size or cfg.model.answer_vocab_size

    @torch.no_grad()
    def step(state: TrainState, batch: dict) -> dict:
        if mesh is not None and mesh.shape[DATA_AXIS] > 1:
            return {k: gather_rows(v, mesh) for k, v in rows(shard_batch(batch, mesh)).items()}
        return rows(batch)

    def rows(batch: dict) -> dict:
        with fused_mesh(mesh):
            logits = model(batch["images"], batch["question_ids"], train=False)
        # Index 0 (<unk>) is never a prediction, and an out-of-vocabulary
        # reference (answer id 0) is never correct (``steps.py:239-248``).
        preds = argmax_real(logits, limit)
        answerable = batch["answer_ids"] != 0
        correct = (preds == batch["answer_ids"]) & answerable & batch["valid"]
        return {"preds": preds, "correct": correct}

    return step
