"""Train and eval steps (the port of ``btia_tpu/train/steps.py``), on one
device.

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
draws the masks the uninterrupted run drew. The mesh (data / model
parallelism) is not ported yet.
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

    def __init__(self, model: BTIAADNet, cfg: Config, steps_per_epoch: int):
        t = cfg.train
        total = max(steps_per_epoch * t.epochs, t.warmup_steps + 1)
        groups: Dict[str, List[torch.nn.Parameter]] = {"encoder": [], "rest": []}
        for name, p in model.named_parameters():
            enc = t.encoder_lr_scale != 1.0 and name.split(".", 1)[0] in _ENCODERS
            groups["encoder" if enc else "rest"].append(p)
        peaks = {"encoder": t.lr * t.encoder_lr_scale, "rest": t.lr}
        names = [g for g in ("encoder", "rest") if groups[g]]
        self.params = [p for g in names for p in groups[g]]
        self.schedules = [warmup_cosine(peaks[g], t.warmup_steps, total, peaks[g] * 0.01)
                          for g in names]
        self.max_norm = t.grad_clip
        self.adamw = torch.optim.AdamW(
            [{"params": groups[g]} for g in names], lr=0.0, betas=(0.9, 0.999),
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


@dataclasses.dataclass
class TrainState:
    """The port's counterpart of the reference's TrainState. The model and
    optimizer are updated in place; ``step`` counts optimizer steps."""

    step: int
    model: BTIAADNet
    optimizer: Optimizer
    seed: int

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed, "params": self.model.state_dict(),
                "opt_state": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.seed = int(state["seed"])
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])


def create_state(model: BTIAADNet, cfg: Config, steps_per_epoch: int = 100,
                 seed: Optional[int] = None) -> TrainState:
    return TrainState(
        step=0, model=model, optimizer=Optimizer(model, cfg, steps_per_epoch),
        seed=cfg.train.seed if seed is None else seed,
    )


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's dropout masks: a function of (seed, step)
    only, as ``fold_in(rng, step)`` is."""
    hi, lo = (int(w) for w in np.random.SeedSequence([seed, step]).generate_state(2))
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


def make_train_step(model: BTIAADNet, cfg: Config) -> Callable[[TrainState, dict], Tuple[TrainState, dict]]:
    """One optimizer step on a batch dict of tensors on the model's device
    (``batch_to_device``). Returns the state and {loss, accuracy, grad_norm}
    as 0-d tensors on the device."""
    ls = cfg.train.label_smoothing

    def step(state: TrainState, batch: dict) -> Tuple[TrainState, dict]:
        gen = dropout_generator(state.seed, state.step, state.device)
        logits = model(batch["images"], batch["question_ids"], train=True, generator=gen)
        labels = batch["answer_ids"]
        loss = cross_entropy(logits, labels, label_smoothing=ls)
        loss.backward()
        gnorm = state.optimizer.step()
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        state.step += 1
        return state, {"loss": loss.detach(), "accuracy": acc, "grad_norm": gnorm}

    return step


def make_train_step_scan(model: BTIAADNet, cfg: Config) -> Callable[[TrainState, dict], Tuple[TrainState, dict]]:
    """K optimizer steps per call on a chunk dict of (K, B, ...) tensors, the
    counterpart of the reference's ``lax.scan`` chunk: the same as K
    sequential ``make_train_step`` calls. Metrics are stacked (K,)."""
    step = make_train_step(model, cfg)

    def multi(state: TrainState, chunk: dict) -> Tuple[TrainState, dict]:
        rows = []
        for i in range(chunk["images"].shape[0]):
            state, m = step(state, {k: v[i] for k, v in chunk.items()})
            rows.append(m)
        return state, {k: torch.stack([m[k] for m in rows]) for k in rows[0]}

    return multi


def make_eval_step(model: BTIAADNet, cfg: Config, vocab_size: int = 0) -> Callable[[TrainState, dict], dict]:
    limit = vocab_size or cfg.model.answer_vocab_size

    @torch.no_grad()
    def step(state: TrainState, batch: dict) -> dict:
        logits = model(batch["images"], batch["question_ids"], train=False)
        # Index 0 (<unk>) is never a prediction, and an out-of-vocabulary
        # reference (answer id 0) is never correct (``steps.py:239-248``).
        preds = argmax_real(logits, limit)
        answerable = batch["answer_ids"] != 0
        correct = (preds == batch["answer_ids"]) & answerable & batch["valid"]
        return {"preds": preds, "correct": correct}

    return step
