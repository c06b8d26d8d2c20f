"""Plain float32 reference of the configurations' training step: the
forward of ``model.py`` with train-time dropout, softmax cross-entropy
(label smoothing as configured) averaged over the batch, the gradients by
autograd, clipping by the global norm (scale max_norm / norm only when
norm >= max_norm), then AdamW (bias-corrected moments, decoupled weight
decay lr * wd * p) with the encoders at ``encoder_lr_scale`` times the
learning rate under a linear warmup from 0 and a cosine decay.

Dropout keeps each element with probability 1 - rate and scales it by
1 / (1 - rate). Its masks are drawn as the configuration's program draws
them, so that the two runs drop the same elements: one ``torch.Generator``
a step, seeded from (train seed, step) through numpy's ``SeedSequence``,
one bf16 mask of each dropped tensor's shape a site, in the order of the
forward: the ViT blocks' FFN hidden, BERT's embedding output and then, a
layer, its attention and FFN outputs, BTIA's attention outputs (image, then
question) and FFN outputs (image, then question) a layer, the head's FFN
hidden. The batch runs in blocks of rows, each with its rows of the masks.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import model as M

ENCODERS = ("image_encoder.", "question_encoder.")


def dropout_seed(seed: int, step: int, stream: int = 0) -> int:
    """The seed of one step's masks; a data-parallel rank's `stream` (its
    data index + 1) gives it masks of its own."""
    words = [seed, step] if stream == 0 else [seed, step, stream]
    hi, lo = (int(w) for w in np.random.SeedSequence(words).generate_state(2))
    return (hi & 0x7FFFFFFF) << 32 | lo


def mask_shapes(m: dict, B: int) -> List[tuple]:
    """The shapes of one step's dropout masks, in the order they are drawn."""
    size, p, dv, depth, _ = M.VIT[m["image_encoder"]]
    n_img = (size // p) ** 2 + 1
    gt = m.get("image_pool_grid", 0)
    n_fused = gt * gt + 1 if gt and size // p > gt else n_img
    S, dt, h = m["max_question_len"], m["bert_hidden"], m["hidden_dim"]
    shapes = [(B, n_img, 4 * dv)] * depth
    shapes += [(B, S, dt)] + [(B, S, dt)] * (2 * m["bert_layers"])
    shapes += [(B, n_fused, h), (B, S, h), (B, n_fused, h), (B, S, h)] * m["btia_layers"]
    shapes += [(B, m["num_answer_queries"] or m["answer_vocab_size"], 2 * h)]
    return shapes


def draw_masks(m: dict, B: int, seed: int, step: int, device, ranks: int = 1) -> List[torch.Tensor]:
    """One step's masks for a batch of B rows; over `ranks` data-parallel
    ranks each draws its own B / ranks rows, in rank order."""
    keep = 1.0 - m["dropout"]
    per_rank = []
    for r in range(ranks):
        g = torch.Generator(device=device)
        g.manual_seed(dropout_seed(seed, step, 0 if ranks == 1 else r + 1))
        per_rank.append([torch.empty(s, dtype=torch.bfloat16, device=device).bernoulli_(keep, generator=g)
                         for s in mask_shapes(m, B // ranks)])
    return [torch.cat(site) for site in zip(*per_rank)] if ranks > 1 else per_rank[0]


class _Dropper:
    """Hands the forward its masks in order, cut to a block of rows."""

    def __init__(self, masks, rows: slice, keep: float):
        self.masks, self.rows, self.keep, self.i = masks, rows, keep, 0

    def __call__(self, x):
        mask = self.masks[self.i][self.rows]
        self.i += 1
        if mask.shape != x.shape:
            raise ValueError(f"dropout site {self.i}: mask {tuple(mask.shape)} for {tuple(x.shape)}")
        return x / self.keep * mask.to(x.dtype)


def loss_and_grads(P: M.Params, images, ids, labels, m: dict, masks, smoothing: float,
                   block: int, mm=M.mm_f32) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The batch's mean loss and each leaf's gradient, in blocks of rows."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in P.items()}
    B = images.shape[0]
    total = 0.0
    keep = 1.0 - m["dropout"]
    for r0 in range(0, B, block):
        rows = slice(r0, min(B, r0 + block))
        drop = _Dropper(masks, rows, keep) if m["dropout"] > 0 else None
        logits = M.forward(images[rows], ids[rows], leaves, m, mm, drop)
        if drop is not None and drop.i != len(masks):
            raise ValueError(f"the forward used {drop.i} dropout sites of {len(masks)}")
        V = logits.shape[-1]
        target = torch.nn.functional.one_hot(labels[rows].long(), V).float()
        if smoothing:
            target = target * (1 - smoothing) + smoothing / V
        loss = -(target * torch.log_softmax(logits, -1)).sum() / B
        loss.backward()
        total += float(loss.detach())
    return total, {k: v.grad if v.grad is not None else torch.zeros_like(v) for k, v in leaves.items()}


def learning_rate(t: dict, count: int, encoder: bool, total_steps: int) -> float:
    peak = t["lr"] * (t["encoder_lr_scale"] if encoder and t["encoder_lr_scale"] != 1.0 else 1.0)
    warm = t["warmup_steps"]
    if count < warm:
        return peak * count / warm
    cos_steps = total_steps - warm
    step = min(count - warm, cos_steps)
    alpha = 0.01
    return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * step / cos_steps)) + alpha)


class AdamW:
    def __init__(self, P: M.Params, t: dict, total_steps: int):
        self.t, self.total = t, total_steps
        self.m = {k: torch.zeros_like(v) for k, v in P.items()}
        self.v = {k: torch.zeros_like(v) for k, v in P.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, P: M.Params, grads: Dict[str, torch.Tensor]) -> float:
        """Clip, update P in place; returns the unclipped global norm."""
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
        scale = 1.0 if norm < self.t["grad_clip"] else self.t["grad_clip"] / norm
        b1, b2, eps, wd = 0.9, 0.999, 1e-8, self.t["weight_decay"]
        n = self.count + 1
        for k, p in P.items():
            g = grads[k] * scale
            lr = learning_rate(self.t, self.count, k.startswith(ENCODERS), self.total)
            p.mul_(1 - lr * wd)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(1 - b2**n)).add_(eps)
            p.addcdiv_(self.m[k], denom, value=-lr / (1 - b1**n))
        self.count += 1
        return norm
