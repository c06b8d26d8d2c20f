"""BERT-base question encoder (the port of ``btia_tpu/models/bert.py``).

Post-LN with eps 1e-12; word + position + token-type (all zero) embeddings;
mask = ids > 0 (WordPiece PAD = 0). The attention site is K1 with the
residual and the post-LN ``ln_attn`` folded in (``bert.py:59-65``); under
train-time dropout the site is a plain K1 and the dropout, residual and
post-LN run outside it (``bert.py:66-71``), as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from btia_tpu_torch.core.dtypes import DTypePolicy
from btia_tpu_torch.models.layers import (
    Dropout, Embed, LayerNorm, LayerNormParams, Mlp, MultiHeadAttention, maybe_drop,
)
from btia_tpu_torch.ops.norms import layernorm


@dataclasses.dataclass(frozen=True)
class BertSpec:
    vocab_size: int = 30522
    dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 512
    type_vocab: int = 2
    ln_eps: float = 1e-12


class BertLayer(nn.Module):
    def __init__(self, spec: BertSpec, policy: DTypePolicy, device=None):
        super().__init__()
        s = spec
        self.ln_attn = LayerNormParams(s.dim, s.ln_eps, device)
        self.attn = MultiHeadAttention(s.dim, s.num_heads, policy, device=device)
        self.mlp = Mlp(s.dim, s.mlp_dim, policy, device)
        self.ln_mlp = LayerNorm(s.dim, policy, s.ln_eps, device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                drop: Optional[Dropout] = None, train: bool = False) -> torch.Tensor:
        if drop is None:
            x = self.attn(x, kv_mask=mask, residual=True, post_ln=self.ln_attn.triple())
        else:
            attn = drop(self.attn(x, kv_mask=mask))
            x = layernorm(x + attn, *self.ln_attn.triple()).to(x.dtype)
        return self.ln_mlp(x + maybe_drop(self.mlp(x, train=train), drop))


class BertQuestionEncoder(nn.Module):
    """WordPiece ids -> contextual token features. Returns (feats, mask)."""

    def __init__(self, spec: BertSpec, policy: DTypePolicy, device=None):
        super().__init__()
        self.spec = spec
        self.policy = policy
        s = spec
        self.word_embed = Embed(s.vocab_size, s.dim, device)
        self.pos_embed = Embed(s.max_len, s.dim, device)
        self.type_embed = Embed(s.type_vocab, s.dim, device)
        self.ln_embed = LayerNorm(s.dim, policy, s.ln_eps, device)
        for i in range(s.depth):
            self.add_module(f"layer{i}", BertLayer(s, policy, device))

    def forward(
        self, token_ids: torch.Tensor, mask: Optional[torch.Tensor] = None,
        drop: Optional[Dropout] = None, train: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if mask is None:
            mask = token_ids > 0
        B, S = token_ids.shape
        cd = self.policy.compute_dtype
        pos_ids = torch.arange(S, device=token_ids.device)[None, :]
        x = (
            self.word_embed(token_ids, cd)
            + self.pos_embed(pos_ids, cd)
            + self.type_embed(torch.zeros_like(token_ids), cd)
        )
        x = maybe_drop(self.ln_embed(x), drop)
        for i in range(self.spec.depth):
            x = getattr(self, f"layer{i}")(x, mask, drop, train)
        return x, mask
