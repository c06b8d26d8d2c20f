"""Answer heads (port of ``btia_tpu/models/heads.py``): the attention-driven
(AD) head and the pool-and-MLP head (``SimpleClassifier``).

Learned answer queries attend over the fused image+question tokens through
K2 (``fused_static_q_attention``) with the kv LayerNorm and the query
residual folded in (``heads.py:74-78``), then ln_mlp + Mlp (with train-time
dropout inside, ``heads.py:79-85``) + ln_out. Two
modes: per-answer queries (``num_queries == 0``, one query scored against
its own weight row) and factorized (K queries, mean-pooled, scored against
an answer table).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from btia_tpu_torch.core.dtypes import DTypePolicy
from btia_tpu_torch.models.layers import (
    Dense, Dropout, LayerNorm, LayerNormParams, Mlp, _param, masked_mean, maybe_drop,
)
from btia_tpu_torch.ops.fused_attn import fused_static_q_attention
from btia_tpu_torch.ops.gemm import prepare_once


class ADHead(nn.Module):
    def __init__(self, dim: int, num_heads: int, vocab_size: int, num_queries: int = 0,
                 mlp_ratio: float = 2.0, policy: DTypePolicy = DTypePolicy(), device=None):
        super().__init__()
        self.num_heads = num_heads
        self.num_queries = num_queries
        self.policy = policy
        self.answer_queries = _param(num_queries or vocab_size, dim, device=device)
        self.ln_kv = LayerNormParams(dim, device=device)
        self.q_proj = Dense(dim, dim, policy, device)
        self.k_proj = Dense(dim, dim, policy, device)
        self.v_proj = Dense(dim, dim, policy, device)
        self.o_proj = Dense(dim, dim, policy, device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), policy, device, inner_dropout=True)
        self.ln_mlp = LayerNorm(dim, policy, device=device)
        self.ln_out = LayerNorm(dim, policy, device=device)
        if num_queries == 0:
            self.answer_weights = _param(vocab_size, dim, device=device)
        else:
            self.answer_table = _param(vocab_size, dim, device=device)
        self.answer_bias = _param(vocab_size, device=device)

    def forward(self, tokens: torch.Tensor, token_mask: Optional[torch.Tensor],
                drop: Optional[Dropout] = None, train: bool = False) -> torch.Tensor:
        cd, acc = self.policy.compute_dtype, self.policy.accum_dtype
        q = self.answer_queries
        # Where no gradient flows, the cast table is one tensor per version
        # of the parameter, so K2's projected query table, prepared from it,
        # is prepared once too (``prepare_once``).
        queries = (q.to(cd) if torch.is_grad_enabled() and q.requires_grad
                   else prepare_once((q,), ("cast", cd), lambda: (q.to(cd),))[0])
        feats = fused_static_q_attention(
            queries, tokens.to(cd), token_mask,
            self.q_proj.kernel, self.q_proj.bias, self.k_proj.kernel, self.k_proj.bias,
            self.v_proj.kernel, self.v_proj.bias, self.o_proj.kernel, self.o_proj.bias,
            self.num_heads, kv_ln=self.ln_kv.triple(), residual=True,
        )
        feats = feats + self.mlp(self.ln_mlp(feats), drop, train)
        feats = self.ln_out(feats)
        if self.num_queries == 0:
            logits = torch.einsum("bad,ad->ba", feats.to(acc), self.answer_weights.to(acc))
        else:
            pooled = feats.mean(dim=1)
            logits = pooled.to(acc) @ self.answer_table.to(acc).T
        return (logits + self.answer_bias).float()


class SimpleClassifier(nn.Module):
    """The mlp head (``heads.py:128-162``): the mean of the image tokens and
    the masked mean of the text tokens, concatenated -> fc1 (2 * dim wide,
    compute dtype) -> exact (erf) GELU -> dropout -> fc_out in the accum
    dtype -> f32 logits."""

    def __init__(self, dim: int, vocab_size: int, hidden_mult: float = 2.0,
                 policy: DTypePolicy = DTypePolicy(), device=None):
        super().__init__()
        hidden = int(dim * hidden_mult)
        self.fc1 = Dense(2 * dim, hidden, policy, device)
        self.fc_out = Dense(hidden, vocab_size, dataclasses.replace(policy, compute_dtype=policy.accum_dtype),
                            device)

    def forward(self, img_tokens: torch.Tensor, txt_tokens: torch.Tensor, txt_mask: Optional[torch.Tensor],
                drop: Optional[Dropout] = None, train: bool = False) -> torch.Tensor:
        joint = torch.cat([img_tokens.mean(dim=1), masked_mean(txt_tokens, txt_mask)], dim=-1)
        x = maybe_drop(F.gelu(self.fc1(joint), approximate="none"), drop)
        return self.fc_out(x).float()
