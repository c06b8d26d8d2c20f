"""LSTM question encoder (the port of ``btia_tpu/models/lstm.py``).

One matrix product projects every step's input (``ih``, with its bias);
then a loop over the S steps (at most 32 here) does one (B, H) x (H, 4H)
product each with the recurrent kernel and its own bias ``hh_bias``. Gates
in PyTorch's order (i, f, g, o). A masked step carries h and c through, and
its output is the carried h; the reverse direction scans from the end.
h and c stay in the compute dtype and round at every step under bf16, as
the reference's scan carry does (``lstm.py:56-71``).

cuDNN's ``nn.LSTM`` cannot carry the state through masked steps inside a
row, so it is not this module; the tests use it as an oracle of the gate
order on unmasked rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from btia_tpu_torch.core.dtypes import DTypePolicy
from btia_tpu_torch.models.layers import Dense, Dropout, Embed, _param, maybe_drop


class LSTMLayer(nn.Module):
    def __init__(self, in_dim: int, hidden: int, policy: DTypePolicy, reverse: bool = False, device=None):
        super().__init__()
        self.hidden = hidden
        self.policy = policy
        self.reverse = reverse
        self.ih = Dense(in_dim, 4 * hidden, policy, device)
        self.hh_kernel = _param(hidden, 4 * hidden, device=device)
        self.hh_bias = _param(4 * hidden, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, S, E) -> (B, S, H); mask (B, S) True = a real step."""
        cd = self.policy.compute_dtype
        B, S, _ = x.shape
        w_hh, b_hh = self.hh_kernel.to(cd), self.hh_bias.to(cd)
        xz = self.ih(x)  # (B, S, 4H), every step's input product at once
        h = c = torch.zeros((B, self.hidden), dtype=cd, device=x.device)
        m = None if mask is None else mask.to(cd)
        outs = [None] * S
        for t in (reversed(range(S)) if self.reverse else range(S)):
            z = xz[:, t] + h @ w_hh + b_hh
            i, f, g, o = z.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            c_new = f * c + i * torch.tanh(g)
            h_new = o * torch.tanh(c_new)
            if m is not None:
                mt = m[:, t, None]
                h_new = mt * h_new + (1 - mt) * h
                c_new = mt * c_new + (1 - mt) * c
            h, c = h_new, c_new
            outs[t] = h
        return torch.stack(outs, dim=1)


class LSTMQuestionEncoder(nn.Module):
    """Embedding + (bi)LSTM. Returns (token states (B, S, H or 2H), mask)."""

    def __init__(self, vocab_size: int, embed_dim: int, hidden: int, bidirectional: bool = True,
                 policy: DTypePolicy = DTypePolicy(), device=None):
        super().__init__()
        self.policy = policy
        self.bidirectional = bidirectional
        self.word_embed = Embed(vocab_size, embed_dim, device)
        self.fwd = LSTMLayer(embed_dim, hidden, policy, device=device)
        if bidirectional:
            self.bwd = LSTMLayer(embed_dim, hidden, policy, reverse=True, device=device)

    @property
    def out_dim(self) -> int:
        return self.fwd.hidden * (2 if self.bidirectional else 1)

    def forward(self, token_ids: torch.Tensor, mask: Optional[torch.Tensor] = None,
                drop: Optional[Dropout] = None, train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        if mask is None:
            mask = token_ids > 0  # id 0 = PAD (data/vocab.py)
        emb = maybe_drop(self.word_embed(token_ids, self.policy.compute_dtype), drop)
        out = self.fwd(emb, mask)
        if self.bidirectional:
            out = torch.cat([out, self.bwd(emb, mask)], dim=-1)
        return out, mask
