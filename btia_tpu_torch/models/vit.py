"""Vision Transformer image encoders (the port of ``btia_tpu/models/vit.py``).

Patchify is a reshape in (p, p, C) order plus a Dense, as in the reference,
not an NCHW convolution; pre-LN blocks; the self-attention site goes through
``MultiHeadAttention``, whose 577-token score tile takes the long-sequence
road to K3. Train-time dropout sits inside each block's Mlp
(``vit.py:63-69``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from btia_tpu_torch.core.dtypes import DTypePolicy
from btia_tpu_torch.models.layers import Dense, Dropout, LayerNorm, Mlp, MultiHeadAttention, _param, remat


@dataclasses.dataclass(frozen=True)
class ViTSpec:
    image_size: int
    patch_size: int
    dim: int
    depth: int
    num_heads: int
    mlp_ratio: float = 4.0

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_tokens(self) -> int:  # patches + CLS
        return self.grid * self.grid + 1


VIT_SPECS = {
    "vit_b16": ViTSpec(image_size=224, patch_size=16, dim=768, depth=12, num_heads=12),
    "vit_l336": ViTSpec(image_size=336, patch_size=14, dim=1024, depth=24, num_heads=16),
    "vit_test": ViTSpec(image_size=96, patch_size=8, dim=64, depth=2, num_heads=4),
}


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, policy: DTypePolicy, device=None):
        super().__init__()
        self.ln1 = LayerNorm(dim, policy, device=device)
        self.attn = MultiHeadAttention(dim, num_heads, policy, device=device)
        self.ln2 = LayerNorm(dim, policy, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), policy, device, inner_dropout=True)

    def forward(self, x: torch.Tensor, drop: Optional[Dropout] = None,
                train: bool = False) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x), drop, train)


class ViT(nn.Module):
    """Returns all tokens (CLS + patches): (B, N+1, D). With ``remat`` each
    block is rematerialised in the backward pass (``vit.py:117``)."""

    def __init__(self, spec: ViTSpec, policy: DTypePolicy, device=None, remat: bool = False):
        super().__init__()
        self.spec = spec
        self.policy = policy
        self.remat = remat
        s = spec
        self.patch_embed = Dense(s.patch_size * s.patch_size * 3, s.dim, policy, device)
        self.cls_token = _param(1, 1, s.dim, device=device)
        self.pos_embed = _param(1, s.num_tokens, s.dim, device=device)
        for i in range(s.depth):
            self.add_module(f"block{i}", ViTBlock(s.dim, s.num_heads, s.mlp_ratio, policy, device))
        self.ln_final = LayerNorm(s.dim, policy, device=device)

    def forward(self, images: torch.Tensor, drop: Optional[Dropout] = None,
                train: bool = False) -> torch.Tensor:
        s = self.spec
        B, H, W, C = images.shape
        if H != s.image_size or W != s.image_size:
            raise ValueError(f"expected {s.image_size}px input, got {H}x{W}")
        x = images.to(self.policy.compute_dtype)
        g, p = s.grid, s.patch_size
        x = x.reshape(B, g, p, g, p, C).permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, p * p * C)
        x = self.patch_embed(x)
        cls = self.cls_token.to(x.dtype).expand(B, 1, s.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for i in range(s.depth):
            block = getattr(self, f"block{i}")
            x = remat(block, x, drop=drop, train=train) if self.remat else block(x, drop, train)
        return self.ln_final(x)
