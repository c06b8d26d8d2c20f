"""BTIA — bidirectional text-image attention fusion (port of
``btia_tpu/models/btia.py``).

Per layer, two K1 sites with the pre-LNs and residuals folded in
(``btia.py:86-98``); each LN's params feed both directions:

    img' = img + O_i(Attn(Q(LN img), K(LN txt), V(LN txt)))   # masked by txt
    txt' = txt + O_t(Attn(Q(LN txt), K(LN img), V(LN img)))   # unmasked
    img  = img' + FFN_i(LN img');  txt = txt' + FFN_t(LN txt')

Under train-time dropout the residual leaves the sites (pre-LN only) and
each attention and FFN output is dropped before its residual add
(``btia.py:65-122``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from btia_tpu_torch.core.dtypes import DTypePolicy
from btia_tpu_torch.models.layers import Dense, Dropout, LayerNorm, LayerNormParams, Mlp, maybe_drop, remat
from btia_tpu_torch.ops.fused_attn import fused_dense_attention

_PROJS = ("i2t_q_proj", "i2t_k_proj", "i2t_v_proj", "t2i_q_proj",
          "t2i_k_proj", "t2i_v_proj", "i2t_o_proj", "t2i_o_proj")


class BTIALayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, policy: DTypePolicy, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.policy = policy
        self.ln_img = LayerNormParams(dim, device=device)
        self.ln_txt = LayerNormParams(dim, device=device)
        for name in _PROJS:
            self.add_module(name, Dense(dim, dim, policy, device))
        hidden = int(dim * mlp_ratio)
        self.mlp_img = Mlp(dim, hidden, policy, device)
        self.ln_img2 = LayerNorm(dim, policy, device=device)
        self.mlp_txt = Mlp(dim, hidden, policy, device)
        self.ln_txt2 = LayerNorm(dim, policy, device=device)

    def _site(self, direction, x_q, x_kv, mask, q_ln, kv_ln, residual):
        p = lambda n: getattr(self, f"{direction}_{n}_proj")
        q, k, v, o = p("q"), p("k"), p("v"), p("o")
        return fused_dense_attention(
            x_q, x_kv, mask, q.kernel, q.bias, k.kernel, k.bias, v.kernel, v.bias,
            o.kernel, o.bias, self.num_heads, q_ln=q_ln, kv_ln=kv_ln, residual=residual,
        )

    def forward(self, img, txt, txt_mask, drop: Optional[Dropout] = None,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        cd = self.policy.compute_dtype
        img_c, txt_c = img.to(cd), txt.to(cd)
        ln_i, ln_t = self.ln_img.triple(), self.ln_txt.triple()
        fuse_res = drop is None
        out_i = self._site("i2t", img_c, txt_c, txt_mask, ln_i, ln_t, fuse_res)
        out_t = self._site("t2i", txt_c, img_c, None, ln_t, ln_i, fuse_res)
        if fuse_res:
            img, txt = out_i, out_t
        else:
            img, txt = img + drop(out_i), txt + drop(out_t)
        img = img + maybe_drop(self.mlp_img(self.ln_img2(img), train=train), drop)
        txt = txt + maybe_drop(self.mlp_txt(self.ln_txt2(txt), train=train), drop)
        return img, txt


class BTIA(nn.Module):
    """A stack of BTIALayers; with ``remat`` each layer is rematerialised in
    the backward pass (``btia.py:146``)."""

    def __init__(self, dim: int, num_heads: int, num_layers: int, mlp_ratio: float,
                 policy: DTypePolicy, device=None, remat: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.remat = remat
        for i in range(num_layers):
            self.add_module(f"layer{i}", BTIALayer(dim, num_heads, mlp_ratio, policy, device))

    def forward(self, img, txt, txt_mask: Optional[torch.Tensor], drop: Optional[Dropout] = None,
                train: bool = False):
        for i in range(self.num_layers):
            layer = getattr(self, f"layer{i}")
            if self.remat:
                img, txt = remat(layer, img, txt, txt_mask, drop=drop, train=train)
            else:
                img, txt = layer(img, txt, txt_mask, drop, train)
        return img, txt
