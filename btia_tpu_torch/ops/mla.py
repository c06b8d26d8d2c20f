"""The attention core of the latent attention (``models/mla_moe.py::MLA``):
the part between ``kv_b_proj`` and ``o_proj``, on the packed real tokens.
No TPU kernel corresponds: the JAX package has no MLA.

``mla_attention(q, kv, q_pe, k_pe, index, mask)``: T packed rows, the real
tokens at flat grid indices ``index`` (sorted; ``nonzero`` of the (B, S)
``mask``), each attending, head by head, to the real keys of its own
question at positions up to its own: ``causal & mask`` on the grid. q (T, H,
dn + dr) is ``q_proj``'s output (its first dn columns a head are read),
kv (T, H, dn + dv) ``kv_b_proj``'s ([k_nope | v]), q_pe (T, H, dr) the
rotated rope part of q, k_pe (T, 1, dr) the one rotated key every head
shares. Returns o (T, H * dv), ``o_proj``'s input. The arithmetic: the
products of the operands summed in f32, scaled by (dn + dr)^-0.5, the
softmax in f32, the probabilities rounded once to the operands' dtype, P V
summed in f32 and rounded once.

On the card, bf16 operands with dn <= 128, dr <= 64 and dv <= 128 (each a
multiple of 8; every published MLA: DeepSeek-V2/V3 and Kimi-VL's 128, 64,
128) and S <= 32 take one launch of ``csrc/mla_attn.cu``, which reads the
projections' outputs as they lie and writes o packed: no grid of B * S rows
exists (``mla_attention.launches`` counts the launches). A question's
output does not depend on the other questions of the batch, bit for bit.
Everything else takes the plain twin, ``_mla_plain``, which scatters the
rows into zero-filled (B * S, H, .) grids, runs the product in f32 over each
question's S x S block and gathers the real rows back. ``kernel_refuses``
says which, and why.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from btia_tpu_torch.ops import _native

MAX_NOPE, MAX_ROPE, MAX_V = 128, 64, 128  # the kernel's column blocks: 2, 1 and 2 of 64
MAX_S = 32  # an item's 64 rows see the 32 rows before them


def _mla_plain(q, kv, q_pe, k_pe, index, mask):
    """The twin: the real rows scattered into zero-filled grids of every
    (question, position), the product in f32 over each question's (S, S)
    block under ``causal & mask``, the softmax in f32, P rounded to the
    operands' dtype, the real rows of P V gathered back."""
    T, H, _ = q.shape
    (B, S), dr = mask.shape, q_pe.shape[-1]
    dn = q.shape[-1] - dr
    dv = kv.shape[-1] - dn
    cd = q.dtype
    qg = q.new_zeros(B * S, H, dn + dr)
    kg = q.new_zeros(B * S, H, dn + dr)
    vg = q.new_zeros(B * S, H, dv)
    qg[index] = torch.cat([q[..., :dn], q_pe], -1)
    kg[index] = torch.cat([kv[..., :dn], k_pe.expand(T, H, dr)], -1)
    vg[index] = kv[..., dn:]
    heads = lambda t: t.view(B, S, H, -1).transpose(1, 2)
    scores = heads(qg).float() @ heads(kg).float().transpose(-1, -2) / math.sqrt(dn + dr)
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    allowed = causal[None, None] & mask[:, None, None, :]
    # a key-less row (a query of an all-padding question) is never read
    probs = torch.softmax(scores.masked_fill(~allowed, torch.finfo(torch.float32).min), -1)
    o = (probs.to(cd) @ heads(vg)).transpose(1, 2).reshape(B * S, H * dv)
    return o[index]


def kernel_refuses(q, kv, q_pe, k_pe, mask) -> Optional[str]:
    """Why these operands take the twin, or None where the kernel takes
    them: the dtype, the parts' widths, S, then the device."""
    dr = q_pe.shape[-1]
    dn = q.shape[-1] - dr
    dv = kv.shape[-1] - dn
    if any(t.dtype != torch.bfloat16 for t in (q, kv, q_pe, k_pe)):
        return "dtype: the kernel takes bf16"
    if not (0 < dn <= MAX_NOPE and 0 < dr <= MAX_ROPE and 0 < dv <= MAX_V) or (dn | dr | dv) % 8:
        return f"widths: nope {dn}, rope {dr}, v {dv}; the kernel takes multiples of 8 up to 128, 64, 128"
    if mask.shape[1] > MAX_S:
        return f"S {mask.shape[1]}: the kernel's window holds S <= {MAX_S}"
    if not all(t.is_cuda for t in (q, kv, q_pe, k_pe, mask)):
        return "device: the kernel runs on a CUDA card"
    return None


def _mla_cuda(q, kv, q_pe, k_pe, index, mask):
    T, H, _ = q.shape
    dr = q_pe.shape[-1]
    dn = q.shape[-1] - dr
    dv = kv.shape[-1] - dn
    q, kv, q_pe, k_pe = (_native.aligned(t) for t in (q, kv, q_pe, k_pe.reshape(T, dr)))
    if index.dtype != torch.int64 or not index.is_contiguous() or index.shape != (T,):
        raise ValueError(f"mla_attention: index must be a packed (T,) int64 tensor, got {index.dtype} "
                         f"{tuple(index.shape)}")
    o = torch.empty(T, H * dv, dtype=torch.bfloat16, device=q.device)
    strides = (ctypes.c_longlong * 9)(q.stride(0), q.stride(1), q_pe.stride(0), q_pe.stride(1), kv.stride(0),
                                      kv.stride(1), k_pe.stride(0), H * dv, dv)
    _native.check(
        _native.lib().btia_mla_attn(
            q.data_ptr(), q_pe.data_ptr(), kv.data_ptr(), k_pe.data_ptr(), o.data_ptr(), index.data_ptr(), strides,
            T, H, mask.shape[1], dn, dr, dv, (dn + dr) ** -0.5, _native.stream(q),
        ),
        "btia_mla_attn",
    )
    return o


def mla_attention(q: torch.Tensor, kv: torch.Tensor, q_pe: torch.Tensor, k_pe: torch.Tensor, index: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """The MLA's attention core on the packed rows (the module docstring):
    one kernel launch where ``kernel_refuses`` finds nothing, else the
    twin. No host synchronisation on either route."""
    if q.shape[0] == 0 or kernel_refuses(q, kv, q_pe, k_pe, mask) is not None:
        return _mla_plain(q, kv, q_pe, k_pe, index, mask)
    out = _mla_cuda(q, kv, q_pe, k_pe, index, mask)
    mla_attention.launches += 1
    return out


mla_attention.launches = 0
