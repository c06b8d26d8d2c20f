"""Attention over pre-projected q/k/v in the (B, S, H, D) layout.

The port of ``btia_tpu/ops/attention.py:mha_bshd``, with its three roads:

* long sequences (score tile Sq*Sk above ``SMALL_SCORE_TILE``: ViT
  self-attention, the AD head's 2048 answer queries) go to K3,
  ``bshd_flash_attention`` (``csrc/flash_bshd.cu``);
* short sequences at a batch of at least ``FANOUT_MIN_BATCH`` with
  D % 64 == 0 go to K4, ``fanout_attention`` (``csrc/fanout.cu``). In
  training this is where the backward pass of every fused K1 site
  recomputes its attention;
* otherwise the reference's einsum road with an additive -1e9 mask bias
  (``attention.py:801-811``).

Each kernel entry routes by device: a CUDA tensor launches the hand-written
kernel (counted in the entry's ``.launches``) or raises, a CPU tensor takes
the plain PyTorch twin. Each is a ``torch.autograd.Function`` whose backward
is plain PyTorch mirroring the reference's ``custom_vjp`` (``_bshd_bwd``,
``_fanout_bwd``): the reference has no backward kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from btia_tpu_torch.ops import _native

NEG_INF = -1e9
LOG2E = 1.4426950408889634
# Sq*Sk above this is a long sequence (``attention.py:_SMALL_SCORE_TILE``).
SMALL_SCORE_TILE = 32_768
# Short sequences at this batch or above take K4 (``_FANOUT_MIN_BATCH``).
FANOUT_MIN_BATCH = 64


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, H, S, D) in f32."""
    B, S, HD = x.shape
    return x.reshape(B, S, num_heads, HD // num_heads).transpose(1, 2).float()


def attend_log2(q, k, v, colmask, num_heads: int) -> torch.Tensor:
    """The masked exp2 softmax of K1, K2 and K4 in plain PyTorch: q
    (B, Sq, HD) already in the log2 domain, k/v (B, Sk, HD), colmask
    (B, Sk) f32 {0, 1}; -1e9 bias before the max, exp2 times the mask,
    denominator floored at 1e-30, division after PV -> (B, Sq, HD)."""
    B, Sq, HD = q.shape
    cd = q.dtype
    s = _heads(q, num_heads) @ _heads(k, num_heads).transpose(-1, -2)  # (B, H, Sq, Sk)
    cm = colmask[:, None, None, :]
    s = s - (1.0 - cm) * 1e9
    e = torch.exp2(s - s.amax(-1, keepdim=True)) * cm
    denom = torch.clamp_min(e.sum(-1, keepdim=True), 1e-30)
    acc = e.to(cd).float() @ _heads(v, num_heads)
    return (acc / denom).to(cd).transpose(1, 2).reshape(B, Sq, HD)


def _log2_scale(head_dim: int) -> float:
    """scale*log2(e): folds the softmax scale and exp -> exp2 into q."""
    return (1.0 / head_dim**0.5) * LOG2E


def _softmax_bwd(q, k, v, g, num_heads, s_bias, mult=None):
    """The reference's XLA rematerialisation of attention's vjp in the
    packed layout (``_bshd_bwd`` / ``_fanout_bwd``): recompute the f32
    probabilities with natural exp, then the four products. s_bias is the
    additive score bias (B, 1, 1, Sk) or None; mult a (B, 1, 1, Sk)
    multiplicative key mask applied after exp (K4) or None (K3)."""
    B, Sq, HD = q.shape
    Sk = k.shape[1]
    D = HD // num_heads
    scale = 1.0 / D**0.5
    q4, k4, v4 = (_heads(t, num_heads) for t in (q, k, v))
    s = (q4 @ k4.transpose(-1, -2)) * scale
    if s_bias is not None:
        s = s + s_bias
    if mult is None:
        p = torch.softmax(s, dim=-1)
    else:
        e = torch.exp(s - s.amax(-1, keepdim=True)) * mult
        p = e / torch.clamp_min(e.sum(-1, keepdim=True), 1e-30)
    g4 = _heads(g, num_heads)
    dv = p.transpose(-1, -2) @ g4
    dp = g4 @ v4.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = (ds @ k4) * scale
    dk = (ds.transpose(-1, -2) @ q4) * scale
    merge = lambda t, S, like: t.transpose(1, 2).reshape(B, S, HD).to(like.dtype)
    return merge(dq, Sq, q), merge(dk, Sk, k), merge(dv, Sk, v)


# ---------------------------------------------------------------------------
# K3: long-sequence attention (``_bshd_flash_kernel``)
# ---------------------------------------------------------------------------


def _bshd_flash_plain(q, k, v, kv_mask, num_heads: int) -> torch.Tensor:
    """K3's plain twin, with ``_bshd_flash_kernel``'s arithmetic: q prescaled
    by scale*log2(e) and rounded to the compute dtype, exp2 softmax with an
    additive -1e9 bias on masked keys, division BEFORE PV."""
    B, Sq, HD = q.shape
    c = _log2_scale(HD // num_heads)
    qs = (q.float() * c).to(q.dtype)
    s = _heads(qs, num_heads) @ _heads(k, num_heads).transpose(-1, -2)
    if kv_mask is not None:
        s = s + torch.where(kv_mask, 0.0, NEG_INF).float()[:, None, None, :]
    e = torch.exp2(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(v.dtype)
    out = p.float() @ _heads(v, num_heads)
    return out.transpose(1, 2).reshape(B, Sq, HD).to(q.dtype)


def _bshd_flash_cuda(q, k, v, kv_mask, num_heads: int) -> torch.Tensor:
    B, Sq, HD = q.shape
    Sk = k.shape[1]
    if HD != num_heads * 64:
        raise ValueError(f"K3 kernel takes head width 64, got {HD // num_heads}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _native.require(t, f"bshd_flash_attention {name}")
    mask = None if kv_mask is None else kv_mask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    _native.check(
        _native.lib().btia_flash_bshd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, num_heads, Sq, Sk, _log2_scale(64), _native.stream(q),
        ),
        "btia_flash_bshd",
    )
    return out


class _BshdFlash(torch.autograd.Function):
    """K3 forward; backward as ``_bshd_bwd`` (additive-bias softmax)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, num_heads):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.num_heads = num_heads
        return _native.route(bshd_flash_attention, q, _bshd_flash_cuda, _bshd_flash_plain,
                             q, k, v, kv_mask, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask = ctx.saved_tensors
        bias = None
        if kv_mask is not None:
            bias = torch.where(kv_mask, 0.0, NEG_INF).float()[:, None, None, :]
        dq, dk, dv = _softmax_bwd(q, k, v, g, ctx.num_heads, bias)
        return dq, dk, dv, None, None


def bshd_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    num_heads: int,
) -> torch.Tensor:
    """K3: q (B, Sq, H*D), k/v (B, Sk, H*D), kv_mask (B, Sk) True=valid.

    A CUDA tensor launches the kernel (counted in ``.launches``); a CPU
    tensor takes the plain twin."""
    return _BshdFlash.apply(q, k, v, kv_mask, num_heads)


bshd_flash_attention.launches = 0


# ---------------------------------------------------------------------------
# K4: batch fan-out attention for short sequences (``_fanout_kernel``)
# ---------------------------------------------------------------------------


def _fanout_plain(q, k, v, colmask, num_heads: int) -> torch.Tensor:
    """K4's plain twin, with ``_fanout_kernel``'s arithmetic: q prescaled by
    scale*log2(e) in f32 and rounded, then the masked exp2 softmax."""
    qs = (q.float() * _log2_scale(q.shape[2] // num_heads)).to(q.dtype)
    return attend_log2(qs, k, v, colmask, num_heads)


def _fanout_cuda(q, k, v, colmask, num_heads: int) -> torch.Tensor:
    B, Sq, HD = q.shape
    Sk = k.shape[1]
    if HD != num_heads * 64:
        raise ValueError(f"K4 kernel takes head width 64, got {HD // num_heads}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _native.require(t, f"fanout_attention {name}")
    cm = colmask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    _native.check(
        _native.lib().btia_fanout(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cm.data_ptr(), out.data_ptr(),
            B, num_heads, Sq, Sk, _log2_scale(64), _native.stream(q),
        ),
        "btia_fanout",
    )
    return out


class _Fanout(torch.autograd.Function):
    """K4 forward; backward as ``_fanout_bwd`` (mask bias before the max,
    exp times the mask, so p is exactly 0 at masked keys)."""

    @staticmethod
    def forward(ctx, q, k, v, colmask, num_heads):
        ctx.save_for_backward(q, k, v, colmask)
        ctx.num_heads = num_heads
        return _native.route(fanout_attention, q, _fanout_cuda, _fanout_plain,
                             q, k, v, colmask, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, colmask = ctx.saved_tensors
        cm = colmask.float()[:, None, None, :]
        dq, dk, dv = _softmax_bwd(q, k, v, g, ctx.num_heads, -(1.0 - cm) * 1e9, mult=cm)
        return dq, dk, dv, None, None


def fanout_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    colmask: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """K4: q (B, Sq, H*D), k/v (B, Sk, H*D), colmask (B, Sk) f32 {0, 1}.

    A fully masked row gives 0. A CUDA tensor launches the kernel (counted
    in ``.launches``); a CPU tensor takes the plain twin."""
    return _Fanout.apply(q, k, v, colmask, num_heads)


fanout_attention.launches = 0


def mha_bshd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over (B, S, H, Dh) tensors; kv_mask (B, Sk) True=valid."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    flat = lambda t, S: t.reshape(B, S, H * D)
    if Sq * Sk > SMALL_SCORE_TILE:
        out = bshd_flash_attention(flat(q, Sq), flat(k, Sk), flat(v, Sk), kv_mask, H)
        return out.reshape(B, Sq, H, D)
    if B >= FANOUT_MIN_BATCH and D % 64 == 0:
        cm = (kv_mask.to(torch.float32) if kv_mask is not None
              else torch.ones((B, Sk), dtype=torch.float32, device=q.device))
        out = fanout_attention(flat(q, Sq), flat(k, Sk), flat(v, Sk), cm, H)
        return out.reshape(B, Sq, H, D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / D**0.5)
    if kv_mask is not None:
        scores = scores + torch.where(kv_mask, 0.0, NEG_INF).float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)
