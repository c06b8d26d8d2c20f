"""BTIA bidirectional cross-attention (the port of ``btia_tpu/ops/bicross.py``).

    img <- txt : out_i = softmax(Q_img K_txt^T / sqrt(d)) V_txt   (question-masked)
    txt <- img : out_t = softmax(Q_txt K_img^T / sqrt(d)) V_img   (dense)

K6, ``bicross_bhsd_attention`` (``csrc/bicross.cu`` on the short-sequence
kernel of ``csrc/short_flash.cuh``), computes both directions in one launch,
at any head width up to 256 in bf16; bf16 heads from 257 to 1024 take the
wide-head kernel (``csrc/attn_wide.cu``) and f32 operands the CUDA-core
kernel (``csrc/attn_simt.cu``), both directions in one launch too
(``attention.attention_route``). The BTIA block does not call it (its two
directions are K1 sites, ``models/btia.py``); it is an explicit op and an
oracle, reached through ``bicross_attention(impl="pallas")``, through
``bicross_attention`` with the switch on the kernels and Ni*Nt above
``SMALL_SCORE_TILE``, and through ``bicross_bshd`` on such long tiles. A
CUDA tensor launches the kernel (counted in ``.launches``) or raises, a CPU
tensor takes the plain twin. The backward is the vjp of ``mha_reference`` in
each direction (``_bicross_bwd``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from btia_tpu_torch.ops import _native
from btia_tpu_torch.ops.attention import (
    SMALL_SCORE_TILE, _bhsd_operand, _log2_scale, _mha_bhsd_plain, _round8, _resolved_impl,
    _route_or_raise, attend, mha_bshd, mha_reference, operand, short_plan,
)


def bicross_reference(
    qi, ki, vi, qt, kt, vt, txt_mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain oracle. qi/ki/vi: (B, H, Ni, D) image side; qt/kt/vt:
    (B, H, Nt, D) text side. Returns (out_img, out_txt)."""
    return mha_reference(qi, kt, vt, txt_mask), mha_reference(qt, ki, vi, None)


def _bicross_plain(qi, ki, vi, qt, kt, vt, txt_mask):
    """K6's plain twin: ``_mha_kernel``'s arithmetic (``_attn_block_log2``,
    division after PV) in each direction, the question mask on img <- txt."""
    return _mha_bhsd_plain(qi, kt, vt, txt_mask), _mha_bhsd_plain(qt, ki, vi, None)


# K6's widest head on the tensor cores: the short-sequence kernel's
# templates pad D to 64, 128, 192 or 256 in shared memory, as K5's do. The
# reference pads any width; a wider bf16 head takes the wide-head kernel.
K6_MAX_HEAD_WIDTH = 256


def k6_takes(head_dim: int) -> bool:
    """Whether K6's tensor-core (bf16) kernel takes this head width: every width up to
    256 (one not a multiple of 8 through a padded copy)."""
    return 1 <= head_dim <= K6_MAX_HEAD_WIDTH


def _bicross_views(route, qi, ki, vi, qt, kt, vt, txt_mask):
    """Both directions in one launch of the CUDA-core or wide-head kernel
    (its two problems), each operand read through its strides."""
    for t in (qi, ki, vi, qt, kt, vt):  # the route took qi's dtype
        _native.require(t, "bicross_bhsd_attention", qi.dtype, contiguous=False)
    oi, ot = (torch.empty_like(x if x.stride(3) == 1 else x.contiguous()) for x in (qi, qt))
    c = _log2_scale(qi.shape[3])
    x = [operand(t) for t in (qi, ki, vi, qt, kt, vt, oi, ot)]
    attend(route, [(x[0], x[4], x[5], x[6], txt_mask, c), (x[3], x[1], x[2], x[7], None, c)], qi.shape[3],
           mult_mask=False)
    return oi, ot


def _bicross_cuda(qi, ki, vi, qt, kt, vt, txt_mask, pack: bool = True):
    B, H, Ni, D = qi.shape
    Nt = qt.shape[2]
    route = _route_or_raise(qi.dtype, D, k6_takes, "K6 kernel", f"up to {K6_MAX_HEAD_WIDTH}")
    if min(B, H, Ni, Nt) == 0:
        raise ValueError(f"K6 kernel takes B, H, Ni, Nt >= 1, got {(B, H, Ni, Nt)}")
    if route != "wgmma":
        return _bicross_views(route, qi, ki, vi, qt, kt, vt, txt_mask)
    dw = _round8(D)
    operands = (qi, ki, vi, qt, kt, vt)
    if dw != D:
        # TMA reads rows of 16-byte multiples: one zero-padded copy (K5's rule).
        operands = tuple(torch.nn.functional.pad(t, (0, dw - D)) for t in operands)
    names = ("qi", "ki", "vi", "qt", "kt", "vt")
    ops = [_bhsd_operand(t, f"bicross_bhsd_attention {n}") for t, n in zip(operands, names)]
    outs = [_bhsd_operand(torch.empty_like(ops[i][0]), "bicross_bhsd_attention out") for i in (0, 3)]
    (oi, _), (ot, _) = outs
    strides = (ctypes.c_longlong * 24)(*(s for _, st in ops + outs for s in st))
    plan = short_plan([(B, H, Ni, Nt), (B, H, Nt, Ni)], dw, pack)
    mask = None if txt_mask is None else txt_mask.to(torch.bool).contiguous()  # read as bytes
    _native.check(
        _native.lib().btia_bicross(
            *(t.data_ptr() for t, _ in ops), None if mask is None else mask.data_ptr(),
            oi.data_ptr(), ot.data_ptr(), strides, (ctypes.c_int * len(plan))(*plan),
            B, H, Ni, Nt, dw, _log2_scale(D), _native.stream(qi),
        ),
        "btia_bicross",
    )
    return (oi, ot) if dw == D else (oi[..., :D], ot[..., :D])


def _vjp_reference(q, k, v, mask, g):
    """The vjp of ``mha_reference`` at (q, k, v)."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        return torch.autograd.grad(mha_reference(*leaves, mask), leaves, g)


class _Bicross(torch.autograd.Function):
    """``_bicross``: K6 (or its twin) when ``use_kernel``, else
    ``bicross_reference``; the backward is ``_bicross_bwd`` either way."""

    @staticmethod
    def forward(ctx, qi, ki, vi, qt, kt, vt, txt_mask, use_kernel):
        ctx.save_for_backward(qi, ki, vi, qt, kt, vt, txt_mask)
        if use_kernel:
            return _native.route(bicross_bhsd_attention, qi, _bicross_cuda, _bicross_plain,
                                 qi, ki, vi, qt, kt, vt, txt_mask)
        return bicross_reference(qi, ki, vi, qt, kt, vt, txt_mask)

    @staticmethod
    def backward(ctx, gi, gt):
        qi, ki, vi, qt, kt, vt, txt_mask = ctx.saved_tensors
        dqi, dkt, dvt = _vjp_reference(qi, kt, vt, txt_mask, gi)
        dqt, dki, dvi = _vjp_reference(qt, ki, vi, None, gt)
        return dqi, dki, dvi, dqt, dkt, dvt, None, None


def bicross_bhsd_attention(
    qi, ki, vi, qt, kt, vt, txt_mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: both directions in one launch. Image side (B, H, Ni, D), text
    side (B, H, Nt, D), in any strides with D packed; txt_mask (B, Nt)
    True=valid; on the card bf16 D up to 256 on the tensor cores
    (``k6_takes``), bf16 heads of 257-1024 on the wide-head kernel, f32 up
    to 1024 on the CUDA-core kernel (``attention_route``)."""
    return _Bicross.apply(qi, ki, vi, qt, kt, vt, txt_mask, True)


bicross_bhsd_attention.launches = 0


def bicross_attention(
    qi, ki, vi, qt, kt, vt,
    txt_mask: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional cross-attention (the BTIA core op). Image side
    (B, H, Ni, D), text side (B, H, Nt, D); txt_mask (B, Nt) True=valid.
    impl: "pallas" (K6, the hand-written kernel), "xla", or None: the
    switch, with Ni*Nt of at most ``SMALL_SCORE_TILE`` on the plain road.
    Returns (out_img, out_txt)."""
    if impl is None:
        impl = _resolved_impl()
        if impl == "pallas" and qi.shape[2] * qt.shape[2] <= SMALL_SCORE_TILE:
            impl = "xla"
    return _Bicross.apply(qi, ki, vi, qt, kt, vt, txt_mask, impl == "pallas")


def bicross_bshd(
    qi, ki, vi, qt, kt, vt, txt_mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional cross-attention over (B, S, H, D) tensors: K6 through
    (B, H, S, D) views for long tiles with the switch on the kernels, else
    two ``mha_bshd`` calls."""
    if _resolved_impl() == "pallas" and qi.shape[1] * qt.shape[1] > SMALL_SCORE_TILE:
        t = lambda x: x.transpose(1, 2)
        oi, ot = bicross_bhsd_attention(t(qi), t(ki), t(vi), t(qt), t(kt), t(vt), txt_mask)
        return t(oi), t(ot)
    return mha_bshd(qi, kt, vt, txt_mask), mha_bshd(qt, ki, vi, None)
