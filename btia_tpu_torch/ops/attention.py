"""Multi-head attention: the port of ``btia_tpu/ops/attention.py``.

The switch ``set_attention_impl`` / ``get_attention_impl`` takes the
reference's three values:

* ``"auto"`` (the default): the hand-written kernels on a CUDA tensor, their
  plain twins on a CPU tensor;
* ``"pallas"``: the same routing here. The name is kept so callers' code
  runs unchanged; in this package it means "the hand-written kernel";
* ``"xla"``: the reference's plain road on any device; no kernel launches.

``mha`` is attention in the (B, H, S, D) layout, with ``impl`` choosing
``"pallas"`` (K5, ``mha_bhsd_attention``, ``csrc/mha_bhsd.cu``), ``"xla"``
(``mha_reference`` with ``_mha_bwd``), ``"packed"`` (``_mha_packed``) or, with
None, the switch and the small-tile rule. ``mha_bshd`` is attention in the
projection-native (B, S, H, D) layout, with the reference's roads when the
switch is on the kernels:

* long sequences (score tile Sq*Sk above ``SMALL_SCORE_TILE``: ViT
  self-attention, the AD head's 2048 answer queries) go to K3,
  ``bshd_flash_attention`` (``csrc/flash_bshd.cu``), when D % 64 == 0 and
  H*D % 128 == 0, and otherwise to K5 through a (B, H, S, D) view;
* short sequences at a batch of at least ``FANOUT_MIN_BATCH`` with
  D % 64 == 0 go to K4, ``fanout_attention`` (``csrc/fanout.cu`` on
  ``csrc/short_flash.cuh``). In training this is where the backward pass
  of every fused K1 site recomputes its attention;
* otherwise, and always under ``"xla"``, the reference's einsum road
  (``attention.py:801-811``): ``mha_reference`` on (B, H, S, D) views.

The roads are the reference's gates, whatever the head width or dtype.
Each CUDA entry picks its kernel by (dtype, head width), ``attention_route``:
bf16 at the widths its tensor-core kernel is built for goes there (the
``*_takes`` predicates: K3 and K4 ``TILE_HEAD_WIDTHS``, the multiples of 64
up to 256; K5 and K6, in ``ops/bicross.py``, every width up to 256); bf16
from 257 to ``SIMT_MAX_HEAD_WIDTH`` (1024) to the wide-head tensor-core
kernel ``csrc/attn_wide.cu`` (``wide_attention``); f32 at any width up to
1024 to the CUDA-core kernel ``csrc/attn_simt.cu`` (``simt_attention``),
which computes f32 in f32; any other operand raises before anything is
built. No route casts f32 to bf16. K3 and K5 share one
kernel (``csrc/flash_bshd.cu``): K5 gives it the (B, H, S, D) views with
their own strides, K3 the packed (B, S, H*D) layout. K4 and K6 share the
short-sequence kernel (``csrc/short_flash.cuh``), whose work items
``short_plan`` lays out on the host.

Each kernel entry routes by device: a CUDA tensor launches the hand-written
kernel (counted in the entry's ``.launches``) or raises, a CPU tensor takes
the plain PyTorch twin. Each is a ``torch.autograd.Function`` whose backward
is plain PyTorch mirroring the reference's ``custom_vjp`` (``_mha_bwd``,
``_bshd_bwd``, ``_fanout_bwd``): the reference has no backward kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from btia_tpu_torch.ops import _native
from btia_tpu_torch.ops._native import H100_SMS

NEG_INF = -1e9
LOG2E = 1.4426950408889634
# Sq*Sk above this is a long sequence (``attention.py:_SMALL_SCORE_TILE``).
SMALL_SCORE_TILE = 32_768
# Short sequences at this batch or above take K4 (``_FANOUT_MIN_BATCH``).
FANOUT_MIN_BATCH = 64

_IMPL = "auto"


def set_attention_impl(impl: str) -> None:
    """Set the switch: "auto", "pallas" (the hand-written kernels) or "xla"
    (the plain road, no kernel)."""
    global _IMPL
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown attention impl {impl!r}")
    _IMPL = impl


def get_attention_impl() -> str:
    return _IMPL


def _resolved_impl() -> str:
    """The road the switch selects: "pallas" (the kernels, launched on the
    card, their twins on the CPU) for "auto" and "pallas", else "xla"."""
    return "xla" if _IMPL == "xla" else "pallas"


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


def _attention_vjp(q, k, v, g, s_bias, mult=None):
    """The reference's XLA rematerialisation of attention's vjp (``_mha_bwd``,
    ``_bshd_bwd``, ``_fanout_bwd``) in the (B, H, S, D) layout: recompute
    the f32 probabilities with natural exp, then the four products. s_bias
    is the additive score bias (B, 1, 1, Sk) or None; mult a (B, 1, 1, Sk)
    multiplicative key mask applied after exp (K4) or None. Returns f32
    (dq, dk, dv)."""
    scale = 1.0 / q.shape[-1] ** 0.5
    q, k, v, g = (t.float() for t in (q, k, v, g))
    s = (q @ k.transpose(-1, -2)) * scale
    if s_bias is not None:
        s = s + s_bias
    if mult is None:
        p = torch.softmax(s, dim=-1)
    else:
        e = torch.exp(s - s.amax(-1, keepdim=True)) * mult
        p = e / torch.clamp_min(e.sum(-1, keepdim=True), 1e-30)
    dv = p.transpose(-1, -2) @ g
    dp = g @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return (ds @ k) * scale, (ds.transpose(-1, -2) @ q) * scale, dv


def _softmax_bwd(q, k, v, g, num_heads, s_bias, mult=None):
    """``_attention_vjp`` in the packed (B, S, H*D) layout (``_bshd_bwd`` /
    ``_fanout_bwd``), each gradient in its input's dtype."""
    grads = _attention_vjp(*(_heads(t, num_heads) for t in (q, k, v, g)), s_bias, mult)
    return tuple(d.transpose(1, 2).reshape(x.shape).to(x.dtype) for d, x in zip(grads, (q, k, v)))


# ---------------------------------------------------------------------------
# The (B, H, S, D) API: mha_reference, _mha_packed, K5 and mha
# ---------------------------------------------------------------------------


def _key_bias(kv_mask: torch.Tensor) -> torch.Tensor:
    """(B, Sk) True=valid -> the (B, 1, 1, Sk) f32 additive bias, 0 / -1e9."""
    return torch.where(kv_mask, 0.0, NEG_INF).float()[:, None, None, :]


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v: q (B, H, Sq, D), k/v (B, H, Sk, D),
    kv_mask (B, Sk) True=valid. Returns q.dtype; softmax in f32, the
    probabilities rounded to v.dtype before PV."""
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / q.shape[-1] ** 0.5)
    if kv_mask is not None:
        s = s + _key_bias(kv_mask)
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    return (probs.float() @ v.float()).to(q.dtype)


def _mha_packed(q, k, v, kv_mask):
    """Head-packed attention (``attention.py:_mha_packed``): one
    (H*Sq, H*Sk) score matrix per batch row with -1e9 off the same-head
    blocks. Plain tensor code; never chosen automatically."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    same_head = torch.block_diag(*[torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)] * H)
    s = (q.reshape(B, H * Sq, D).float() @ k.reshape(B, H * Sk, D).float().transpose(-1, -2))
    s = s * (1.0 / D**0.5) + torch.where(same_head, 0.0, NEG_INF).float()
    if kv_mask is not None:
        s = s + torch.where(kv_mask.repeat(1, H), 0.0, NEG_INF).float()[:, None, :]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return (p.float() @ v.reshape(B, H * Sk, D).float()).reshape(B, H, Sq, D).to(q.dtype)


def _mha_bhsd_plain(q, k, v, kv_mask) -> torch.Tensor:
    """K5's plain twin, with ``_mha_kernel``'s arithmetic: q prescaled by
    scale*log2(e) in f32 and rounded, an additive -1e9 bias on masked keys,
    exp2, the exponentials rounded to v.dtype for PV and the division by
    their f32 sum AFTER PV (``_attn_block_log2``, ``defer_div=True``)."""
    qs = (q.float() * _log2_scale(q.shape[-1])).to(q.dtype)
    s = qs.float() @ k.float().transpose(-1, -2)
    if kv_mask is not None:
        s = s + _key_bias(kv_mask)
    e = torch.exp2(s - s.amax(-1, keepdim=True))
    acc = e.to(v.dtype).float() @ v.float()
    return (acc / e.sum(-1, keepdim=True)).to(q.dtype)


def _span_strides(shape, stride) -> list:
    """The (batch, head, row) strides of a (B, H, S, D) operand with a
    dimension of size 1 given the span of the others: any stride reads its
    one index, and TMA takes only nonzero multiples of 16 bytes. A stride
    of 0 over several rows (a broadcast) stays 0."""
    if shape[0] > 1 and shape[1] > 1 and shape[2] > 1:
        return [stride[0], stride[1], stride[2]]
    span = max([shape[3]] + [stride[i] * shape[i] for i in range(3) if shape[i] > 1])
    return [span if shape[i] == 1 else stride[i] for i in range(3)]


def _spans(t: torch.Tensor) -> list:
    """``_span_strides`` of a (B, H, S, D) view."""
    return _span_strides(t.shape, t.stride())


# The CUDA-core and wide-head launchers (``attend``) take each operand as a
# spec: (tensor, element offset from its data pointer, (B, H, S, D) shape,
# (batch, head, row, column) strides). An entry names the heads inside its
# buffers this way without building views, which cost the host several
# microseconds each (PERF.md §6); a view is built only where a copy is.
def operand(t: torch.Tensor) -> tuple:
    """The spec of a (B, H, S, D) view."""
    return t, 0, t.shape, t.stride()


def operand_view(spec) -> torch.Tensor:
    """The (B, H, S, D) view a spec names."""
    t, off, shape, stride = spec
    return t.as_strided(shape, stride, t.storage_offset() + off)


def _ptr(spec) -> int:
    """The device address of a spec's first element."""
    return spec[0].data_ptr() + spec[1] * spec[0].element_size()


def _tma_ok(ptr: int, col_stride: int, st) -> bool:
    """Whether TMA reads a 16-bit operand in place at this address through
    (batch, head, row) strides st: columns packed, a 16-byte aligned base,
    strides multiples of 8 elements, the head and row strides nonzero (a
    batch stride of 0 is one row that every batch row reads)."""
    return col_stride == 1 and ptr % 16 == 0 and not (st[0] % 8 or st[1] % 8 or st[2] % 8) \
        and st[1] > 0 and st[2] > 0 and st[0] >= 0


def _bhsd_operand(t: torch.Tensor, what: str):
    """A (B, H, S, D) bf16 CUDA operand the tile kernels read in place
    (16-byte rows through its strides, ``_tma_ok``), copied only where its
    strides do not allow that; returns it with its (batch, head, row)
    strides (``_spans``). A broadcast (stride 0) batch is copied."""
    _native.require(t, what, contiguous=False)
    st = _spans(t)
    if not _tma_ok(t.data_ptr(), t.stride(3), st) or st[0] == 0:
        t = _native.aligned(t)
        st = _spans(t)
    return t, st


# Head widths the tensor-core tiles of K1/K2's core, K3 and K4 are built
# for: the multiples of 64 up to 256. The reference's gates (``D % 64 == 0``)
# have no upper bound; a wider bf16 head goes to the wide-head kernel.
TILE_HEAD_WIDTHS = (64, 128, 192, 256)
# The widest head either of the routes below takes: ViT-L's hidden width,
# the widest head a registered config can give.
SIMT_MAX_HEAD_WIDTH = 1024
# The f32 kernel (csrc/attn_simt.cu) computes a head's output in slices of
# at most this many columns, one slice a block (a head up to 64 wide in one
# slice of 64); the wide bf16 kernel (csrc/attn_wide.cu) in balanced slices
# of at most WIDE_SLICE columns, as many as a warpgroup's registers hold.
SIMT_SLICE = 128
WIDE_SLICE = 256


def attention_route(dtype: torch.dtype, head_dim: int, tensor_core_takes) -> Optional[str]:
    """The kernel an attention entry launches for operands of `dtype` at
    head width `head_dim`: "wgmma" (the entry's tensor-core kernel, bf16 at
    the widths `tensor_core_takes` names), "wide" (``csrc/attn_wide.cu``,
    tensor cores: bf16 from 257 to ``SIMT_MAX_HEAD_WIDTH``), "simt"
    (``csrc/attn_simt.cu``, CUDA cores: f32 at any width up to it), or None
    where no kernel takes them."""
    if head_dim != int(head_dim) or not 1 <= head_dim <= SIMT_MAX_HEAD_WIDTH:
        return None
    if dtype == torch.bfloat16:
        return "wgmma" if tensor_core_takes(head_dim) else "wide" if head_dim > 256 else None
    return "simt" if dtype == torch.float32 else None


def _route_or_raise(dtype, head_dim, tensor_core_takes, what, widths) -> str:
    route = attention_route(dtype, head_dim, tensor_core_takes)
    if route is None:
        raise ValueError(
            f"{what} takes head widths {widths} in bf16 (and above 256 up to {SIMT_MAX_HEAD_WIDTH} on the "
            f"wide-head kernel), and up to {SIMT_MAX_HEAD_WIDTH} in f32 on the CUDA-core kernel; "
            f"got {dtype} at D = {head_dim:g}"
        )
    return route


def simt_plan(problems, head_dim: int) -> list:
    """The f32 kernel's plan (``btia_attn_simt``) for problems of (q, k, v,
    o, mask, qscale) f32 operand specs (``operand``): [query rows a block, output
    columns a block, load path]. 32 rows where every problem's Sq <= 32 (the
    K1 sites at 32 question tokens), else 64; 64 columns for D <= 64, else
    ``SIMT_SLICE`` (a wider head splits over the grid); 16-byte copies
    (path 1) where every pointer is 16-byte aligned and every stride and D
    are multiples of 4 elements, else 4-byte copies (path 0)."""
    bq = 32 if all(p[0][2][2] <= 32 for p in problems) else 64
    slice_w = 64 if head_dim <= 64 else SIMT_SLICE
    specs = [x for p in problems for x in p[:4]]
    vec = head_dim % 4 == 0 and all(_ptr(x) % 16 == 0 and all(s % 4 == 0 for s in x[3][:3]) for x in specs)
    return [bq, slice_w, int(vec)]


@functools.lru_cache(maxsize=None)
def wide_plan(dw: int) -> tuple:
    """The wide kernel's plan (``btia_attn_wide``) for a head padded to `dw`
    columns: (slice width, slices). As few slices of at most ``WIDE_SLICE``
    columns as cover the head, each rounded up to a multiple of 64 (192 or
    256 above 256 columns): D 384 as 2 x 192, 512 as 2 x 256, 1024 as
    4 x 256. The slices are the blocks of one thread block cluster, block r
    owning columns [r * width, (r + 1) * width) (at most 4: 1024 / 256)."""
    n = -(-dw // WIDE_SLICE)
    return -(-dw // (64 * n)) * 64, n


def _key_masks(masks):
    """The problems' (B, Sk) key masks as the C entries read them, bool
    (read as bytes) or {0, 1} f32, packed, with their element size (1 or
    4; 4 where no problem has one). Returns (masks, element size)."""
    masks = [None if m is None else (m.contiguous() if m.dtype == torch.bool else m.to(torch.float32).contiguous())
             for m in masks]
    mask_bytes = {1 if m.dtype == torch.bool else 4 for m in masks if m is not None} or {4}
    if len(mask_bytes) != 1:
        raise ValueError("attention: the problems' key masks must share a dtype")
    return masks, mask_bytes.pop()


def simt_attention(problems, head_dim: int, mult_mask: bool) -> None:
    """Launch the f32 kernel (``csrc/attn_simt.cu``, CUDA cores) on one or two
    problems (K6's two directions), each ``(q, k, v, o, mask, qscale)``:
    f32 (B, H, S, D) operand specs (``operand``) read and written through
    their strides (o in place); a (B, Sk) key mask (bool, read as bytes, or {0, 1} f32) or
    None; the factor q is scaled by. ``mult_mask`` picks K1/K2/K4's mask
    (after exp2, a fully masked row gives 0) over K3/K5/K6's additive -1e9.
    Counts its launches in ``.launches``."""
    for p in problems:
        for x in p[:4]:
            _native.require(x[0], "CUDA-core attention", torch.float32, contiguous=False)
    problems = [(*(x if x[3][3] == 1 else operand(operand_view(x).contiguous()) for x in p[:3]), *p[3:])
                for p in problems]
    if any(p[3][3][3] != 1 for p in problems):
        raise ValueError("CUDA-core attention: the output's columns must be packed")
    args, (qs0, qs1), mask_bytes, keep, _ = attend_args(problems)
    plan = simt_plan(problems, head_dim)
    _native.check(
        _native.lib().btia_attn_simt(args, len(problems), qs0, qs1, head_dim, mask_bytes, int(mult_mask),
                                     (ctypes.c_int * 3)(*plan), _native.stream(keep[0])),
        "btia_attn_simt",
    )
    simt_attention.launches += 1


simt_attention.launches = 0


def _wide_read(x, dw: int):
    """(tensor, pointer, (batch, head, row) strides) through which the wide
    kernel's TMA reads the bf16 operand spec x: in place where it can
    (``_tma_ok``, D == dw; a dimension of size 1 takes ``_span_strides``; a
    batch stride of 0, one row that every batch row reads as K2's query
    table, is kept), else from one packed copy, D zero-padded to dw (where
    D % 8: TMA rows are 16-byte multiples)."""
    t, _, shape, stride = x
    ptr, st = _ptr(x), _span_strides(shape, stride)
    if shape[3] == dw and _tma_ok(ptr, stride[3], st):
        return t, ptr, st
    t = operand_view(x)
    if shape[3] != dw:
        t = torch.nn.functional.pad(t, (0, dw - shape[3]))
    t = _native.aligned(t)
    return t, t.data_ptr(), _spans(t)


# The argument array of the f32 and wide kernels (csrc/attn_simt.cu and
# csrc/attn_wide.cu): int64 a problem, the device pointers of q, k, v, o and
# the key mask (0: none), the (batch, head, row) strides of q, k, v and o,
# and B, H, Sq, Sk.
ATTEND_ARGS = 21


def attend_args(problems, dw: Optional[int] = None):
    """The f32 (dw None: operands as they lie) or wide kernel's (dw its
    padded head width: q, k, v by ``_wide_read``) arguments from (q, k, v, o,
    mask, qscale) problems of operand specs (``operand``), in one pass: the
    int64 array (``ATTEND_ARGS`` a problem), the two q scales, the masks'
    element size (``_key_masks``), the tensors that must outlive the launch,
    and the (o, buffer) pairs whose padded buffer the wide kernel writes in
    o's place (o's rows not 16-byte aligned, or D != dw) to be copied back."""
    masks, mask_bytes = _key_masks([p[4] for p in problems])
    vals, keep, copies = [], [], []
    for (q, k, v, o, _, _), mask in zip(problems, masks):
        if dw is None:
            reads = [(x[0], _ptr(x), x[3][:3]) for x in (q, k, v, o)]
        else:
            reads = [_wide_read(x, dw) for x in (q, k, v)]
            out, _, shape, stride = o
            ptr, st = _ptr(o), _span_strides(shape, stride)
            if shape[3] != dw or not _tma_ok(ptr, stride[3], st):
                out = torch.empty((*shape[:3], dw), dtype=out.dtype, device=out.device)
                ptr, st = out.data_ptr(), _spans(out)
                copies.append((o, out))
            reads.append((out, ptr, st))
        keep += [r[0] for r in reads] + [mask]
        vals += [r[1] for r in reads] + [0 if mask is None else mask.data_ptr()]
        for r in reads:
            vals += r[2]
        vals += [*q[2][:3], k[2][2]]
    scales = [p[5] for p in problems] + [1.0]
    return (ctypes.c_longlong * len(vals))(*vals), scales[:2], mask_bytes, keep, copies


def wide_attention(problems, head_dim: int, mult_mask: bool) -> None:
    """Launch the wide-head kernel (``csrc/attn_wide.cu``, tensor cores,
    a thread block cluster an item) on one or two problems as
    ``simt_attention`` takes them, bf16 at head widths of 257 to 1024: q, k
    and v read in place where TMA can (``_wide_read``), o written in place
    where its rows are 16-byte aligned, else through one padded buffer. The
    callers have checked that the operands are bf16 CUDA tensors; the C
    entry refuses the pointers and strides it cannot read. Counts its
    launches in ``.launches``."""
    dw = _round8(head_dim)
    args, (qs0, qs1), mask_bytes, keep, copies = attend_args(problems, dw)
    sw, n = wide_plan(dw)
    _native.check(
        _native.lib().btia_attn_wide(args, len(problems), qs0, qs1, dw, sw, n, mask_bytes, int(mult_mask),
                                     _native.stream(keep[0])),
        "btia_attn_wide",
    )
    for o, out in copies:
        operand_view(o).copy_(out[..., :head_dim])
    wide_attention.launches += 1


wide_attention.launches = 0


def attend(route: str, problems, head_dim: int, mult_mask: bool) -> None:
    """``simt_attention`` (route "simt") or ``wide_attention`` ("wide") on
    (q, k, v, o, mask, qscale) problems of operand specs (``operand``)."""
    (simt_attention if route == "simt" else wide_attention)(problems, head_dim, mult_mask)


def _attend_bshd(route, q, k, v, mask, num_heads, qscale, mult_mask, what):
    """K3 and K4 on the f32 or wide-head kernel: (B, S, H*D) q, k, v read
    as (B, H, S, D) operands; the output packed (B, Sq, H*D)."""
    for t in (q, k, v):  # the route took q's dtype
        _native.require(t, what, q.dtype, contiguous=False)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    D = q.shape[2] // num_heads

    def heads(t):  # the spec of t.unflatten(2, (H, D)).transpose(1, 2)
        sb, ss, sc = t.stride()
        return t, 0, (t.shape[0], num_heads, t.shape[1], D), (sb, D * sc, ss, sc)

    attend(route, [(heads(q), heads(k), heads(v), heads(out), mask, qscale)], D, mult_mask)
    return out


# Q rows of one work item of K3/K5's persistent kernel (csrc/flash_bshd.cu,
# head widths padded to 64 or 128), and of one block of its first design
# (DP 192: 128, DP 256: 64).
FLASH_ITEM_ROWS = 128


@functools.lru_cache(maxsize=256)
def flash_plan(B: int, H: int, Sq: int, dw: int) -> tuple:
    """(items, grid) of K3/K5's kernel for B x H heads of dw columns and Sq
    query rows. At a padded width DP = 64 or 128 the persistent kernel's
    work items are (128-row q tile, head, batch), numbered with the q tile
    fastest, and its grid one block an SM up to one an item: block i takes
    items i, i + grid, i + 2 grid, ... At DP 192 and 256 one block a q tile
    of 128 or 64 rows: grid = items."""
    dp = -(-dw // 64) * 64
    rows = FLASH_ITEM_ROWS if dp <= 192 else 64
    items = -(-Sq // rows) * H * B
    return items, (min(items, H100_SMS) if dp <= 128 else items)


def key_mask_arg(kv_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A (B, Sk) key mask (True / nonzero = a real key) as the tile kernels
    read it, one byte a key: a bool mask as it lies (no copy once
    contiguous), any other as ``kv_mask != 0``; None for no mask."""
    if kv_mask is None:
        return None
    return (kv_mask if kv_mask.dtype == torch.bool else kv_mask != 0).contiguous()


def k3_takes(head_dim: int) -> bool:
    """Whether K3's tensor-core (bf16) kernel is built for this head width."""
    return head_dim in TILE_HEAD_WIDTHS


def k4_takes(head_dim: int) -> bool:
    """Whether K4's tensor-core (bf16) kernel is built for this head width."""
    return head_dim in TILE_HEAD_WIDTHS


# K5's widest head on the tensor cores: the kernel's four templates pad D to
# 64, 128, 192 or 256 in shared memory. The reference pads any width; a
# wider bf16 head takes the wide-head kernel.
K5_MAX_HEAD_WIDTH = 256


def k5_takes(head_dim: int) -> bool:
    """Whether K5's tensor-core (bf16) kernel takes this head width: every width up to
    256 (one not a multiple of 8 through a padded copy)."""
    return 1 <= head_dim <= K5_MAX_HEAD_WIDTH


def _mha_bhsd_cuda(q, k, v, kv_mask) -> torch.Tensor:
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    route = _route_or_raise(q.dtype, D, k5_takes, "K5 kernel", f"up to {K5_MAX_HEAD_WIDTH}")
    if min(B, Sq, Sk) == 0:
        raise ValueError(f"K5 kernel takes B, Sq, Sk >= 1, got {(B, Sq, Sk)}")
    if route != "wgmma":
        for t in (q, k, v):  # the route took q's dtype
            _native.require(t, "mha_bhsd_attention", q.dtype, contiguous=False)
        out = torch.empty_like(q if q.stride(3) == 1 else q.contiguous())
        attend(route, [(*map(operand, (q, k, v, out)), kv_mask, _log2_scale(D))], D, mult_mask=False)
        return out
    dw = -(-D // 8) * 8
    if dw != D:
        # TMA reads rows of 16-byte multiples: one zero-padded copy, the
        # reference's own pad of D in device memory (_mha_pallas).
        q, k, v = (torch.nn.functional.pad(t, (0, dw - D)) for t in (q, k, v))
    ops = [_bhsd_operand(t, f"mha_bhsd_attention {n}") for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    # The output takes q's layout: for mha_bshd's views, a (B, S, H, D) buffer.
    out, st_o = _bhsd_operand(torch.empty_like(ops[0][0]), "mha_bhsd_attention out")
    strides = (ctypes.c_longlong * 12)(*(s for _, st in ops for s in st), *st_o)
    mask = key_mask_arg(kv_mask)
    _native.check(
        _native.lib().btia_mha_bhsd(
            *(t.data_ptr() for t, _ in ops), None if mask is None else mask.data_ptr(),
            out.data_ptr(), strides, B, H, Sq, Sk, dw, _log2_scale(D), flash_plan(B, H, Sq, dw)[1],
            _native.stream(q),
        ),
        "btia_mha_bhsd",
    )
    return out if dw == D else out[..., :D]


class _Mha(torch.autograd.Function):
    """``_mha``: K5 (or its twin) when ``use_kernel``, else ``mha_reference``;
    the backward is ``_mha_bwd`` (``_attention_vjp``) either way."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, use_kernel):
        ctx.save_for_backward(q, k, v, kv_mask)
        if use_kernel:
            return _native.route(mha_bhsd_attention, q, _mha_bhsd_cuda, _mha_bhsd_plain,
                                 q, k, v, kv_mask)
        return mha_reference(q, k, v, kv_mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask = ctx.saved_tensors
        grads = _attention_vjp(q, k, v, g, None if kv_mask is None else _key_bias(kv_mask))
        return (*(d.to(x.dtype) for d, x in zip(grads, (q, k, v))), None, None)


def mha_bhsd_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K5: q (B, H, Sq, D), k/v (B, H, Sk, D) in any strides with D packed,
    kv_mask (B, Sk) True=valid; on the card bf16 D up to 256 on the tensor
    cores (``k5_takes``), bf16 heads of 257-1024 on the wide-head kernel and
    f32 up to 1024 on the CUDA-core kernel (``attention_route``).

    A CUDA tensor launches the kernel (counted in ``.launches``) or raises;
    a CPU tensor takes the plain twin. A row whose every key is masked
    averages V over the Sk keys (as ``mha_reference``)."""
    return _Mha.apply(q, k, v, kv_mask, True)


mha_bhsd_attention.launches = 0


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Multi-head attention: q (B, H, Sq, D), k/v (B, H, Sk, D), kv_mask
    (B, Sk) True=valid. impl: "pallas" (K5, the hand-written kernel), "xla",
    "packed", or None: the switch, with score tiles of at most
    ``SMALL_SCORE_TILE`` on the plain road."""
    if impl is None:
        impl = _resolved_impl()
        if impl == "pallas" and q.shape[2] * k.shape[2] <= SMALL_SCORE_TILE:
            impl = "xla"
    if impl == "packed":
        return _mha_packed(q, k, v, kv_mask)
    return _Mha.apply(q, k, v, kv_mask, impl == "pallas")


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
        s = s + _key_bias(kv_mask)
    e = torch.exp2(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(v.dtype)
    out = p.float() @ _heads(v, num_heads)
    return out.transpose(1, 2).reshape(B, Sq, HD).to(q.dtype)


def _bshd_flash_cuda(q, k, v, kv_mask, num_heads: int) -> torch.Tensor:
    B, Sq, HD = q.shape
    Sk = k.shape[1]
    D = HD // num_heads
    route = _route_or_raise(q.dtype, HD / num_heads, k3_takes,
                            "K3 kernel", TILE_HEAD_WIDTHS)
    if Sq == 0 or Sk == 0 or B == 0:
        raise ValueError(f"K3 kernel takes B, Sq, Sk >= 1, got {(B, Sq, Sk)}")
    if route != "wgmma":
        return _attend_bshd(route, q, k, v, kv_mask, num_heads, _log2_scale(D), False, "bshd_flash_attention")
    q, k, v = _native.aligned(q), _native.aligned(k), _native.aligned(v)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _native.require(t, f"bshd_flash_attention {name}")
    mask = key_mask_arg(kv_mask)
    out = torch.empty_like(q)
    _native.check(
        _native.lib().btia_flash_bshd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, num_heads, D, Sq, Sk, _log2_scale(D), flash_plan(B, num_heads, Sq, D)[1], _native.stream(q),
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
        bias = None if kv_mask is None else _key_bias(kv_mask)
        dq, dk, dv = _softmax_bwd(q, k, v, g, ctx.num_heads, bias)
        return dq, dk, dv, None, None


def bshd_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    num_heads: int,
) -> torch.Tensor:
    """K3: q (B, Sq, H*D), k/v (B, Sk, H*D), kv_mask (B, Sk) True=valid; on
    the card bf16 D in ``TILE_HEAD_WIDTHS`` on the tensor cores
    (``k3_takes``), bf16 heads of 257-1024 on the wide-head kernel, f32 up to
    1024 on the CUDA-core kernel.

    A CUDA tensor launches the kernel (counted in ``.launches``) or raises;
    a CPU tensor takes the plain twin."""
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


def fanout_strides(x: torch.Tensor, num_heads: int) -> list:
    """The (batch, head, row) strides, in elements, under which a packed
    (B, S, H*D) tensor reads as its (B, H, S, D) view: (S*H*D, D, H*D). K4
    hands these to its kernel, so no transpose is copied."""
    B, S, HD = x.shape
    return [S * HD, HD // num_heads, HD]


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def short_plan(shapes, head_dim: int, pack: bool = True) -> list:
    """Plan the work items of the short-sequence kernel (K4 and K6,
    ``csrc/short_flash.cuh``) for one or two problems, each (B, H, Sq, Sk),
    at head width ``head_dim`` (a multiple of 8 up to 256). Returns
    ``[bn, pack, q_span, k_span, groups, q_tiles, ...]``: the key tile bn
    (32 or 64 keys), then per problem the batch rows packed into one 64-row
    tile, the tile rows and keys each of them takes (64 and bn when not
    packed), ceil(B / pack) and ceil(Sq / 64) (1 when packed).

    The key tile is 32 keys, or 64 where every problem can pack two or more
    batch rows (Sq <= 32 and Sk <= 32); rows longer than the tile loop over
    key tiles (on an H100 the 32-key tile ran faster than one that held 82,
    197 or 577 keys). A problem with Sq <= 32 packs as many batch rows as fit
    both 64 query rows and bn keys (the TPU kernel's bb packing), each at a
    multiple of 8 rows (TMA's 128-byte swizzle repeats every 8 rows);
    ``pack=False`` keeps one batch row a tile."""
    bn = 64 if pack and all(sq <= 32 and sk <= 32 and b > 1 for b, _, sq, sk in shapes) else 32
    plan = [bn]
    for B, _, Sq, Sk in shapes:
        p = min(64 // _round8(Sq), bn // _round8(Sk), B) if pack and Sq <= 32 else 1
        if p > 1:
            plan += [p, _round8(Sq), _round8(Sk), -(-B // p), 1]
        else:
            plan += [1, 64, bn, B, -(-Sq // 64)]
    return plan


def short_items(shapes, plan) -> list:
    """The (b, h, q row) triples that each problem's items store, in the
    kernel's order (``sf_decode`` in ``csrc/short_flash.cuh``): one (N, 3)
    int64 tensor per problem. The CPU tests hold it to cover each row of
    each problem exactly once."""
    out = []
    for p, (B, H, Sq, _) in enumerate(shapes):
        pack, q_span, _, groups, q_tiles = plan[1 + 5 * p: 6 + 5 * p]
        it = torch.arange(groups * H * q_tiles)
        q0 = (it % q_tiles) * 64
        h = (it // q_tiles) % H
        b0 = (it // q_tiles // H) * pack
        r = torch.arange(64)
        jr = r // q_span if pack > 1 else torch.zeros_like(r)
        b, q = b0[:, None] + jr[None], q0[:, None] + (r - jr * q_span)[None]
        keep = (jr[None] < pack) & (b < B) & (q < Sq)
        out.append(torch.stack([b[keep], h[:, None].expand_as(b)[keep], q[keep]], 1))
    return out


def _fanout_cuda(q, k, v, colmask, num_heads: int, pack: bool = True) -> torch.Tensor:
    B, Sq, HD = q.shape
    Sk = k.shape[1]
    D = HD // num_heads
    route = _route_or_raise(q.dtype, HD / num_heads, k4_takes,
                            "K4 kernel", TILE_HEAD_WIDTHS)
    if min(B, Sq, Sk) == 0:
        raise ValueError(f"K4 kernel takes B, Sq, Sk >= 1, got {(B, Sq, Sk)}")
    if route != "wgmma":
        return _attend_bshd(route, q, k, v, colmask.to(torch.float32), num_heads, _log2_scale(D), True,
                            "fanout_attention")
    q, k, v = _native.aligned(q), _native.aligned(k), _native.aligned(v)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _native.require(t, f"fanout_attention {name}")
    cm = colmask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in fanout_strides(t, num_heads)))
    plan = short_plan([(B, num_heads, Sq, Sk)], D, pack)
    _native.check(
        _native.lib().btia_fanout(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cm.data_ptr(), out.data_ptr(), strides,
            (ctypes.c_int * len(plan))(*plan), B, num_heads, Sq, Sk, D, _log2_scale(D), _native.stream(q),
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
    """K4: q (B, Sq, H*D), k/v (B, Sk, H*D), colmask (B, Sk) f32 {0, 1}; on
    the card bf16 D in ``TILE_HEAD_WIDTHS`` on the tensor cores
    (``k4_takes``), bf16 heads of 257-1024 on the wide-head kernel, f32 up to
    1024 on the CUDA-core kernel.

    A fully masked row gives 0. A CUDA tensor launches the kernel (counted
    in ``.launches``) or raises; a CPU tensor takes the plain twin."""
    return _Fanout.apply(q, k, v, colmask, num_heads)


fanout_attention.launches = 0


def mha_bshd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over (B, S, H, Dh) tensors; kv_mask (B, Sk) True=valid.
    The roads are the reference's (``attention.py:767-812``)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    flat = lambda x, S: x.reshape(B, S, H * D)
    t = lambda x: x.transpose(1, 2)  # (B, S, H, D) <-> (B, H, S, D), a view
    kernels = _resolved_impl() == "pallas"
    if kernels and Sq * Sk > SMALL_SCORE_TILE:
        if D % 64 == 0 and (H * D) % 128 == 0:
            out = bshd_flash_attention(flat(q, Sq), flat(k, Sk), flat(v, Sk), kv_mask, H)
            return out.reshape(B, Sq, H, D)
        return t(mha_bhsd_attention(t(q), t(k), t(v), kv_mask))  # K5 reads the views in place
    if kernels and B >= FANOUT_MIN_BATCH and D % 64 == 0:
        cm = (kv_mask.to(torch.float32) if kv_mask is not None
              else torch.ones((B, Sk), dtype=torch.float32, device=q.device))
        out = fanout_attention(flat(q, Sq), flat(k, Sk), flat(v, Sk), cm, H)
        return out.reshape(B, Sq, H, D)
    return t(mha_reference(t(q), t(k), t(v), kv_mask))
