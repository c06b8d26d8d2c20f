"""LayerNorm with the reference's fast-variance formula, and K7.

The port of ``btia_tpu/ops/norms.py``. The formula is the reference's
``_ln_exact``: f32 statistics, var = max(0, E[x^2] - E[x]^2), rsqrt — the
one flax's ``nn.LayerNorm`` uses (``use_fast_variance=True``).
``F.layer_norm`` computes the variance in two passes and would not round the
same way, so it is not used.

K7, the single-pass row kernel (``_ln_kernel`` behind ``_layernorm_pallas``
and the custom_vjp ``_layernorm_fast``), is ``csrc/layernorm.cu``, with a
backward kernel for that custom_vjp's backward (the vjp of ``_ln_exact``,
``_layernorm_fast_bwd``). Two entries reach the forward, each with its own
launch count: ``layernorm``, which every LayerNorm of the models calls, and
``layernorm_fast``, the ops API's. Their backward is ``layernorm_backward``,
counted apart. On a CUDA tensor each launches its kernel or raises; on a CPU
tensor each is its plain twin: ``_ln_exact`` (the TPU kernel computes the
same arithmetic) and ``_ln_exact_vjp``. The reference's ``layernorm``
ignores ``fast`` and keeps the plain formula on every device: there XLA
fuses it into one pass over each row. Eager PyTorch runs it as a chain of
about a dozen f32 passes over device memory (its vjp about two dozen), so
on the card the model's LayerNorms go to K7.
"""

from __future__ import annotations

import torch

from btia_tpu_torch.ops import _native


def _ln_exact(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    mean2 = (x32 * x32).mean(-1, keepdim=True)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def layernorm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-6,
    fast: bool = False,
) -> torch.Tensor:
    """Normalize over the last axis in f32. Returns x.dtype.

    A CUDA tensor launches K7 (counted in ``.launches``) or raises; a CPU
    tensor takes ``_ln_exact``. ``fast`` is accepted and ignored, as in the
    reference: the device decides."""
    del fast
    return _native.route(layernorm, x, _LayerNormFast.apply, _ln_exact, x, scale, bias, eps)


layernorm.launches = 0


# ---------------------------------------------------------------------------
# K7: single-pass row LayerNorm (``_ln_kernel``)
# ---------------------------------------------------------------------------

_LN_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _f32(t: torch.Tensor) -> torch.Tensor:
    """t as the f32 contiguous vector the kernels read: t itself if it is."""
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()


def _ln_dtype(x: torch.Tensor) -> int:
    D = x.shape[-1]
    elem = _LN_DTYPES.get(x.dtype)
    if elem is None or D < 1:
        raise ValueError(f"K7 kernel takes bf16 or f32 rows of width 1 or more, got {x.dtype} width {D}")
    return elem


def _layernorm_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                    out: torch.Tensor = None) -> torch.Tensor:
    """Launch K7 over the rows of x's last axis, at any width; `out`, if
    given, is a contiguous tensor of x's shape and may be x (in place).
    Counts nothing: its entries count their own launches, and K1's prologue
    and post-LN launch this as part of K1's chain."""
    elem = _ln_dtype(x)
    x = x.contiguous()
    _native.require(x, "layernorm x", x.dtype)
    out = torch.empty_like(x) if out is None else out
    D = x.shape[-1]
    M = x.numel() // D
    if M:
        scale, bias = _f32(scale), _f32(bias)  # held until the call has read them
        _native.check(
            _native.lib().btia_layernorm(x.data_ptr(), out.data_ptr(), scale.data_ptr(), bias.data_ptr(), M, D,
                                         eps, elem, _native.stream(x)),
            "btia_layernorm",
        )
    return out


def _layernorm_bwd_cuda(x, scale, bias, g, eps, needs=(True, True, True)):
    """Launch K7's backward kernel: (dx, dscale, dbias) of ``_ln_exact`` at
    (x, scale, bias) for the gradient g of its output, each None unless
    `needs` asks for it. dscale and dbias, both or neither, come from the
    kernel's partial rows (one f32 row of dscale and dbias sums for each
    block of its row kernel, as many as ``btia_layernorm_bwd_parts`` says)
    and its column kernel; bias is not read."""
    elem = _ln_dtype(x)
    x, g = x.contiguous(), g.contiguous()
    _native.require(x, "layernorm_backward x", x.dtype)
    _native.require(g, "layernorm_backward g", x.dtype)
    D = x.shape[-1]
    M = x.numel() // D
    dx = torch.empty_like(x) if needs[0] else None
    params = needs[1] or needs[2]
    f32 = dict(dtype=torch.float32, device=x.device)
    ds, db = (torch.empty(D, **f32), torch.empty(D, **f32)) if params else (None, None)
    if M:
        sc, lib = _f32(scale), _native.lib()
        ptr = lambda t: None if t is None else t.data_ptr()
        rows = lib.btia_layernorm_bwd_parts(x.data_ptr(), g.data_ptr(), sc.data_ptr(), ptr(dx), M, D, elem) \
            if params else 0
        part = torch.empty(rows, 2 * D, **f32) if params else None
        _native.check(
            lib.btia_layernorm_bwd(x.data_ptr(), g.data_ptr(), sc.data_ptr(), ptr(dx), ptr(ds), ptr(db), ptr(part),
                                   rows, M, D, eps, elem, _native.stream(x)),
            "btia_layernorm_bwd",
        )
    elif params:
        ds.zero_()
        db.zero_()
    # No .to() where the type already matches: a dispatch each, in host-bound train steps.
    cast = lambda t, like: t if t.dtype == like.dtype else t.to(like.dtype)
    return (dx, cast(ds, scale) if needs[1] else None, cast(db, bias) if needs[2] else None)


def _ln_exact_vjp(x, scale, bias, g, eps, needs=(True, True, True)):
    """The backward kernel's plain twin: the vjp of ``_ln_exact`` through
    autograd (the reference's ``_layernorm_fast_bwd``), (dx, dscale, dbias),
    each None unless `needs` asks for it."""
    leaves = [t.detach().requires_grad_(need) for t, need in zip((x, scale, bias), needs)]
    wanted = [t for t in leaves if t.requires_grad]
    if not wanted:
        return (None, None, None)
    with torch.enable_grad():
        grads = iter(torch.autograd.grad(_ln_exact(*leaves, eps), wanted, g))
    return tuple(next(grads) if t.requires_grad else None for t in leaves)


def layernorm_backward(x, scale, bias, g, eps=1e-6, needs=(True, True, True)):
    """K7's backward, (dx, dscale, dbias) for the gradient g of K7's output
    at (x, scale, bias), each None unless `needs` asks for it. A CUDA tensor
    launches the backward kernel (counted in ``.launches``) or raises; a CPU
    tensor takes ``_ln_exact_vjp``."""
    return _native.route(layernorm_backward, x, _layernorm_bwd_cuda, _ln_exact_vjp, x, scale, bias, g, eps, needs)


layernorm_backward.launches = 0


class _LayerNormFast(torch.autograd.Function):
    """K7: the forward kernel; the backward ``layernorm_backward`` (the
    backward kernel on the card, the vjp of ``_ln_exact`` on the CPU)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _layernorm_cuda(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        return (*layernorm_backward(x, scale, bias, g, ctx.eps, tuple(ctx.needs_input_grad[:3])), None)


def layernorm_fast(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """K7 through the ops API: LayerNorm over the last axis in one pass over
    each row (bf16 or f32 in, the same out; f32 statistics). A CUDA tensor
    launches the kernel (counted in ``.launches``) or raises; a CPU tensor
    takes the plain twin."""
    return _native.route(layernorm_fast, x, _LayerNormFast.apply, _ln_exact, x, scale, bias, eps)


layernorm_fast.launches = 0
