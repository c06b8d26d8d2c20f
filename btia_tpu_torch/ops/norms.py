"""LayerNorm with the reference's fast-variance formula, and K7.

The port of ``btia_tpu/ops/norms.py``. The formula is the reference's
``_ln_exact``: f32 statistics, var = max(0, E[x^2] - E[x]^2), rsqrt — the
one flax's ``nn.LayerNorm`` uses (``use_fast_variance=True``).
``F.layer_norm`` computes the variance in two passes and would not round the
same way, so it is not used.

K7, the single-pass row kernel (``_ln_kernel`` behind ``_layernorm_pallas``
and the custom_vjp ``_layernorm_fast``), is ``csrc/layernorm.cu``. Two
entries reach it, each with its own launch count: ``layernorm``, which
every LayerNorm of the models calls, and ``layernorm_fast``, the ops API's.
On a CUDA tensor each launches K7 (its backward the vjp of ``_ln_exact``, as
the reference's ``_layernorm_fast_bwd``) or raises; on a CPU tensor each is
``_ln_exact`` itself, the kernel's plain twin (the TPU kernel computes the
same arithmetic). The reference's ``layernorm`` ignores ``fast`` and keeps
the plain formula on every device: there XLA fuses it into one pass over
each row. Eager PyTorch runs it as a chain of about a dozen f32 passes over
device memory, so on the card the model's LayerNorms go to K7.
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


def _layernorm_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                    out: torch.Tensor = None) -> torch.Tensor:
    """Launch K7 over the rows of x's last axis, at any width; `out`, if
    given, is a contiguous tensor of x's shape and may be x (in place).
    Counts nothing: its entries count their own launches, and K1's prologue
    and post-LN launch this as part of K1's chain."""
    D = x.shape[-1]
    if x.dtype not in _LN_DTYPES or D < 1:
        raise ValueError(f"K7 kernel takes bf16 or f32 rows of width 1 or more, got {x.dtype} width {D}")
    x = x.contiguous()
    _native.require(x, "layernorm x", x.dtype)
    out = torch.empty_like(x) if out is None else out
    if x.numel() == 0:
        return out
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    _native.check(
        _native.lib().btia_layernorm(
            x.data_ptr(), out.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            x.numel() // D, D, float(eps), _LN_DTYPES[x.dtype], _native.stream(x),
        ),
        "btia_layernorm",
    )
    return out


class _LayerNormFast(torch.autograd.Function):
    """K7 forward; backward the vjp of ``_ln_exact`` (``_layernorm_fast_bwd``)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _layernorm_cuda(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip((x, scale, bias), ctx.needs_input_grad)]
        with torch.enable_grad():
            out = _ln_exact(*leaves, ctx.eps)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in leaves), None)


def layernorm_fast(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """K7 through the ops API: LayerNorm over the last axis in one pass over
    each row (bf16 or f32 in, the same out; f32 statistics). A CUDA tensor
    launches the kernel (counted in ``.launches``) or raises; a CPU tensor
    takes the plain twin."""
    return _native.route(layernorm_fast, x, _LayerNormFast.apply, _ln_exact, x, scale, bias, eps)


layernorm_fast.launches = 0
