"""Int8 matrix products for quantized serving (the port of
``btia_tpu/ops/quant.py``).

Dynamic per-row activation quantization times static per-output-column
weight quantization, symmetric, round half to even:

  quantize_weight:    fp32 (in, out) kernel -> (int8 kernel, scale (out,))
  quantize_activation: (..., in) -> (int8, scale (..., 1))
  int8_matmul:        the unfused form, rescaled to ``out_dtype``
  int8_matmul_fused:  K8: per-row quantization of x, int8 x int8 -> int32,
                      rescale, bias and an optional tanh-GELU, as two
                      kernels behind one entry (``csrc/int8_mm.cu``: the
                      row quantization, then the int8 wgmma GEMM)

``int8_matmul_fused`` takes ``act`` by name (None or ``"gelu_tanh"``), since
the kernel applies it in its epilogue; the reference takes a callable.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from btia_tpu_torch.ops import _native

ACTS = (None, "gelu_tanh")


def apply_act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The activation named `act` (None or ``"gelu_tanh"``), in y's dtype."""
    if act is None:
        return y
    if act == "gelu_tanh":
        return F.gelu(y, approximate="tanh")
    raise ValueError(f"act must be one of {ACTS}, got {act!r}")


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8. w: (in, out) -> (w_i8, scale (out,))."""
    wf = w.float()
    scale = torch.clamp_min(wf.abs().amax(dim=0), 1e-8) / 127.0
    return torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8), scale


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (token) symmetric int8. x: (..., in) -> (x_i8, scale (..., 1))."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-8) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def _int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8-valued operands, rounded once to f32:
    every partial sum is an integer of magnitude at most K * 127^2, far
    below 2^53, so a float64 product is exact on either device (the CUDA
    kernel's int32 sum is exact for K < 2^31 / 127^2 = 133,144)."""
    return (a.double() @ b.double()).float()


def int8_matmul(x: torch.Tensor, w_i8: torch.Tensor, w_scale: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (..., in) @ dequant(w_i8 (in, out)) with dynamic activation quant."""
    x_i8, x_scale = quantize_activation(x)
    return (_int_product(x_i8, w_i8) * x_scale * w_scale).to(out_dtype)


def int8_matmul_fused_reference(x, w_i8, w_scale, bias=None, act: Optional[str] = None,
                                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain oracle of the fused kernel (``quant.py:194``): the
    activation divided by its scale and clipped."""
    x_i8, x_scale = quantize_activation(x)
    y = _int_product(x_i8, w_i8) * x_scale * w_scale
    if bias is not None:
        y = y + bias.float()
    return apply_act(y, act).to(out_dtype)


def quantization_error(w: torch.Tensor) -> float:
    """Max relative reconstruction error of per-channel int8 for a weight."""
    w_i8, s = quantize_weight(w)
    wf = w.float()
    return float((w_i8.float() * s - wf).abs().max() / torch.clamp_min(wf.abs().max(), 1e-8))


# ---------------------------------------------------------------------------
# K8: the fused int8 matrix product (``_int8_mm_kernel``)
# ---------------------------------------------------------------------------


def _int8_mm_plain(x, w_i8, w_scale, bias, act, out_dtype) -> torch.Tensor:
    """K8's plain twin, with ``_int8_mm_kernel``'s arithmetic, which is not
    the oracle's at rounding ties: sx = max(amax, 1e-8) * f32(1/127), then
    round-half-even(x * (1/sx)) with no clip; the exact int32 product; then
    (acc * sx) * ws + b in f32, the activation in f32, and one cast."""
    xf = x.float()
    sx = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-8) * (1.0 / 127.0)
    xi = torch.round(xf * torch.reciprocal(sx))
    y = _int_product(xi, w_i8) * sx * w_scale.float().reshape(1, -1)
    if bias is not None:
        y = y + bias.float().reshape(1, -1)
    return apply_act(y, act).to(out_dtype)


def _quantize_rows_plain(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first half of K8's twin (``quant_rows_kernel``): x (M, K) ->
    (xi (M, K) int8, sx (M,) f32), the arithmetic of ``_int8_mm_plain``.
    |x * (1/sx)| <= 127 up to four f32 roundings, so no value rounds past
    127 and the int8 cast is exact."""
    xf = x.float()
    sx = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) * (1.0 / 127.0)
    xi = torch.round(xf * torch.reciprocal(sx)[:, None])
    return xi.to(torch.int8), sx


def _int8_gemm_plain(xi, sx, w_i8, w_scale, bias, act, out_dtype) -> torch.Tensor:
    """The second half of K8's twin (``int8_gemm_kernel``): the exact
    integer product of xi (M, K) int8 and w_i8 (K, N), then (acc * sx) * ws
    + b in f32, the activation in f32, one cast."""
    y = _int_product(xi, w_i8) * sx.float()[:, None] * w_scale.float().reshape(1, -1)
    if bias is not None:
        y = y + bias.float().reshape(1, -1)
    return apply_act(y, act).to(out_dtype)


_OUT = {torch.bfloat16: 0, torch.float32: 1}


def _quantize_rows_cuda(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's first kernel: x (M, K) bf16 -> (xi (M, K) int8, sx (M,) f32),
    into scratch allocated here."""
    M, K = x.shape
    if K % 16 or M == 0:
        raise ValueError(f"K8 kernel takes K % 16 == 0 and M >= 1, got {(M, K)}")
    x = _native.aligned(x)
    _native.require(x, "int8_matmul_fused x")
    xi = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    _native.check(
        _native.lib().btia_int8_quant_rows(x.data_ptr(), xi.data_ptr(), sx.data_ptr(), M, K, _native.stream(x)),
        "btia_int8_quant_rows",
    )
    return xi, sx


def _int8_gemm_cuda(xi, sx, w_nk, w_scale, bias, act, out_dtype) -> torch.Tensor:
    """K8's second kernel: xi (M, K) int8 and sx (M,) from
    ``_quantize_rows_cuda``, the weight as its (N, K) copy w_nk."""
    M, K = xi.shape
    N = w_nk.shape[0]
    if K % 16 or M == 0 or N == 0 or w_nk.shape[1] != K:
        raise ValueError(f"K8 kernel takes K % 16 == 0 and M, N >= 1, got {(M, K, N)}")
    if out_dtype not in _OUT:
        raise ValueError(f"K8 kernel writes bf16 or f32, not {out_dtype}")
    _native.require(xi, "int8_matmul_fused xi", torch.int8)
    _native.require(sx, "int8_matmul_fused sx", torch.float32)
    _native.require(w_nk, "int8_matmul_fused w_i8", torch.int8)
    ws = w_scale.reshape(-1).float().contiguous()
    b = None if bias is None else bias.reshape(-1).float().contiguous()
    for t, name in ((ws, "w_scale"), (b, "bias")):
        if t is not None and (t.device != xi.device or t.numel() != N):
            raise ValueError(f"int8_matmul_fused {name}: expected {N} values on {xi.device}")
    if xi.data_ptr() % 16 or w_nk.data_ptr() % 16:
        raise ValueError("int8_matmul_fused: TMA reads xi and w_i8 from 16-byte aligned rows")
    out = torch.empty((M, N), dtype=out_dtype, device=xi.device)
    _native.check(
        _native.lib().btia_int8_gemm(
            xi.data_ptr(), sx.data_ptr(), w_nk.data_ptr(), ws.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(), M, N, K, ACTS.index(act),
            _OUT[out_dtype], _native.stream(xi),
        ),
        "btia_int8_gemm",
    )
    return out


def _int8_mm_cuda(x, w_i8, w_scale, bias, act, out_dtype) -> torch.Tensor:
    """K8 on the card: the row quantization, then the int8 GEMM on the
    weight's (N, K) copy (each output column's weights contiguous along K,
    the K-major layout int8 wgmma reads)."""
    if x.shape[1] != w_i8.shape[0]:
        raise ValueError(f"int8_matmul_fused: x {tuple(x.shape)} does not match w_i8 {tuple(w_i8.shape)}")
    xi, sx = _quantize_rows_cuda(x)
    w_nk = _native.aligned(w_i8.t())
    return _int8_gemm_cuda(xi, sx, w_nk, w_scale, bias, act, out_dtype)


def int8_matmul_fused(
    x: torch.Tensor,
    w_i8: torch.Tensor,
    w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """K8: x (M, K) @ dequant(w_i8 (K, N), w_scale (N,)) + bias, then act.

    A CUDA tensor launches the two kernels (counted once in ``.launches``)
    or raises; a CPU tensor takes the plain twin."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    return _native.route(int8_matmul_fused, x, _int8_mm_cuda, _int8_mm_plain,
                         x, w_i8, w_scale, bias, act, out_dtype)


int8_matmul_fused.launches = 0
