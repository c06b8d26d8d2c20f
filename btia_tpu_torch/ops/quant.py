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
the kernel applies it in its epilogue; the reference takes a callable. It
quantizes and lays out the weight on every call, as the reference does.
The model's road (``models/layers.py::Dense``) prepares the weight once per
version instead (``int8_weight``: the same int8 values and scales, in K8's
(N, K) layout) and calls ``int8_matmul_nk``; a row-parallel product under a
model axis calls ``int8_matmul_row_parallel``. Every one of them counts in
``int8_matmul_fused.launches``, once a call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from btia_tpu_torch.ops import _native
from btia_tpu_torch.ops._native import H100_SMS
from btia_tpu_torch.ops.gemm import ACTS, apply_act, prepare_once
from btia_tpu_torch.parallel.collectives import all_reduce_, all_reduce_max_
from btia_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8. w: (in, out) -> (w_i8, scale (out,))."""
    wf = w.float()
    return _quantize_columns(wf, wf.abs().amax(dim=0))


def _quantize_columns(wf: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_weight`` of the f32 weight wf (in, out) given each output
    column's amax (out,)."""
    scale = torch.clamp_min(amax, 1e-8) / 127.0
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


def _row_amax_plain(x) -> torch.Tensor:
    """Each row's amax |x| (M,) f32 (``int8_mm.cu``'s amax mode)."""
    return x.float().abs().amax(dim=-1)


def _quantize_rows_at_plain(x, amax) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) -> (xi (M, K) int8, sx (M,) f32) at the given row amaxes,
    the arithmetic of ``_int8_mm_plain``: sx = max(amax, 1e-8) * f32(1/127),
    xi = round-half-even(x * (1/sx)). |x * (1/sx)| <= 127 up to four f32
    roundings wherever amax >= |x|, so no value rounds past 127 and the int8
    cast is exact."""
    sx = torch.clamp_min(amax.float(), 1e-8) * (1.0 / 127.0)
    xi = torch.round(x.float() * torch.reciprocal(sx)[:, None])
    return xi.to(torch.int8), sx


def _quantize_rows_plain(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first half of K8's twin (``quant_rows_kernel``): x (M, K) ->
    (xi (M, K) int8, sx (M,) f32) at each row's own amax."""
    return _quantize_rows_at_plain(x, _row_amax_plain(x))


def _int8_gemm_plain(xi, sx, w_i8, w_scale, bias, act, out_dtype) -> torch.Tensor:
    """The second half of K8's twin (``int8_gemm_kernel``): the exact
    integer product of xi (M, K) int8 and w_i8 (K, N), then (acc * sx) * ws
    + b in f32, the activation in f32, one cast."""
    y = _int_product(xi, w_i8) * sx.float()[:, None] * w_scale.float().reshape(1, -1)
    if bias is not None:
        y = y + bias.float().reshape(1, -1)
    return apply_act(y, act).to(out_dtype)


def _int8_acc_plain(xi, w_nk) -> torch.Tensor:
    """The int32 accumulators xi (M, K) @ w_nk (N, K)^T (the GEMM's int32
    output mode): exact in float64, then exact in int32 (K < 133,144)."""
    return (xi.double() @ w_nk.double().t()).to(torch.int32)


def _int8_dequant_plain(acc, amax, w_scale, bias, act, out_dtype) -> torch.Tensor:
    """The GEMM's epilogue on int32 accumulators (``int8_dequant_kernel``),
    at the rows' sx taken from their amax as ``_quantize_rows_at_plain``
    takes it: f32(acc) (one rounding, as the f64 product's in
    ``_int8_gemm_plain``), then (acc * sx) * ws + b in f32, the activation,
    one cast."""
    sx = torch.clamp_min(amax.float(), 1e-8) * (1.0 / 127.0)
    y = acc.float() * sx[:, None] * w_scale.float().reshape(1, -1)
    if bias is not None:
        y = y + bias.float().reshape(1, -1)
    return apply_act(y, act).to(out_dtype)


_OUT = {torch.bfloat16: 0, torch.float32: 1, torch.int32: 2}
INT8_TILE = (128, 256)  # K8's GEMM output tile (``int8_gemm_kernel``): rows, columns


def int8_plan(M: int, N: int) -> Tuple[int, int]:
    """(tiles, grid) of K8's persistent GEMM: 128 x 256 output tiles, N
    tiles fastest; one block an H100 SM up to one a tile. Block b takes
    tiles b, b + grid, b + 2 grid, ...: each tile once."""
    tiles = -(-M // INT8_TILE[0]) * -(-N // INT8_TILE[1])
    return tiles, min(tiles, H100_SMS)


def _quantize_rows_cuda(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's row quantization: x (M, K) bf16 -> (xi (M, K) int8, sx (M,)
    f32), into scratch allocated here."""
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


def _vector(t, n, device, name):
    if t is None:
        return None
    v = t.reshape(-1).float().contiguous()
    if v.device != device or v.numel() != n:
        raise ValueError(f"int8_matmul_fused {name}: expected {n} values on {device}")
    return v


def _int8_gemm_cuda(a, a_scale, w_nk, w_scale, bias, act, out_dtype, a_bf16: bool = False,
                    row_amax: bool = False):
    """K8's GEMM on the weight's (N, K) layout w_nk. a: the row
    quantization's xi (M, K) int8 with its sx (M,), or (``a_bf16``) bf16 x
    with its rows' amax (M,), quantized in the kernel. out_dtype torch.int32
    writes the raw accumulators (w_scale, bias and act unused). With
    ``row_amax`` (bf16 out, GELU) returns (y, the amax |y| of each row)."""
    M, K = a.shape
    N = w_nk.shape[0]
    if K % 16 or M == 0 or N == 0 or w_nk.shape[1] != K:
        raise ValueError(f"K8 kernel takes K % 16 == 0 and M, N >= 1, got {(M, K, N)}")
    if out_dtype not in _OUT:
        raise ValueError(f"K8 kernel writes bf16, f32 or int32, not {out_dtype}")
    if row_amax and (out_dtype != torch.bfloat16 or act is None or a_bf16 or N % 8):
        raise ValueError("K8 takes the output's row amax of a bf16 GELU product on int8 rows, N % 8 == 0")
    if a_bf16 and not (out_dtype == torch.int32 or (out_dtype == torch.bfloat16 and act is None and N % 8 == 0)):
        raise ValueError("K8 quantizes bf16 rows in its GEMM for bf16 out (no activation, N % 8 == 0) or int32")
    _native.require(a, "int8_matmul_fused x" if a_bf16 else "int8_matmul_fused xi", torch.bfloat16 if a_bf16
                    else torch.int8)
    _native.require(a_scale, "int8_matmul_fused row scales", torch.float32)
    _native.require(w_nk, "int8_matmul_fused w_i8", torch.int8)
    if a_scale.shape != (M,):
        raise ValueError(f"int8_matmul_fused: {tuple(a_scale.shape)} row scales for {M} rows")
    ws, b = _vector(w_scale, N, a.device, "w_scale"), _vector(bias, N, a.device, "bias")
    if a.data_ptr() % 16 or w_nk.data_ptr() % 16:
        raise ValueError("int8_matmul_fused: TMA reads x and w_i8 from 16-byte aligned rows")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    amax = torch.zeros((M,), dtype=torch.float32, device=a.device) if row_amax else None
    _, grid = int8_plan(M, N)
    _native.check(
        _native.lib().btia_int8_gemm(
            a.data_ptr(), a_scale.data_ptr(), int(a_bf16), w_nk.data_ptr(), ws.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(), None if amax is None else amax.data_ptr(),
            M, N, K, ACTS.index(act), _OUT[out_dtype], grid, _native.stream(a),
        ),
        "btia_int8_gemm",
    )
    return (out, amax) if row_amax else out


def _int8_dequant_cuda(acc, amax, w_scale, bias, act, out_dtype) -> torch.Tensor:
    """The GEMM's epilogue alone, on int32 accumulators (M, N), at the sx
    of the rows' amax (M,)."""
    M, N = acc.shape
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8 dequant writes bf16 or f32, not {out_dtype}")
    _native.require(acc, "int8 dequant acc", torch.int32)
    _native.require(amax, "int8 dequant amax", torch.float32)
    ws, b = _vector(w_scale, N, acc.device, "w_scale"), _vector(bias, N, acc.device, "bias")
    out = torch.empty((M, N), dtype=out_dtype, device=acc.device)
    _native.check(
        _native.lib().btia_int8_dequant(acc.data_ptr(), amax.data_ptr(), ws.data_ptr(),
                                        None if b is None else b.data_ptr(), out.data_ptr(), M, N, ACTS.index(act),
                                        _OUT[out_dtype], _native.stream(acc)),
        "btia_int8_dequant",
    )
    return out


def _int8_mm_nk_cuda(x, w_nk, w_scale, bias, act, out_dtype, x_amax=None, row_amax=False):
    """K8 on the card on a weight already in its (N, K) layout: the row
    quantization, then the GEMM; or, given the rows' amax, the GEMM on bf16
    x, which it quantizes itself."""
    if x.shape[1] != w_nk.shape[1]:
        raise ValueError(f"int8_matmul_fused: x {tuple(x.shape)} does not match w_nk {tuple(w_nk.shape)}")
    if x_amax is not None:
        return _int8_gemm_cuda(_native.aligned(x), x_amax, w_nk, w_scale, bias, act, out_dtype, a_bf16=True)
    xi, sx = _quantize_rows_cuda(x)
    return _int8_gemm_cuda(xi, sx, w_nk, w_scale, bias, act, out_dtype, row_amax=row_amax)


def _int8_mm_nk_plain(x, w_nk, w_scale, bias, act, out_dtype, x_amax=None, row_amax=False):
    xi, sx = _quantize_rows_at_plain(x, _row_amax_plain(x) if x_amax is None else x_amax)
    y = _int8_gemm_plain(xi, sx, w_nk.t(), w_scale, bias, act, out_dtype)
    return (y, _row_amax_plain(y)) if row_amax else y


def _int8_mm_cuda(x, w_i8, w_scale, bias, act, out_dtype) -> torch.Tensor:
    """K8 on the card from the reference's operands: the weight's (N, K)
    copy (each output column's weights contiguous along K, the K-major
    layout int8 wgmma reads), made on every call."""
    if x.shape[1] != w_i8.shape[0]:
        raise ValueError(f"int8_matmul_fused: x {tuple(x.shape)} does not match w_i8 {tuple(w_i8.shape)}")
    return _int8_mm_nk_cuda(x, _native.aligned(w_i8.t()), w_scale, bias, act, out_dtype)


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


def int8_weight(kernel: torch.Tensor, row_parallel: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Dense's f32 kernel (K, N) as K8's operands, (w_nk (N, K) int8,
    w_scale (N,) f32), made once per version of the kernel
    (``prepare_once``): ``quantize_weight``'s values, transposed. With
    `row_parallel` under a model axis (the kernel holds this rank's rows of
    a row-parallel weight) each column's amax is first taken over the model
    group (a max all-reduce), so the shard holds its rows of the whole
    weight's quantization and the group's scales."""
    group = row_parallel and axis_size(MODEL_AXIS) > 1

    def make():
        wf = kernel.float()
        amax = wf.abs().amax(dim=0)
        if group:
            amax = all_reduce_max_(amax.contiguous(), MODEL_AXIS)
        w_i8, scale = _quantize_columns(wf, amax)
        return _native.aligned(w_i8.t()), scale

    tag = ("int8_nk", axis_size(MODEL_AXIS)) if group else ("int8_nk",)
    return prepare_once((kernel,), tag, make)


def int8_matmul_nk(x, w_nk, w_scale, bias=None, act: Optional[str] = None,
                   out_dtype: torch.dtype = torch.bfloat16, x_amax=None, row_amax: bool = False):
    """K8 on a prepared weight (``int8_weight``): ``int8_matmul_fused(x,
    w_nk.t(), ...)`` bit for bit, without the per-call quantization and
    copy of the weight. Counted in ``int8_matmul_fused.launches``.

    An Mlp's pair of products runs with no row quantization pass between
    them: fc1 (``row_amax``, bf16 out, GELU) returns (y, the amax |y| of each
    row) as well, and fc2 takes that amax as ``x_amax`` (bf16 out, no
    activation) and quantizes its bf16 x in the GEMM. The rows' scales and
    int8 values are those of the row quantization of the same x, so the
    outputs are the same bits."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if row_amax and (act is None or out_dtype != torch.bfloat16 or x_amax is not None):
        raise ValueError("row_amax: K8 takes the row amax of a bf16 GELU product on its own quantized rows")
    if x_amax is not None and (act is not None or out_dtype != torch.bfloat16):
        raise ValueError("x_amax: K8 quantizes bf16 rows in its GEMM for a bf16 product with no activation")
    return _native.route(int8_matmul_fused, x, _int8_mm_nk_cuda, _int8_mm_nk_plain,
                         x, w_nk, w_scale, bias, act, out_dtype, x_amax, row_amax)


def _row_parallel_cuda(x, x_amax, w_nk, w_scale, bias, out_dtype):
    acc = _int8_gemm_cuda(_native.aligned(x), x_amax, w_nk, w_scale, None, None, torch.int32, a_bf16=True)
    return _int8_dequant_cuda(all_reduce_(acc, MODEL_AXIS), x_amax, w_scale, bias, None, out_dtype)


def _row_parallel_plain(x, x_amax, w_nk, w_scale, bias, out_dtype):
    xi, _ = _quantize_rows_at_plain(x, x_amax)
    acc = _int8_acc_plain(xi, w_nk)
    return _int8_dequant_plain(all_reduce_(acc, MODEL_AXIS), x_amax, w_scale, bias, None, out_dtype)


def int8_matmul_row_parallel(x, x_amax, w_nk, w_scale, bias=None,
                             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K8 on a row-parallel product under a model axis (fc2 of a sharded
    Mlp): x (M, K / tp) bf16, this rank's columns of the input, with their
    rows' amax (M,) (this rank's fc1 returns it); w_nk (N, K / tp) its rows
    of the weight, prepared with the group's scales
    (``int8_weight(row_parallel=True)``); the whole bias (N,).

    The amaxes are all-reduced by max (in place), which gives every rank
    the one-process scale sx of each whole row; each rank quantizes its
    columns at sx in K8's GEMM into int32 accumulators, which are summed
    over the group exactly (int32); the epilogue, with the whole bias once,
    runs on the sum. So the result equals the one-process product bit for
    bit. No activation: a row-parallel product's GELU would follow the sum.
    Counted once in ``int8_matmul_fused.launches``."""
    all_reduce_max_(x_amax, MODEL_AXIS)
    return _native.route(int8_matmul_fused, x, _row_parallel_cuda, _row_parallel_plain,
                         x, x_amax, w_nk, w_scale, bias, out_dtype)
