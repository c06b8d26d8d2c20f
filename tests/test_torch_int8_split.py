"""K8 as two kernels: the plain twins of its halves against the whole.

On the card ``int8_matmul_fused`` runs a row-quantization kernel and then an
int8 wgmma GEMM (``csrc/int8_mm.cu``); on the CPU it still takes
``_int8_mm_plain``. The halves' twins, ``_quantize_rows_plain`` and
``_int8_gemm_plain``, must compose to exactly ``_int8_mm_plain``: the same
f32 operations in the same order, so the outputs are equal bit for bit
(``torch.equal``), in bf16 and in f32, with and without bias and GELU.

Shapes: the eight FFN products of the int8 serve step of
``streaming_vitl`` (M = 9,232 to 131,072 rows, K and N 768 to 4,096) cut to
a CPU's size, keeping each one's K : N ratio, plus a ragged M and N and the
smallest K the kernel takes in whole 16-byte rows, 48.
"""

import numpy as np
import pytest
import torch

from btia_tpu_torch.ops import quant as Q

SHAPES = {
    # name: (M, K, N, act)
    "vit_fc1": (577, 128, 512, "gelu_tanh"),
    "vit_fc2": (577, 512, 128, None),
    "txt_fc1": (256, 96, 384, "gelu_tanh"),
    "txt_fc2": (256, 384, 96, None),
    "img_fc1": (400, 96, 384, "gelu_tanh"),
    "img_fc2": (400, 384, 96, None),
    "head_fc1": (512, 96, 192, "gelu_tanh"),
    "head_fc2": (512, 192, 96, None),
    "ragged": (37, 64, 20, "gelu_tanh"),
    "k48": (64, 48, 64, None),
}


def _operands(M, K, N, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32) * 2).to(torch.bfloat16)
    x[3] = 0  # an all-zero row: the 1e-8 floor of its scale
    w_i8, ws = Q.quantize_weight(torch.from_numpy(rng.randn(K, N).astype(np.float32) * K**-0.5))
    b = torch.from_numpy(rng.randn(N).astype(np.float32) * 0.02)
    return x, w_i8, ws, b


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_halves_compose_to_the_whole(name, out):
    M, K, N, act = SHAPES[name]
    x, w_i8, ws, b = _operands(M, K, N, seed=len(name))
    whole = Q._int8_mm_plain(x, w_i8, ws, b, act, out)
    xi, sx = Q._quantize_rows_plain(x)
    assert xi.dtype == torch.int8 and xi.shape == (M, K) and sx.dtype == torch.float32 and sx.shape == (M,)
    assert torch.equal(Q._int8_gemm_plain(xi, sx, w_i8, ws, b, act, out), whole)
    assert torch.equal(Q._int8_gemm_plain(xi, sx, w_i8, ws, None, act, out),
                       Q._int8_mm_plain(x, w_i8, ws, None, act, out))
    # The CPU entry takes the whole twin.
    assert torch.equal(Q.int8_matmul_fused(x, w_i8, ws, b, act=act, out_dtype=out), whole)


def test_quantized_rows_stay_in_int8():
    """No value rounds past +-127 (the kernel writes int8 with no clip),
    whatever the row's scale; a zero row quantizes to 0 at the 1e-8 floor."""
    rng = np.random.RandomState(9)
    rows = [rng.randn(48) * s for s in (1e-12, 1e-3, 1.0, 3e4)]
    x = torch.from_numpy(np.stack(rows + [np.zeros(48)]).astype(np.float32)).to(torch.bfloat16)
    xi, sx = Q._quantize_rows_plain(x)
    xf = x.float()
    assert int(xi.abs().max()) == 127
    assert torch.equal(xi.float(), torch.round(xf * torch.reciprocal(sx)[:, None]))
    assert not xi[-1].any() and sx[-1] == torch.tensor(1e-8) * torch.tensor(1.0 / 127.0)


def test_cuda_halves_check_their_shapes():
    """The card's halves refuse what the kernels do not take before any
    kernel is built: K % 16 != 0, and operands that do not match."""
    x = torch.zeros(4, 40, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K % 16 == 0"):
        Q._quantize_rows_cuda(x)
    xi = torch.zeros(4, 48, dtype=torch.int8)
    with pytest.raises(ValueError, match="K % 16 == 0"):
        Q._int8_gemm_cuda(xi, torch.ones(4), torch.zeros(8, 32, dtype=torch.int8), torch.ones(8), None, None,
                          torch.bfloat16)
    with pytest.raises(ValueError, match="does not match"):
        Q._int8_mm_cuda(torch.zeros(4, 48, dtype=torch.bfloat16), torch.zeros(32, 8, dtype=torch.int8),
                        torch.ones(8), None, None, torch.bfloat16)
    assert Q.int8_matmul_fused.launches == 0
