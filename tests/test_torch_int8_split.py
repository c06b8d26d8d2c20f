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


# ---------------------------------------------------------------------------
# The weight prepared once per version, the model's road, the row-parallel
# road's halves and the GEMM's persistent plan.


def _kernel(K, N, seed):
    rng = np.random.RandomState(seed)
    return torch.nn.Parameter(torch.from_numpy(rng.randn(K, N).astype(np.float32) * K**-0.5))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_prepared_weight_is_quantize_weight_transposed(name):
    """``int8_weight`` gives ``quantize_weight``'s int8 values in K8's (N, K)
    layout and its scales, bit for bit."""
    M, K, N, act = SHAPES[name]
    w = _kernel(K, N, len(name))
    w_nk, ws = Q.int8_weight(w)
    w_i8, scale = Q.quantize_weight(w)
    assert w_nk.dtype == torch.int8 and w_nk.shape == (N, K) and w_nk.is_contiguous()
    assert torch.equal(w_nk, w_i8.t()) and torch.equal(ws, scale)


def test_weight_is_prepared_once_per_version():
    """A second call prepares nothing and returns the same tensors; an
    in-place update of the kernel (an optimizer step, ``load_state_dict``)
    prepares it again, with the new values."""
    from btia_tpu_torch.ops.gemm import prepare_once

    w = _kernel(64, 32, 1)
    builds = prepare_once.builds
    first = Q.int8_weight(w)
    assert prepare_once.builds == builds + 1
    again = Q.int8_weight(w)
    assert all(a is b for a, b in zip(again, first)) and prepare_once.builds == builds + 1
    with torch.no_grad():
        w.mul_(2)
    moved = Q.int8_weight(w)
    assert prepare_once.builds == builds + 2
    assert torch.equal(moved[0], Q.quantize_weight(w)[0].t()) and torch.equal(moved[1], Q.quantize_weight(w)[1])


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_models_road_equals_the_ops_api(name, out):
    """``int8_matmul_nk`` on the prepared weight and ``Dense.int8`` equal
    ``int8_matmul_fused`` (per-call quantization) bit for bit."""
    from btia_tpu_torch.core.dtypes import DTypePolicy
    from btia_tpu_torch.models.layers import Dense

    M, K, N, act = SHAPES[name]
    x, _, _, b = _operands(M, K, N, seed=len(name) + 1)
    w = _kernel(K, N, len(name) + 2)
    want = Q.int8_matmul_fused(x, *Q.quantize_weight(w), b, act=act, out_dtype=out)
    assert torch.equal(Q.int8_matmul_nk(x, *Q.int8_weight(w), b, act=act, out_dtype=out), want)
    dense = Dense(K, N, DTypePolicy(compute_dtype=out, param_dtype=torch.float32))
    with torch.no_grad():
        dense.kernel.copy_(w)
        dense.bias.copy_(b)
        assert torch.equal(dense.int8(x.to(out), act), Q.int8_matmul_fused(
            x.to(out), *Q.quantize_weight(w), b, act=act, out_dtype=out))


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_row_parallel_halves_compose_to_the_whole(name, out):
    """The row-parallel road's twins (the rows' amax, the quantization at
    given amaxes, int32 accumulators, the epilogue on them at the amaxes'
    scales) compose to ``_int8_mm_plain`` exactly; quantizing at a larger
    amax than the row's own (a shard's row under the group's maximum) stays
    in int8."""
    M, K, N, act = SHAPES[name]
    x, w_i8, ws, b = _operands(M, K, N, seed=len(name) + 3)
    amax = Q._row_amax_plain(x)
    assert amax.dtype == torch.float32 and amax.shape == (M,)
    xi, sx = Q._quantize_rows_at_plain(x, amax)
    assert torch.equal(xi, Q._quantize_rows_plain(x)[0]) and torch.equal(sx, Q._quantize_rows_plain(x)[1])
    acc = Q._int8_acc_plain(xi, w_i8.t())
    assert acc.dtype == torch.int32
    assert torch.equal(Q._int8_dequant_plain(acc, amax, ws, b, act, out), Q._int8_mm_plain(x, w_i8, ws, b, act, out))
    wide, _ = Q._quantize_rows_at_plain(x, amax * 3)
    assert int(wide.abs().max()) <= 43


@pytest.mark.parametrize("name", ["vit_fc1", "txt_fc1", "head_fc1", "ragged"])
def test_mlp_pair_without_a_quantization_pass(name):
    """An Mlp's two products on the model's road: fc1 also returns its
    output's row amax (``row_amax``), and fc2 quantizes its bf16 input at
    that amax (``x_amax``); the pair equals two calls of the ops API's
    entry bit for bit, as does an int8 ``Mlp``."""
    from btia_tpu_torch.core.dtypes import DTypePolicy
    from btia_tpu_torch.models.layers import Mlp

    M, K, H, _ = SHAPES[name]
    x, _, _, _ = _operands(M, K, H, seed=len(name) + 4)
    w1, w2 = _kernel(K, H, 5), _kernel(H, K, 6)
    rng = np.random.RandomState(7)
    b1, b2 = (torch.from_numpy(rng.randn(n).astype(np.float32) * 0.02) for n in (H, K))
    h, amax = Q.int8_matmul_nk(x, *Q.int8_weight(w1), b1, "gelu_tanh", row_amax=True)
    want_h = Q.int8_matmul_fused(x, *Q.quantize_weight(w1), b1, act="gelu_tanh")
    assert torch.equal(h, want_h) and torch.equal(amax, want_h.float().abs().amax(-1))
    want = Q.int8_matmul_fused(want_h, *Q.quantize_weight(w2), b2)
    assert torch.equal(Q.int8_matmul_nk(h, *Q.int8_weight(w2), b2, x_amax=amax), want)
    mlp = Mlp(K, H, DTypePolicy(int8=True))
    with torch.no_grad():
        for t, v in ((mlp.fc1.kernel, w1), (mlp.fc1.bias, b1), (mlp.fc2.kernel, w2), (mlp.fc2.bias, b2)):
            t.copy_(v)
        assert torch.equal(mlp(x), want)
    with pytest.raises(ValueError, match="row_amax"):
        Q.int8_matmul_nk(x, *Q.int8_weight(w1), b1, None, row_amax=True)
    with pytest.raises(ValueError, match="x_amax"):
        Q.int8_matmul_nk(h, *Q.int8_weight(w2), b2, "gelu_tanh", x_amax=amax)


@pytest.mark.parametrize("M,N", [(1, 1), (128, 256), (129, 257), (9232, 4096), (65536, 768), (131072, 1536)])
def test_int8_plan_covers_every_tile_once(M, N):
    """The persistent GEMM's walk: block b takes tiles b + j * grid while
    they exist; every 128 x 256 tile is taken once, and no block is
    launched without one."""
    tiles, grid = Q.int8_plan(M, N)
    assert tiles == -(-M // 128) * -(-N // 256) and 1 <= grid <= min(tiles, Q.H100_SMS)
    taken = sorted(b + j * grid for b in range(grid) for j in range(tiles) if b + j * grid < tiles)
    assert taken == list(range(tiles))


def test_row_parallel_without_a_mesh_is_the_one_process_product():
    """``int8_matmul_row_parallel`` with no model group: the all-reduces are
    the identity, so it is the plain product at the given amaxes; the CPU
    twins count no launch."""
    x, w_i8, ws, b = _operands(40, 96, 48, seed=7)
    got = Q.int8_matmul_row_parallel(x, Q._row_amax_plain(x), w_i8.t().contiguous(), ws, b)
    assert torch.equal(got, Q._int8_mm_plain(x, w_i8, ws, b, None, torch.bfloat16))
    assert Q.int8_matmul_fused.launches == 0
