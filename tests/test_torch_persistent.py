"""The host side of the persistent kernels: K3/K5's attention
(``csrc/flash_bshd.cu``, planned by ``ops/attention.py::flash_plan``) and
K1/K2's projection GEMM (``csrc/fused_attn.cu``, planned by
``ops/gemm.py::gemm_plan``), on the CPU.

The plans: the GEMM's tile by shape and both grids, and that the static
schedule the kernels walk (block i takes work items i, i + grid, ...)
covers every work item exactly once, at counts just under, at and over one
and two items an SM.

The C entries: each wrapper runs on CPU tensors against a stand-in for the
kernel library that reads and writes the tensors' memory through the
pointers, strides and shapes it is handed, refuses what the C entry
refuses, and computes each output tile of the schedule it is given, and
only those. So a wrong argument, stride, mask form, plan or schedule shows
as an error or as output the schedule never wrote, held against the plain
twin: attention within 1/32 of the largest magnitude (the chip's bound: the
kernel rounds the probabilities after sums taken in another order), the
GEMM within one bf16 step an element. The kernels' own arithmetic is held
to the twins on the card (``chip_smoke.py`` phase 2).

``Dense``'s route (``models/layers.py``): the calls that take the GEMM with
the bias and GELU in its epilogue, through the same stand-in, and the ones
that keep the chain, with its counters. The tests marked ``chip`` run the
GEMM itself at the serve step's Mlp and K1/K2 sites and skip without a card
(``python -m pytest --noconftest -m chip tests/test_torch_persistent.py``).
"""

import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from btia_tpu_torch.ops import _native
from btia_tpu_torch.ops import attention as A
from btia_tpu_torch.ops import fused_attn as FA
from btia_tpu_torch.ops import gemm as G

BF16 = torch.bfloat16
INVALID = 1  # cudaErrorInvalidValue
SMS = 132


def _view(ptr, dtype, shape, strides):
    """The tensor at host address `ptr` with `shape` and element `strides`,
    aliasing that memory (writes go through)."""
    extent = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    size = torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_char * (extent * size)).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).as_strided(shape, strides)


# ---------------------------------------------------------------------------
# The plans
# ---------------------------------------------------------------------------


def _blocks(items, grid):
    """The kernels' static schedule: block i takes work items i, i + grid, ..."""
    return [list(range(i, items, grid)) for i in range(min(grid, items))]


def gemm_schedule(M, N):
    """Each block's output tiles as (first row, first column), N tiles
    fastest, as gemm_bias_ws_kernel walks them."""
    tile, grid = G.gemm_plan(M, N)
    bm, bn = G.GEMM_TILES[tile]
    tiles_n = -(-N // bn)
    return [[(t // tiles_n * bm, t % tiles_n * bn) for t in blk] for blk in _blocks(-(-M // bm) * tiles_n, grid)]


def flash_schedule(B, H, Sq, dw):
    """Each block's work items as (q tile, head, batch), the q tile fastest,
    as flash_ws_kernel walks them."""
    items, grid = A.flash_plan(B, H, Sq, dw)
    nqt = -(-Sq // A.FLASH_ITEM_ROWS)
    return [[(it % nqt, it // nqt % H, it // (nqt * H)) for it in blk] for blk in _blocks(items, grid)]

# (M, N, tile): the serve sites (128 x 256), the train sites (M 2,048 and
# 12,608: 128 x 128 where the wide tile would leave SMs idle), N not a
# multiple of 256, and tile counts around 132 and 264.
GEMM_TILES = [(65536, 768, (128, 256)), (65536, 1536, (128, 256)), (102400, 768, (128, 256)),
              (167936, 1536, (128, 256)), (131072, 768, (128, 256)), (2048, 768, (128, 128)),
              (2048, 1536, (128, 256)), (12608, 768, (128, 128)), (12608, 1536, (128, 256)),
              (1, 768, (128, 128)), (300, 264, (128, 128)), (131 * 128, 256, (128, 256)),
              (264 * 128, 256, (128, 256)), (265 * 128, 256, (128, 128))]


@pytest.mark.parametrize("M,N,tile", GEMM_TILES)
def test_gemm_plan_tile_and_grid(M, N, tile):
    """128 x 256 where N is a multiple of 256 and the wide tiles' rounds,
    weighted, cost no more; the grid one block an SM up to one a tile."""
    t, grid = G.gemm_plan(M, N)
    assert G.GEMM_TILES[t] == tile
    bm, bn = tile
    assert grid == min(-(-M // bm) * -(-N // bn), SMS)


@pytest.mark.parametrize("M,N", [(1, 8), (127, 768), (129, 768), (131 * 128, 256), (132 * 128, 256),
                                 (133 * 128, 256), (263 * 128, 256), (264 * 128, 256), (265 * 128, 256),
                                 (264 * 128, 128), (65536, 1536), (12608, 768)])
def test_gemm_schedule_covers_every_tile_once(M, N):
    bm, bn = G.GEMM_TILES[G.gemm_plan(M, N)[0]]
    blocks = gemm_schedule(M, N)
    assert len(blocks) == G.gemm_plan(M, N)[1] and all(blocks)
    got = sorted(t for blk in blocks for t in blk)
    assert got == [(m, n) for m in range(0, M, bm) for n in range(0, N, bn)]
    # The tiles at work at one time run N fastest.
    first_round = [blk[0] for blk in blocks]
    assert first_round == sorted(first_round)


# (B, H, Sq, dw) -> items: ViT-L, ViT-B, the AD head at D 64 and 128, one
# row, and item counts around 132 and 264.
FLASH_PLANS = [(16, 16, 577, 64, 1280), (64, 12, 197, 64, 1536), (64, 12, 2048, 64, 12288), (64, 6, 2048, 128, 6144),
               (1, 1, 1, 64, 1), (1, 1, 577, 64, 5), (131, 1, 100, 64, 131), (66, 2, 128, 96, 132),
               (133, 1, 64, 64, 133), (263, 1, 50, 128, 263), (132, 2, 100, 64, 264), (265, 1, 20, 64, 265)]


@pytest.mark.parametrize("B,H,Sq,dw,items", FLASH_PLANS)
def test_flash_plan_and_schedule_cover_every_item_once(B, H, Sq, dw, items):
    """Work items (128-row q tile, head, batch), the grid one block an SM up
    to one an item; every (q tile, head, batch) exactly once, q tiles of one
    head next to each other."""
    assert A.flash_plan(B, H, Sq, dw) == (items, min(items, SMS))
    blocks = flash_schedule(B, H, Sq, dw)
    assert len(blocks) == min(items, SMS) and all(blocks)
    got = sorted(x for blk in blocks for x in blk)
    assert got == sorted((qt, h, b) for qt in range(-(-Sq // 128)) for h in range(H) for b in range(B))
    first_round = [blk[0] for blk in blocks]
    nqt = -(-Sq // 128)
    assert [qt + nqt * (h + H * b) for qt, h, b in first_round] == list(range(len(blocks)))


@pytest.mark.parametrize("dw,rows", [(192, 128), (256, 64), (136, 128), (200, 64)])
def test_flash_plan_first_design_one_block_a_tile(dw, rows):
    """Heads padded to 192 or 256 keep the first design: one block a q tile
    of 128 (DP 192) or 64 (DP 256) rows, the grid not capped."""
    assert A.flash_plan(3, 5, 577, dw) == (-(-577 // rows) * 15,) * 2


def test_key_mask_arg_reads_bool_masks_in_place():
    m = torch.rand(3, 7) > 0.5
    got = A.key_mask_arg(m)
    assert got.data_ptr() == m.data_ptr() and got.dtype == torch.bool
    f = m.float()
    assert torch.equal(A.key_mask_arg(f), m) and A.key_mask_arg(None) is None


# ---------------------------------------------------------------------------
# The C entries against a stand-in
# ---------------------------------------------------------------------------


def _attend(q, k, v, keep, qscale):
    """The kernel's attention on (S, D) operands: q scaled and rounded to
    bf16, exp2 softmax with -1e9 on masked keys, P rounded to bf16, one
    division after PV."""
    s = (q.float() * qscale).to(BF16).float() @ k.float().T
    if keep is not None:
        s = s - (~keep).float()[None, :] * 1e9
    e = torch.exp2(s - s.amax(-1, keepdim=True))
    return ((e.to(BF16).float() @ v.float()) / e.sum(-1, keepdim=True)).to(BF16)


class _StandIn:
    """The C entries of K3, K5 and the projection GEMM as the host sees
    them: the checks they make, then each output tile of the schedule the
    arguments give, computed through the pointers and strides handed in."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _run_items(qv, kv, vv, ov, mask, B, H, Sq, dw, qscale, grid):
        dp = -(-dw // 64) * 64
        if dp <= 128:
            nqt = -(-Sq // 128)
            items = [(it % nqt, it // nqt % H, it // (nqt * H)) for blk in _blocks(nqt * H * B, grid) for it in blk]
            rows = 128
        else:  # the first design: one block a q tile, the grid not read
            rows = 128 if dp <= 192 else 64
            items = [(qt, h, b) for b in range(B) for h in range(H) for qt in range(-(-Sq // rows))]
        for qt, h, b in items:
            r = slice(qt * rows, min(Sq, qt * rows + rows))
            keep = None if mask is None else mask[b] != 0
            ov[b, h, r] = _attend(qv[b, h, r], kv[b, h], vv[b, h], keep, qscale)

    def btia_flash_bshd(self, q, k, v, mask, o, B, H, D, Sq, Sk, qscale, grid, stream):
        self.calls.append(("btia_flash_bshd", B, H, D, Sq, Sk, grid, mask is not None))
        if D not in (64, 128, 192, 256) or min(B, H, Sq, Sk, grid) < 1 or any(p % 16 for p in (q, k, v, o)):
            return INVALID
        HD = H * D
        bshd = lambda p, S: _view(p, BF16, (B, S, H, D), (S * HD, HD, D, 1)).transpose(1, 2)
        m = None if mask is None else _view(mask, torch.uint8, (B, Sk), (Sk, 1))
        self._run_items(bshd(q, Sq), bshd(k, Sk), bshd(v, Sk), bshd(o, Sq), m, B, H, Sq, D, qscale, grid)
        return 0

    def btia_mha_bhsd(self, q, k, v, mask, o, strides, B, H, Sq, Sk, D, qscale, grid, stream):
        st = [strides[i] for i in range(12)]
        self.calls.append(("btia_mha_bhsd", B, H, D, Sq, Sk, grid, mask is not None))
        if D < 8 or D % 8 or D > 256 or min(B, H, Sq, Sk, grid) < 1 or any(x <= 0 or x % 8 for x in st) \
                or any(p % 16 for p in (q, k, v, o)):
            return INVALID
        view = lambda p, i, S: _view(p, BF16, (B, H, S, D), (*st[3 * i: 3 * i + 3], 1))
        m = None if mask is None else _view(mask, torch.uint8, (B, Sk), (Sk, 1))
        self._run_items(view(q, 0, Sq), view(k, 1, Sk), view(v, 2, Sk), view(o, 3, Sq), m, B, H, Sq, D, qscale,
                        grid)
        return 0

    def btia_gemm_bias(self, a, w, bias, resid, resid_rows, c, M, N, K, act, tile, grid, stream):
        self.calls.append(("btia_gemm_bias", M, N, K, resid_rows if resid else 0, act, tile, grid))
        if K % 8 or N % 8 or M < 1 or resid_rows < 1 or tile not in (0, 1) or grid < 1 \
                or act not in (0, 1) or (act and resid) or any(p % 16 for p in (a, w, c, resid or 0)):
            return INVALID
        bm, bn = G.GEMM_TILES[tile]
        tiles_n = -(-N // bn)
        tiles = -(-M // bm) * tiles_n
        av, wv = _view(a, BF16, (M, K), (K, 1)), _view(w, BF16, (K, N), (N, 1))
        bv, cv = _view(bias, torch.float32, (N,), (1,)), _view(c, BF16, (M, N), (N, 1))
        rv = None if not resid else _view(resid, BF16, (resid_rows, N), (N, 1))
        for blk in _blocks(tiles, grid):
            for t in blk:
                r, cs = slice(t // tiles_n * bm, t // tiles_n * bm + bm), slice(t % tiles_n * bn, t % tiles_n * bn + bn)
                y = av[r].float() @ wv[:, cs].float() + bv[cs]
                y = (F.gelu(y, approximate="tanh") if act else y).to(BF16)
                if rv is not None:
                    rows = torch.arange(M)[r] % resid_rows
                    y = (y.float() + rv[rows][:, cs].float()).to(BF16)
                cv[r, cs] = y
        return 0

    def __getattr__(self, name):
        pytest.fail(f"{name} was called")


@pytest.fixture
def stand_in(monkeypatch):
    """CPU tensors through the CUDA halves: the device checks pass, the
    dtype and layout checks stay, the library is the stand-in."""
    lib = _StandIn()

    def require(t, what, dtype=BF16, contiguous=True):
        if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)) or (contiguous and not t.is_contiguous()):
            raise ValueError(f"{what}: {t.dtype}, contiguous={t.is_contiguous()}")

    monkeypatch.setattr(_native, "lib", lambda: lib)
    monkeypatch.setattr(_native, "require", require)
    monkeypatch.setattr(_native, "stream", lambda t: 0)
    return lib


def _rand(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(BF16)


def _mask(rng, B, S):
    m = torch.from_numpy(rng.rand(B, S) > 0.3)
    m[0] = False  # a fully masked row
    m[:, 0] |= torch.arange(B) > 0
    return m


def _close(got, want):
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    assert err <= scale / 32, (err, scale)


@pytest.mark.parametrize("B,Sq,Sk,H,D,masked", [(2, 200, 150, 2, 64, True), (3, 1, 1, 1, 64, False),
                                                (140, 20, 70, 1, 64, True), (2, 130, 65, 3, 128, False),
                                                (1, 70, 40, 2, 192, True), (2, 65, 33, 1, 256, False)])
def test_k3_host_code(B, Sq, Sk, H, D, masked, stand_in):
    """K3's wrapper hands the kernel the bool mask as bytes and the planned
    grid; every row of the output is the schedule's."""
    rng = np.random.RandomState(B + Sq + D)
    q, k, v = _rand(rng, B, Sq, H * D), _rand(rng, B, Sk, H * D), _rand(rng, B, Sk, H * D)
    m = _mask(rng, B, Sk) if masked else None
    got = A._bshd_flash_cuda(q, k, v, m, H)
    _close(got, A._bshd_flash_plain(q, k, v, m, H))
    assert stand_in.calls == [("btia_flash_bshd", B, H, D, Sq, Sk, A.flash_plan(B, H, Sq, D)[1], masked)]


@pytest.mark.parametrize("D,masked", [(64, True), (96, False), (100, True), (8, False), (136, True)])
def test_k5_host_code_on_strided_views(D, masked, stand_in):
    """K5 reads (B, S, H, D) views through their strides (mha_bshd's long
    road); a head width not a multiple of 8 goes through the padded copy."""
    rng = np.random.RandomState(D)
    B, H, Sq, Sk = 3, 2, 140, 90
    q, k, v = (_rand(rng, B, S, H, D).transpose(1, 2) for S in (Sq, Sk, Sk))
    m = _mask(rng, B, Sk) if masked else None
    got = A._mha_bhsd_cuda(q, k, v, m)
    _close(got, A._mha_bhsd_plain(q, k, v, m))
    dw = -(-D // 8) * 8
    assert stand_in.calls == [("btia_mha_bhsd", B, H, dw, Sq, Sk, A.flash_plan(B, H, Sq, dw)[1], masked)]


@pytest.mark.parametrize("M,K,N,rr", [(1, 64, 256, 0), (127, 64, 128, 127), (129, 136, 256, 64), (300, 64, 264, 3),
                                      (131 * 128, 8, 256, 0), (133 * 128, 16, 256, 64)])
def test_gemm_host_code(M, K, N, rr, stand_in):
    """The projection GEMM's wrapper hands the kernel gemm_plan's tile and
    grid; every output tile is the schedule's, with the bias in f32 and the
    residual (repeating every rr rows) in bf16."""
    rng = np.random.RandomState(M % 1000 + K)
    a, w = _rand(rng, M, K), (_rand(rng, K, N).float() * K**-0.5).to(BF16)
    b = torch.from_numpy(rng.randn(N).astype(np.float32)) * 0.02
    r = _rand(rng, rr, N) if rr else None
    got = G.gemm_bias(a, w, b, r, rr)
    y0 = FA._proj_plain(a, w, b, BF16)
    want = y0 if r is None else (y0.float() + r.float().repeat(-(-M // rr), 1)[:M]).to(BF16)
    step = lambda x: torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(1e-30))) - 7)
    tol = step(want) + (0 if r is None else step(y0)) + 1e-6 * want.float().abs().max()
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    assert stand_in.calls == [("btia_gemm_bias", M, N, K, rr, 0, *G.gemm_plan(M, N))]


def test_launch_error_raises(stand_in, monkeypatch):
    """A non-zero code from a C entry raises; nothing falls back."""
    monkeypatch.setattr(_StandIn, "btia_gemm_bias", lambda self, *a: INVALID)
    rng = np.random.RandomState(0)
    with pytest.raises(RuntimeError, match=f"btia_gemm_bias: CUDA error {INVALID}"):
        G.gemm_bias(_rand(rng, 4, 8), _rand(rng, 8, 8), torch.zeros(8))


def _bf16_step(x):
    """One bf16 step (2^-7 of the leading binade) at each element's magnitude."""
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(1e-30))) - 7)


@pytest.mark.parametrize("M,K,N", [(1, 64, 256), (300, 136, 264), (131 * 128, 16, 256), (129, 768, 3072)])
def test_gemm_host_code_gelu(M, K, N, stand_in):
    """With act "gelu_tanh" the wrapper hands the kernel act 1 and the same
    plan; every output tile is bf16(gelu_tanh(a @ w + b)) taken in f32, one
    rounding."""
    rng = np.random.RandomState(M % 1000 + K + 1)
    a, w = _rand(rng, M, K), (_rand(rng, K, N).float() * K**-0.5).to(BF16)
    b = torch.from_numpy(rng.randn(N).astype(np.float32)) * 0.02
    got = G.gemm_bias(a, w, b, act="gelu_tanh")
    want = F.gelu(a.float() @ w.float() + b, approximate="tanh")
    assert bool(((got.float() - want).abs() <= _bf16_step(want) + 1e-6 * want.abs().max()).all())
    assert stand_in.calls == [("btia_gemm_bias", M, N, K, 0, 1, *G.gemm_plan(M, N))]


@pytest.mark.parametrize("act,dtype,resid", [("gelu_tanh", BF16, True), ("gelu_tanh", torch.float32, False),
                                             ("relu", BF16, False)])
def test_gemm_act_refused(act, dtype, resid, stand_in):
    """The epilogue's activation takes no residual, no f32 operands and no
    other name: the wrapper raises before any launch."""
    rng = np.random.RandomState(3)
    a, w = _rand(rng, 64, 64).to(dtype), _rand(rng, 64, 64).to(dtype)
    r = _rand(rng, 64, 64) if resid else None
    with pytest.raises(ValueError, match="act"):
        G.gemm_bias(a, w, torch.zeros(64), r, 64 if resid else 0, act=act)
    assert stand_in.calls == []


# ---------------------------------------------------------------------------
# Dense's route: the epilogue GEMM or the chain
# ---------------------------------------------------------------------------


def _dense(K, N, compute_dtype=BF16, seed=0):
    from btia_tpu_torch.core.dtypes import DTypePolicy
    from btia_tpu_torch.models.layers import Dense

    torch.manual_seed(seed)
    d = Dense(K, N, DTypePolicy(compute_dtype=compute_dtype))
    with torch.no_grad():
        d.kernel.normal_(0, K**-0.5)
        d.bias.normal_(0, 0.02)
    return d


# case -> (K, compute dtype, on the card, grad mode, reduce, the route)
DENSE_ROUTES = {
    "bf16_card_no_grad": (64, BF16, True, False, False, "epilogue"),
    "grad_wanted": (64, BF16, True, True, False, "chain"),
    "fp32": (64, torch.float32, True, False, False, "chain"),
    "reduce": (64, BF16, True, False, True, "chain"),
    "k_not_multiple_of_8": (60, BF16, True, False, False, "chain"),
    "cpu": (64, BF16, False, False, False, "chain"),
}


def _run_dense_case(case, monkeypatch, act="gelu_tanh"):
    """One Dense call of `case` on (3, 5, K) rows to N = 136; returns
    (Dense, input, output). "On the card": CPU tensors that report is_cuda,
    through the stand-in library."""
    K, cd, card, grad, reduce, _ = DENSE_ROUTES[case]
    if card:
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True), raising=False)
    d = _dense(K, 136, cd)
    x = torch.from_numpy(np.random.RandomState(K).randn(3, 5, K).astype(np.float32)).to(cd)
    with torch.set_grad_enabled(grad):
        y = d(x, act=act, reduce=(lambda t: t) if reduce else None)
    return d, x, y


@pytest.mark.parametrize("case", sorted(DENSE_ROUTES))
def test_dense_route(case, stand_in, monkeypatch):
    """The epilogue GEMM (one launch: bias and GELU in its epilogue, on the
    kernel cast once) only for a bf16 input on the card with no gradient
    wanted, no reduce and K, N multiples of 8; every other call the chain
    (cast, matmul, bias add, GELU in the compute dtype), bit for bit."""
    d, x, y = _run_dense_case(case, monkeypatch)
    K, cd = DENSE_ROUTES[case][:2]
    x2 = x.reshape(-1, K)
    if DENSE_ROUTES[case][-1] == "epilogue":
        assert stand_in.calls == [("btia_gemm_bias", 15, 136, K, 0, 1, *G.gemm_plan(15, 136))]
        want = F.gelu(x2.float() @ d.kernel.detach().to(cd).float() + d.bias.detach(), approximate="tanh")
        assert y.dtype == BF16
        assert bool(((y.reshape(15, 136).float() - want).abs() <= _bf16_step(want) + 1e-6).all())
    else:
        assert stand_in.calls == []
        want = F.gelu(x2 @ d.kernel.to(cd) + d.bias.to(cd), approximate="tanh")
        assert torch.equal(y.reshape(15, 136), want)
    assert y.shape == (3, 5, 136)


def test_dense_counters_count_each_route(stand_in, monkeypatch):
    """``Dense.epilogue_calls`` and ``Dense.chain_calls`` count each call by
    the route it took; the kernel is cast once per version, not per call."""
    from btia_tpu_torch.models.layers import Dense

    for case, (*_, route) in sorted(DENSE_ROUTES.items()):
        before = (Dense.epilogue_calls, Dense.chain_calls)
        with monkeypatch.context() as m:
            _run_dense_case(case, m)
        assert (Dense.epilogue_calls - before[0], Dense.chain_calls - before[1]) == \
            ((1, 0) if route == "epilogue" else (0, 1)), case
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "is_cuda", property(lambda self: True), raising=False)
        d, x = _dense(64, 136), torch.randn(4, 64).to(BF16)
        builds = G.prepare_once.builds
        with torch.no_grad():
            d(x), d(x, act="gelu_tanh")
        assert G.prepare_once.builds == builds + 1
        with torch.no_grad():
            d.kernel.add_(1.0)  # a new version of the kernel is cast again
            d(x)
        assert G.prepare_once.builds == builds + 2


@pytest.mark.parametrize("compute_dtype", [BF16, torch.float32])
def test_mlp_on_the_cpu_runs_the_chain_bit_for_bit(compute_dtype):
    """On the CPU an Mlp runs the chain: fc1's product and bias add in the
    compute dtype, the GELU (tanh under bf16, exact under fp32), fc2's
    product and bias add, bit for bit."""
    from btia_tpu_torch.core.dtypes import DTypePolicy
    from btia_tpu_torch.models.layers import Mlp

    torch.manual_seed(1)
    mlp = Mlp(48, 96, DTypePolicy(compute_dtype=compute_dtype))
    with torch.no_grad():
        for p in mlp.parameters():
            p.normal_(0, 0.2)
    x = torch.randn(2, 7, 48).to(compute_dtype)
    cd = compute_dtype
    with torch.no_grad():
        got = mlp(x)
        h = x.reshape(-1, 48) @ mlp.fc1.kernel.to(cd) + mlp.fc1.bias.to(cd)
        h = F.gelu(h, approximate="none" if cd == torch.float32 else "tanh")
        want = (h @ mlp.fc2.kernel.to(cd) + mlp.fc2.bias.to(cd)).reshape(2, 7, 48)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# On the card: the epilogue GEMM at the serve step's Mlp sites
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")


# The serve step's Mlp products (streaming_vitl, 16 images x 128 questions):
# (M, K, N, act): ViT-L, BERT (and BTIA's text rows), BTIA's image rows,
# the AD head.
MLP_SITES = [(9232, 1024, 4096, "gelu_tanh"), (9232, 4096, 1024, None), (65536, 768, 3072, "gelu_tanh"),
             (65536, 3072, 768, None), (102400, 768, 3072, "gelu_tanh"), (102400, 3072, 768, None),
             (131072, 768, 1536, "gelu_tanh"), (131072, 1536, 768, None)]


@pytest.mark.chip
@pytest.mark.parametrize("M,K,N,act", MLP_SITES)
def test_epilogue_gemm_at_the_mlp_sites(M, K, N, act, card):
    """``gemm_bias`` with the bias (and at fc1 the GELU) in its epilogue
    against an f32 reference of the same function on the same bf16
    operands: each element within one bf16 step of the reference, plus a
    floor of 1e-6 of its largest magnitude for every 768 of K (the tensor
    cores' f32 accumulation truncates, so its error grows with K: the
    kernel read up to 1.5e-6 of the largest beyond a step at K = 4096 on an
    H100, bf16 ``addmm`` 4.4e-5)."""
    g = torch.Generator(device=card).manual_seed(M + K)
    a = torch.randn(M, K, generator=g, device=card).to(BF16)
    w = (torch.randn(K, N, generator=g, device=card) * K**-0.5).to(BF16)
    b = torch.randn(N, generator=g, device=card) * 0.02
    got = G.gemm_bias(a, w, b, act=act).float()
    want = a.float() @ w.float() + b
    if act:
        want = F.gelu(want, approximate="tanh")
    assert bool(torch.isfinite(got).all())
    floor = 1e-6 * max(1.0, K / 768) * want.abs().max()
    assert bool(((got - want).abs() <= _bf16_step(want) + floor).all())


@pytest.mark.chip
@pytest.mark.parametrize("M,K,N,rr", [(65536, 768, 768, 0), (65536, 768, 1536, 0), (65536, 768, 768, 65536),
                                      (131072, 768, 768, 64), (12608, 768, 1536, 0)])
def test_projection_gemm_without_act_at_k1_k2_sites(M, K, N, rr, card):
    """K1/K2's projection sites (no activation, the kernel's act 0
    instance): within one bf16 step of ``_proj_plain`` (plus the residual's
    rounding). That they keep the earlier kernel's bits is
    ``compare_kernels.py``'s to show (its gemm group, max |parent - this|)."""
    g = torch.Generator(device=card).manual_seed(M + N)
    a = torch.randn(M, K, generator=g, device=card).to(BF16)
    w = (torch.randn(K, N, generator=g, device=card) * K**-0.5).to(BF16)
    b = torch.randn(N, generator=g, device=card) * 0.02
    r = torch.randn(rr, N, generator=g, device=card).to(BF16) if rr else None
    got = G.gemm_bias(a, w, b, r, rr)
    y0 = FA._proj_plain(a, w, b, BF16)
    want = y0 if r is None else (y0.float() + r.float().repeat(M // rr, 1)).to(BF16)
    tol = _bf16_step(want) + (0 if r is None else _bf16_step(y0)) + 1e-6 * want.float().abs().max()
    assert bool(((got.float() - want.float()).abs() <= tol).all())
