"""The models' LayerNorms on K7 (``ops/norms.py::layernorm``), on the CPU.

(a) On a CPU tensor ``layernorm`` is ``_ln_exact``, its plain twin, bit for
bit, gradients too, and a small ``vqa_rad_lstm`` and ``streaming_vitl`` give
the logits of the plain formula exactly.

(b) ``layernorm``'s CUDA half forced onto CPU tensors (its route takes the
kernel road whatever the device), against a stand-in for the kernel library
that reads and writes the tensors through the pointers it is handed and
computes K7's arithmetic (the twin's). A small ``streaming_vitl`` serve
forward sends each standalone LayerNorm to K7 exactly once: the launches
equal the model's census (the calls of ``layernorm`` from its modules) and
``2 ViT depth + BERT depth + 2 BTIA layers + 6``, and the plain formula
runs 0 times. Its logits match the plain forward: fp32 within 1e-5 of the
largest magnitude, bf16 within 1/32 of it (the tolerances of
``test_torch_simt_route.py``; the stand-in computes the twin's arithmetic,
so here they are met exactly). The same holds for BERT's train-time post-LN,
for ``_unfused_site`` (also as K1's backward recompute) and for a block
under ``remat``, whose gradients equal autograd through the plain formula:
K7's backward is the vjp of ``_ln_exact``.

(c) K7's host code at widths 4,097, 6,144 and 8,192, above the 4,096 its
register kernels hold, hands the stand-in the same arguments as at 768;
its forward and backward host code at aligned (48, 768, 1,024) and ragged
(1,500, 4,097) widths, in place, and with no gradient wanted for scale and
bias, hands the C entries what they read, and their outputs are the
twins', bit for bit.

K7's backward (``layernorm_backward``, its own count) is forced with the
forward: the stand-in's ``btia_layernorm_bwd`` computes the twin's vjp
through the pointers it is handed. A LayerNorm's backward launches it once
(BERT's post-LN and ln_mlp, ``_unfused_site`` as K1's recompute, a remat
block, every LayerNorm of a small ``vqa_med_full`` train step), and the
plain formula runs 0 times in forward or backward.
"""

import numpy as np
import pytest
import torch

from btia_tpu_torch.configs import get_config
from btia_tpu_torch.core.dtypes import DTypePolicy
from btia_tpu_torch.models import bert, layers
from btia_tpu_torch.models.bert import BertLayer, BertSpec
from btia_tpu_torch.models.model import build_model
from btia_tpu_torch.models.vit import VIT_SPECS, ViTBlock
from btia_tpu_torch.ops import _native
from btia_tpu_torch.ops import fused_attn as FA
from btia_tpu_torch.ops import norms as N
from btia_tpu_torch.ops.norms import _ln_exact

F32, BF16 = torch.float32, torch.bfloat16
VITL_SMALL = {
    "model.image_encoder": "vit_test", "model.bert_layers": 2, "model.bert_hidden": 128,
    "model.bert_heads": 2, "model.hidden_dim": 128, "model.num_heads": 2, "model.btia_layers": 1,
    "model.answer_vocab_size": 64, "model.num_answer_queries": 8,
}
LSTM_SMALL = {"model.image_encoder": "resnet_tiny", "model.hidden_dim": 128, "model.num_heads": 2,
              "model.btia_layers": 1, "model.answer_vocab_size": 32, "model.question_vocab_size": 100,
              "model.word_embed_dim": 32, "model.lstm_hidden": 64, "model.max_question_len": 12}
# The modules that call layernorm, by the name each imported.
CALLERS = (layers, bert, FA)


def _rand(rng, *shape, dt=F32, scale=1.0, shift=0.0):
    return torch.from_numpy((rng.randn(*shape) * scale + shift).astype(np.float32)).to(dt)


def _ln_params(rng, d):
    return 1 + _rand(rng, d, scale=0.2), _rand(rng, d, scale=0.1)


def _close(got, want, dt):
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= (1e-5 if dt == F32 else 1 / 32) * scale


def _close_grads(got, want, dt):
    """Gradients within the tolerance of the largest of them all: some are 0
    in exact arithmetic (a key projection's bias under softmax)."""
    scale = max(w.float().abs().max().item() for w in want)
    tol = (1e-5 if dt == F32 else 1 / 32) * scale
    assert all((a.float() - b.float()).abs().max().item() <= tol for a, b in zip(got, want))


def _plain_layernorm(x, scale, bias, eps=1e-6, fast=False):
    return _ln_exact(x, scale, bias, eps)


# ---------------------------------------------------------------------------
# (a) the CPU road
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [48, 768, 6144])
def test_cpu_layernorm_is_the_twin_bit_for_bit(D, dt):
    rng = np.random.RandomState(D)
    x = _rand(rng, 3, 7, D, dt=dt, scale=2.0, shift=0.5)
    sc, bi = _ln_params(rng, D)
    g = _rand(rng, 3, 7, D, dt=dt)
    leaves = [t.clone().requires_grad_(True) for t in (x, sc, bi)]
    twins = [t.clone().requires_grad_(True) for t in (x, sc, bi)]
    before = N.layernorm.launches
    out = N.layernorm(*leaves, 1e-6)
    want = _ln_exact(*twins, 1e-6)
    assert N.layernorm.launches == before and out.dtype == dt
    assert torch.equal(out, want)
    for a, b in zip(torch.autograd.grad(out, leaves, g), torch.autograd.grad(want, twins, g)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("config,over,shape", [
    ("streaming_vitl", VITL_SMALL, dict(B=2, size=96, Q=32, L=32, vocab=500)),
    ("vqa_rad_lstm", LSTM_SMALL, dict(B=8, size=64, Q=1, L=12, vocab=100)),
])
def test_cpu_logits_are_the_plain_formulas(config, over, shape, monkeypatch):
    model = build_model(get_config(config, **over).model, device="cpu", seed=0)
    images, qids = _inputs(np.random.RandomState(3), **shape)
    with torch.inference_mode():
        got = model.answer_questions(model.encode_image(images), qids)
        for mod in CALLERS:
            monkeypatch.setattr(mod, "layernorm", _plain_layernorm)
        want = model.answer_questions(model.encode_image(images), qids)
    assert torch.equal(got, want)


def _inputs(rng, B, size, Q, L, vocab):
    images = torch.from_numpy(rng.randint(0, 256, (B, size, size, 3)).astype(np.uint8))
    qids = np.zeros((B, Q, L), np.int64)
    for i in range(B):
        for j in range(Q):
            n = rng.randint(3, L + 1)
            qids[i, j, :n] = rng.randint(1, vocab, n)
    return images, torch.from_numpy(qids)


# ---------------------------------------------------------------------------
# (b) the CUDA half forced onto CPU tensors, against a stand-in library
# ---------------------------------------------------------------------------


def _view(ptr, dtype, rows, D):
    """The (rows, D) row-major tensor at host address `ptr`, aliasing that
    memory (writes go through)."""
    import ctypes

    size = torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_char * (rows * D * size)).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).view(rows, D)


class _K7Lib:
    """K7's C entry on the host: reads x, scale and bias through their
    pointers, writes the output through its own (x's memory when in place),
    computes the twin's arithmetic, records each call. Any other entry fails
    the test: the forced road is K7's alone."""

    PARTS = 7  # the stand-in's wave: fewer blocks than most calls' rows

    def __init__(self):
        self.calls = []
        self.bwd_calls = []
        self.parts_calls = []

    def btia_layernorm(self, x, out, scale, bias, rows, D, eps, elem, stream):
        dt = (BF16, F32)[elem]
        self.calls.append({"dtype": dt, "rows": rows, "D": D, "eps": eps, "in_place": x == out,
                           "stream": stream})
        y = _ln_exact(_view(x, dt, rows, D).clone(), _view(scale, F32, 1, D)[0], _view(bias, F32, 1, D)[0], eps)
        _view(out, dt, rows, D).copy_(y)
        return 0

    def btia_layernorm_bwd_parts(self, x, g, scale, dx, rows, D, elem):
        """The partial rows the backward's grid needs: here a wave of PARTS
        blocks, no more than the rows."""
        self.parts_calls.append({"rows": rows, "D": D, "dx": dx is not None, "elem": elem})
        return min(rows, self.PARTS)

    def btia_layernorm_bwd(self, x, g, scale, dx, dscale, dbias, part, part_rows, rows, D, eps, elem, stream):
        """The vjp of the twin (``_ln_exact`` as this module imported it, not
        the counted one) through the pointers; bias is not handed over, and
        no gradient depends on it. dscale, dbias and the partial rows come
        together, or not at all."""
        dt = (BF16, F32)[elem]
        params = dscale is not None
        assert params == (dbias is not None) == (part is not None)
        assert part_rows == (min(rows, self.PARTS) if params else 0)
        self.bwd_calls.append({"dtype": dt, "rows": rows, "D": D, "eps": eps, "dx": dx is not None,
                               "params": params, "part_rows": part_rows, "stream": stream})
        leaves = [_view(x, dt, rows, D).clone().requires_grad_(dx is not None),
                  _view(scale, F32, 1, D)[0].clone().requires_grad_(params),
                  torch.zeros(D, requires_grad=params)]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(_ln_exact(*leaves, eps), [t for t in leaves if t.requires_grad],
                                             _view(g, dt, rows, D)))
        if dx is not None:
            _view(dx, dt, rows, D).copy_(next(grads))
        if params:
            _view(dscale, F32, 1, D)[0].copy_(next(grads))
            _view(dbias, F32, 1, D)[0].copy_(next(grads))
        return 0

    def __getattr__(self, name):
        pytest.fail(f"{name} was called on the forced LayerNorm road")


def _force_k7(monkeypatch):
    """``layernorm``'s and ``layernorm_backward``'s routes take their CUDA
    halves for CPU tensors too, against the stand-in; every other entry
    routes as before (its twin). Returns the stand-in and a list that grows
    by one at each call of the plain formula ``N._ln_exact``."""
    lib = _K7Lib()
    plain_calls = []
    real_route, real_exact = _native.route, N._ln_exact
    forced = (N.layernorm, N.layernorm_backward)

    def route(entry, t, cuda_fn, plain_fn, *args):
        if entry not in forced:
            return real_route(entry, t, cuda_fn, plain_fn, *args)
        out = cuda_fn(*args)
        entry.launches += 1
        return out

    def require(t, what, dtype=BF16, contiguous=True):
        if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)) or (contiguous and not t.is_contiguous()):
            raise ValueError(f"{what}: {t.dtype}, contiguous={t.is_contiguous()}")

    monkeypatch.setattr(_native, "route", route)
    monkeypatch.setattr(_native, "lib", lambda: lib)
    monkeypatch.setattr(_native, "require", require)
    monkeypatch.setattr(_native, "stream", lambda t: 0)
    monkeypatch.setattr(N, "_ln_exact", lambda *a: plain_calls.append(a[0].shape) or real_exact(*a))
    return lib, plain_calls


@pytest.fixture
def k7_forced(monkeypatch):
    return _force_k7(monkeypatch)


def _census(monkeypatch, fn):
    """The calls of ``layernorm`` from the model's modules while fn() runs,
    by (rows, width)."""
    seen = {}
    real = N.layernorm

    def spy(x, *a, **kw):
        key = (x.numel() // x.shape[-1], x.shape[-1])
        seen[key] = seen.get(key, 0) + 1
        return real(x, *a, **kw)

    for mod in CALLERS:
        monkeypatch.setattr(mod, "layernorm", spy)
    try:
        out = fn()
    finally:
        for mod in CALLERS:
            monkeypatch.setattr(mod, "layernorm", real)
    return out, seen


@pytest.mark.parametrize("mixed", [True, False], ids=["bf16", "fp32"])
def test_small_serve_forward_sends_every_layernorm_to_k7_once(mixed, monkeypatch):
    over = {**VITL_SMALL, "model.mixed_precision": mixed}
    cfg = get_config("streaming_vitl", **over)
    model = build_model(cfg.model, device="cpu", seed=0)
    images, qids = _inputs(np.random.RandomState(4), B=2, size=96, Q=32, L=32, vocab=500)
    run = lambda: model.answer_questions(model.encode_image(images), qids)
    with torch.inference_mode():
        plain, census = _census(monkeypatch, run)
        lib, plain_calls = _force_k7(monkeypatch)
        before = N.layernorm.launches, N.layernorm_fast.launches
        got = run()
    m = cfg.model
    expected = 2 * VIT_SPECS[m.image_encoder].depth + m.bert_layers + 2 * m.btia_layers + 6
    launches = N.layernorm.launches - before[0]
    assert launches == sum(census.values()) == expected == len(lib.calls)
    assert N.layernorm_fast.launches == before[1]
    assert plain_calls == []  # none left on the plain formula
    cd = BF16 if mixed else F32
    assert {c["dtype"] for c in lib.calls} == {cd}
    assert sorted((c["rows"], c["D"]) for c in lib.calls) == sorted(k for k, n in census.items() for _ in range(n))
    _close(got, plain, cd)


@pytest.mark.parametrize("dt", [F32, BF16], ids=["fp32", "bf16"])
def test_bert_train_time_post_ln_on_k7(dt, k7_forced):
    """BERT's post-LN at train time (``bert.py``: dropout between the
    attention and the residual, so the LN is not folded into K1): two
    launches a layer (post-LN and ln_mlp), gradients equal to autograd
    through the plain formula."""
    lib, plain_calls = k7_forced
    rng = np.random.RandomState(6)
    policy = DTypePolicy(compute_dtype=dt)
    layer = BertLayer(BertSpec(vocab_size=50, dim=128, depth=1, num_heads=2, mlp_dim=256), policy, device="cpu")
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(_rand(rng, *p.shape, scale=0.05) + (1.0 if p.dim() == 1 and p.shape[0] == 128 else 0.0))
    x = _rand(rng, 4, 9, 128, dt=dt).requires_grad_(True)
    mask = torch.ones(4, 9, dtype=torch.bool)
    drop = layers.Dropout(0.0, torch.Generator().manual_seed(0))  # train-time structure, no element dropped
    before = N.layernorm.launches, N.layernorm_backward.launches
    out = layer(x, mask, drop, train=True)
    assert N.layernorm.launches - before[0] == 2 == len(lib.calls) and plain_calls == []
    g = _rand(rng, *out.shape, dt=dt)
    got = torch.autograd.grad(out, [x, *layer.parameters()], g)
    # One backward launch a LayerNorm, every gradient wanted; no plain chain.
    assert N.layernorm_backward.launches - before[1] == 2 == len(lib.bwd_calls) and plain_calls == []
    assert all(c["dx"] and c["params"] and c["dtype"] == dt for c in lib.bwd_calls)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bert, "layernorm", _plain_layernorm)
        mp.setattr(layers, "layernorm", _plain_layernorm)
        want_out = layer(x, mask, drop, train=True)
        want = torch.autograd.grad(want_out, [x, *layer.parameters()], g)
    _close(out, want_out, dt)
    _close_grads(got, want, dt)


def _site(rng, dt, din=128, H=2):
    w = [_rand(rng, *s, scale=0.05) for s in ((din, 128), (128,), (din, 128), (128,), (din, 128), (128,),
                                               (128, din), (din,))]
    lns = dict(q_ln=(*_ln_params(rng, din), 1e-6), kv_ln=(*_ln_params(rng, din), 1e-6), residual=True,
               post_ln=(*_ln_params(rng, din), 1e-12))
    return w, lns


@pytest.mark.parametrize("dt", [F32, BF16], ids=["fp32", "bf16"])
def test_unfused_site_and_k1_backward_recompute_on_k7(dt, k7_forced):
    """``_unfused_site`` with its three LNs: three launches and the plain
    site's output; K1's fused forward (the twin here) then its backward,
    which recomputes ``_unfused_site``: three launches there, gradients
    equal to the recompute through the plain formula."""
    lib, plain_calls = k7_forced
    rng = np.random.RandomState(7)
    w, lns = _site(rng, dt)
    x_q, x_kv = _rand(rng, 3, 9, 128, dt=dt), _rand(rng, 3, 13, 128, dt=dt)
    m = torch.from_numpy(rng.rand(3, 13) > 0.3)
    m[:, 0] = True
    before = N.layernorm.launches
    got = FA._unfused_site(x_q, x_kv, m, *w, 2, **lns)
    assert N.layernorm.launches - before == 3 == len(lib.calls) and plain_calls == []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FA, "layernorm", _plain_layernorm)
        want = FA._unfused_site(x_q, x_kv, m, *w, 2, **lns)
    _close(got, want, dt)

    leaves = [t.clone().requires_grad_(True) for t in (x_q, x_kv, *w)]
    g = _rand(rng, 3, 9, 128, dt=dt)

    def grads():
        out = FA.fused_dense_attention(leaves[0], leaves[1], m, *leaves[2:], 2, interpret=True, **lns)
        return torch.autograd.grad(out, leaves, g)

    calls = len(lib.calls)
    got = grads()
    assert len(lib.calls) - calls == 3  # the recompute's q, kv and post LNs
    assert len(lib.bwd_calls) == 3 and plain_calls == []  # and their backward, once each
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FA, "layernorm", _plain_layernorm)
        want = grads()
    _close_grads(got, want, dt)


def test_remat_block_recomputes_its_layernorms_on_k7(k7_forced):
    """A ViT block under ``remat``: its two LNs launch K7 in the forward and
    again in the backward's recompute; the gradients equal the plain
    block's."""
    lib, _ = k7_forced
    rng = np.random.RandomState(8)
    block = ViTBlock(64, 4, 2.0, DTypePolicy(compute_dtype=F32), device="cpu")
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(_rand(rng, *p.shape, scale=0.05) + (1.0 if p.dim() == 1 and p.shape[0] == 64 else 0.0))
    x = _rand(rng, 2, 17, 64).requires_grad_(True)
    g = _rand(rng, 2, 17, 64)
    before = N.layernorm.launches
    out = layers.remat(block, x, drop=None, train=True)
    assert N.layernorm.launches - before == 2
    got = torch.autograd.grad(out, [x, *block.parameters()], g)
    assert N.layernorm.launches - before == 4 == len(lib.calls)
    # The recompute's graph feeds the forward's nodes: one backward each.
    assert len(lib.bwd_calls) == 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "layernorm", _plain_layernorm)
        want = torch.autograd.grad(block(x, None, True), [x, *block.parameters()], g)
    _close_grads(got, want, F32)


# ---------------------------------------------------------------------------
# (c) K7's host code at any width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [4097, 6144, 8192])
def test_k7_host_code_at_wide_rows_as_at_768(D, dt, k7_forced):
    lib, _ = k7_forced
    rng = np.random.RandomState(D)
    outs = {}
    for width in (768, D):
        x = _rand(rng, 2, 3, width, dt=dt, scale=2.0, shift=0.5)
        sc, bi = _ln_params(rng, width)
        outs[width] = (N._layernorm_cuda(x, sc, bi, 1e-6), _ln_exact(x, sc, bi, 1e-6))
        y = x.clone()
        assert N._layernorm_cuda(y, sc, bi, 1e-6, out=y) is y  # in place, as K1's post-LN
        assert torch.equal(y, outs[width][1])
    narrow, wide = lib.calls[0:2], lib.calls[2:4]
    assert [{**c, "D": None} for c in wide] == [{**c, "D": None} for c in narrow]
    assert [c["D"] for c in wide] == [D, D] and [c["in_place"] for c in wide] == [False, True]
    assert all(c["rows"] == 6 and c["dtype"] == dt for c in lib.calls)
    for got, want in outs.values():
        assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("dt", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [48, 768, 1024, 1500, 4097])
def test_k7_forward_host_code_aligned_ragged_in_place(D, dt, k7_forced):
    """The forward's host code at widths of 16-byte rows (48, 768, 1024) and
    ragged ones (1500 in bf16, 4097): one call of the C entry with x's rows,
    width, eps and type, f32 scale and bias (a bf16 scale converted), out of
    place and in place (K1's post-LN), each the twin bit for bit."""
    lib, _ = k7_forced
    rng = np.random.RandomState(D)
    x = _rand(rng, 3, 5, D, dt=dt, scale=2.0, shift=0.5)
    sc, bi = _ln_params(rng, D)
    want = _ln_exact(x, sc, bi, 1e-5)
    got = N._layernorm_cuda(x, sc.to(BF16), bi, 1e-5)
    assert torch.equal(got, _ln_exact(x, sc.to(BF16).float(), bi, 1e-5))
    y = x.clone()
    assert N._layernorm_cuda(y, sc, bi, 1e-5, out=y) is y and torch.equal(y, want)
    assert [(c["rows"], c["D"], c["dtype"], c["in_place"]) for c in lib.calls] == [(15, D, dt, False),
                                                                                 (15, D, dt, True)]
    assert all(c["eps"] == pytest.approx(1e-5) for c in lib.calls)


@pytest.mark.parametrize("dt", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [48, 768, 1500, 6144])
@pytest.mark.parametrize("needs", [(True, True, True), (True, False, False), (False, True, True),
                                   (True, True, False)], ids=["all", "dx", "params", "dscale"])
def test_k7_backward_host_code(needs, D, dt, k7_forced):
    """The backward's host code: one call of ``btia_layernorm_bwd`` with x
    and g's rows (g made contiguous), x's type, null dx where x needs no
    gradient, dscale, dbias and as many partial rows as
    ``btia_layernorm_bwd_parts`` asks for x's rows, width and type where
    scale or bias needs one (null and no query where neither does: no
    column sums); the gradients the twin's (``_ln_exact_vjp``) bit for bit,
    None where not wanted."""
    lib, plain_calls = k7_forced
    rng = np.random.RandomState(D + 7)
    x = _rand(rng, 280, D, dt=dt, scale=2.0, shift=0.5)  # 2-D: the stand-in's dscale sums as the twin's
    sc, bi = _ln_params(rng, D)
    g = _rand(rng, D, 280, dt=dt).t()  # not contiguous
    before = N.layernorm_backward.launches
    got = N.layernorm_backward(x, sc, bi, g, 1e-6, needs)
    want = N._ln_exact_vjp(x, sc, bi, g.contiguous(), 1e-6, needs)  # g's layout orders the twin's sums
    assert N.layernorm_backward.launches - before == 1 and len(plain_calls) == 1  # the twin's, here
    params = needs[1] or needs[2]
    assert lib.bwd_calls == [{"dtype": dt, "rows": 280, "D": D, "eps": pytest.approx(1e-6), "dx": needs[0],
                              "params": params, "part_rows": 7 if params else 0, "stream": 0}]
    assert lib.parts_calls == ([{"rows": 280, "D": D, "dx": needs[0], "elem": int(dt == F32)}] if params else [])
    for a, b in zip(got, want):
        assert (a is None) == (b is None) and (a is None or (a.dtype == b.dtype and torch.equal(a, b)))


def test_k7_backward_host_code_no_rows(k7_forced):
    """No rows: nothing is launched; dscale and dbias are zeros."""
    lib, _ = k7_forced
    x = torch.empty(0, 3, 64)
    dx, ds, db = N.layernorm_backward(x, torch.ones(64), torch.zeros(64), torch.empty(0, 3, 64), 1e-6)
    assert lib.bwd_calls == [] and dx.shape == x.shape
    assert torch.equal(ds, torch.zeros(64)) and torch.equal(db, torch.zeros(64))


def test_small_train_step_one_backward_launch_a_layernorm(k7_forced):
    """One ``make_train_step`` step of a small ``vqa_med_full`` (vit_test, 2
    BERT layers, one BTIA layer; fp32, dropout 0, batch 8: the sites take
    the unfused road) with K7 forced: every LayerNorm of the step launches
    the forward once and its backward once (the census of the forward's
    calls), the plain formula never runs, and the step's loss and gradient
    norm are the unforced step's."""
    from btia_tpu_torch.train import steps as S

    lib, plain_calls = k7_forced
    over = {**VITL_SMALL, "model.mixed_precision": False, "model.dropout": 0.0, "train.warmup_steps": 2}
    cfg = get_config("vqa_med_full", **{k: v for k, v in over.items() if k != "model.num_answer_queries"})
    rng = np.random.RandomState(9)
    images, qids = _inputs(rng, B=8, size=64, Q=1, L=32, vocab=500)
    batch = {"images": images, "question_ids": qids[:, 0], "answer_ids": torch.from_numpy(rng.randint(0, 64, 8)),
             "valid": torch.ones(8, dtype=torch.bool)}

    def one_step():
        model = build_model(cfg.model, device="cpu", seed=0)
        state = S.create_state(model, cfg, steps_per_epoch=10)
        _, met = S.make_train_step(model, cfg)(state, batch)
        return met

    before = N.layernorm.launches, N.layernorm_backward.launches
    got = one_step()
    fwd, bwd = N.layernorm.launches - before[0], N.layernorm_backward.launches - before[1]
    m = cfg.model
    # ViT 2 a block + the final, BERT's embedding LN and 2 ln_mlp + 2 train-time
    # post-LNs, txt_ln, img_ln, the BTIA layer's 2 and its 2 sites' 4 (q and
    # kv, unfused), the AD head's 3 (its site's kv LN, ln_mlp, ln_out).
    assert fwd == bwd == len(lib.calls) == len(lib.bwd_calls) > 2 * m.bert_layers + 2 * m.btia_layers
    assert all(c["dx"] or c["params"] for c in lib.bwd_calls) and plain_calls == []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_native, "route", lambda e, t, c, p, *a: p(*a))
        want = one_step()
    for k in ("loss", "grad_norm"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6, abs=1e-7)
