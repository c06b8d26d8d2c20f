"""The host side of K1/K2's attention core and of their prepared weights.

The core runs on the card only (``csrc/short_flash.cuh`` in its zero-rows
mode, entry ``btia_attn_core`` in ``csrc/fused_attn.cu``), so what is held
here is what the wrapper hands it:

* the (batch, head, row) strides and element offsets of ``core_operands``
  address the twin's head views (``attention._heads``) in the chain's
  buffers: q in the (B*Sq, HD) GEMM output, k and v side by side in the
  (B*Sk, 2*HD) ``[k|v]`` output, o in a (B*Sq, HD) buffer, and K2's shared
  (K, HD) query table, read at batch coordinate 0 for every batch row;
* ``short_plan`` / ``short_items`` store every (b, h, q row) exactly once at
  the K1/K2 sites of the registered configs, and every plan is one the
  kernel takes (``sf_plan_ok``);
* the weights the chain prepares once per weight version (``prepare_once``)
  equal the per-call formula bit for bit, are reused while the parameters
  are unchanged, and are made again after an in-place update (an ``AdamW``
  step).

The twins' agreement with the JAX Pallas kernels is held by
``test_torch_kernels.py``, ``test_torch_headwidth.py`` and
``test_torch_gate.py``.
"""

import numpy as np
import pytest
import torch

from btia_tpu_torch.ops import attention as A
from btia_tpu_torch.ops import fused_attn as FA
from btia_tpu_torch.ops import gemm as G

LOG2E = A.LOG2E

# (B, Sq, Sk, heads, head width)
STRIDE_CASES = [(3, 5, 7, 2, 64), (2, 9, 4, 3, 128), (2, 3, 6, 1, 192), (4, 33, 2, 1, 256)]


def _numbered(*shape):
    """A buffer whose every element holds its own flat index."""
    return torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)


def _view(buf, op, B, H, S, D):
    offset, strides = op
    return torch.as_strided(buf, (B, H, S, D), (*strides, 1), offset)


@pytest.mark.parametrize("B,Sq,Sk,H,D", STRIDE_CASES)
def test_core_operands_address_the_twin_head_views(B, Sq, Sk, H, D):
    """q, k, v and o read through core_operands are the (B, H, S, D) head
    views attend_log2 takes of the q rows and the two halves of each [k|v]
    row, with no copy; v starts at a 16-byte aligned offset."""
    HD = H * D
    ops = FA.core_operands(Sq, Sk, HD, H)
    q, kv, o = _numbered(B * Sq, HD), _numbered(B * Sk, 2 * HD), _numbered(B * Sq, HD)
    assert torch.equal(_view(q, ops["q"], B, H, Sq, D), A._heads(q.view(B, Sq, HD), H))
    assert torch.equal(_view(kv, ops["k"], B, H, Sk, D), A._heads(kv[:, :HD].reshape(B, Sk, HD), H))
    assert torch.equal(_view(kv, ops["v"], B, H, Sk, D), A._heads(kv[:, HD:].reshape(B, Sk, HD), H))
    assert torch.equal(_view(o, ops["o"], B, H, Sq, D), A._heads(o.view(B, Sq, HD), H))
    assert ops["v"][0] * 2 % 16 == 0  # bf16 elements: TMA's 16-byte base rule
    for _, strides in ops.values():
        assert all(s > 0 and s % 8 == 0 for s in strides)


@pytest.mark.parametrize("B,K,Sk,H,D", [(4, 8, 6, 2, 64), (3, 64, 82, 12, 64), (2, 5, 9, 3, 256)])
def test_shared_query_table_is_read_for_every_batch_row(B, K, Sk, H, D):
    """K2's (K, HD) table: encoded as one batch row (B = 1, its batch
    stride a nonzero multiple of 8), and loaded at batch coordinate 0 for
    every batch row, the rows past 0 included. Both give the twin's head
    view of the table broadcast over the batch; nothing is expanded."""
    HD = H * D
    ops = FA.core_operands(K, Sk, HD, H)
    table = _numbered(K, HD)
    offset, (sb, sh, ss) = ops["q"]
    assert sb > 0 and sb % 8 == 0
    assert torch.equal(_view(table, ops["q"], 1, H, K, D), A._heads(table[None], H))
    every_row = torch.as_strided(table, (B, H, K, D), (0, sh, ss, 1), offset)
    twin = A._heads(table[None].expand(B, K, HD), H)
    assert torch.equal(every_row, twin)
    assert torch.equal(every_row[B - 1], twin[B - 1]) and B > 1


# (name, (B, H, Sq, Sk), head width): the K1/K2 sites of the registered
# configs at full width, an interpret=True batch of 5, and a K2 table of 8
# queries over short rows, which packs.
CORE_PLANS = {
    "serve_bert": ((2048, 12, 32, 32), 64),
    "serve_i2t": ((2048, 12, 50, 32), 64),
    "serve_t2i": ((2048, 12, 32, 50), 64),
    "serve_k2": ((2048, 12, 64, 82), 64),
    "serve_k2_d256": ((2048, 3, 64, 82), 256),
    "train_bert": ((64, 12, 32, 32), 64),
    "train_i2t": ((64, 12, 197, 32), 64),
    "train_i2t_d192": ((64, 4, 197, 32), 192),
    "train_i2t_d256": ((64, 3, 197, 32), 256),
    "train_t2i": ((64, 12, 32, 197), 64),
    "eval_t2i_d128": ((128, 6, 32, 197), 128),
    "pathvqa_i2t": ((64, 12, 197, 32), 64),
    "pathvqa_eval_t2i": ((128, 12, 32, 197), 64),
    "slake_i2t": ((64, 12, 49, 32), 64),
    "interpret_batch_5": ((5, 2, 16, 16), 64),
    "k2_table_8_packs": ((64, 2, 8, 20), 64),
}


@pytest.mark.parametrize("name", sorted(CORE_PLANS))
def test_core_plan_stores_every_row_once(name):
    """The plan the core's wrapper asks for (short_plan, as _core_launcher
    calls it) stores each (b, h, q row) exactly once (short_items, the
    kernel's sf_decode), and passes the kernel's sf_plan_ok."""
    (B, H, Sq, Sk), D = CORE_PLANS[name]
    assert FA.core_admits(Sq, Sk, D) and FA.core_takes(D)
    plan = A.short_plan([(B, H, Sq, Sk)], D)
    bn, pack, q_span, k_span, groups, q_tiles = plan
    assert bn in (32, 64) and groups * pack >= B
    if pack == 1:
        assert (q_span, k_span) == (64, bn) and q_tiles * 64 >= Sq
    else:
        assert q_span % 8 == 0 and k_span % 8 == 0 and q_span >= Sq and k_span >= Sk
        assert pack * q_span <= 64 and pack * k_span <= bn and q_tiles == 1
    (rows,) = A.short_items([(B, H, Sq, Sk)], plan)
    flat = (rows[:, 0] * H + rows[:, 1]) * Sq + rows[:, 2]
    assert rows.shape[0] == B * H * Sq
    assert torch.equal(torch.bincount(flat, minlength=B * H * Sq), torch.ones(B * H * Sq, dtype=torch.int64))
    if name == "k2_table_8_packs":
        assert pack > 1
    if name == "serve_bert":
        assert plan == [64, 2, 32, 32, 1024, 1]


def _params(rng, *shape):
    return torch.nn.Parameter(torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.05))


def _site_params(seed, din=128, hd=128):
    rng = np.random.RandomState(seed)
    return [_params(rng, *s) for s in ((din, hd), (hd,), (din, hd), (hd,), (din, hd), (hd,), (hd, din), (din,))]


def _dense_formula(wq, bq, wk, bk, wv, bv, wo, bo, num_heads, cd):
    """The per-call preparation K1's chain made before it was cached: the
    GEMM operands as ``gemm_bias`` received and cast them."""
    c = (1.0 / (wq.shape[1] // num_heads) ** 0.5) * LOG2E
    return ((wq.float() * c).to(cd), bq.float() * c, torch.cat([wk, wv], dim=1).to(cd),
            torch.cat([bk, bv]).float(), wo.to(cd), bo.float())


def _static_q_formula(queries, wq, bq, wk, bk, wv, bv, wo, bo, num_heads, cd):
    """K2's per-call preparation, as ``_dense_formula``."""
    c = (1.0 / (wq.shape[1] // num_heads) ** 0.5) * LOG2E
    table = ((queries.float() @ wq.float() + bq.float()) * c).to(cd)
    return (table, torch.cat([wk, wv], dim=1).to(cd), torch.cat([bk, bv]).float(), wo.to(cd), bo.float(),
            queries.to(cd))


def _bits(t):
    return t.detach().contiguous().view(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)


def _bitwise_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous()
        assert torch.equal(_bits(g), _bits(w))


def _adamw_step(params):
    opt = torch.optim.AdamW(params, lr=1e-2)
    loss = sum((p.float() ** 2).sum() for p in params)
    loss.backward()
    opt.step()


@pytest.mark.parametrize("num_heads", [1, 2])
def test_dense_weights_prepared_once_per_version(num_heads):
    """K1's prepared GEMM operands equal the per-call formula bit for bit;
    a second call with the parameters unchanged hands back the same
    tensors without preparing; an AdamW step makes them again, equal to
    the formula on the updated parameters; none is an inference tensor or
    carries autograd history, even when made inside inference mode."""
    w = _site_params(seed=num_heads)
    cd = torch.bfloat16
    builds = G.prepare_once.builds
    with torch.inference_mode():
        first = FA._dense_weights(*w, num_heads, cd)
    assert G.prepare_once.builds == builds + 1
    with torch.no_grad():
        _bitwise_equal(first, _dense_formula(*w, num_heads, cd))
    assert not any(t.is_inference() or t.grad_fn is not None for t in first)
    again = FA._dense_weights(*w, num_heads, cd)
    assert all(a is b for a, b in zip(again, first)) and G.prepare_once.builds == builds + 1
    _adamw_step(w)
    after = FA._dense_weights(*w, num_heads, cd)
    assert G.prepare_once.builds == builds + 2
    with torch.no_grad():
        _bitwise_equal(after, _dense_formula(*w, num_heads, cd))
    assert not torch.equal(after[0], first[0]) and not torch.equal(after[2], first[2])


def test_static_q_weights_prepared_once_per_version():
    """K2's prepared operands, the projected query table among them, equal
    the per-call formula bit for bit and are made again after an AdamW step
    that moves the queries and the weights."""
    rng = np.random.RandomState(7)
    queries = _params(rng, 8, 128)
    w = _site_params(seed=8)
    cd = torch.bfloat16
    first = FA._static_q_weights(queries, *w, 2, cd)
    _bitwise_equal(first, _static_q_formula(queries.detach(), *(t.detach() for t in w), 2, cd))
    assert all(a is b for a, b in zip(FA._static_q_weights(queries, *w, 2, cd), first))
    _adamw_step([queries, *w])
    after = FA._static_q_weights(queries, *w, 2, cd)
    _bitwise_equal(after, _static_q_formula(queries.detach(), *(t.detach() for t in w), 2, cd))
    assert not torch.equal(after[0], first[0])


def test_prepared_weights_follow_load_state_dict_and_free_with_their_model():
    """load_state_dict copies into the parameters in place (their version
    moves), so the next call prepares from the loaded values; when the
    parameters are freed, their entries and prepared tensors go too."""
    lin = torch.nn.ModuleList(torch.nn.Linear(64, 64) for _ in range(4))
    w = [t for m in lin for t in (m.weight, m.bias)]
    cd = torch.bfloat16
    first = FA._dense_weights(*w, 1, cd)
    other = torch.nn.ModuleList(torch.nn.Linear(64, 64) for _ in range(4))
    lin.load_state_dict(other.state_dict())
    loaded = FA._dense_weights(*w, 1, cd)
    with torch.no_grad():
        _bitwise_equal(loaded, _dense_formula(*w, 1, cd))
    assert not torch.equal(loaded[0], first[0])
    held = len(G._PREPARED)
    del lin, w, first, loaded
    assert len(G._PREPARED) == held - 1


def test_a_source_prepared_as_itself_is_not_held_alive():
    """A cast to the dtype a parameter already has returns the parameter;
    the entry keeps it by index, so freeing the parameter still frees the
    entry."""
    p = torch.nn.Parameter(torch.ones(4, 8, dtype=torch.bfloat16))
    out = G.prepare_once((p,), ("cast", torch.bfloat16), lambda: (p.to(torch.bfloat16),))
    assert out[0] is p
    assert G.prepare_once((p,), ("cast", torch.bfloat16), lambda: (p.to(torch.bfloat16),))[0] is p
    held = len(G._PREPARED)
    del p, out
    assert len(G._PREPARED) == held - 1
