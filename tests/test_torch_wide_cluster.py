"""The host side of the wide-head kernel's cluster design
(``csrc/attn_wide.cu``, ``ops/attention.py``): its plan (a thread block
cluster of one block a column slice), the argument array its launcher packs
in one pass (``attend_args``), and the f32 route's arguments, the same
array.

The end-to-end cases run every entry's CUDA half on CPU tensors against
``test_torch_simt_route.py``'s stand-in library, which reads the tensors
through the pointers and strides it is handed, refuses what the C entry
refuses and computes what the kernel computes; bf16 within 1/32 of the
largest magnitude of the plain twin, as there.
"""

import ctypes

import numpy as np
import pytest
import torch

from btia_tpu_torch.ops import attention as A
from btia_tpu_torch.ops import bicross as BX
from btia_tpu_torch.ops import fused_attn as FA

from test_torch_simt_route import _close, _FakeLib, _mask, _rand, _specs, fake_lib  # noqa: F401  (fixture)

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dw", range(264, 1025, 8))
def test_wide_plan_is_a_cluster_of_slices(dw):
    """Every head width the wide route takes (257-1024, padded to a multiple
    of 8): the cluster's blocks cover the columns [0, dw) once each, each
    block at least one column; the cluster has as many blocks as slices,
    2 to 4; the slice width is a multiple of 64 and at most 256."""
    sw, n = A.wide_plan(dw)
    assert sw % 64 == 0 and sw <= A.WIDE_SLICE and 2 <= n <= 4
    cols = torch.zeros(dw, dtype=torch.int64)
    for r in range(n):
        lo, hi = r * sw, min((r + 1) * sw, dw)
        assert hi > lo  # every block owns columns
        cols[lo:hi] += 1
    assert bool((cols == 1).all()) and n * sw >= dw
    assert n == (2 if dw <= 512 else 3 if dw <= 768 else 4)


def test_wide_plan_is_cached():
    """One plan a head width, computed once (``functools.lru_cache``)."""
    A.wide_plan.cache_clear()
    A.wide_plan(384)
    A.wide_plan(384)
    info = A.wide_plan.cache_info()
    assert (info.hits, info.misses) == (1, 1)


# The kernel's instances (csrc/attn_wide.cu: aw_dispatch): (slice width,
# cluster size).
WIDE_INSTANCES = {(192, 2), (256, 2), (192, 3), (256, 3), (256, 4)}


@pytest.mark.parametrize("lo,hi,plan", [(264, 384, (192, 2)), (392, 512, (256, 2)), (520, 576, (192, 3)),
                                        (584, 768, (256, 3)), (776, 1024, (256, 4))])
def test_wide_plan_takes_a_built_instance(lo, hi, plan):
    """Each head width maps to one of the instances the C entry dispatches
    to, over the ranges its source note names."""
    assert plan in WIDE_INSTANCES
    assert {A.wide_plan(dw) for dw in range(lo, hi + 1, 8)} == {plan}


def _unpack(args, nprob):
    """The argument array as (pointers, strides, dims) lists, a problem each."""
    a = [args[i] for i in range(A.ATTEND_ARGS * nprob)]
    assert len(args) == A.ATTEND_ARGS * nprob
    return [(a[i:i + 5], [a[i + 5 + 3 * j: i + 8 + 3 * j] for j in range(4)], a[i + 17:i + 21])
            for i in range(0, len(a), A.ATTEND_ARGS)]


def test_wide_args_shared_query_table():
    """K2's one query table for every batch row: its batch stride stays 0,
    read in place; k and v in the [k|v] buffer with v HD elements in."""
    B, Sq, Sk, H, D = 3, 5, 7, 2, 384
    HD = H * D
    q = torch.zeros(Sq, HD, dtype=BF16)
    kv = torch.zeros(B * Sk, 2 * HD, dtype=BF16)
    out = torch.zeros(B * Sq, HD, dtype=BF16)
    ops = FA.core_operands(Sq, Sk, HD, H)
    ops["q"] = (0, [0, *ops["q"][1][1:]])
    base = {"q": q, "k": kv, "v": kv, "o": out}
    specs = [(base[n], ops[n][0], (B, H, Sq if n in "qo" else Sk, D), (*ops[n][1], 1)) for n in "qkvo"]
    m = torch.ones(B, Sk, dtype=torch.bool)
    args, scales, mask_bytes, keep, copies = A.attend_args([(*specs, m, 1.0)], D)
    [(ptrs, strides, dims)] = _unpack(args, 1)
    assert ptrs == [q.data_ptr(), kv.data_ptr(), kv.data_ptr() + 2 * HD, out.data_ptr(), m.data_ptr()]
    assert strides[0][0] == 0 and strides[0][1:] == [D, HD]
    assert strides[1] == strides[2] == [Sk * 2 * HD, D, 2 * HD]
    assert dims == [B, H, Sq, Sk] and mask_bytes == 1 and not copies and scales == [1.0, 1.0]


def test_wide_args_two_problems():
    """K6's two directions in one array, each with its own dims and mask
    (the text mask on img <- txt, none the other way: pointer 0)."""
    B, H, Ni, Nt, D = 2, 2, 6, 4, 320
    qi, ki, vi = (torch.zeros(B, H, Ni, D, dtype=BF16) for _ in range(3))
    qt, kt, vt = (torch.zeros(B, H, Nt, D, dtype=BF16) for _ in range(3))
    oi, ot = torch.empty_like(qi), torch.empty_like(qt)
    tm = torch.ones(B, Nt, dtype=torch.bool)
    c = A._log2_scale(D)
    args, scales, mask_bytes, _, copies = A.attend_args(_specs([(qi, kt, vt, oi, tm, c), (qt, ki, vi, ot, None, c)]), D)
    (p0, s0, d0), (p1, s1, d1) = _unpack(args, 2)
    assert p0 == [qi.data_ptr(), kt.data_ptr(), vt.data_ptr(), oi.data_ptr(), tm.data_ptr()]
    assert p1 == [qt.data_ptr(), ki.data_ptr(), vi.data_ptr(), ot.data_ptr(), 0]
    assert d0 == [B, H, Ni, Nt] and d1 == [B, H, Nt, Ni]
    assert s0[0] == [H * Ni * D, Ni * D, D] and s1[1] == [H * Ni * D, Ni * D, D]
    assert scales == [c, c] and mask_bytes == 1 and not copies


def test_wide_args_padded_copy_and_output_buffer():
    """D 300: q, k and v as one zero-padded copy each (304 columns, packed),
    the output through a padded buffer that the caller copies back."""
    rng = np.random.RandomState(3)
    q, k, v = (_rand(rng, 2, 1, n, 300, dt=BF16) for n in (5, 7, 7))
    o = torch.empty_like(q)
    args, _, _, keep, copies = A.attend_args(_specs([(q, k, v, o, None, 1.0)]), 304)
    [(ptrs, strides, _)] = _unpack(args, 1)
    padded = keep[:3]
    assert all(t.shape[3] == 304 and t.data_ptr() == p for t, p in zip(padded, ptrs))
    assert torch.equal(padded[0][..., :300], q) and not padded[0][..., 300:].any()
    (orig, buf), = copies
    assert orig[0] is o and buf.shape == (2, 1, 5, 304) and ptrs[3] == buf.data_ptr()
    assert strides[3] == [5 * 304, 2 * 5 * 304, 304]  # H = 1: the head stride is the span, B * its batch stride


def test_wide_args_batch_of_one_takes_spans():
    """A batch of one (and one head): any stride reads its one index, so
    the strides given are the spans (nonzero multiples of 8), whatever the
    view's own, and nothing is copied."""
    buf = torch.zeros(64 + 9 * 384, dtype=BF16)
    q = buf[64:].as_strided((1, 1, 9, 384), (5, 3, 384, 1))  # odd strides on the size-1 dims
    args, _, _, keep, copies = A.attend_args(_specs([(q, q, q, torch.zeros(1, 1, 9, 384, dtype=BF16), None, 1.0)]), 384)
    [(ptrs, strides, _)] = _unpack(args, 1)
    assert ptrs[0] == q.data_ptr() and keep[0] is q and not copies
    assert strides[0] == [9 * 384, 9 * 384, 384]


def test_wide_args_misaligned_view_is_copied():
    """A view 8 bytes off a 16-byte boundary is copied once, aligned."""
    buf = torch.zeros(2 * 5 * 384 + 8, dtype=BF16)
    x = buf[4:4 + 2 * 5 * 384].view(2, 1, 5, 384)
    args, _, _, keep, _ = A.attend_args(_specs([(x, x, x, torch.zeros(2, 1, 5, 384, dtype=BF16), None, 1.0)]), 384)
    [(ptrs, _, _)] = _unpack(args, 1)
    assert ptrs[0] % 16 == 0 and ptrs[0] != x.data_ptr() and torch.equal(keep[0], x)


def test_attend_specs_give_the_f32_route_its_views(fake_lib):
    """K3's operand specs handed to ``attend`` give ``btia_attn_simt`` the
    pointers, strides and dims of its (B, H, S, D) views where they lie, in
    the wide route's argument array (no mask: pointer 0)."""
    rng = np.random.RandomState(4)
    B, Sq, Sk, H, D = 2, 9, 13, 2, 64
    q, k, v = _rand(rng, B, Sq, H * D), _rand(rng, B, Sk, H * D), _rand(rng, B, Sk, H * D)
    seen = []
    real = _FakeLib.btia_attn_simt

    def spy(self, args, nprob, *rest):
        seen.append(_FakeLib.problems(args, nprob))
        return real(self, args, nprob, *rest)

    _FakeLib.btia_attn_simt = spy
    try:
        out = A._bshd_flash_cuda(q, k, v, None, H)
    finally:
        _FakeLib.btia_attn_simt = real
    _close(out, A._bshd_flash_plain(q, k, v, None, H), F32)
    views = [t.unflatten(2, (H, D)).transpose(1, 2) for t in (q, k, v, out)]
    assert seen == [([t.data_ptr() for t in views] + [0], [s for t in views for s in t.stride()[:3]],
                     [B, H, Sq, Sk])]


@pytest.mark.parametrize("H,D", [(1, 768), (1, 1024), (2, 512)])
def test_wide_entries_at_three_and_four_slices(H, D, fake_lib):
    """K3, K4 and K1's core on clusters of 2, 3 and 4 slices, against their
    twins."""
    rng = np.random.RandomState(D)
    q, k, v = (_rand(rng, 2, n, H * D, dt=BF16) for n in (70, 40, 40))
    m = _mask(rng, 2, 40)
    _close(A._bshd_flash_cuda(q, k, v, m, H), A._bshd_flash_plain(q, k, v, m, H), BF16)
    qs = q[:, :20]
    _close(A._fanout_cuda(qs, k, v, m.float(), H), A._fanout_plain(qs, k, v, m.float(), H), BF16)
    kv = torch.cat([k, v], 2).reshape(2 * 40, 2 * H * D)
    got = FA._core_cuda(qs.reshape(40, H * D), kv, m, 2, 20, 40, H)
    want = A.attend_log2(qs, k, v, m.float(), H)
    _close(got.view(2, 20, -1), want, BF16)
    sw, n = A.wide_plan(D)
    assert [c[5] for c in fake_lib.calls] == [(sw, n)] * 3


def test_wide_k6_and_k5_padded(fake_lib):
    """K6's two directions in one cluster launch, and K5 at D 300 through the
    padded copy, against their twins."""
    rng = np.random.RandomState(11)
    H, D = 1, 300
    img = [_rand(rng, 2, H, 23, D, dt=BF16) for _ in range(3)]
    txt = [_rand(rng, 2, 11, H, D, dt=BF16).transpose(1, 2) for _ in range(3)]
    tm = _mask(rng, 2, 11)
    for g, w in zip(BX._bicross_cuda(*img, *txt, tm), BX._bicross_plain(*img, *txt, tm)):
        _close(g, w, BF16)
    m = _mask(rng, 2, 23)
    _close(A._mha_bhsd_cuda(*img, m), A._mha_bhsd_plain(*img, m), BF16)
    assert [(c[2], c[3], c[5]) for c in fake_lib.calls] == [(2, 304, (192, 2)), (1, 304, (192, 2))]
    assert isinstance(A.attend_args(_specs([(*img, img[0], None, 1.0)]), 304)[0], ctypes.Array)
