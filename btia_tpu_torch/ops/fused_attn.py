"""Fused projection + attention + output-projection sites (K1 and K2).

The port of ``btia_tpu/ops/fused_attn.py``. Each entry computes what its TPU
kernel computes, with the surrounding block's LayerNorms and residual folded
in:

* ``fused_dense_attention`` (K1, ``_fused_kernel``): optional f32 pre-LN on
  the q and kv streams -> q/k/v projections with scale*log2(e) folded into
  wq/bq -> masked exp2 softmax (mask applied after exp, denominator floored at
  1e-30, so a fully masked row gives 0) -> output projection -> optional
  residual (raw x_q, compute dtype) -> optional f32 post-LN.
* ``fused_static_q_attention`` (K2, ``_staticq_kernel``): the same with a
  batch-invariant (K, Din) query table projected once, a kv pre-LN and the
  raw query table as residual.

Routing is by device: a CUDA tensor launches the hand-written kernel chain
(counted in the entry's ``.launches``) or raises; a CPU tensor takes the plain
PyTorch twin. The chain is K7's LN prologue, the projection GEMM
(``ops/gemm.py::gemm_bias``), the attention core on the short-sequence kernel of
``csrc/short_flash.cuh`` (K4's, entry ``btia_attn_core``; the work items
planned by ``attention.short_plan``), the output GEMM and K7's post-LN. The
GEMMs' weights (the scaled q projection, ``[wk|wv]``, wo, the f32 biases and
K2's projected query table) are prepared once per weight version
(``gemm.prepare_once``), not once a call. The gate is the reference's
(``_fuses``, ``fused_attn.py:1027-1035`` with one device): the switch on
the kernels, a batch of at least ``FANOUT_MIN_BATCH`` (64), a shape the core
admits (``core_admits``: Sq*Sk <= 32768 and D % 64 == 0), and q/kv input,
head and output widths that are multiples of 128. Every serve, train and
eval site of the registered configs passes it; a ``Predictor`` bucket or a
``StreamingServer`` batch under 64 rows does not. Under the bf16 policy the
chain runs on the tensor cores, its core at the widths ``core_takes`` names
(64 to 256), wider bf16 heads (257 to 1024) on the wide-head kernel
(``csrc/attn_wide.cu``); f32 operands (the fp32 policy) run the projections
on ``gemm_f32`` (``csrc/gemm_f32.cu``) and the core on the CUDA-core
attention kernel (``csrc/attn_simt.cu``). Nothing is cast to bf16 on the
f32 route.
Other sites take the unfused road of projections + ``mha_bshd``, as the
reference does, and so do all sites under ``set_attention_impl("xla")`` or
inside ``disable_fused()``. ``interpret=True`` forces the fused road past
the gate, as the reference's argument of that name does (on the CPU the
twin, on the card the kernel chain, which raises for a shape its kernels do
not take); ``disable_fused()`` is authoritative over it too.

Each site is a ``torch.autograd.Function`` whose backward mirrors the
reference's ``custom_vjp`` (``_fused_bwd``, ``_fused_site_bwd``,
``_staticq_bwd``, ``_staticq_site_bwd``): it recomputes the unfused road
under autograd, so at a batch of 64 or more on the card the recomputed
attention goes through K4. The key mask gets no gradient.

Inside ``fused_mesh(mesh)`` with a model axis tp > 1 (the reference's
``_fused_over_mesh`` / ``_staticq_over_mesh``), the q/k/v/o weights a site
is handed are this rank's shards (``parallel.sharding.shard_params``: its
q/k/v columns and its o rows), ``num_heads`` is the whole model's, and the
rank runs the single-device entry on its ``num_heads // tp`` heads: the
site cut to its prologue (the q/kv pre-LNs stay in the chain; no residual,
no post-LN) with the bias share ``(bo.float() / tp).to(bo.dtype)``. The
partial outputs are summed over the model group, then the residual (the
query table on K2's road) and the post-LN (``layernorm``: K7 on the card)
act on the sum. The gate reads the shard's shapes: the local
batch and the (HD / tp)-wide projections. A site that fails it takes the
unfused road split the same way (its projections on the shard's columns,
the attention on its heads, the output product summed before its bias),
which XLA's partitioner does for the reference. Replicated tensors that
enter shard-local work get their gradient summed over the model group
(``parallel.collectives``). ``fused_mesh(None)`` or a 1-rank mesh changes
nothing; a data axis alone changes nothing here either, since each rank is
handed its own rows.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from btia_tpu_torch.ops import _native
from btia_tpu_torch.ops.attention import (
    FANOUT_MIN_BATCH, LOG2E, SMALL_SCORE_TILE, TILE_HEAD_WIDTHS, _key_masks, _resolved_impl, _route_or_raise,
    attend, attend_log2, mha_bshd, short_plan,
)
from btia_tpu_torch.ops.gemm import gemm_bias, prepare_once
from btia_tpu_torch.ops.norms import _layernorm_cuda, _ln_exact, layernorm
from btia_tpu_torch.parallel.collectives import copy_to_model, reduce_from_model
from btia_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size, use_mesh

# A folded LayerNorm: (scale, bias, eps), or None for a disabled stage. The
# reference's SiteCfg carried the eps values as static Pallas arguments;
# here the triples themselves say which stages run.
LN = Optional[Tuple[torch.Tensor, torch.Tensor, float]]

_ENABLED = True


@contextlib.contextmanager
def disable_fused():
    """Route ``fused_dense_attention`` / ``fused_static_q_attention`` through
    the unfused road for every call inside this context, whatever the shape
    or the attention switch (``fused_attn.py:disable_fused``)."""
    global _ENABLED
    old = _ENABLED
    _ENABLED = False
    try:
        yield
    finally:
        _ENABLED = old


def fused_mesh(mesh):
    """Run the sites under a (data, model) mesh (``fused_attn.py:fused_mesh``):
    a context inside which the model axis splits each site's heads (see the
    module docstring), and the MLPs' and BatchNorm's collectives run over
    the mesh's groups. ``mesh=None`` or a 1-rank mesh is a no-op."""
    return use_mesh(mesh)


def _shard_heads(num_heads: int) -> Tuple[int, int]:
    """(tp, this rank's heads) under the active mesh's model axis."""
    tp = axis_size(MODEL_AXIS)
    if num_heads % tp:
        raise ValueError(f"{num_heads} attention heads do not divide over model={tp}")
    return tp, num_heads // tp


def _bias_share(bo: torch.Tensor, tp: int) -> torch.Tensor:
    """A rank's share of a row-parallel bias, rounded to bo's dtype as the
    reference rounds it; the model group's sum of the partials restores bo.
    Its gradient is summed over the group. Without autograd it is prepared
    once per version of bo, so the weights prepared from it are too."""
    if torch.is_grad_enabled() and bo.requires_grad:
        return (copy_to_model(bo).float() / tp).to(bo.dtype)
    return prepare_once((bo,), ("share", tp), lambda: ((bo.float() / tp).to(bo.dtype),))[0]


def _copied_ln(ln: LN) -> LN:
    return None if ln is None else (copy_to_model(ln[0]), copy_to_model(ln[1]), ln[2])


def core_takes(head_dim: int) -> bool:
    """Whether the tensor-core (bf16) attention core of K1/K2 is built for this head
    width: ``TILE_HEAD_WIDTHS``, the multiples of 64 up to 256."""
    return head_dim in TILE_HEAD_WIDTHS


def core_admits(sq: int, sk: int, head_dim: int) -> bool:
    """Whether a site's attention fits the fused kernels: the reference's
    shape gate (``btia_tpu/ops/fused_attn.py:1030-1031``). The core computes
    every such shape at the widths it takes: rows of up to 64 queries a
    tile, keys in tiles of 32 (or 64) through an online softmax."""
    return sq * sk <= SMALL_SCORE_TILE and head_dim % 64 == 0


def _fuses(batch: int, sq: int, sk: int, num_heads: int, din_q: int, din_kv: int, hd: int,
           dout: int, interpret: bool = False) -> bool:
    """Whether a site takes the fused road: the reference's ``use_fused``
    with one device (``fused_attn.py:1027-1035``; ``:933-941`` for K2, where
    sq is the query table's rows and batch is x_kv's). din_q, din_kv, hd and
    dout are wq.shape[0], wk.shape[0], wq.shape[1] and wo.shape[1]."""
    gates = (
        _resolved_impl() == "pallas"
        and batch >= FANOUT_MIN_BATCH
        and core_admits(sq, sk, hd // num_heads)
        and din_q % 128 == 0
        and din_kv % 128 == 0
        and hd % 128 == 0
        and dout % 128 == 0
    )
    return _ENABLED and (interpret or gates)


def _proj_plain(x, w, b, cd):
    """bf16-valued operands, f32 accumulation, f32 bias, one rounding."""
    return (x.float() @ w.to(cd).float() + b.float()).to(cd)


def _colmask(kv_mask, x_kv):
    if kv_mask is None:
        return torch.ones(x_kv.shape[:2], dtype=torch.float32, device=x_kv.device)
    return kv_mask.to(torch.float32)


def _fused_dense_plain(x_q, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                       num_heads, q_ln, kv_ln, residual, post_ln):
    """K1's plain twin (``_fused_kernel`` arithmetic)."""
    cd = x_q.dtype
    c = (1.0 / (wq.shape[1] // num_heads) ** 0.5) * LOG2E
    xq = _ln_exact(x_q, *q_ln) if q_ln else x_q
    xkv = _ln_exact(x_kv, *kv_ln).to(cd) if kv_ln else x_kv
    q = _proj_plain(xq, (wq.float() * c).to(cd), bq.float() * c, cd)
    k = _proj_plain(xkv, wk, bk, cd)
    v = _proj_plain(xkv, wv, bv, cd)
    attn = attend_log2(q, k, v, _colmask(kv_mask, x_kv), num_heads)
    out = _proj_plain(attn, wo, bo, cd)
    if residual:
        out = x_q.to(cd) + out
    if post_ln:
        out = _ln_exact(out, *post_ln)
    return out


def _dense_weights(wq, bq, wk, bk, wv, bv, wo, bo, num_heads, cd):
    """K1's GEMM operands (``prepare_once``): wq*c in cd and bq*c in f32
    (c = scale*log2(e)), [wk|wv] in cd and [bk|bv] in f32, wo in cd and bo
    in f32; each value the per-call formula's."""
    def make():
        c = (1.0 / (wq.shape[1] // num_heads) ** 0.5) * LOG2E
        return ((wq.float() * c).to(cd).contiguous(), bq.float() * c,
                torch.cat([wk, wv], dim=1).to(cd), torch.cat([bk, bv]).float(),
                wo.to(cd).contiguous(), bo.float().contiguous())

    return prepare_once((wq, bq, wk, bk, wv, bv, wo, bo), ("dense", num_heads, cd), make)


def _static_q_weights(queries, wq, bq, wk, bk, wv, bv, wo, bo, num_heads, cd):
    """K2's operands (``prepare_once``): the projected (K, HD) query table
    (``_static_q_table``), [wk|wv] in cd and [bk|bv] in f32, wo in cd and bo
    in f32, and the raw queries in cd (the residual)."""
    def make():
        return (_static_q_table(queries, wq, bq, num_heads, cd).contiguous(),
                torch.cat([wk, wv], dim=1).to(cd), torch.cat([bk, bv]).float(),
                wo.to(cd).contiguous(), bo.float().contiguous(), queries.to(cd).contiguous())

    return prepare_once((queries, wq, bq, wk, bk, wv, bv, wo, bo), ("static_q", num_heads, cd), make)


def core_operands(Sq: int, Sk: int, HD: int, num_heads: int) -> dict:
    """Where the attention core reads its (B, H, S, D) operands in the
    chain's buffers: q in the (B*Sq, HD) GEMM output (or K2's (Sq, HD)
    table), k and v in the (B*Sk, 2*HD) [k|v] GEMM output, o in a
    (B*Sq, HD) buffer. Per operand, its element offset from its buffer's
    base and its (batch, head, row) strides: v starts HD elements into each
    [k|v] row. A shared table is read at batch coordinate 0 for every batch
    row; its batch stride only has to be a nonzero multiple of 8."""
    D = HD // num_heads
    rows, kv = [Sq * HD, D, HD], [Sk * 2 * HD, D, 2 * HD]
    return {"q": (0, rows), "k": (0, kv), "v": (HD, kv), "o": (0, rows)}


def _core_launcher(q, kv, kv_mask, B, Sq, Sk, num_heads, q_shared=False):
    """Check the core's operands and bind one launch of its C entry
    (``btia_attn_core``, the short-sequence kernel in its zero-rows mode):
    q (B*Sq, HD) rows already in the log2 domain, or with q_shared K2's
    (Sq, HD) table for every batch row; kv (B*Sk, 2*HD) = [k | v] rows;
    kv_mask (B, Sk), bool (read as bytes) or {0, 1} f32, or None. Returns
    (launch, out): each launch() writes the (B*Sq, HD) result into out and
    returns the entry's code."""
    HD = q.shape[1]
    D = HD // num_heads
    if HD != num_heads * D or not (core_takes(D) and core_admits(Sq, Sk, D)):
        raise ValueError(
            f"attention core takes head widths {TILE_HEAD_WIDTHS} and Sq*Sk <= {SMALL_SCORE_TILE}, "
            f"got D = {HD / num_heads:g}, Sq = {Sq}, Sk = {Sk}"
        )
    _native.require(q, "attention core q")
    _native.require(kv, "attention core [k|v]")
    if q.shape[0] != (Sq if q_shared else B * Sq) or kv.shape != (B * Sk, 2 * HD):
        raise ValueError(f"attention core: q {tuple(q.shape)} and [k|v] {tuple(kv.shape)} do not fit "
                         f"B = {B}, Sq = {Sq}, Sk = {Sk}, HD = {HD}")
    # TMA reads each operand from a 16-byte aligned base: v, HD elements into
    # the [k|v] rows, is aligned only for HD % 8 == 0.
    if HD % 8 or q.data_ptr() % 16 or kv.data_ptr() % 16:
        raise ValueError(f"attention core: q and [k|v] must be 16-byte aligned with HD % 8 == 0, got HD = {HD}")
    (mask,), mask_bytes = _key_masks([kv_mask])
    if mask is not None and mask.shape != (B, Sk):
        raise ValueError(f"attention core: key mask {tuple(mask.shape)}, expected {(B, Sk)}")
    out = torch.empty((B * Sq, HD), dtype=q.dtype, device=q.device)
    ops = core_operands(Sq, Sk, HD, num_heads)
    strides = (ctypes.c_longlong * 12)(*(s for name in "qkvo" for s in ops[name][1]))
    plan = short_plan([(B, num_heads, Sq, Sk)], D)
    plan_c = (ctypes.c_int * len(plan))(*plan)
    v_off = ops["v"][0] * kv.element_size()
    lib, stream = _native.lib(), _native.stream(q)

    def launch():  # holds q, kv and mask alive while it can be called
        return lib.btia_attn_core(q.data_ptr(), kv.data_ptr(), kv.data_ptr() + v_off,
                                  None if mask is None else mask.data_ptr(), mask_bytes, out.data_ptr(),
                                  strides, plan_c, B, num_heads, Sq, Sk, D, int(q_shared), stream)

    return launch, out


def _core_cuda(q, kv, kv_mask, B, Sq, Sk, num_heads, q_shared=False):
    """The attention core of K1/K2 on the card: bf16 at ``core_takes``'s
    widths on the short-sequence kernel (``_core_launcher``); bf16 from 257
    to 1024 wide on the wide-head kernel and f32 on the CUDA-core kernel
    (``attention.attend``), reading the same buffers as (B, H, S, D)
    operands (specs, ``attention.operand``) through the same strides."""
    HD = q.shape[1]
    D = HD // num_heads
    route = _route_or_raise(q.dtype, HD / num_heads, core_takes,
                            "attention core", TILE_HEAD_WIDTHS)
    if route == "wgmma":
        launch, out = _core_launcher(q, kv, kv_mask, B, Sq, Sk, num_heads, q_shared)
        _native.check(launch(), "btia_attn_core")
        return out
    for t in (q, kv):
        _native.require(t, "attention core", q.dtype, contiguous=False)
    if q.shape[0] != (Sq if q_shared else B * Sq) or kv.shape != (B * Sk, 2 * HD):
        raise ValueError(f"attention core: q {tuple(q.shape)} and [k|v] {tuple(kv.shape)} do not fit "
                         f"B = {B}, Sq = {Sq}, Sk = {Sk}, HD = {HD}")
    q, kv = q.contiguous(), kv.contiguous()
    out = torch.empty((B * Sq, HD), dtype=q.dtype, device=q.device)
    ops = core_operands(Sq, Sk, HD, num_heads)
    if q_shared:  # K2's one table for every batch row
        ops["q"] = (0, [0, *ops["q"][1][1:]])
    base = {"q": q, "k": kv, "v": kv, "o": out}
    specs = [(base[n], ops[n][0], (B, num_heads, Sq if n in "qo" else Sk, D), (*ops[n][1], 1)) for n in "qkvo"]
    # q arrives in the log2 domain: scaled by 1.
    attend(route, [(*specs, kv_mask, 1.0)], D, mult_mask=True)
    return out


def _fused_dense_cuda(x_q, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                      num_heads, q_ln, kv_ln, residual, post_ln):
    """K1 on the card: LN prologue -> q and [k|v] GEMMs -> attention core ->
    out-projection GEMM with the residual -> post-LN, all hand-written."""
    B, Sq, Din = x_q.shape
    Sk = x_kv.shape[1]
    cd = x_q.dtype
    # Serving replicates one image's tokens over its questions as a view
    # with a zero stride; the kernels read packed rows.
    x_q, x_kv = x_q.contiguous(), x_kv.contiguous()
    # The chain runs bf16 (tensor cores) and f32 (CUDA cores) operands.
    _native.require(x_q, "fused_dense_attention x_q", (torch.bfloat16, torch.float32))
    _native.require(x_kv, "fused_dense_attention x_kv", cd)
    wq_c, bq_c, wkv, bkv, wo_c, bo_c = _dense_weights(wq, bq, wk, bk, wv, bv, wo, bo, num_heads, cd)
    xq2 = x_q.view(B * Sq, Din)
    xkv2 = x_kv.view(B * Sk, x_kv.shape[2])
    # The LN prologue and post-LN are K7's kernel, launched as part of K1.
    xq_in = _layernorm_cuda(xq2, *q_ln) if q_ln else xq2
    xkv_in = _layernorm_cuda(xkv2, *kv_ln) if kv_ln else xkv2
    q = gemm_bias(xq_in, wq_c, bq_c)
    kv = gemm_bias(xkv_in, wkv, bkv)
    attn = _core_cuda(q, kv, kv_mask, B, Sq, Sk, num_heads)
    out = gemm_bias(attn, wo_c, bo_c, resid=xq2 if residual else None, resid_rows=B * Sq)
    if post_ln:
        _layernorm_cuda(out, *post_ln, out=out)
    return out.view(B, Sq, wo.shape[1])


def _unfused(x_q, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo, num_heads, reduce=None):
    """Plain projections + ``mha_bshd`` (``fused_attn.py:_unfused``). With
    `reduce` (a model axis), the output product is reduced before its bias."""
    cd = x_q.dtype
    B, Sq, _ = x_q.shape
    Sk = x_kv.shape[1]
    HD = wq.shape[1]
    dense = lambda x, w, b: torch.matmul(x, w.to(cd)) + b.to(cd)
    q = dense(x_q, wq, bq).reshape(B, Sq, num_heads, HD // num_heads)
    k = dense(x_kv, wk, bk).reshape(B, Sk, num_heads, HD // num_heads)
    v = dense(x_kv, wv, bv).reshape(B, Sk, num_heads, HD // num_heads)
    out = mha_bshd(q, k, v, kv_mask).reshape(B, Sq, HD)
    if reduce is None:
        return dense(out, wo, bo)
    return reduce(torch.matmul(out, wo.to(cd))) + bo.to(cd)


def _unfused_site(x_q, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                  num_heads, q_ln, kv_ln, residual, post_ln):
    """The unfused mirror of K1 (``fused_attn.py:_unfused_site``): the
    semantics oracle and the backward's recompute."""
    xq_in = layernorm(x_q, *q_ln) if q_ln else x_q
    xkv_in = layernorm(x_kv, *kv_ln) if kv_ln else x_kv
    out = _unfused(xq_in, xkv_in, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo, num_heads)
    if residual:
        out = x_q + out
    if post_ln:
        out = layernorm(out, *post_ln)
    return out


def _ln_args(*lns: LN):
    """LN triples -> (scale, bias) tensors for ``Function.apply`` (None for
    a disabled stage) and their eps values."""
    tensors = [t for ln in lns for t in ((None, None) if ln is None else ln[:2])]
    return tensors, tuple(None if ln is None else ln[2] for ln in lns)


def _ln_triples(tensors, eps):
    return [None if e is None else (tensors[2 * i], tensors[2 * i + 1], e)
            for i, e in enumerate(eps)]


def _recompute_grads(ctx, unfused, g):
    """The reference's vjp policy: recompute `unfused` (a function of the
    saved tensors, the key mask at index 2) under autograd and
    differentiate it. Returns one gradient per saved tensor, None for the
    mask and for every input that needs none."""
    saved = ctx.saved_tensors
    leaves = [
        None if t is None or i == 2 else t.detach().requires_grad_(ctx.needs_input_grad[i])
        for i, t in enumerate(saved)
    ]
    leaves[2] = None if saved[2] is None else saved[2].detach()
    wanted = [t for t in leaves if t is not None and t.requires_grad]
    with torch.enable_grad():
        out = unfused(*leaves)
        grads = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
    return [next(grads) if t is not None and t.requires_grad else None for t in leaves]


class _FusedDense(torch.autograd.Function):
    """K1: the kernel (or its twin) forward; the backward recomputes
    ``_unfused_site`` (``_fused_bwd`` / ``_fused_site_bwd``)."""

    @staticmethod
    def forward(ctx, x_q, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                qls, qlb, kls, klb, pos, pob, num_heads, eps, residual):
        ctx.save_for_backward(x_q, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                              qls, qlb, kls, klb, pos, pob)
        ctx.site = (num_heads, eps, residual)
        q_ln, kv_ln, post_ln = _ln_triples((qls, qlb, kls, klb, pos, pob), eps)
        return _native.route(fused_dense_attention, x_q, _fused_dense_cuda, _fused_dense_plain,
                             x_q, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                             num_heads, q_ln, kv_ln, residual, post_ln)

    @staticmethod
    def backward(ctx, g):
        num_heads, eps, residual = ctx.site

        def unfused(x_q, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo, *lns):
            q_ln, kv_ln, post_ln = _ln_triples(lns, eps)
            return _unfused_site(x_q, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                                 num_heads, q_ln, kv_ln, residual, post_ln)

        return (*_recompute_grads(ctx, unfused, g), None, None, None)


def fused_dense_attention(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    wq, bq, wk, bk, wv, bv, wo, bo,
    num_heads: int,
    interpret: bool = False,
    q_ln: LN = None,
    kv_ln: LN = None,
    residual: bool = False,
    post_ln: LN = None,
) -> torch.Tensor:
    """K1: x_q (B, Sq, Din), x_kv (B, Sk, Din), kv_mask (B, Sk) True=valid.

    q_ln / kv_ln / post_ln are (scale, bias, eps) triples folded into the
    site; residual adds the raw x_q to the projected output. interpret
    forces the fused road past the gate (not past ``disable_fused()``)."""
    if (residual or post_ln is not None) and wo.shape[1] != x_q.shape[-1]:
        raise ValueError("residual / post-LN need Dout == Din of x_q")
    tp, heads = _shard_heads(num_heads)
    fuse = _fuses(x_q.shape[0], x_q.shape[1], x_kv.shape[1], heads, wq.shape[0], wk.shape[0],
                  wq.shape[1], wo.shape[1], interpret)
    if tp > 1:
        return _dense_over_model(x_q, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                                 heads, tp, fuse, q_ln, kv_ln, residual, post_ln)
    if not fuse:
        return _unfused_site(x_q, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                             num_heads, q_ln, kv_ln, residual, post_ln)
    lns, eps = _ln_args(q_ln, kv_ln, post_ln)
    return _FusedDense.apply(x_q, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                             *lns, num_heads, eps, residual)


fused_dense_attention.launches = 0


def _dense_over_model(x_q, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                      heads, tp, fuse, q_ln, kv_ln, residual, post_ln):
    """K1's site on this rank's shard (``_fused_over_mesh``): `heads` heads,
    the weights' local columns / rows; the partial outputs summed over the
    model group, then the residual and the post-LN."""
    if fuse:
        xq_in = copy_to_model(x_q)
        xkv_in = xq_in if x_kv is x_q else copy_to_model(x_kv)
        lns, eps = _ln_args(_copied_ln(q_ln), _copied_ln(kv_ln), None)
        out = reduce_from_model(_FusedDense.apply(
            xq_in, xkv_in, kv_mask, wq, bq, wk, bk, wv, bv, wo, _bias_share(bo, tp),
            *lns, heads, eps, False))
    else:
        xq_in = layernorm(x_q, *q_ln) if q_ln else x_q
        xkv_in = layernorm(x_kv, *kv_ln) if kv_ln else x_kv
        xq_c = copy_to_model(xq_in)
        xkv_c = xq_c if xkv_in is xq_in else copy_to_model(xkv_in)
        out = _unfused(xq_c, xkv_c, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo, heads,
                       reduce=reduce_from_model)
    if residual:
        out = x_q + out
    if post_ln:
        out = layernorm(out, *post_ln)
    return out


def _static_q_table(queries, wq, bq, num_heads, cd):
    """The (K, HD) query table, projected once in f32 and prescaled by
    scale*log2(e) (outside the kernel, as ``_staticq_pallas`` does)."""
    c = (1.0 / (wq.shape[1] // num_heads) ** 0.5) * LOG2E
    return ((queries.float() @ wq.float() + bq.float()) * c).to(cd)


def _static_q_plain(queries, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                    num_heads, kv_ln, residual):
    """K2's plain twin (``_staticq_kernel`` arithmetic)."""
    cd = x_kv.dtype
    B = x_kv.shape[0]
    K = queries.shape[0]
    q2 = _static_q_table(queries, wq, bq, num_heads, cd)
    xkv = _ln_exact(x_kv, *kv_ln) if kv_ln else x_kv
    k = _proj_plain(xkv, wk, bk, cd)
    v = _proj_plain(xkv, wv, bv, cd)
    q = q2[None].expand(B, K, q2.shape[1])
    attn = attend_log2(q, k, v, _colmask(kv_mask, x_kv), num_heads)
    out = _proj_plain(attn, wo, bo, cd)
    if residual:
        out = queries.to(cd)[None] + out
    return out


def _static_q_cuda(queries, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                   num_heads, kv_ln, residual):
    """K2 on the card: kv LN prologue -> [k|v] GEMM -> attention core with one
    shared query table -> out-projection GEMM with the query residual."""
    B, Sk, Din = x_kv.shape
    K = queries.shape[0]
    cd = x_kv.dtype
    x_kv = x_kv.contiguous()
    _native.require(x_kv, "fused_static_q_attention x_kv", (torch.bfloat16, torch.float32))
    q2, wkv, bkv, wo_c, bo_c, qraw = _static_q_weights(queries, wq, bq, wk, bk, wv, bv, wo, bo, num_heads, cd)
    xkv2 = x_kv.view(B * Sk, Din)
    xkv_in = _layernorm_cuda(xkv2, *kv_ln) if kv_ln else xkv2
    kv = gemm_bias(xkv_in, wkv, bkv)
    # One query table for every batch row: never expanded over the batch.
    attn = _core_cuda(q2, kv, kv_mask, B, K, Sk, num_heads, q_shared=True)
    out = gemm_bias(attn, wo_c, bo_c, resid=qraw if residual else None, resid_rows=K)
    return out.view(B, K, wo.shape[1])


def _static_q_unfused_site(queries, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                           num_heads, kv_ln, residual):
    """The unfused mirror of K2 (``_staticq_unfused_site``): the queries
    broadcast over the batch through ``_unfused``."""
    B = x_kv.shape[0]
    q_tokens = queries[None].to(x_kv.dtype).expand(B, *queries.shape)
    xkv_in = layernorm(x_kv, *kv_ln) if kv_ln else x_kv
    out = _unfused(q_tokens, xkv_in, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo, num_heads)
    return q_tokens + out if residual else out


class _StaticQ(torch.autograd.Function):
    """K2: the kernel (or its twin) forward; the backward recomputes
    ``_static_q_unfused_site`` (``_staticq_bwd`` / ``_staticq_site_bwd``)."""

    @staticmethod
    def forward(ctx, queries, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                kls, klb, num_heads, eps, residual):
        ctx.save_for_backward(queries, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo, kls, klb)
        ctx.site = (num_heads, eps, residual)
        (kv_ln,) = _ln_triples((kls, klb), eps)
        return _native.route(fused_static_q_attention, x_kv, _static_q_cuda, _static_q_plain,
                             queries, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                             num_heads, kv_ln, residual)

    @staticmethod
    def backward(ctx, g):
        num_heads, eps, residual = ctx.site

        def unfused(queries, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo, *lns):
            (kv_ln,) = _ln_triples(lns, eps)
            return _static_q_unfused_site(queries, x_kv, kv_mask, wq, bq, wk, bk, wv, bv,
                                          wo, bo, num_heads, kv_ln, residual)

        return (*_recompute_grads(ctx, unfused, g), None, None, None)


def fused_static_q_attention(
    queries: torch.Tensor,
    x_kv: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    wq, bq, wk, bk, wv, bv, wo, bo,
    num_heads: int,
    interpret: bool = False,
    kv_ln: LN = None,
    residual: bool = False,
) -> torch.Tensor:
    """K2: batch-invariant queries (K, Din) attend over x_kv (B, Sk, Din).

    kv_ln folds the pre-attention LayerNorm into the site; residual adds the
    raw query table to the projected output. interpret forces the fused
    road past the gate (not past ``disable_fused()``)."""
    if residual and wo.shape[1] != queries.shape[1]:
        raise ValueError("residual needs Dout == Din of the queries")
    tp, heads = _shard_heads(num_heads)
    fuse = _fuses(x_kv.shape[0], queries.shape[0], x_kv.shape[1], heads, wq.shape[0], wk.shape[0],
                  wq.shape[1], wo.shape[1], interpret)
    if tp > 1:
        return _static_q_over_model(queries, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                                    heads, tp, fuse, kv_ln, residual)
    if not fuse:
        return _static_q_unfused_site(queries, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                                      num_heads, kv_ln, residual)
    lns, eps = _ln_args(kv_ln)
    return _StaticQ.apply(queries, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                          *lns, num_heads, eps, residual)


fused_static_q_attention.launches = 0


def _static_q_over_model(queries, x_kv, kv_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                         heads, tp, fuse, kv_ln, residual):
    """K2's site on this rank's shard (``_staticq_over_mesh``): the query
    table replicated, the rest split as K1's; the query residual after the
    model group's sum."""
    if fuse:
        lns, eps = _ln_args(_copied_ln(kv_ln))
        out = reduce_from_model(_StaticQ.apply(
            copy_to_model(queries), copy_to_model(x_kv), kv_mask, wq, bq, wk, bk, wv, bv, wo,
            _bias_share(bo, tp), *lns, heads, eps, False))
    else:
        q_tokens = queries[None].to(x_kv.dtype).expand(x_kv.shape[0], *queries.shape)
        xkv_in = layernorm(x_kv, *kv_ln) if kv_ln else x_kv
        out = _unfused(copy_to_model(q_tokens), copy_to_model(xkv_in), kv_mask, wq, bq, wk, bk, wv, bv,
                       wo, bo, heads, reduce=reduce_from_model)
    if residual:
        out = queries[None].to(out.dtype) + out
    return out
