"""The mixture-of-experts layer's routing and its grouped expert GEMM
(``models/mla_moe.py``). No TPU kernel corresponds: the JAX package has no
such layer.

A MoE layer of T tokens, each routed to k of G groups (the routed experts,
and the shared experts as groups every token visits), runs as:

* ``plan(eid, G)``: where each (token, slot) row goes in a permuted buffer
  whose groups start at multiples of ``BLOCK`` (128) rows, each group's rows
  in token order (a stable sort), padded to the block; the group of every
  128-row block; the number of blocks in use; the rows each group got. All
  of it on the card, with no host read: only the buffer's size, from T and k,
  is the host's.
* ``gather``: the permuted rows (``index_select``; padding rows are zeros).
* ``grouped_gemm(a, w, plan, "swiglu")``: silu(a @ Wg) * (a @ Wu) of each
  row's group, w (G, K, 2I) holding [gate | up]; then
  ``grouped_gemm(h, w2, plan, row_scale=rw)``: each row's product with its
  group's down projection, times its routing weight, rounded once to bf16.
* ``combine``: each token's k rows summed in slot order in f32: a fixed
  order, no float atomics.

On the card ``grouped_gemm`` is one launch of ``csrc/moe_gemm.cu`` (wgmma
and TMA, persistent, the block's group and the blocks in use read from
device memory); on the CPU its plain twin, a loop over the groups with the
same arithmetic (f32 products of the bf16 operands, one rounding).
``grouped_gemm.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from btia_tpu_torch.ops import _native
from btia_tpu_torch.ops._native import H100_SMS

BLOCK = 128  # the kernel's tile rows: every group starts at a multiple
ACTS = ("swiglu", None)  # the C entry's mode: 0 SwiGLU over [gate | up], 1 the rows scaled


@dataclasses.dataclass
class Plan:
    """Where the rows of a routed layer lie (``plan``): ``dest`` (T, k)
    each (token, slot) row's place in the permuted buffer of ``rows`` rows;
    ``blk_group`` (rows / BLOCK,) int32 the group of each block (G past the
    last); ``used`` (1,) int32 the blocks in use; ``counts`` (G,) the rows
    each group got. Everything but ``rows`` lives on the tokens' device."""

    dest: torch.Tensor
    blk_group: torch.Tensor
    used: torch.Tensor
    counts: torch.Tensor
    rows: int


def plan(eid: torch.Tensor, groups: int) -> Plan:
    """The permutation of the (T, k) group ids `eid` (int64, each in
    [0, groups)): rows grouped by group, each group in (token, slot) order
    and padded to a multiple of ``BLOCK``. No host synchronisation."""
    T, k = eid.shape
    flat = eid.reshape(-1)
    n = flat.numel()
    dev = flat.device
    counts = torch.zeros(groups, dtype=torch.int64, device=dev).index_add_(0, flat, torch.ones_like(flat))
    padded = (counts + BLOCK - 1) // BLOCK * BLOCK
    pend = torch.cumsum(padded, 0)
    order = torch.argsort(flat, stable=True)
    sorted_g = flat[order]
    rank = torch.arange(n, device=dev) - (torch.cumsum(counts, 0) - counts)[sorted_g]
    dest = torch.empty_like(flat)
    dest[order] = (pend - padded)[sorted_g] + rank
    rows = (-(-n // BLOCK) + groups) * BLOCK  # padding adds under BLOCK rows a group
    starts = torch.arange(0, rows, BLOCK, device=dev)
    blk_group = torch.bucketize(starts, pend, right=True).to(torch.int32)
    used = (pend[-1:] // BLOCK).to(torch.int32)
    return Plan(dest.view(T, k), blk_group, used, counts, rows)


def single_group(T: int, device) -> Plan:
    """The plan of one group holding T rows in order (a dense SwiGLU layer on
    the grouped GEMM): no permutation, the last block ragged."""
    nblk = -(-T // BLOCK)
    return Plan(torch.arange(T, device=device).view(T, 1), torch.zeros(nblk, dtype=torch.int32, device=device),
                torch.full((1,), nblk, dtype=torch.int32, device=device),
                torch.full((1,), T, dtype=torch.int64, device=device), T)


def gather(x: torch.Tensor, p: Plan) -> torch.Tensor:
    """The (p.rows, D) permuted buffer: row p.dest[t, j] is x[t]; padding
    rows are zeros."""
    T, k = p.dest.shape
    src = torch.full((p.rows,), T, dtype=torch.int64, device=x.device)
    src[p.dest.reshape(-1)] = torch.arange(T, device=x.device).repeat_interleave(k)
    return torch.cat([x, x.new_zeros(1, x.shape[1])]).index_select(0, src)


def scatter_weights(w: torch.Tensor, p: Plan) -> torch.Tensor:
    """(p.rows,) f32: row p.dest[t, j] weighs w[t, j]; padding rows 0."""
    out = torch.zeros(p.rows, dtype=torch.float32, device=w.device)
    out[p.dest.reshape(-1)] = w.reshape(-1).float()
    return out


def combine(y: torch.Tensor, p: Plan) -> torch.Tensor:
    """(T, D) f32: each token's k rows of the permuted `y`, summed in slot
    order."""
    T, k = p.dest.shape
    return y.index_select(0, p.dest.reshape(-1)).view(T, k, -1).sum(1, dtype=torch.float32)


def _epilogue(acc: torch.Tensor, act: Optional[str], half: int, scale: Optional[torch.Tensor]) -> torch.Tensor:
    if act == "swiglu":
        return F.silu(acc[:, :half]) * acc[:, half:]
    return acc if scale is None else acc * scale[:, None]


def _grouped_plain(a, w, p: Plan, act, row_scale):
    """The twin: for each group's run of blocks in use, the f32 product of
    the bf16 operands and the epilogue, rounded once; rows of no block in
    use are zero."""
    G, _, Nw = w.shape
    half = Nw // 2
    n_out = half if act == "swiglu" else Nw
    out = torch.zeros(p.rows, n_out, dtype=a.dtype, device=a.device)
    groups = p.blk_group[: int(p.used[0])].tolist()
    b = 0
    while b < len(groups):
        e = b
        while e < len(groups) and groups[e] == groups[b]:
            e += 1
        r0, r1 = b * BLOCK, min(e * BLOCK, p.rows)
        acc = a[r0:r1].float() @ w[groups[b]].float()
        scale = None if row_scale is None else row_scale[r0:r1]
        out[r0:r1] = _epilogue(acc, act, half, scale).to(a.dtype)
        b = e
    return out


def grouped_plan(rows: int, n_out: int, act) -> tuple:
    """(tiles_n, grid) of the grouped GEMM: output tiles of 128 columns under
    SwiGLU (each reading 128 gate and 128 up columns), 256 otherwise; one
    persistent block an SM up to the most tiles the buffer can hold."""
    tiles_n = -(-n_out // (128 if act == "swiglu" else 256))
    return tiles_n, min(H100_SMS, -(-rows // BLOCK) * tiles_n)


def _grouped_cuda(a, w, p: Plan, act, row_scale):
    G, K, Nw = w.shape
    if a.shape[1] != K or K % 8:
        raise ValueError(f"grouped GEMM takes a (rows, K) with K a multiple of 8 matching w's, got {tuple(a.shape)}"
                         f" against {tuple(w.shape)}")
    if act == "swiglu" and Nw % 256:
        raise ValueError(f"grouped GEMM's SwiGLU takes [gate | up] halves of multiples of 128, got {Nw}")
    if Nw % 8:
        raise ValueError(f"grouped GEMM takes N a multiple of 8, got {Nw}")
    a = _native.aligned(a)
    w = _native.aligned(w)
    _native.require(a, "grouped GEMM input")
    _native.require(w, "grouped GEMM weights")
    n_out = Nw // 2 if act == "swiglu" else Nw
    out = torch.empty((p.rows, n_out), dtype=torch.bfloat16, device=a.device)
    scale = None
    if row_scale is not None:
        scale = row_scale.contiguous()
        _native.require(scale, "grouped GEMM row scale", torch.float32)
    tiles_n, grid = grouped_plan(p.rows, n_out, act)
    _native.check(
        _native.lib().btia_moe_gemm(
            a.data_ptr(), w.data_ptr(), out.data_ptr(), p.blk_group.data_ptr(), p.used.data_ptr(),
            None if scale is None else scale.data_ptr(), p.rows, K, Nw, G, ACTS.index(act), grid,
            _native.stream(a),
        ),
        "btia_moe_gemm",
    )
    return out


def grouped_gemm(a: torch.Tensor, w: torch.Tensor, p: Plan, act: Optional[str] = None,
                 row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each row of the permuted `a` (p.rows, K) times its group's weight
    ``w[g]`` (G, K, N), for the blocks in use. ``act="swiglu"``: w holds
    [gate | up] and the result is silu(gate) * up, (p.rows, N / 2).
    Otherwise (p.rows, N), each row times ``row_scale`` (f32, one a row)
    where given. The epilogue in f32, one rounding to `a`'s dtype. Rows of
    no block in use are left unwritten on the card (zero on the CPU)."""
    if act not in ACTS or (act is not None and row_scale is not None):
        raise ValueError(f"grouped GEMM takes act in {ACTS}, a row scale only without one; got {act!r}")
    return _native.route(grouped_gemm, a, _grouped_cuda, _grouped_plain, a, w, p, act, row_scale)


grouped_gemm.launches = 0
