"""The collectives of the mesh, each on one axis's process group and written
through ``all_reduce`` alone.

``all_reduce`` is the one collective that every backend takes on CUDA
tensors (gloo documents ``all_reduce`` and ``broadcast`` there), so a gather
is an all-reduce into a zeroed buffer in which each rank fills its own
slot, here and on the card alike.

The autograd pair of Megatron's tensor parallelism, as ``shard_map``'s
transpose gives it in the reference:

* ``copy_to_model`` — identity forward; the backward sums the gradient over
  the model group. Every replicated tensor that enters shard-local work (a
  column-parallel product's input, a LayerNorm folded into a shard's site,
  the bias share of a row-parallel product) goes through it, so its
  gradient is the sum of the shards' contributions;
* ``reduce_from_model`` — the sum of the shards' partial outputs forward;
  the backward passes the (replicated) gradient through.

``all_reduce_sum`` sums both ways (BatchNorm's statistics over the data
group). ``all_reduce_max_`` takes the maximum (the row and column amaxes of
int8 products under a model axis). Without a mesh, or on an axis of size 1,
each is the identity.

``stats`` counts the all-reduces this process issued and their bytes, per
axis (sums and maxima alike); ``reset_stats`` zeroes it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from btia_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, active_mesh

stats: Dict[str, Dict[str, int]] = {}


def reset_stats() -> None:
    stats.clear()


def _group(axis: str, mesh: Optional[Mesh]):
    mesh = mesh if mesh is not None else active_mesh()
    return None if mesh is None else mesh.group(axis)


def all_reduce_(t: torch.Tensor, axis: str, mesh: Optional[Mesh] = None,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum `t` (contiguous) over the axis's group, in place (or reduce it
    by `op`); returns it."""
    group = _group(axis, mesh)
    if group is None:
        return t
    s = stats.setdefault(axis, {"calls": 0, "bytes": 0})
    s["calls"] += 1
    s["bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_max_(t: torch.Tensor, axis: str, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The elementwise maximum of `t` (contiguous) over the axis's group, in
    place; returns it. Counted in ``stats`` as ``all_reduce_`` counts."""
    return all_reduce_(t, axis, mesh, dist.ReduceOp.MAX)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.contiguous().clone(), MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), MODEL_AXIS)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis), None


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the model group's partial outputs (identity backward)."""
    return x if _group(MODEL_AXIS, None) is None else _ReduceFromModel.apply(x)


def copy_to_model(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Identity forward; the gradient summed over the model group."""
    if x is None or _group(MODEL_AXIS, None) is None or not torch.is_grad_enabled():
        return x
    return _CopyToModel.apply(x)


def all_reduce_sum(x: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
    """The sum over the axis's group, forward and backward."""
    return x if _group(axis, None) is None else _AllReduceSum.apply(x, axis)


def gather_dim(x: torch.Tensor, axis: str, mesh: Optional[Mesh] = None, dim: int = 0) -> torch.Tensor:
    """The axis group's equal-sized pieces of a tensor, joined along `dim` in
    the order of the axis index (an all-gather, as an all-reduce of a zeroed
    buffer in which each rank fills its own slot). Booleans travel as bytes."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or mesh.group(axis) is None:
        return x
    n, i = mesh.shape[axis], mesh.index(axis)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    shape = list(src.shape)
    size = shape[dim]
    shape[dim] = n * size
    buf = torch.zeros(shape, dtype=src.dtype, device=src.device)
    buf.narrow(dim, i * size, size).copy_(src)
    all_reduce_(buf, axis, mesh)
    return buf.bool() if x.dtype == torch.bool else buf


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The data group's row blocks of a batch, in rank order: each rank gets
    the whole batch back, as a global array reads whole on every process."""
    return gather_dim(x, DATA_AXIS, mesh, 0)
