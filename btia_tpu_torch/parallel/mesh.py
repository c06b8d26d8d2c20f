"""The ('data', 'model') mesh over ``torch.distributed`` ranks (the port of
``btia_tpu/parallel/mesh.py``).

The reference's mesh is an array of devices that one program partitions
over. Here every rank is a process, and a ``Mesh`` is that process's view of
the mesh: the axis sizes, this rank's (data, model) coordinate and the
process group of each axis it lies on.

Axes:
  ``data``  — batch (DP): gradients average over the data group.
  ``model`` — tensor parallelism (TP): attention heads and MLP hidden units
              are split over the model group, whose all-reduce joins each
              block's partial outputs.

Ranks are laid out row-major, as the reference's
``np.asarray(devices).reshape(data, model)`` lays out devices, so the
chatty model axis is the contiguous one (ranks 2i and 2i+1 at model 2).
A 1 x 1 mesh creates no process group, so one process with the default
``MeshCfg()`` behaves exactly as without a mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, Optional, Tuple

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape. -1 means "all remaining ranks"."""

    data: int = -1
    model: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int]:
        data, model = self.data, self.model
        if model == -1 and data == -1:
            raise ValueError("at most one mesh axis may be -1")
        if data == -1:
            data = n_devices // model
        if model == -1:
            model = n_devices // data
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} != {n_devices} devices; "
                f"pick divisors of the device count"
            )
        return data, model


class Mesh:
    """One rank's view of a (data, model) mesh.

    ``shape`` is {"data": dp, "model": tp}; ``coord`` this rank's (data,
    model) indices; ``group(axis)`` the process group of the ranks that
    share this rank's other coordinate, None where the axis has size 1."""

    def __init__(self, data: int, model: int, rank: int = 0,
                 groups: Optional[Dict[str, object]] = None):
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.size = data * model
        self.rank = rank
        self.coord = divmod(rank, model)
        self._groups = groups or {}

    def group(self, axis: str):
        return self._groups.get(axis)

    def index(self, axis: str) -> int:
        return self.coord[0 if axis == DATA_AXIS else 1]

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, coord={self.coord})"


def make_mesh(config: MeshConfig = MeshConfig()) -> Mesh:
    """Build this rank's view of a mesh over all ranks of the default process
    group (one rank when none is initialised).

    Every rank creates every axis group, in the same order
    (``dist.new_group`` is collective): the model groups {d*tp .. d*tp+tp-1}
    for each data index d, then the data groups {m, tp+m, ...} for each
    model index m. An axis of size 1 gets no group."""
    initialized = dist.is_available() and dist.is_initialized()
    world_size = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    data, model = config.resolve(world_size)
    groups: Dict[str, object] = {}
    if world_size > 1:
        if model > 1:
            for d in range(data):
                ranks = [d * model + m for m in range(model)]
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[MODEL_AXIS] = g
        if data > 1:
            for m in range(model):
                ranks = [d * model + m for d in range(data)]
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[DATA_AXIS] = g
    return Mesh(data, model, rank, groups)


def single_device_mesh() -> Mesh:
    """A 1 x 1 mesh: this process alone, no process group."""
    return Mesh(1, 1)


def best_mesh_config(n_devices: int, max_model: int = 1) -> MeshConfig:
    """Largest model axis dividing n_devices, capped at max_model."""
    model = math.gcd(n_devices, max_model)
    while n_devices % model:
        model -= 1
    return MeshConfig(data=n_devices // model, model=model)


# The mesh the model's collectives run over: set by ``ops.fused_mesh``.
_ACTIVE: Optional[Mesh] = None


def active_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing ``fused_mesh`` context, or None."""
    return _ACTIVE


def axis_size(axis: str) -> int:
    """The active mesh's size along `axis` (1 without a mesh)."""
    return 1 if _ACTIVE is None else _ACTIVE.shape[axis]


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[None]:
    """Make `mesh` the active one inside the context; None or a 1-rank mesh
    leaves no mesh active."""
    global _ACTIVE
    old = _ACTIVE
    _ACTIVE = mesh if (mesh is not None and mesh.size > 1) else None
    try:
        yield
    finally:
        _ACTIVE = old
