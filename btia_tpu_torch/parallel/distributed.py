"""Process-group initialisation (the port of
``btia_tpu/parallel/distributed.py``).

Each rank of a mesh is one process. ``maybe_initialize`` joins them into a
``torch.distributed`` process group; a single process skips it and runs
without one.

The backend is stated, never guessed from what happens to work: ``"nccl"``
by default on the card, one card per local rank, and ``"gloo"`` on the CPU
or when the caller names it. NCCL refuses two ranks on one card, so ranks
that share a card (a one-card test of a two-rank mesh) ask for ``"gloo"``,
whose collectives on CUDA tensors are staged through the host.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 120.0


def default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def maybe_initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Initialise the process group when a multi-process run is asked for.

    Resolution order: explicit arguments (``coordinator_address`` as
    ``host:port``) -> torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK`` (PyTorch's idiom, in place of the reference's
    ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``).
    A rendezvous or collective that waits longer than `timeout_s` fails
    instead of hanging. Returns True if the process group is (already) up."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    num_processes = num_processes or _int_env("WORLD_SIZE")
    process_id = process_id if process_id is not None else _int_env("RANK")
    if not (coordinator_address and num_processes):
        return False
    backend = backend or default_backend()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        local = _local_index(process_id or 0)
        n = torch.cuda.device_count()
        if local >= n:
            raise RuntimeError(
                f"backend 'nccl' takes one card per local rank: local rank {local} of a host with {n} "
                "card(s); pass backend='gloo' to share a card between ranks"
            )
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id or 0, timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def _local_index(rank: int) -> int:
    local = _int_env("LOCAL_RANK")
    return rank if local is None else local


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def local_rank() -> int:
    """This process's rank on its host (torchrun's ``LOCAL_RANK``, else its
    global rank), and on the card the device it runs on: card
    ``local_rank`` under NCCL, ``local_rank % cards`` under gloo, where
    ranks may share a card."""
    local = _local_index(process_index())
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        nccl = dist.is_initialized() and dist.get_backend() == "nccl"
        if nccl and local >= n:
            raise RuntimeError(f"backend 'nccl': local rank {local} has no card of its own ({n} card(s))")
        torch.cuda.set_device(local % n)
    return local
