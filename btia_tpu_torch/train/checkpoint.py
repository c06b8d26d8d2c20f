"""Checkpointing with ``torch.save`` (the port of
``btia_tpu/train/checkpoint.py``), with the orbax manager's contract:

* ``save`` snapshots the state to host memory before it returns and writes
  the file on a background thread, so the step loop may go on updating the
  live tensors at once; ``wait_until_finished`` makes every save durable;
* the latest ``max_to_keep`` steps are kept, older ones deleted;
* the best step by validation metric lives in its own single-slot
  directory, so rotation never deletes it, and its pointer ``best.json`` is
  written only after that save is durable;
* ``restore`` loads the latest step, a given one, or the best.

Each checkpoint is one file ``step_<n>.pt``, written under a temporary name
and renamed, so a crash never leaves a partial file under a step's name.
The config is serialized beside the weights, as in the reference.

Under a mesh every rank calls ``save`` (the state is gathered from the
shards, a collective), and only the primary (``primary=True``) writes.
"""

from __future__ import annotations

import json
import os
import re
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from btia_tpu_torch.configs.config import Config
from btia_tpu_torch.train.steps import TrainState

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _to_host(obj):
    """A copy of `obj` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _steps(directory: Path) -> List[int]:
    if not directory.is_dir():
        return []
    return sorted(int(m.group(1)) for p in directory.iterdir() if (m := _STEP_FILE.match(p.name)))


def _write(directory: Path, step: int, payload: dict, keep: int) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f".step_{step}.pt.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, directory / f"step_{step}.pt")
    for old in _steps(directory)[:-keep]:
        (directory / f"step_{old}.pt").unlink(missing_ok=True)


class Checkpointer:
    def __init__(self, directory: str | Path, max_to_keep: int = 3, primary: bool = True):
        self.primary = primary
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.best_directory = self.directory / "best_ckpt"
        self.max_to_keep = max_to_keep
        self._writer = ThreadPoolExecutor(max_workers=1)
        self._pending: List[Future] = []
        self._best_metric: Optional[float] = self._read_best()[1]

    def _submit(self, directory: Path, step: int, payload: dict, keep: int) -> Future:
        fut = self._writer.submit(_write, directory, step, payload, keep)
        self._pending.append(fut)
        return fut

    def save(self, state: TrainState, metric: Optional[float] = None) -> None:
        """Returns once the state is snapshotted to host memory; the file is
        written in the background."""
        payload = _to_host(state.state_dict())
        step = state.step
        if not self.primary:
            return
        self._submit(self.directory, step, payload, self.max_to_keep)
        if metric is not None and (self._best_metric is None or metric > self._best_metric):
            self._best_metric = metric
            # Durable before the pointer: best.json never names a step that
            # is not on disk in best_ckpt.
            self._submit(self.best_directory, step, payload, 1).result()
            tmp = self.directory / "best.json.tmp"
            tmp.write_text(json.dumps({"step": step, "metric": metric}))
            os.replace(tmp, self.directory / "best.json")

    def wait_until_finished(self) -> None:
        """Block until every save so far is on disk (re-raising its error)."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def _read_best(self) -> Tuple[Optional[int], Optional[float]]:
        f = self.directory / "best.json"
        if f.exists():
            d = json.loads(f.read_text())
            return int(d["step"]), float(d["metric"])
        return None, None

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()  # count only durable saves
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None, best: bool = False) -> TrainState:
        """Load a checkpoint into `state` (in place, onto its device)."""
        self.wait_until_finished()
        directory = self.directory
        if best and _steps(self.best_directory):
            directory, step = self.best_directory, _steps(self.best_directory)[-1]
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        payload = torch.load(directory / f"step_{step}.pt", map_location=state.device)
        state.load_state_dict(payload)
        return state

    # -- sidecar files ----------------------------------------------------

    def save_config(self, cfg: Config) -> None:
        (self.directory / "config.json").write_text(cfg.to_json())

    def load_config(self) -> Config:
        return Config.from_json((self.directory / "config.json").read_text())
