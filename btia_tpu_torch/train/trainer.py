"""Training / eval harness (the port of ``btia_tpu/train/trainer.py``).

Epoch loop over the prefetching host pipeline, per-epoch evaluation with the
reference's metric definitions, best-on-val checkpointing, resume from the
latest checkpoint (mid-epoch too: the batch order is a function of
(seed, epoch), so the restored step reproduces the uninterrupted sequence),
and a SIGTERM / SIGINT handler that saves durably and returns. Runs on the
card unless the caller passes ``device="cpu"``.

The mesh comes from ``cfg.mesh`` over the ranks of the process group
(``parallel.distributed.maybe_initialize``), as the reference's does
(``trainer.py:61``); one process with a mesh that does not factor raises.
Every rank builds the same pipeline and model and feeds its own rows
(``shard_batch`` / ``shard_chunk``). Only the primary writes the
checkpoints, the metrics log, the config and the vocabularies; a
checkpoint holds the gathered, whole state, so it loads on one device, and
a run under the same mesh resumes from it.
"""

from __future__ import annotations

import itertools
import signal
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from btia_tpu_torch.configs.config import Config
from btia_tpu_torch.core.device import resolve_device
from btia_tpu_torch.data.builder import DataModule, build_data
from btia_tpu_torch.data.pipeline import Batch
from btia_tpu_torch.models.model import BTIAADNet, build_model
from btia_tpu_torch.parallel.distributed import is_primary
from btia_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from btia_tpu_torch.parallel.sharding import shard_batch, shard_chunk
from btia_tpu_torch.train.checkpoint import Checkpointer
from btia_tpu_torch.train.metrics import EvalAccumulator
from btia_tpu_torch.train.steps import (
    TrainState,
    create_state,
    make_eval_step,
    make_train_step,
    make_train_step_scan,
)
from btia_tpu_torch.utils.logging import MetricLogger
from btia_tpu_torch.utils.profiling import span

_FIELDS = ("images", "question_ids", "answer_ids", "valid")


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype == torch.int32:
        t = t.long()
    return t.to(device)


def batch_to_device(batch: Batch, device, mesh=None) -> dict:
    """A batch's tensors on the device; with a mesh, this rank's rows."""
    with span("btia.train.to_device"):
        arrays = {k: getattr(batch, k) for k in _FIELDS}
        if mesh is not None:
            arrays = shard_batch(arrays, mesh)
        return {k: _tensor(a, device) for k, a in arrays.items()}


def chunk_to_device(batches: List[Batch], device, mesh=None) -> dict:
    """K batches stacked to (K, B, ...) tensors for the K-step call; with a
    mesh, this rank's rows of each."""
    with span("btia.train.to_device"):
        arrays = {k: np.stack([getattr(b, k) for b in batches]) for k in _FIELDS}
        if mesh is not None:
            arrays = shard_chunk(arrays, mesh)
        return {k: _tensor(a, device) for k, a in arrays.items()}


class Trainer:
    def __init__(
        self,
        cfg: Config,
        workdir: str | Path = "runs/default",
        data: Optional[DataModule] = None,
        device="cuda",
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        if cfg.train.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        self.data = data or build_data(cfg)
        self.mesh = make_mesh(MeshConfig(cfg.mesh.data, cfg.mesh.model))
        self.primary = is_primary()
        self.model: BTIAADNet = build_model(cfg.model, device=self.device, seed=cfg.train.seed)
        self.state: TrainState = create_state(
            self.model, cfg, steps_per_epoch=self.data.steps("train"), mesh=self.mesh
        )
        self.train_step = make_train_step(self.model, cfg, self.mesh)
        self.train_step_scan = (
            make_train_step_scan(self.model, cfg, self.mesh) if cfg.train.steps_per_call > 1 else None
        )
        self.eval_step = make_eval_step(self.model, cfg, vocab_size=len(self.data.answer_vocab),
                                        mesh=self.mesh)
        self.ckpt = Checkpointer(self.workdir / cfg.train.checkpoint_dir, cfg.train.keep_checkpoints,
                                 primary=self.primary)
        if self.primary:
            self.ckpt.save_config(cfg)
            self.data.save_vocabs(self.workdir / "vocabs")
        self.logger = MetricLogger(self.workdir / "metrics.jsonl" if self.primary else None,
                                   echo=self.primary)
        self._preempted = False

    def install_preemption_handler(self) -> None:
        """On SIGTERM / SIGINT, finish the step in flight, save durably and
        return from ``fit``; a restart resumes where it stopped."""

        def handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    def resume_if_available(self) -> bool:
        if self.ckpt.latest_step() is not None:
            self.ckpt.restore(self.state)
            return True
        return False

    def fit(self, epochs: Optional[int] = None) -> List[Dict[str, float]]:
        cfg = self.cfg
        history: List[Dict[str, float]] = []
        epochs = epochs or cfg.train.epochs
        spe = max(self.data.steps("train"), 1)
        start_epoch, start_offset = divmod(self.state.step, spe)
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            losses, accs, n_items = [], [], 0
            it = self.data.iterator("train", seed=cfg.train.seed + epoch)
            offset = start_offset if epoch == start_epoch else 0
            it = itertools.islice(it, offset, None)
            K = max(1, cfg.train.steps_per_call)
            i = offset - 1  # step index within the epoch
            while True:
                buf = list(itertools.islice(it, K))
                if not buf:
                    break
                if len(buf) == K and self.train_step_scan is not None:
                    _, ms = self.train_step_scan(self.state, chunk_to_device(buf, self.device, self.mesh))
                    m = {k: v[-1] for k, v in ms.items()}  # last step's metrics
                else:
                    for b in buf:
                        _, m = self.train_step(self.state, batch_to_device(b, self.device, self.mesh))
                i += len(buf)
                n_items += sum(len(b) for b in buf)
                if self._preempted:
                    self.ckpt.save(self.state)
                    # The one save that must be durable before returning:
                    # the process is about to die.
                    self.ckpt.wait_until_finished()
                    self.logger.log(split="preempt", step=self.state.step)
                    return history
                first = i < offset + len(buf)
                if first or (i + 1) // cfg.train.log_every > (i + 1 - len(buf)) // cfg.train.log_every:
                    m = {k: float(v) for k, v in m.items()}
                    losses.append(m["loss"])
                    accs.append(m["accuracy"])
                    self.logger.log(step=self.state.step, split="train", **m)
            wall = time.time() - t0
            eval_metrics = self.evaluate("val")
            row = {
                "epoch": epoch,
                "train_loss": float(np.mean(losses)) if losses else float("nan"),
                "train_accuracy": float(np.mean(accs)) if accs else float("nan"),
                "examples_per_sec": n_items / max(wall, 1e-6),
                **{f"val_{k}": v for k, v in eval_metrics.items()},
            }
            if self.device.type == "cuda":  # this process's card, since it started
                row["peak_mem_gib"] = torch.cuda.max_memory_allocated(self.device) / 2**30
            history.append(row)
            self.logger.log(split="epoch", **row)
            # Async: the next epoch's steps overlap the checkpoint write.
            self.ckpt.save(self.state, metric=eval_metrics.get("accuracy"))
        self.ckpt.wait_until_finished()  # durable before fit() returns
        return history

    def evaluate(self, split: str = "test") -> Dict[str, float]:
        acc = EvalAccumulator()
        vocab = self.data.answer_vocab
        for batch in self.data.iterator(split):
            out = self.eval_step(self.state, batch_to_device(batch, self.device))
            preds = out["preds"].cpu().numpy()
            acc.add_batch(
                correct=out["correct"].cpu().numpy(),
                valid=batch.valid,
                answer_types=batch.answer_types,
                categories=batch.categories,
                pred_answers=[vocab.decode(int(p)) for p in preds],
                ref_answers=[vocab.decode(int(a)) for a in batch.answer_ids],
            )
        return acc.summary()
