"""The train driver: the program's ``Trainer`` stepping as ``fit`` steps it
(``train_step_scan`` over chunks of ``steps_per_call`` batches, single
steps for an epoch's remainder), fed by ``data.iterator("train")`` epoch
after epoch, with no evaluation or checkpoint in the window.

Set-up: the kernel library, the mix's VQA-Med corpus from the seed
(written by the first run of that seed in the checkout, under
``.portbench_cache/corpus/``) and read by the program's loader, the
WordPiece vocabulary file and the answer list (both handed to the program
and to the reference), one pass over the images to fill the pipeline's RAM
cache, the Trainer with the weights made on the card from the seed, and
its first ``setup_calls`` calls, which warm the step up; the first three
steps' losses, the first gradient as the optimizer holds it after one step
and each leaf's change after three steps are read there.

Window: whole calls until the first one that finishes after ``--seconds``;
``examples_per_s`` is the examples of every step in them over the elapsed
time. With ``--trace 1`` the profiler runs over the window's last seconds
(``trace.trace_span``), and the model FLOPs rate (``step_mfu.train``) is
taken over the calls before it, which no profiler start or stop falls into.

After the window, once memory is read and the Trainer is freed: the
reference runs the same three steps from the same weights, images (decoded
from the corpus's files), questions and answers, and the two are compared.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from portbench import bench, flops, traffic
from portbench.reference import model as R
from portbench.reference import train as RT
from portbench.reference.wordpiece import WordPiece

BETA1 = 0.9
REF_BLOCK_ROWS = 32  # rows the reference runs at a time, so that its f32 activations fit on the card


def _leaf_norms(tensors) -> np.ndarray:
    import torch

    return torch.stack([t.detach().float().norm() for t in tensors]).double().cpu().numpy()


class Readings:
    """Wraps the optimizer's step during set-up: after its first step the
    first gradient (AdamW's first moment / (1 - beta1)), after its third
    each leaf's change from the initial weights."""

    def __init__(self, opt, initial):
        self.opt, self.initial = opt, initial
        self.grad1 = self.change3 = None
        self.orig = opt.step
        opt.step = self.step

    def step(self):
        norm = self.orig()
        c = self.opt.count
        if c == 1:
            st = self.opt.adamw.state
            self.grad1 = _leaf_norms([st[p]["exp_avg"] if p in st else p.new_zeros(())
                                      for p in self.opt.params]) / (1 - BETA1)
        elif c == 3:
            self.change3 = _leaf_norms([p - self.initial[n] for n, p in zip(self.opt.names, self.opt.params)])
        return norm

    def remove(self):
        self.opt.step = self.orig


def _fault(trainer, fault: str):
    """Plant a fault (tests and calibration only); returns its undo."""
    if fault == "state_unchanged":
        trainer.state.optimizer.adamw.step = lambda *a, **k: None
    elif fault == "half_batch":
        scan = trainer.train_step_scan
        trainer.train_step_scan = lambda st, ch: scan(st, {k: v[:, : v.shape[1] // 2] for k, v in ch.items()})
    elif fault == "no_allreduce":  # the gradients' exchange between cards left out
        from btia_tpu_torch.train import steps

        orig = steps.all_reduce_
        steps.all_reduce_ = lambda t, axis, mesh=None, **k: t if t.numel() > 1 else orig(t, axis, mesh, **k)
        return lambda: setattr(steps, "all_reduce_", orig)
    elif fault is not None:
        raise KeyError(fault)
    return lambda: None


def run(r: bench.Run) -> None:
    import torch

    from btia_tpu_torch.data.builder import build_data
    from btia_tpu_torch.data.vocab import AnswerVocab
    from btia_tpu_torch.ops import _native
    from btia_tpu_torch.train.trainer import Trainer

    mix, dev = r.mix, r.device
    r.info["setup_to_driver_s"] = round(time.perf_counter() - r.t_start, 2)
    world = int(mix.get("ranks", 1))
    if world > 1 and r.variant != "control":
        from btia_tpu_torch.parallel.distributed import local_rank, maybe_initialize

        maybe_initialize(backend="gloo" if dev == "cpu" else None)
        local_rank()
        if dev == "cpu":  # the ranks share this host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if dev == "cuda":
        _native.lib()
    t_corpus = time.perf_counter()
    corpus = traffic.cached_corpus(mix, r.seed, bench.CACHE / "corpus")
    data_dir = Path(corpus["samples"][0][0]).parents[2]
    r.info["setup_corpus_s"] = round(time.perf_counter() - t_corpus, 2)
    vocab_file = traffic.write_vocab(r.scratch / "vocab.txt", corpus["questions"])
    # the configuration's batch is a card's; the Trainer takes the global one
    cfg = r.cfg.override(**{"data.data_dir": str(data_dir), "train.batch_size": r.cfg.train.batch_size * world})
    m = bench.model_dict(cfg)
    if r.variant == "control":  # the reference in fp8, in the program's place
        spe = len(corpus["samples"]) // cfg.train.batch_size
        loss, g1, ch = reference_steps(cfg, m, corpus, vocab_file, spe, r.seed, dev, R.mm_fp8, ranks=world)
        names = sorted(g1)
        prog = {"loss": loss, "grad1": np.asarray([g1[n] for n in names]),
                "change3": np.asarray([ch[n] for n in names])}
        return judge(r, cfg, m, corpus, vocab_file, names, prog, spe, world)
    dm = build_data(cfg, bert_vocab_file=str(vocab_file))
    dm.answer_vocab = AnswerVocab(corpus["answers"])
    t_fill = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(dm.cache.get, sorted({s.image_path for s in dm.train})))
    r.info["setup_cache_fill_s"] = round(time.perf_counter() - t_fill, 2)
    t_trainer = time.perf_counter()
    trainer = Trainer(cfg, r.scratch / "run", data=dm, device=dev)
    r.info["setup_trainer_s"] = round(time.perf_counter() - t_trainer, 2)
    weights = R.make_weights(m, r.seed, dev)
    trainer.model.load_state_dict(weights, strict=True)
    readings = Readings(trainer.state.optimizer, weights)
    undo = _fault(trainer, r.fault)
    try:
        out = _steps(r, trainer, dm, readings, cfg, m, world, dev)
    finally:
        undo()
    # the program's state is freed before the reference runs
    del trainer, dm, readings, weights
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    if out is not None:
        t_judge = time.perf_counter()
        judge(r, cfg, m, corpus, vocab_file, *out, world)
        r.info["judge_s"] = round(time.perf_counter() - t_judge, 2)


def _steps(r, trainer, dm, readings, cfg, m, world, dev):
    """Set-up's first calls and the window; returns what the judge needs
    (leaf names, steps an epoch, the program's readings), on rank 0."""
    import torch

    from btia_tpu_torch.train.trainer import batch_to_device, chunk_to_device

    mix = r.mix
    K = max(1, cfg.train.steps_per_call)

    def calls():
        """(buf, call) pairs as ``fit`` makes them, epoch after epoch."""
        for epoch in itertools.count():
            it = dm.iterator("train", seed=cfg.train.seed + epoch)
            while True:
                t = time.perf_counter()
                buf = list(itertools.islice(it, K))
                wait = time.perf_counter() - t
                if not buf:
                    break
                yield buf, wait

    def step(buf):
        if len(buf) == K and trainer.train_step_scan is not None:
            return trainer.train_step_scan(trainer.state, chunk_to_device(buf, trainer.device, trainer.mesh))[1]
        for b in buf:
            _, ms = trainer.train_step(trainer.state, batch_to_device(b, trainer.device, trainer.mesh))
        return ms

    t_calls = time.perf_counter()
    feed = calls()
    losses = []
    for i in itertools.count():
        if i >= int(mix["setup_calls"]) and len(losses) >= 3:
            break
        ms = step(next(feed)[0])
        losses += list(np.atleast_1d(ms["loss"].detach().float().cpu().numpy()))
    readings.remove()
    losses = np.asarray(losses[:3])
    r.info["setup_first_calls_s"] = round(time.perf_counter() - t_calls, 2)
    if dev == "cuda":
        torch.cuda.synchronize()

    tracer = None
    if r.trace:
        from portbench.trace import Tracer, trace_span

        tracer = Tracer(r.scratch / "trace.json").prepare()
    from btia_tpu_torch.parallel import collectives

    collectives.reset_stats()
    t0 = time.perf_counter()
    r.setup_s = t0 - r.t_start
    t_end = t0 + r.seconds
    t_trace = t_end - trace_span(r.seconds) if tracer is not None else math.inf
    mfu = None  # (seconds, examples, steps, data wait) before the profiler started
    examples = steps = 0
    data_wait = 0.0
    while True:
        buf, wait = next(feed)
        data_wait += wait
        step(buf)
        steps += len(buf)
        examples += sum(len(b) for b in buf)
        now = time.perf_counter()
        if mfu is None and now >= t_trace:
            if dev == "cuda":
                torch.cuda.synchronize()  # the span's work done
            mfu = (time.perf_counter() - t0, examples, steps, data_wait)
            tracer.start()
        if _stop(now >= t_end, world, dev):
            if dev == "cuda":
                torch.cuda.synchronize()
            break
    elapsed = time.perf_counter() - t0
    if tracer is not None:
        tracer.stop()
    if dev == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated()
    if world > 1:
        allreduced = collectives.stats.get("data", {}).get("bytes", 0)
        import torch.distributed as dist

        dist.destroy_process_group()
        if r.rank != 0:
            return None
    r.attempted, r.failed = steps, 0
    r.e2e["examples_per_s"] = examples / elapsed
    r.ctx.update(kind="train", seconds=elapsed, examples=examples, steps=steps, chips=world,
                 data_wait_ms=1e3 * data_wait / max(steps, 1), model=m, peak_flops=world * flops.PEAK_BF16_FLOPS,
                 memory_peak_bytes=r.memory_peak_bytes)
    if mfu is not None:  # the host-side readings, too, from before the profiler started
        r.ctx.update(mfu_seconds=mfu[0], mfu_flops=mfu[1] * flops.train_example_flops(m),
                     data_wait_ms=1e3 * mfu[3] / max(mfu[2], 1))
    if world > 1:
        r.ctx["allreduce_mb"] = allreduced / 1e6 / max(steps, 1)
    r.info.update(steps=steps, examples=examples, elapsed_s=round(elapsed, 4),
                  train_samples=len(dm.train), losses=[float(x) for x in losses])
    if tracer is not None:
        t_read = time.perf_counter()
        r.ctx["trace"] = tracer.load()
        r.info.update(trace_start_s=round(tracer.start_s, 3), trace_read_s=round(time.perf_counter() - t_read, 2),
                      **r.ctx["trace"].link_stats())

    prog = {"loss": losses, "grad1": readings.grad1, "change3": readings.change3}
    return list(trainer.state.optimizer.names), prog, dm.steps("train")


def _stop(mine: bool, world: int, dev) -> bool:
    """Whether the window ends after this call: on several ranks, once any
    rank's clock says so (they must run the same calls)."""
    if world == 1:
        return mine
    import torch
    import torch.distributed as dist

    flag = torch.tensor([float(mine)], device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def reference_steps(cfg, m, corpus, vocab_file, spe: int, seed: int, dev, mm=R.mm_f32, n_steps: int = 3,
                    ranks: int = 1):
    """The reference's first `n_steps` steps: (losses, first gradient's leaf
    norms, each leaf's change after the last step, leaf names)."""
    import torch
    from PIL import Image

    B = cfg.train.batch_size
    samples = corpus["samples"]
    order = np.arange(len(samples))
    np.random.RandomState(cfg.train.seed).shuffle(order)
    wp = WordPiece(vocab_file)
    aid = {a: i + 1 for i, a in enumerate(corpus["answers"])}
    ingest = max(256, R.VIT[m["image_encoder"]][0])  # the pipeline's image cache size
    P = R.make_weights(m, seed, dev)
    P0 = {k: v.clone() for k, v in P.items()}
    opt = RT.AdamW(P, dataclasses.asdict(cfg.train), max(spe * cfg.train.epochs, cfg.train.warmup_steps + 1))
    losses, grad1 = [], None
    for s in range(n_steps):
        rows = [samples[i] for i in order[s * B : (s + 1) * B]]
        imgs = np.stack([np.asarray(Image.open(p).convert("RGB").resize((ingest, ingest), Image.BILINEAR))
                         for p, _, _ in rows])
        ids = torch.tensor([wp.encode(q, m["max_question_len"]) for _, q, _ in rows], device=dev)
        labels = torch.tensor([aid[a] for _, _, a in rows], device=dev)
        masks = RT.draw_masks(m, B, cfg.train.seed, s, dev, ranks) if m["dropout"] > 0 else []
        with R.exact_f32():
            loss, grads = RT.loss_and_grads(P, torch.from_numpy(imgs).to(dev), ids, labels, m, masks,
                                            cfg.train.label_smoothing, REF_BLOCK_ROWS, mm)
        del masks
        opt.step(P, grads)
        if s == 0:
            grad1 = {k: float(opt.m[k].norm()) / (1 - BETA1) for k in P}
        losses.append(loss)
    change = {k: float((P[k] - P0[k]).norm()) for k in P}
    return np.asarray(losses), grad1, change


def leaf_gap(prog: np.ndarray, ref: np.ndarray, ref_grad: np.ndarray) -> float:
    """The worst leaf's gap of norms, against the larger of its reference
    norm and the median leaf's; leaves whose reference gradient is under a
    thousandth of the median leaf's (nought but for rounding) are left out."""
    counted = ref_grad >= 1e-3 * np.median(ref_grad)
    scale = np.maximum(ref, np.median(ref[counted]))
    return float((np.abs(prog - ref) / scale)[counted].max())


def judge(r: bench.Run, cfg, m, corpus, vocab_file, names, prog, spe, ranks: int = 1) -> None:
    lim = r.limits
    losses, grad1, change = reference_steps(cfg, m, corpus, vocab_file, spe, r.seed, r.device, ranks=ranks)
    g_ref = np.asarray([grad1[n] for n in names])
    c_ref = np.asarray([change[n] for n in names])
    loss_gap = float((np.abs(prog["loss"] - losses) / np.abs(losses)).max())
    r.info.update(ref_losses=[float(x) for x in losses],
                  leaves_counted=int((g_ref >= 1e-3 * np.median(g_ref)).sum()), leaves=len(names))
    r.check("loss_gap", loss_gap, lim["loss_gap"])
    r.check("grad1_leaf_gap", leaf_gap(prog["grad1"], g_ref, g_ref), lim["grad1_leaf_gap"])
    r.check("change3_leaf_gap", leaf_gap(prog["change3"], c_ref, g_ref), lim["change3_leaf_gap"])
