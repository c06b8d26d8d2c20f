"""Tracing and timing hooks (the port of ``btia_tpu/utils/profiling.py``).

* ``trace(logdir)``: a ``torch.profiler`` region that writes a Chrome /
  Perfetto trace (``chrome://tracing``, ui.perfetto.dev) into ``logdir``;
* ``span(name, key)``: a named range of the program's own (``btia.*``) on
  the profiler's clock while a profiler runs, and nothing but one flag's
  read otherwise;
* ``fetch(tree)``: copy every tensor leaf to the host, the real completion
  point of work launched on the card (PyTorch returns before the card
  finishes);
* ``Timer``: accumulating spans, timed on CUDA events when the result lives
  on the card and on the host clock otherwise;
* ``memory_stats(device)``: the card's allocator statistics.

The reference's ``dump_hlo`` and ``check_tracer_leaks`` have no counterpart:
the first arranges XLA's HLO dumps and the second JAX's check for traced
values escaping a trace. The port runs eagerly, with neither a compiler IR
nor tracers; its kernels' compiler output is ``nvcc``'s (``-Xptxas=-v`` in
``ops/_native.py``).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from btia_tpu_torch.core.device import resolve_device


@contextlib.contextmanager
def trace(logdir: str | Path = "runs/trace") -> Iterator[torch.profiler.profile]:
    """Profile a region: ``with trace('runs/x/trace'): step(...)``. The card
    is traced too when the process has one. Yields the profiler, whose
    ``key_averages()`` give the time by operator and kernel."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / f"trace_{time.time_ns()}.json"))


_OFF = contextlib.nullcontext()


def span(name: str, key=None):
    """A range named `name` (``name|key`` with a `key`) around a block, on
    the thread that runs it, while a profiler (``torch.profiler.profile``,
    ``trace`` above) is active: ``with span("btia.serve.drain", n): ...``.
    It lands in the Chrome trace as a ``user_annotation`` event on the
    profiler's clock, the kernels' clock. With no profiler active it reads
    one flag and returns a shared null context: no name is formatted, no
    ``RecordFunction`` made and no clock read. A span open while a profiler
    starts or stops (a generator suspended inside one) raises nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name if key is None else f"{name}|{key}")


def _leaves(tree) -> Iterator:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def fetch(tree):
    """Host copies of every tensor leaf of `tree` (dicts, lists and tuples),
    the same structure back; other leaves unchanged. Returns once the work
    that made them has finished."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: fetch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fetch(v) for v in tree)
    return tree


def _on_card(tree) -> bool:
    return any(isinstance(x, torch.Tensor) and x.is_cuda for x in _leaves(tree))


class Timer:
    """Accumulating timer for step loops."""

    def __init__(self):
        self.total = 0.0  # seconds
        self.count = 0

    @contextlib.contextmanager
    def span(self, result=None) -> Iterator[None]:
        """Time the block and the fetch of `result`, a tensor or a tree of
        them (a list the block fills will do). When `result` holds a tensor
        on the card as the block ends, the span is the card's time between
        two CUDA events on the current stream, one recorded as the block
        starts and one after the fetch; otherwise the host clock's."""
        start = None
        if torch.cuda.is_available():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        yield
        if start is not None and _on_card(result):
            end = torch.cuda.Event(enable_timing=True)
            fetch(result)
            end.record()
            end.synchronize()
            self.total += start.elapsed_time(end) / 1e3
        else:
            fetch(result)
            self.total += time.perf_counter() - t0
        self.count += 1

    @property
    def mean_ms(self) -> float:
        return 1000.0 * self.total / max(self.count, 1)


def memory_stats(device: Optional[torch.device | str] = "cuda") -> dict:
    """``torch.cuda.memory_stats`` of a card; ``{}`` for the CPU, which keeps
    no allocator statistics (as the reference returns ``{}`` for a device
    without them)."""
    dev = resolve_device(device)
    return dict(torch.cuda.memory_stats(dev)) if dev.type == "cuda" else {}
