"""Host-side input pipeline: decode → tokenize → batch → prefetch.

The single host core [SURVEY §7.3] must never starve the chip, so:
  * decoded ingest-size uint8 images are cached in RAM (medical VQA corpora
    are small — VQA-RAD has 315 images [B:7]);
  * batches are assembled on a background thread (queue-based prefetch)
    overlapping host work with device steps;
  * everything device-side (final resize, normalize) happens inside the
    jit'd model [B:5], so a batch is just uint8 images + int32 ids.

Eval iterators pad the final batch and carry a validity mask so jit sees
one static batch shape [SURVEY §3.2].

While a profiler runs, the consumer's wait for each batch is a
``btia.data.wait`` span (``utils/profiling.py::span``) on the consuming
thread; the prefetch thread opens none.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, List, Optional, Protocol

import numpy as np

from btia_tpu_torch.data.datasets import VQASample
from btia_tpu_torch.data.image import load_ingest_image
from btia_tpu_torch.data.vocab import AnswerVocab
from btia_tpu_torch.utils.profiling import span


class TextEncoder(Protocol):
    def encode(self, text: str, max_len: int) -> List[int]: ...


@dataclasses.dataclass
class Batch:
    images: np.ndarray  # (B, S, S, 3) uint8
    question_ids: np.ndarray  # (B, L) int32
    answer_ids: np.ndarray  # (B,) int32
    valid: np.ndarray  # (B,) bool — False on eval padding rows
    categories: Optional[List[str]] = None
    answer_types: Optional[List[str]] = None

    def __len__(self) -> int:
        return self.images.shape[0]


class ImageCache:
    def __init__(self, ingest_size: int):
        self.ingest_size = ingest_size
        self._cache: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()

    def get(self, path: str) -> np.ndarray:
        with self._lock:
            hit = self._cache.get(path)
        if hit is not None:
            return hit
        img = load_ingest_image(path, self.ingest_size)
        with self._lock:
            self._cache[path] = img
        return img


def _assemble(
    samples: List[VQASample],
    cache: ImageCache,
    text_encoder: TextEncoder,
    answer_vocab: AnswerVocab,
    max_len: int,
    pad_to: Optional[int] = None,
) -> Batch:
    B = len(samples)
    size = cache.ingest_size
    n = pad_to or B
    images = np.zeros((n, size, size, 3), np.uint8)
    qids = np.zeros((n, max_len), np.int32)
    aids = np.zeros((n,), np.int32)
    valid = np.zeros((n,), bool)
    cats, atypes = [], []
    for i, s in enumerate(samples):
        images[i] = cache.get(s.image_path)
        qids[i] = np.asarray(text_encoder.encode(s.question, max_len), np.int32)
        aids[i] = answer_vocab.encode(s.answer)
        valid[i] = True
        cats.append(s.category)
        atypes.append(s.answer_type)
    cats += [""] * (n - B)
    atypes += [""] * (n - B)
    return Batch(images, qids, aids, valid, cats, atypes)


def make_iterator(
    samples: List[VQASample],
    text_encoder: TextEncoder,
    answer_vocab: AnswerVocab,
    cache: ImageCache,
    batch_size: int,
    max_len: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    prefetch: int = 2,
) -> Iterator[Batch]:
    """One epoch of batches, assembled on a background thread, or on the
    consumer's thread with `prefetch` 0."""
    order = np.arange(len(samples))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    if drop_last:
        order = order[: (len(order) // batch_size) * batch_size]

    def batches() -> Iterator[Batch]:
        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            chunk = [samples[i] for i in idx]
            yield _assemble(
                chunk,
                cache,
                text_encoder,
                answer_vocab,
                max_len,
                pad_to=batch_size if len(chunk) < batch_size else None,
            )

    if prefetch <= 0:
        made = batches()
        while True:
            with span("btia.data.wait"):
                b = next(made, None)
            if b is None:
                return
            yield b

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    _END = object()

    def worker():
        # A mid-epoch failure (e.g. unreadable image) must surface in the
        # consumer, not silently truncate the epoch — that would skew the
        # steps-per-epoch accounting mid-epoch resume depends on.
        try:
            for b in batches():
                q.put(b)
        except BaseException as e:
            q.put(e)
        else:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        with span("btia.data.wait"):
            item = q.get()
        if item is _END:
            break
        if isinstance(item, BaseException):
            raise item
        yield item


def steps_per_epoch(n: int, batch_size: int, drop_last: bool) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)
