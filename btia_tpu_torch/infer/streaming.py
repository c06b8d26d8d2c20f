"""Streaming many-questions-per-image inference (the port of
``btia_tpu/infer/streaming.py``).

Host threads decode DICOM/JPEG bytes and tokenize questions into a bounded
queue; the serving thread batches them into fixed-shape (B images x Q
questions) launches of the model: on-device resize/normalize -> image
encoder -> question tower -> BTIA -> AD head, optionally top-k. Only the
serving thread touches the model and CUDA tensors. CUDA launches return
before the card finishes, so ``dispatch`` launches batch N+1 while the card
still runs batch N, and ``drain`` copies a batch's results to the host once
``max_in_flight`` batches are queued: the host's batching and launching
overlaps the device's compute, as JAX's async dispatch does in the
reference.

While a profiler runs, the serving thread marks its own time with spans
(``utils/profiling.py::span``): ``btia.serve.wait`` (blocked on the decode
queue), ``btia.serve.dispatch|<launch>`` (stacking, packing and the
launches of one batch), ``btia.serve.drain|<launch>`` (the device-to-host
copies of that batch's results) and ``btia.serve.deliver`` (each yield:
the caller's time). The decode threads open none.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict, deque
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from btia_tpu_torch.infer.predict import ImageLike, Predictor
from btia_tpu_torch.ops.answers import real_limit, topk_real
from btia_tpu_torch.utils.profiling import span


class _DecodeError:
    """Queue envelope for a per-request decode/tokenize failure."""

    def __init__(self, idx: int, exc: Exception):
        self.idx = idx
        self.exc = exc


class StreamingServer:
    def __init__(
        self,
        predictor: Predictor,
        image_batch: int = 8,
        questions_per_image: int = 8,
        decode_threads: int = 2,
        queue_depth: int = 4,
        topk: Optional[int] = None,
        dedup_questions: bool = False,
        pack_pairs: bool = False,
        pair_budget: Optional[int] = None,
        max_in_flight: int = 2,
        max_wait_ms: Optional[float] = None,
        adaptive_q: bool = False,
        q_max: Optional[int] = None,
    ):
        """`topk`: return only the top-k (value, answer-id) pairs per
        question over the real answers (``ops/answers.py``), selected on the
        device, instead of the full answer-vocab logits: a far smaller
        device->host copy. serve() then yields ((values (Q, k), ids (Q, k)),
        n) per image instead of (logits, n). 0 means None.

        `dedup_questions`: encode only the unique question rows of each
        batch and gather per pair (exact: ``answer_questions_indexed``);
        serving question streams are template-heavy.

        `pack_pairs`: for UNEVEN question counts, the B images' real
        questions pack densely into a (P,) pair list driving
        ``answer_pairs``, so no fan-out compute goes to padding slots.
        Implies question dedup. serve() then yields exactly n rows per
        image. `questions_per_image` stays the per-image cap.

        `pair_budget` (packed mode): a FIXED pair capacity P; a batch closes
        early (fewer than B images) when the next request would overflow
        it. Without it, P buckets to the batch's real pair count in
        quarters of B*Q. A fixed launch shape keeps the step time steady.

        `adaptive_q`: requests may carry up to `q_max` (default 2Q)
        questions; each batch runs the smallest power-of-two-of-Q bucket
        that fits its largest request, and the base bucket is the same
        launch as with adaptive_q off.

        `max_wait_ms`: bound per-request latency on sparse streams. A
        partial batch is padded and shipped once the OLDEST pending request
        has waited this long. Per-request enqueue->yield latency is tracked
        either way: see `latency_summary()`."""
        self.p = predictor
        self.B = image_batch
        self.Q = questions_per_image
        self.decode_threads = decode_threads
        self.queue_depth = queue_depth
        self.topk = topk or None
        self.pairs_processed = 0
        self.wall_seconds = 0.0
        # Per-request decode/tokenize failures as (request_index, exc): the
        # request is skipped and the server keeps running.
        self.errors: List[Tuple[int, Exception]] = []
        # Template questions repeat across images: memoize tokenization
        # (pure Python WordPiece), bounded, shared by the decode workers
        # under a lock (get/set/evict is a compound sequence).
        self._tok_memo: "OrderedDict" = OrderedDict()
        self._tok_memo_cap = 65536
        self._tok_memo_lock = threading.Lock()
        self.dedup_questions = dedup_questions
        self.pack_pairs = pack_pairs
        # A budget below Q couldn't fit one full request.
        self.pair_budget = max(pair_budget, questions_per_image) if pair_budget else None
        self.max_in_flight = max(1, max_in_flight)
        self.max_wait = max_wait_ms / 1000.0 if max_wait_ms else None
        # Per-request enqueue->yield latency (seconds), a bounded window,
        # reset per serve().
        self.latencies: "deque[float]" = deque(maxlen=65536)
        # Batches launched by this server: the key of a batch's dispatch
        # and drain spans.
        self.dispatches = 0
        # Launch-shape buckets: fixed [Q], or Q*2^i capped at q_max.
        if adaptive_q:
            cap = max(q_max or 2 * self.Q, self.Q)
            self.q_buckets = [self.Q]
            while self.q_buckets[-1] < cap:
                self.q_buckets.append(min(self.q_buckets[-1] * 2, cap))
        else:
            self.q_buckets = [self.Q]
        self.q_cap = self.q_buckets[-1]
        # The forward of each launch shape served so far (a record of the
        # shapes; nothing is compiled).
        self._ifwd_cache: dict = {}
        self._fwd_cache: dict = {}
        if not pack_pairs:
            self._plain_fwd(self.Q)

    def _q_bucket(self, n: int) -> int:
        """Smallest launch bucket holding n questions (n is pre-capped at
        q_cap by the decode workers)."""
        for b in self.q_buckets:
            if n <= b:
                return b
        return self.q_buckets[-1]

    def _with_topk(self, base):
        """Append top-k selection over REAL answers (no <unk>, no head
        padding), on the device."""
        if self.topk is None:
            return base
        k = self.topk
        limit = real_limit(len(self.p.answer_vocab), self.p.cfg.model.answer_vocab_size)
        return lambda *data: topk_real(base(*data), k, limit)

    def _plain_fwd(self, Qb: int):
        """Fan-out for a Qb-question launch bucket."""
        if Qb not in self._fwd_cache:
            self._fwd_cache[Qb] = self._with_topk(self.p._fanout_forward(self.B, Qb))
        return self._fwd_cache[Qb]

    def _indexed_fwd(self, U: int, Qb: int):
        """Dedup fan-out for a (U unique rows, Qb launch) bucket."""
        key = ("idx", U, Qb)
        if key not in self._ifwd_cache:
            self._ifwd_cache[key] = self._with_topk(self.p._fanout_forward_indexed(self.B, Qb, U))
        return self._ifwd_cache[key]

    def _pairs_fwd(self, U: int, P: int):
        """Packed fan-out for a (U, P) bucket."""
        key = (U, P)
        if key not in self._ifwd_cache:
            self._ifwd_cache[key] = self._with_topk(self.p._pairs_forward(self.B, U, P))
        return self._ifwd_cache[key]

    @staticmethod
    def _bucket_pow2(n: int, lo: int, hi: int) -> int:
        b = lo
        while b < n:
            b *= 2
        return min(b, hi)

    def _decode_worker(
        self,
        src: Iterator[Tuple[int, Tuple[ImageLike, Sequence[str]]]],
        out_q: "queue.Queue",
        lock: threading.Lock,
    ) -> None:
        # The None sentinel MUST go out even if decode raises, or serve()
        # blocks forever on q.get(). Per-request exceptions travel through
        # the queue so the serving loop records them and keeps serving.
        try:
            while True:
                with lock:
                    try:
                        idx, item = next(src)
                    except StopIteration:
                        break
                # The latency clock starts when the request leaves the
                # source: decode, batching wait, device queue, compute and
                # the result copy.
                t_enq = time.perf_counter()
                image, questions = item
                try:
                    img = self.p._prep_image(image)
                    qids = np.zeros((self.q_cap, self.p.cfg.model.max_question_len), np.int64)
                    n = min(len(questions), self.q_cap)
                    for j, qtext in enumerate(list(questions)[:n]):
                        with self._tok_memo_lock:
                            ids = self._tok_memo.get(qtext)
                        if ids is None:
                            ids = self.p._tokenize([qtext])[0]
                            with self._tok_memo_lock:
                                self._tok_memo[qtext] = ids
                                if len(self._tok_memo) > self._tok_memo_cap:
                                    self._tok_memo.popitem(last=False)  # LRU
                        qids[j] = ids
                except Exception as e:  # bad request: report, keep serving
                    out_q.put(_DecodeError(idx, e))
                    continue
                out_q.put((idx, img, qids, n, t_enq))
        finally:
            out_q.put(None)

    def warmup(self) -> float:
        """Push one synthetic batch end to end (the kernels' build and the
        allocator's first blocks), so the first real request sees a step's
        latency. Counters and latencies are restored; returns the seconds."""
        t0 = time.perf_counter()
        pp, ws = self.pairs_processed, self.wall_seconds
        img = np.zeros((self.p.ingest_size, self.p.ingest_size, 3), np.uint8)
        for _ in self.serve(iter([(img, ["warmup question"])] * self.B)):
            pass
        self.pairs_processed, self.wall_seconds = pp, ws
        self.latencies.clear()
        return time.perf_counter() - t0

    def serve(
        self,
        requests: Iterable[Tuple[ImageLike, Sequence[str]]],
    ) -> Iterator[Tuple[int, object, int]]:
        """Yields (request_index, result, n_valid_questions) per image, in
        order of COMPLETION: threaded decode reorders requests, so the index
        is the only safe way to attribute answers. result is logits
        (Q, vocab) as a numpy array, or (n, vocab) with pack_pairs, or
        (values, ids) with topk. Failed requests appear in `self.errors` as
        (index, exception) and yield nothing. Pads the tail to the batch's
        launch shape."""
        # Errors are per call; reset here, before the generator starts, so
        # a caller that inspects them before the first next() sees a clean
        # list.
        self.errors = []
        return self._serve_iter(requests)

    def _serve_iter(
        self,
        requests: Iterable[Tuple[ImageLike, Sequence[str]]],
    ) -> Iterator[Tuple[int, object, int]]:
        src = enumerate(iter(requests))
        self.latencies.clear()
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth * self.B)
        lock = threading.Lock()
        workers = [
            threading.Thread(target=self._decode_worker, args=(src, q, lock), daemon=True)
            for _ in range(self.decode_threads)
        ]
        for w in workers:
            w.start()

        done_workers = 0
        pending: List[Tuple[int, np.ndarray, np.ndarray, int, float]] = []
        in_flight: List[Tuple[object, List[Tuple[int, int, int, float]], int]] = []
        t0 = time.perf_counter()
        wall_base = self.wall_seconds
        BQ = self.B * self.q_cap

        def dispatch(items):
            self.dispatches += 1
            with span("btia.serve.dispatch", self.dispatches):
                out, meta = launch(items)
            in_flight.append((out, meta, self.dispatches))

        def launch(items):
            # items: (request_idx, image, qids (q_cap, L), n, t_enq); idx -1
            # marks a tail/partial-batch padding slot. Launches only.
            imgs = np.stack([it[1] for it in items])
            qids = np.stack([it[2] for it in items])
            Qb = self._q_bucket(max(max(it[3], 1) for it in items))
            if self.pack_pairs:
                rows = [it[2][: it[3]] for it in items if it[3] > 0]
                flat = np.concatenate(rows) if rows else np.zeros((0, qids.shape[-1]), qids.dtype)
                uniq, inv = np.unique(flat, axis=0, return_inverse=True)
                U = self._bucket_pow2(max(len(uniq), 1), 32, BQ)
                upad = np.zeros((U - len(uniq), qids.shape[-1]), qids.dtype)
                uniq = np.concatenate([uniq, upad]) if len(upad) else uniq
                p_img = np.concatenate(
                    [np.full(it[3], i, np.int64) for i, it in enumerate(items) if it[3] > 0]
                    or [np.zeros(0, np.int64)]
                )
                if self.pair_budget:
                    P = self.pair_budget
                else:
                    P = self._bucket_pow2(max(len(p_img), 1), max(BQ // 4, 1), BQ)
                pair_img = np.zeros(P, np.int64)
                pair_q = np.zeros(P, np.int64)
                pair_img[: len(p_img)] = p_img
                pair_q[: len(p_img)] = inv.reshape(-1)
                meta, off = [], 0
                for it in items:
                    meta.append((it[0], it[3], off, it[4]))
                    off += max(it[3], 0)
                out = self._pairs_fwd(U, P)(imgs, uniq, pair_img, pair_q)
            elif self.dedup_questions:
                flat = qids[:, :Qb].reshape(self.B * Qb, -1)
                uniq, inv = np.unique(flat, axis=0, return_inverse=True)
                U = self._bucket_pow2(len(uniq), 32, self.B * Qb)
                pad = np.zeros((U - len(uniq), flat.shape[1]), flat.dtype)
                uniq = np.concatenate([uniq, pad]) if len(pad) else uniq
                qmap = inv.reshape(self.B, Qb)
                out = self._indexed_fwd(U, Qb)(imgs, uniq, qmap)
                meta = [(it[0], it[3], 0, it[4]) for it in items]
            else:
                out = self._plain_fwd(Qb)(imgs, qids[:, :Qb])
                meta = [(it[0], it[3], 0, it[4]) for it in items]
            return out, meta

        def drain(block_all: bool = False):
            # Keep <= max_in_flight batches queued on the device; copying a
            # batch's results to the host waits for that batch only.
            while in_flight and (block_all or len(in_flight) >= self.max_in_flight):
                out, meta, launched = in_flight.pop(0)
                with span("btia.serve.drain", launched):
                    host = out.cpu().numpy() if self.topk is None else [t.cpu().numpy() for t in out]
                if self.topk is None:
                    if self.pack_pairs:
                        row = lambda i, n, off: host[off : off + n]
                    else:
                        row = lambda i, n, off: host[i]
                else:
                    vals, idxs = host
                    if self.pack_pairs:
                        row = lambda i, n, off: (vals[off : off + n], idxs[off : off + n])
                    else:
                        row = lambda i, n, off: (vals[i], idxs[i])
                for i, (idx, n, off, t_enq) in enumerate(meta):
                    if n < 0:  # tail-padding row, not a real request
                        continue
                    self.pairs_processed += n
                    # Updated per yield: callers may abandon the generator.
                    now = time.perf_counter()
                    self.wall_seconds = wall_base + now - t0
                    self.latencies.append(now - t_enq)
                    with span("btia.serve.deliver"):
                        yield idx, row(i, n, off), n

        def close_partial():
            # Ship a padded partial batch (max-wait expiry or stream tail).
            pad = pending[-1]
            while len(pending) < self.B:
                pending.append((-1, pad[1], pad[2], -1, 0.0))
            dispatch(pending)

        while done_workers < self.decode_threads:
            if self.max_wait is not None and pending:
                # Wait at most until the OLDEST pending request has waited
                # max_wait, then ship the padded partial batch and drain it.
                deadline = pending[0][4] + self.max_wait
                try:
                    with span("btia.serve.wait"):
                        item = q.get(timeout=max(0.0, deadline - time.perf_counter()))
                except queue.Empty:
                    close_partial()
                    pending = []
                    yield from drain(block_all=True)
                    continue
            elif self.max_wait is not None and in_flight:
                # Nothing pending but results in flight: if the stream
                # stalls, flush them rather than sitting on finished work.
                try:
                    with span("btia.serve.wait"):
                        item = q.get(timeout=self.max_wait)
                except queue.Empty:
                    yield from drain(block_all=True)
                    continue
            else:
                with span("btia.serve.wait"):
                    item = q.get()
            if item is None:
                done_workers += 1
                continue
            if isinstance(item, _DecodeError):
                self.errors.append((item.idx, item.exc))
                continue
            if (
                self.pack_pairs
                and self.pair_budget
                and pending
                and sum(max(it[3], 0) for it in pending) + item[3] > self.pair_budget
            ):
                # Close early: the next request would overflow the fixed
                # pair capacity.
                close_partial()
                pending = []
                yield from drain()
            pending.append(item)
            if len(pending) == self.B:
                dispatch(pending)
                pending = []
                yield from drain()
        if pending:
            close_partial()
        yield from drain(block_all=True)
        self.wall_seconds = wall_base + time.perf_counter() - t0

    @property
    def pairs_per_second(self) -> float:
        return self.pairs_processed / max(self.wall_seconds, 1e-9)

    def latency_summary(self) -> dict:
        """Per-request enqueue->yield latency percentiles (ms) for the last
        serve() stream (window-bounded at 65536 requests)."""
        if not self.latencies:
            return {"n": 0}
        lat = np.sort(np.asarray(self.latencies, np.float64)) * 1e3
        pick = lambda p: float(lat[min(len(lat) - 1, int(p * len(lat)))])
        return {
            "n": len(lat),
            "p50_ms": pick(0.50),
            "p90_ms": pick(0.90),
            "p99_ms": pick(0.99),
            "mean_ms": float(lat.mean()),
            "max_ms": float(lat[-1]),
        }
