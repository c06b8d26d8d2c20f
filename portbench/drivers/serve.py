"""The serve driver: ``StreamingServer.serve`` over a ``Predictor`` of the
program's ``BTIAADNet``, fed by the mix's requests (images as uint8 arrays
or JPEG bytes, question strings), closed loop with a standing backlog or
open loop on a schedule.

Set-up: the kernel library (from its build directory in the checkout), the
weights made on the card from the seed and loaded into the program's model,
the WordPiece vocabulary file and the answer list, the server, and a
warm-up pass of the mix's launch shapes. Window: ``--seconds`` of serving.
Closed loop: the source hands out requests as fast as the server takes
them until the window ends; ``pairs_per_s`` counts the pairs whose top-k
answers reached the host inside it. Open loop: request i is handed out at
its due time (or at once, when the source runs late); its latency runs
from that due time to the yield of its answers; a request that failed or
never came counts as missing the limit. With ``--trace 1`` the profiler
runs over the window's last seconds (``trace.trace_span``); the model FLOPs
rate (``step_mfu.serve``) is taken over the span before it, which no
profiler start or stop falls into.

After the window, once memory is read and the program is freed: the
reference recomputes a seeded sample of the answered requests, the
longest among them, from the images and question strings, and the
served top-k is judged against it.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np

from portbench import bench, flops, traffic
from portbench.reference import model as R
from portbench.reference.wordpiece import WordPiece


def nearest_rank(values, q: float) -> float:
    """The q-th percentile by nearest rank (inf counts as a value)."""
    v = np.sort(np.asarray(values, np.float64))
    return float(v[max(0, math.ceil(q / 100.0 * len(v)) - 1)])


class SlotCounter:
    """Counts the pair slots each launch carries: wraps the Predictor's
    forward factories that the server fetches (B x Q for the fan-out, P for
    the packed pair list)."""

    def __init__(self, pred):
        self.slots = 0
        self.launches = 0
        fan, pairs = pred._fanout_forward, pred._pairs_forward

        def counted(fn, n):
            def call(*a):
                self.slots += n
                self.launches += 1
                return fn(*a)
            return call

        pred._fanout_forward = lambda B, Q: counted(fan(B, Q), B * Q)
        pred._pairs_forward = lambda B, U, P: counted(pairs(B, U, P), P)


def _fault_answers(server, fault: str) -> None:
    """Plant a fault where the answers are produced (tests only):
    ``alter_answer`` rolls each question's top-k ids by one, so its top
    answer is served fifth and its fifth first; ``ascending_topk`` serves
    the top-k lowest first; ``partial_topk`` takes the top-k over the upper
    half of the real answers only, with the right values at the ids it
    serves; ``one_slot`` serves the requests of a launch's first image slot
    the answers of its second."""
    import torch

    from btia_tpu_torch.ops.answers import real_limit

    orig = server._with_topk
    limit = real_limit(len(server.p.answer_vocab), server.p.cfg.model.answer_vocab_size)

    def planted(base):
        if fault == "partial_topk":
            def masked(*a):
                x = base(*a).clone()
                x[..., 1 : 1 + (limit - 1) // 2] = -torch.inf
                return x
            return orig(masked)
        f = orig(base)

        def call(*a):
            vals, ids = f(*a)
            if fault == "alter_answer":
                return vals, ids.roll(1, dims=-1)
            if fault == "ascending_topk":
                return vals.flip(-1), ids.flip(-1)
            if fault == "one_slot":
                return torch.cat([vals[1:2], vals[1:]]), torch.cat([ids[1:2], ids[1:]])
            raise KeyError(fault)
        return call

    server._with_topk = planted
    server._fwd_cache.clear()
    server._ifwd_cache.clear()


def run(r: bench.Run) -> None:
    import torch

    from btia_tpu_torch import Predictor, StreamingServer
    from btia_tpu_torch.data.vocab import AnswerVocab
    from btia_tpu_torch.data.wordpiece import WordPieceTokenizer
    from btia_tpu_torch.models.model import BTIAADNet
    from btia_tpu_torch.ops import _native

    cfg = r.cfg
    if r.variant == "control":  # the program's own lower-precision path
        cfg = cfg.override(**{"model.int8_ffn": True})
    m = bench.model_dict(cfg)
    mix, dev = r.mix, r.device
    if dev == "cuda":
        _native.lib()
    tr = traffic.ServeTraffic(mix, r.seed, r.seconds)
    vocab_file = traffic.write_vocab(r.scratch / "vocab.txt", tr.pool)
    answers = traffic.answer_list(int(mix["answers"]))
    model = BTIAADNet(cfg.model, device=dev)
    model.load_state_dict(R.make_weights(m, r.seed, dev), strict=True)
    pred = Predictor(model, None, WordPieceTokenizer.from_vocab_file(vocab_file), AnswerVocab(answers),
                     cfg, device=dev)
    slots = SlotCounter(pred)
    server = StreamingServer(pred, **mix["server"])
    if r.fault is not None:
        _fault_answers(server, r.fault)
    for _ in server.serve(tr.warmup_requests(int(mix["warmup_requests"]))):
        pass
    if dev == "cuda":
        torch.cuda.synchronize()
    slots.slots = slots.launches = 0

    tracer = None
    if r.trace:
        from portbench.trace import Tracer, trace_span

        tracer = Tracer(r.scratch / "trace.json", model, hook_layers=True).prepare()
    done, results, pulled = {}, {}, [0]
    late = []
    t0 = time.perf_counter()
    r.setup_s = t0 - r.t_start
    t_end = t0 + r.seconds
    t_trace = t_end - trace_span(r.seconds) if tracer is not None else math.inf
    t_mfu = None  # the end of the span the FLOPs rate is taken over

    def source():
        i = 0
        while True:
            if tr.open:
                if i >= tr.n:
                    return
                wait = t0 + tr.due[i] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                else:
                    late.append(-wait)
            elif time.perf_counter() >= t_end:
                return
            pulled[0] = i + 1
            yield tr.request(i)
            i += 1

    for idx, res, n in server.serve(source()):
        t = time.perf_counter()
        done[idx] = t
        results[idx] = (res[0].copy(), res[1].copy(), n)
        if t_mfu is None and t >= t_trace:
            t_mfu = t
            tracer.start()
        elif tracer is not None and tracer.running and t >= t_end:
            tracer.stop()
    t_drained = time.perf_counter()
    if dev == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated()
    errors = list(server.errors)

    # ---- what the window did -------------------------------------------
    attempted = tr.n if tr.open else pulled[0]
    answered = [i for i in range(attempted) if i in done]
    r.attempted, r.failed = attempted, attempted - len(answered)
    in_window = [i for i in answered if done[i] <= t_end]
    pairs_in = sum(results[i][2] for i in in_window)
    counts = {i: len(tr.request(i)[1]) for i in range(attempted)}
    r.e2e["pairs_per_s"] = pairs_in / r.seconds
    if tr.open:
        lat = [(done[i] - (t0 + tr.due[i])) * 1e3 if i in done else math.inf for i in range(attempted)]
        r.e2e["latency_p95_ms"] = nearest_rank(lat, 95)
        r.ctx["latency_p50_ms"] = nearest_rank(lat, 50)
        r.info["generator_late_ms_max"] = 1e3 * max(late, default=0.0)
        r.info["generator_late_ms_end"] = 1e3 * (late[-1] if late and pulled[0] == tr.n else 0.0)
        r.info["answered_share"] = len(answered) / max(attempted, 1)
    real_pairs = sum(results[i][2] for i in answered)
    r.ctx.update(
        kind="serve", seconds=r.seconds, pairs_in_window=pairs_in, real_pairs=real_pairs,
        slot_pairs=slots.slots, launches=slots.launches, model=m, peak_flops=flops.PEAK_BF16_FLOPS)
    if t_mfu is not None:  # the answers completed before the profiler started
        r.ctx.update(mfu_seconds=t_mfu - t0,
                     mfu_flops=sum(flops.request_flops(m, results[i][2]) for i in answered if done[i] <= t_mfu))
    r.info.update(attempted=attempted, answered=len(answered), errors=len(errors),
                  drain_s=round(t_drained - t_end, 3), pairs_in_window=pairs_in, launches=slots.launches,
                  slot_pairs=slots.slots, real_pairs=real_pairs)
    if tracer is not None:
        t_read = time.perf_counter()
        r.ctx["trace"] = tracer.load()
        r.info.update(trace_start_s=round(tracer.start_s, 3), trace_read_s=round(time.perf_counter() - t_read, 2),
                      **r.ctx["trace"].link_stats())

    # ---- correctness: the reference on a sample of the answered requests
    limit = min(len(answers) + 1, m["answer_vocab_size"])
    del server, pred, model, slots
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    judge(r, tr, results, answered, counts, limit, vocab_file, m, dev)
    r.info["judge_s"] = round(time.perf_counter() - t_judge, 2)


def judge(r: bench.Run, tr, results, answered, counts, limit, vocab_file, m, dev) -> None:
    import torch

    lim = r.limits
    rng = np.random.default_rng([int(r.seed) & (2**64 - 1), 11])
    n_sample = int(lim["sample_requests"])
    longest = sorted(answered, key=lambda i: (-counts[i], i))[: max(1, n_sample // 4)]
    rest = [i for i in answered if i not in set(longest)]
    pick = longest + list(rng.choice(rest, size=min(len(rest), n_sample - len(longest)), replace=False))
    wp = WordPiece(vocab_file)
    L = m["max_question_len"]
    P = R.make_weights(m, r.seed, dev)
    gaps, worst = [], []
    bad = 0
    with R.exact_f32():
        for i in pick:
            payload, qs = tr.request(int(i))
            vals, ids, n = results[i]
            vals, ids = np.asarray(vals, np.float64), np.asarray(ids)
            if (n != len(qs) or len(vals) != n or ((ids < 1) | (ids >= limit)).any()
                    or any(len(set(row)) != len(row) for row in ids) or (np.diff(vals, axis=-1) > 0).any()):
                bad += 1  # a row count, an id, a repeat or an order that is wrong
                continue
            tok = torch.tensor([wp.encode(q, L) for q in qs], device=dev)
            image = torch.from_numpy(traffic.decode(payload)).to(dev)
            ref = R.serve_logits(image, tok, P, m).double().cpu().numpy()
            real = ref[:, 1:limit]
            sd = real.std(-1, keepdims=True)
            got = np.take_along_axis(ref, ids, -1)
            k = ids.shape[-1]
            # rank j's gap: how far the reference's value at the served
            # j-th answer lies below the reference's own j-th best
            best = -np.sort(-real, axis=-1)[:, :k]
            gaps.append(((best - got) / sd).max(-1))
            worst.append(100.0 * float((np.abs(vals - got) / sd > lim["value_off_sd"]).mean()))
    gaps = np.concatenate(gaps) if gaps else np.zeros(0)
    r.info.update(checked_requests=len(pick), checked_pairs=len(gaps),
                  request_off_pct_median=float(np.median(worst)) if worst else None)
    r.check("unanswered", float(r.failed), 0.0)
    r.check("bad_answers", float(bad), 0.0)
    # a sample with nothing left to compare fails: inf is over every limit
    r.check("worst_request_off_pct", max(worst) if worst else math.inf, lim["worst_request_off_pct"])
    r.check("topk_gap_sd", float(gaps.max()) if gaps.size else math.inf, lim["topk_gap_sd"])
