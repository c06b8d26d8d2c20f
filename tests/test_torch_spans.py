"""The port's spans (``utils/profiling.py::span``) in the serving loop, the
data pipeline and the train step, on the CPU: with no profiler active they
open no range; under ``torch.profiler`` every span lands in the Chrome
trace on the thread that runs the loop and on no other (not the decode
workers, not the prefetch worker), each dispatch with its drain and the
train steps' keys consecutive; a span open while the profiler starts or
stops raises nothing."""

import json
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from btia_tpu_torch import StreamingServer
from btia_tpu_torch.configs import get_config
from btia_tpu_torch.data.synthetic import generate_synthetic_vqa_med
from btia_tpu_torch.data.vocab import AnswerVocab
from btia_tpu_torch.data.wordpiece import WordPieceTokenizer
from btia_tpu_torch.infer.predict import Predictor
from btia_tpu_torch.models.model import build_model
from btia_tpu_torch.train import steps as S
from btia_tpu_torch.train.trainer import Trainer, batch_to_device, chunk_to_device
from btia_tpu_torch.utils import profiling
from btia_tpu_torch.utils.profiling import span

SMALL = {
    "model.image_encoder": "vit_test",
    "model.bert_layers": 2,
    "model.bert_hidden": 128,
    "model.bert_heads": 2,
    "model.hidden_dim": 128,
    "model.num_heads": 2,
    "model.btia_layers": 1,
    "model.answer_vocab_size": 64,
    "model.num_answer_queries": 8,
    "model.mixed_precision": False,
}
CORPUS = ["is it normal", "what organ is shown", "q one", "q two", "is the lung normal"]
SERVE_MODES = {
    "plain": dict(topk=2),
    "dedup": dict(dedup_questions=True),
    "packed": dict(pack_pairs=True, pair_budget=4, topk=2),
    "max_wait": dict(max_wait_ms=20, topk=2),
}


@pytest.fixture(autouse=True)
def _few_threads():
    """The suite runs several workers on one host; two threads each keep
    these CPU-bound tests from oversubscribing it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def opened(monkeypatch):
    """The names of the ranges opened through the profiler's ops."""
    names = []
    enter = torch.ops.profiler._record_function_enter_new

    def counting(name, args=None):
        names.append(name)
        return enter(name, args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", counting)
    return names


@pytest.fixture(scope="module")
def predictor():
    cfg = get_config("streaming_vitl", **SMALL)
    model = build_model(cfg.model, device="cpu", seed=1)
    return Predictor(model, None, WordPieceTokenizer.toy_vocab(CORPUS), AnswerVocab(["yes", "no", "lung"]), cfg,
                     device="cpu")


def _requests(predictor, n=7):
    img = np.random.RandomState(0).randint(0, 256, (predictor.ingest_size,) * 2 + (3,)).astype(np.uint8)
    return [(img, CORPUS[: 1 + i % 3]) for i in range(n)]


@pytest.fixture(scope="module")
def med_cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("vqa_med")
    generate_synthetic_vqa_med(root, num_images=8)  # 16 pairs per split
    return get_config("vqa_med_full", **dict(SMALL, **{
        "model.num_answer_queries": 0, "model.dropout": 0.1, "data.data_dir": str(root), "data.num_workers": 1,
        "train.batch_size": 4, "train.eval_batch_size": 8, "train.epochs": 1, "train.log_every": 1,
        "train.steps_per_call": 2, "train.warmup_steps": 2,
    }))


def _trace_events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _program_ranges(events):
    """The btia. ranges of a trace, each (name, thread id), in start order."""
    ours = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("btia.")]
    return [(e["name"], e["tid"]) for e in sorted(ours, key=lambda e: e["ts"])]


class _Unformattable:
    def __format__(self, spec):
        raise AssertionError("a span's key was formatted with no profiler active")

    __str__ = __repr__ = __format__


def test_span_without_a_profiler_is_one_flag_read(opened):
    assert not torch.autograd.profiler._is_profiler_enabled
    with span("btia.test", _Unformattable()) as inside:
        assert inside is None
    assert span("btia.test") is span("btia.other", 3) is profiling._OFF
    assert opened == []


@pytest.mark.parametrize("mode", sorted(SERVE_MODES))
def test_serving_loop_opens_no_range_without_a_profiler(predictor, opened, mode):
    server = StreamingServer(predictor, image_batch=2, questions_per_image=3, **SERVE_MODES[mode])
    out = list(server.serve(iter(_requests(predictor))))
    assert len(out) == 7 and server.dispatches >= 4
    assert opened == []


@pytest.mark.parametrize("scan", [False, True])
def test_train_step_opens_no_program_range_without_a_profiler(opened, scan):
    cfg = get_config("vqa_med_full", **dict(SMALL, **{"model.num_answer_queries": 0, "train.warmup_steps": 2}))
    model = build_model(cfg.model, device="cpu", seed=1)
    state = S.create_state(model, cfg, steps_per_epoch=4)
    rng = np.random.RandomState(3)
    K = 2 if scan else 1
    chunk = {"images": torch.from_numpy(rng.randint(0, 256, (K, 2, 256, 256, 3)).astype(np.uint8)),
             "question_ids": torch.from_numpy(rng.randint(1, 50, (K, 2, 32))),
             "answer_ids": torch.from_numpy(rng.randint(0, 64, (K, 2))), "valid": torch.ones(K, 2, dtype=torch.bool)}
    if scan:
        state, m = S.make_train_step_scan(model, cfg)(state, chunk)
    else:
        state, m = S.make_train_step(model, cfg)(state, {k: v[0] for k, v in chunk.items()})
    assert state.step == K and torch.isfinite(m["loss"]).all()
    # torch's own optimizer opens its ranges whatever the profiler; the
    # program opens none
    assert [n for n in opened if n.startswith("btia.")] == []


@pytest.mark.parametrize("mode", ["plain", "max_wait"])
def test_serve_spans_land_on_the_serving_thread(predictor, tmp_path, mode):
    server = StreamingServer(predictor, image_batch=2, questions_per_image=3, decode_threads=2,
                             **SERVE_MODES[mode])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = list(server.serve(iter(_requests(predictor))))
    assert len(out) == 7
    ranges = _program_ranges(_trace_events(prof, tmp_path))
    assert {tid for _, tid in ranges} == {threading.get_native_id()}
    names = Counter(n.split("|")[0] for n, _ in ranges)
    assert names["btia.serve.deliver"] == 7 and names["btia.serve.wait"] >= 7
    launches = [int(n.split("|")[1]) for n, _ in ranges if n.startswith("btia.serve.dispatch|")]
    drains = [int(n.split("|")[1]) for n, _ in ranges if n.startswith("btia.serve.drain|")]
    # seven requests in batches of two: four launches, or more where the
    # max-wait ships a partial one
    assert launches == list(range(1, server.dispatches + 1)) and len(launches) >= 4
    assert sorted(drains) == launches


def test_train_and_data_spans_land_on_the_calling_thread(med_cfg, tmp_path):
    trainer = Trainer(med_cfg, tmp_path / "run", device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        it = trainer.data.iterator("train", seed=0)
        chunk = [next(it), next(it)]
        trainer.train_step_scan(trainer.state, chunk_to_device(chunk, trainer.device))
        for b in it:
            trainer.train_step(trainer.state, batch_to_device(b, trainer.device))
    assert trainer.state.step == 4
    ranges = _program_ranges(_trace_events(prof, tmp_path))
    assert {tid for _, tid in ranges} == {threading.get_native_id()}  # not the prefetch worker's
    names = [n for n, _ in ranges]
    assert names.count("btia.data.wait") == 5  # four batches and the end of the epoch
    assert names.count("btia.train.to_device") == 3  # one chunk, two batches
    steps = [n for n in names if n.startswith("btia.train.") and "|" in n]
    assert steps == [f"btia.train.{part}|{k}" for k in range(4) for part in ("forward", "backward", "optimizer")]


def test_data_spans_without_prefetch(med_cfg, tmp_path):
    trainer = Trainer(med_cfg, tmp_path / "run", device="cpu")
    d = trainer.data
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        from btia_tpu_torch.data.pipeline import make_iterator

        got = list(make_iterator(d.train, d.text_encoder, d.answer_vocab, d.cache, 4, med_cfg.model.max_question_len,
                                 prefetch=0))
    assert len(got) == 4
    names = [n for n, _ in _program_ranges(_trace_events(prof, tmp_path))]
    assert names == ["btia.data.wait"] * 5


def test_a_span_open_across_the_profilers_start_and_stop(predictor, tmp_path):
    """As the benchmark traces: the profiler starts while the serving
    generator is suspended inside a span (opened with no profiler) and
    stops while it is suspended inside another (opened under it)."""
    server = StreamingServer(predictor, image_batch=2, questions_per_image=3, topk=2)
    prof = profile(activities=[ProfilerActivity.CPU])
    got = []
    for i, (idx, res, n) in enumerate(server.serve(iter(_requests(predictor)))):
        got.append(idx)
        if i == 1:
            prof.__enter__()
        elif i == 4:
            prof.__exit__(None, None, None)
    assert sorted(got) == list(range(7))
    ranges = _program_ranges(_trace_events(prof, tmp_path))
    assert any(n.startswith("btia.serve.dispatch|") for n, _ in ranges)

    def gen():
        with span("btia.test.outer", 1):
            yield 1
        yield 2

    g = gen()
    with profile(activities=[ProfilerActivity.CPU]):
        assert next(g) == 1  # opened under the profiler, closed after it stopped
    assert list(g) == [2]
