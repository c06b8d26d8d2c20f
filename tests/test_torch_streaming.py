"""The port's ``StreamingServer`` (``infer/streaming.py``): the behaviours of
``tests/test_infer.py::TestStreaming`` at a small ViT/BERT ``streaming_vitl``
override on the CPU (fp32, random weights from a seed), and the served
results against the JAX package's ``StreamingServer`` on the same weights
and requests.

Tolerances: two modes of the port (plain against dedup, packed pairs,
max-wait or an adaptive bucket) run the same fp32 arithmetic on batches of
other shapes, so logits agree to 2e-5 absolute and 1e-5 relative, as in the
reference's own tests. The port against the JAX server: 1e-4 on logits (the
goldens' tolerance, as in ``test_torch_predict.py``), real question rows
only (an all-PAD padding row attends differently in the two packages).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from btia_tpu.configs import get_config as jax_get_config
from btia_tpu.data.vocab import AnswerVocab as JaxAnswerVocab
from btia_tpu.data.wordpiece import WordPieceTokenizer as JaxWordPiece
from btia_tpu.infer.predict import Predictor as JaxPredictor
from btia_tpu.infer.streaming import StreamingServer as JaxStreamingServer
from btia_tpu.models.model import build_model as jax_build_model
from btia_tpu_torch import StreamingServer
from btia_tpu_torch.configs import get_config
from btia_tpu_torch.convert.from_jax import load_jax_params
from btia_tpu_torch.data.dicom import write_dicom
from btia_tpu_torch.data.vocab import AnswerVocab
from btia_tpu_torch.data.wordpiece import WordPieceTokenizer
from btia_tpu_torch.infer.predict import Predictor
from btia_tpu_torch.models.model import build_model

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
CORPUS = [
    "is it normal", "what organ is shown", "is it normal again", "q one", "q two",
    "q three", "q four", "is the lung normal", "which side is the lesion on",
] + [f"question number {i}" for i in range(6)]
ANSWERS = ["yes", "no", "lung", "left", "right", "brain", "liver", "kidney"]
EXACT = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _few_threads():
    """The suite runs several workers on one host; two threads each keep
    these CPU-bound tests from oversubscribing it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    """The JAX Predictor and the port's, on the same flax weights."""
    jcfg = jax_get_config("streaming_vitl", **SMALL)
    jm = jax_build_model(jcfg.model)
    key = jax.random.PRNGKey(2)
    variables = jax.jit(jm.init)(
        {"params": key, "dropout": key},
        jnp.zeros((1, 256, 256, 3), jnp.uint8), jnp.ones((1, 32), jnp.int32),
    )
    jp = JaxPredictor(jm, variables, JaxWordPiece.toy_vocab(CORPUS), JaxAnswerVocab(ANSWERS), jcfg)
    cfg = get_config("streaming_vitl", **SMALL)
    tm = build_model(cfg.model, device="cpu")
    load_jax_params(tm, variables["params"])
    tp = Predictor(tm, None, WordPieceTokenizer.toy_vocab(CORPUS), AnswerVocab(ANSWERS), cfg,
                   device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def predictor(models):
    return models[1]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """Five JPEG files of other sizes than the ingest size."""
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.RandomState(0)
    out = []
    for i in range(5):
        p = root / f"img{i}.jpg"
        Image.fromarray(rng.randint(0, 256, (64 + 8 * i, 80, 3)).astype(np.uint8)).save(p)
        out.append(str(p))
    return out


def _by_index(results):
    return sorted(results, key=lambda r: r[0])


def test_empty_stream(predictor):
    server = StreamingServer(predictor, image_batch=2, questions_per_image=2)
    assert list(server.serve(iter([]))) == []
    assert server.pairs_processed == 0


def test_excess_questions_truncated(predictor, paths):
    server = StreamingServer(predictor, image_batch=2, questions_per_image=2)
    [(_i, logits, n)] = list(server.serve(iter([(paths[0], ["a", "b", "c", "d"])])))
    assert n == 2  # capped at questions_per_image
    assert logits.shape[0] == 2


def test_abandoned_generator_keeps_sane_stats(predictor, paths):
    server = StreamingServer(predictor, image_batch=1, questions_per_image=1)
    gen = server.serve(iter([(p, ["q"]) for p in paths[:3]]))
    next(gen)  # consume one, abandon the rest
    gen.close()
    assert 0 < server.pairs_per_second < 1e6


def test_bad_request_skipped_not_deadlocked(predictor, paths):
    """A malformed image must not kill a decode thread without its sentinel
    (serve would deadlock): it is skipped and recorded by index."""
    server = StreamingServer(predictor, image_batch=2, questions_per_image=2)
    reqs = [(paths[0], ["q one"]), ("/nonexistent/broken.dcm", ["q two"]), (paths[0], ["q three"])]
    results = list(server.serve(iter(reqs)))
    assert sorted(i for i, _, _ in results) == [0, 2]
    [(bad_idx, exc)] = server.errors
    assert bad_idx == 1 and isinstance(exc, Exception)
    assert server.pairs_processed == 2


def test_corrupt_dicom_survived(predictor, paths, tmp_path):
    blob = write_dicom(None, (np.random.RandomState(1).rand(32, 32) * 4000).astype(np.uint16))
    corrupt = tmp_path / "corrupt.dcm"
    corrupt.write_bytes(blob[: len(blob) // 2])
    server = StreamingServer(predictor, image_batch=2, questions_per_image=2)
    results = list(server.serve(iter([(paths[0], ["q"]), (str(corrupt), ["q"]), (paths[0], ["q"])])))
    assert len(results) == 2
    assert [i for i, _ in server.errors] == [1]


def test_errors_reset_between_serve_calls(predictor, paths):
    server = StreamingServer(predictor, image_batch=1, questions_per_image=1)
    list(server.serve(iter([("/nonexistent/x.dcm", ["q"])])))
    assert len(server.errors) == 1
    assert len(list(server.serve(iter([(paths[0], ["q"])])))) == 1
    assert server.errors == []


def test_errors_reset_eagerly_at_serve_call(predictor, paths):
    """serve() resets errors before iteration starts."""
    server = StreamingServer(predictor, image_batch=1, questions_per_image=1)
    list(server.serve(iter([("/nonexistent/x.dcm", ["q"])])))
    assert len(server.errors) == 1
    gen = server.serve(iter([(paths[0], ["q"])]))
    assert server.errors == []  # cleared at call time, not at the first next()
    assert len(list(gen)) == 1


def test_max_wait_bounds_sparse_stream_latency(predictor, paths):
    """With max_wait_ms a partial batch is padded and shipped once the
    oldest request has waited that long; latency is tracked per request."""
    server = StreamingServer(predictor, image_batch=4, questions_per_image=2, max_wait_ms=150)
    list(server.serve(iter([(paths[0], ["w"])] * 4)))

    def slow_source():
        yield (paths[0], ["q one"])  # then the source stalls
        time.sleep(2.0)
        yield (paths[0], ["q two"])

    t0 = time.perf_counter()
    first_at, results = None, []
    for idx, _, n in server.serve(slow_source()):
        if first_at is None:
            first_at = time.perf_counter() - t0
        results.append((idx, n))
    # Without max_wait the first result waits >= 2 s for a second image.
    assert first_at is not None and first_at < 1.5, first_at
    assert sorted(i for i, _ in results) == [0, 1]
    summary = server.latency_summary()
    assert summary["n"] == 2
    assert summary["p50_ms"] > 0 and summary["p99_ms"] >= summary["p50_ms"]


def test_max_wait_results_match_plain(predictor, paths):
    qs = ["is the lung normal", "what organ is shown"]
    [(_, want, _)] = list(StreamingServer(predictor, image_batch=2, questions_per_image=2)
                          .serve(iter([(paths[0], qs)])))
    bounded = StreamingServer(predictor, image_batch=2, questions_per_image=2, max_wait_ms=50)
    [(_, got, _)] = list(bounded.serve(iter([(paths[0], qs)])))
    np.testing.assert_allclose(got, want, **EXACT)


def test_topk_mode_matches_full_logits(predictor, paths):
    reqs = lambda: iter([(paths[0], ["is it normal", "q two"])])
    [(_i, logits, n_full)] = list(
        StreamingServer(predictor, image_batch=1, questions_per_image=2).serve(reqs()))
    k = 3
    topk = StreamingServer(predictor, image_batch=1, questions_per_image=2, topk=k)
    [(_i, (vals, ids), n)] = list(topk.serve(reqs()))
    assert n == n_full == 2
    assert vals.shape == ids.shape == (2, k)
    limit = min(len(predictor.answer_vocab), predictor.cfg.model.answer_vocab_size)
    masked = logits.copy()
    masked[:, 0] = -np.inf
    masked[:, limit:] = -np.inf
    ref_ids = np.argsort(-masked, axis=-1)[:, :k]
    assert (ids != 0).all() and (ids < limit).all()
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(vals, np.take_along_axis(logits, ref_ids, -1), **EXACT)


def test_dedup_questions_matches_plain(predictor, paths):
    """Dedup encodes the unique question rows once and gathers: exact."""
    reqs = lambda: iter([(p, ["is it normal", "what organ is shown"]) for p in paths[:3]])
    ref = _by_index(StreamingServer(predictor, image_batch=2, questions_per_image=2).serve(reqs()))
    dd = StreamingServer(predictor, image_batch=2, questions_per_image=2, dedup_questions=True)
    got = _by_index(dd.serve(reqs()))
    assert len(ref) == len(got) == 3
    for (ia, la, na), (ib, lb, nb) in zip(ref, got):
        assert na == nb and ia == ib
        np.testing.assert_allclose(la, lb, **EXACT)


def test_adaptive_q_matches_fixed_large_bucket(predictor, paths):
    """A batch whose largest request exceeds the base Q bucket runs the
    next power-of-two-of-Q launch and matches a server fixed at that Q."""
    qs = ["q one", "q two", "q three", "q four"]
    reqs = lambda: iter([(p, qs) for p in paths[:2]])
    ref = _by_index(StreamingServer(predictor, image_batch=2, questions_per_image=4).serve(reqs()))
    ada = StreamingServer(predictor, image_batch=2, questions_per_image=2, adaptive_q=True, q_max=4)
    assert ada.q_buckets == [2, 4]
    got = _by_index(ada.serve(reqs()))
    assert 4 in ada._fwd_cache  # the big bucket actually ran
    for (ia, la, na), (ib, lb, nb) in zip(ref, got):
        assert ia == ib and na == nb == 4
        np.testing.assert_allclose(la[:na], lb[:nb], **EXACT)


def test_adaptive_q_small_requests_stay_on_base_program(predictor, paths):
    server = StreamingServer(predictor, image_batch=2, questions_per_image=2, adaptive_q=True, q_max=8)
    assert len(list(server.serve(iter([(p, ["a", "b"]) for p in paths[:2]])))) == 2
    assert list(server._fwd_cache) == [2]


def test_adaptive_q_dedup_matches_plain(predictor, paths):
    qs = ["is it normal", "what organ is shown", "is it normal again"]
    reqs = lambda: iter([(p, qs) for p in paths[:2]])
    ref = _by_index(StreamingServer(predictor, image_batch=2, questions_per_image=4).serve(reqs()))
    ada = StreamingServer(predictor, image_batch=2, questions_per_image=2, adaptive_q=True, q_max=4,
                          dedup_questions=True)
    got = _by_index(ada.serve(reqs()))
    for (ia, la, na), (ib, lb, nb) in zip(ref, got):
        assert ia == ib and na == nb == 3
        np.testing.assert_allclose(la[:na], lb[:nb], **EXACT)


def test_pack_pairs_uneven_counts_match_plain(predictor, paths):
    reqs = lambda: iter([
        (paths[0], ["is it normal"]),
        (paths[1], ["is it normal", "what organ is shown", "q three"]),
        (paths[2], ["what organ is shown"]),
    ])
    ref = list(StreamingServer(predictor, image_batch=2, questions_per_image=4, decode_threads=1)
               .serve(reqs()))
    packed = StreamingServer(predictor, image_batch=2, questions_per_image=4, pack_pairs=True,
                             decode_threads=1)
    got = list(packed.serve(reqs()))
    assert [n for _, _, n in got] == [n for _, _, n in ref] == [1, 3, 1]
    assert [i for i, _, _ in got] == [i for i, _, _ in ref] == [0, 1, 2]
    assert packed.pairs_processed == 5
    for (_, la, na), (_, lb, nb) in zip(ref, got):
        assert lb.shape[0] == nb  # exactly n rows, no padding
        np.testing.assert_allclose(la[:na], lb, **EXACT)


def test_pair_budget_early_close_matches_plain(predictor, paths):
    qsets = [["a"], ["a", "b", "c"], ["b", "c"], ["a", "c"]]
    reqs = lambda: iter(list(zip(paths[:4], qsets)))
    ref = list(StreamingServer(predictor, image_batch=2, questions_per_image=4, decode_threads=1)
               .serve(reqs()))
    budget = StreamingServer(predictor, image_batch=2, questions_per_image=4, pack_pairs=True,
                             pair_budget=4, decode_threads=1)
    got = list(budget.serve(reqs()))
    assert [n for _, _, n in got] == [n for _, _, n in ref] == [1, 3, 2, 2]
    assert [i for i, _, _ in got] == [0, 1, 2, 3]
    for (_, la, na), (_, lb, nb) in zip(ref, got):
        np.testing.assert_allclose(la[:na], lb, **EXACT)


def test_pack_pairs_randomized_accounting(predictor, paths):
    """Random uneven question counts (zero included), a corrupt request,
    threaded decode, early closes: every good request is answered exactly
    once with exactly its n rows, and pairs_processed is the true count."""
    rnd = np.random.RandomState(7)
    reqs, expected = [], {}
    for i in range(17):
        if i == 5:
            reqs.append(("/nonexistent/broken.dcm", ["q"]))
            continue
        n = int(rnd.randint(0, 5))  # 0..4 questions, capped at Q = 3 below
        reqs.append((paths[i % 4], [f"question number {rnd.randint(0, 6)}" for _ in range(n)]))
        expected[i] = min(n, 3)
    server = StreamingServer(predictor, image_batch=2, questions_per_image=3, pack_pairs=True,
                             pair_budget=4, decode_threads=2)
    got = {}
    for idx, out, n in server.serve(iter(reqs)):
        assert idx not in got, "request answered twice"
        got[idx] = (out, n)
    assert set(got) == set(expected)
    for idx, (out, n) in got.items():
        assert n == expected[idx] and out.shape[0] == n
    assert server.pairs_processed == sum(expected.values())
    [(bad_idx, _)] = server.errors
    assert bad_idx == 5


def test_serve_order_and_shapes(predictor, paths):
    server = StreamingServer(predictor, image_batch=2, questions_per_image=4, decode_threads=2)
    results = list(server.serve(iter([(p, ["q one", "q two", "q three"]) for p in paths])))
    assert sorted(i for i, _, _ in results) == [0, 1, 2, 3, 4]
    for _, logits, n in results:
        assert n == 3 and logits.shape == (4, predictor.cfg.model.answer_vocab_size)
    assert server.pairs_processed == 15
    assert server.pairs_per_second > 0


def test_warmup_restores_the_counters(predictor, paths):
    server = StreamingServer(predictor, image_batch=2, questions_per_image=2)
    list(server.serve(iter([(paths[0], ["q one"])])))
    before = (server.pairs_processed, server.wall_seconds)
    assert server.warmup() > 0
    assert (server.pairs_processed, server.wall_seconds) == before
    assert server.latency_summary() == {"n": 0}


# ---------------------------------------------------------------------------
# The port's server against the JAX package's
# ---------------------------------------------------------------------------


_MODES = {
    "plain": {},
    "dedup": {"dedup_questions": True},
    "pack_pairs": {"pack_pairs": True, "pair_budget": 4},
    "topk": {"topk": 3},
}


@pytest.mark.parametrize("mode", list(_MODES))
def test_matches_the_jax_server(models, paths, mode):
    jp, tp = models
    img = np.random.RandomState(3).randint(0, 256, (256, 256, 3)).astype(np.uint8)
    reqs = [(paths[0], CORPUS[:3]), (img, CORPUS[3:4]), (paths[1], CORPUS[4:8]),
            (paths[2], CORPUS[8:10])]
    kw = dict(image_batch=2, questions_per_image=4, **_MODES[mode])
    ref = _by_index(JaxStreamingServer(jp, **kw).serve(iter(reqs)))
    got = _by_index(StreamingServer(tp, **kw).serve(iter(reqs)))
    assert [(i, n) for i, _, n in got] == [(i, n) for i, _, n in ref] == [(0, 3), (1, 1), (2, 4), (3, 2)]
    full = {i: jp.predict_batch(reqs[i][0], reqs[i][1]) for i, _, _ in ref}
    for (i, a, n), (_, b, _) in zip(got, ref):
        if mode == "topk":
            (va, ia), (vb, _) = a, b
            np.testing.assert_allclose(va[:n], np.asarray(vb)[:n], atol=1e-4, rtol=0)
            # The port's answer ids carry the JAX model's values for them.
            np.testing.assert_allclose(np.take_along_axis(full[i], ia[:n], -1), va[:n], atol=1e-4, rtol=0)
        else:
            np.testing.assert_allclose(a[:n], np.asarray(b)[:n], atol=1e-4, rtol=0)
