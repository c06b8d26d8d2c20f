"""The one traffic generator: deterministic in the seed, the mixes' stated
distributions, every seed the same work in another order."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import traffic as T

MIXES = Path(__file__).resolve().parent.parent / "traffic"
SEED = 2**31 + 12345


def mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


def test_serve_requests_are_a_function_of_the_seed():
    a, b = T.ServeTraffic(mix("fanout-backlog"), SEED, 5), T.ServeTraffic(mix("fanout-backlog"), SEED, 5)
    c = T.ServeTraffic(mix("fanout-backlog"), SEED + 1, 5)
    for i in (0, 7, 8191, 9000):
        ia, qa = a.request(i)
        ib, qb = b.request(i)
        assert np.array_equal(ia, ib) and qa == qb
    assert a.request(3)[1] != c.request(3)[1]
    assert not np.array_equal(a.images, c.images)


def test_fanout_mix_sends_128_questions_of_a_few_thousand():
    t = T.ServeTraffic(mix("fanout-backlog"), SEED, 5)
    assert len(t.pool) == 3000 and len(set(t.pool)) == 3000
    assert all(len(t.request(i)[1]) == 128 for i in range(50))
    img = t.request(0)[0]
    assert img.shape == (336, 336, 3) and img.dtype == np.uint8


def test_open_mix_counts_and_arrivals():
    m = mix("mixed-open")
    t = T.ServeTraffic(m, SEED, 10.0)
    assert t.n == round(m["rate_rps"] * 10.0)
    assert t.counts.min() == 1 and t.counts.max() == 64
    assert abs(t.counts.mean() - 11.2) < 0.3
    assert t.due[0] == 0.0 and np.all(np.diff(t.due) > 0) and t.due[-1] < 10.0
    # every seed: the same counts and gaps, in another order
    u = T.ServeTraffic(m, SEED + 5, 10.0)
    assert sorted(t.counts) == sorted(u.counts) and not np.array_equal(t.counts, u.counts)
    gaps = lambda x: np.sort(np.append(np.diff(x.due), 10.0 - x.due[-1]))
    assert np.allclose(gaps(t), gaps(u))


def test_power_law_mean():
    assert T.count_mean({"kind": "power", "min": 1, "max": 64, "alpha": 1.13}) == pytest.approx(11.17, abs=0.01)


def test_vocabulary_splits_long_words():
    v = T.wordpiece_vocab(["is there pneumothorax in the lung?"])
    assert "pneumothorax" not in v and "pneu" in v and "##mothorax" in v and "lung" in v


def test_corpus_is_a_function_of_the_seed(tmp_path):
    m = mix("vqa-med-train")
    m["corpus"].update(train_images=6, test_images=2, answers=40)
    a = T.write_corpus(m, SEED, tmp_path / "a")
    b = T.write_corpus(m, SEED, tmp_path / "b")
    assert [s[1:] for s in a["samples"]] == [s[1:] for s in b["samples"]]
    assert len(a["samples"]) == 4 * 6 and len(a["answers"]) == 40
    for (pa, _, _), (pb, _, _) in zip(a["samples"], b["samples"]):
        assert Path(pa).read_bytes() == Path(pb).read_bytes()
    lines = (tmp_path / "a" / "Train" / "QAPairsByCategory" / "C1_Modality_train.txt").read_text().splitlines()
    assert len(lines) == 6 and all(len(line.split("|")) == 3 for line in lines)


def test_bursts_shape_the_arrivals_and_keep_the_mean_rate():
    m = dict(mix("mixed-open"), rate_rps=100.0, phases=[[2.0, 3.0], [8.0, 0.5]])
    t = T.ServeTraffic(m, SEED, 20.0)
    assert t.n == 2000 and np.all(np.diff(t.due) >= 0) and t.due[-1] < 20.0
    phase = (t.due % 10.0) < 2.0
    # the on phase: 2 s at 3x, the off phase 8 s at 0.5x; 6 : 4 of the arrivals
    assert abs(phase.mean() - 0.6) < 0.01
    u = T.ServeTraffic(m, SEED + 1, 20.0)
    assert not np.array_equal(t.due, u.due) and abs(((u.due % 10.0) < 2.0).mean() - 0.6) < 0.01


def test_without_phases_the_arrivals_are_as_before():
    m = mix("mixed-open")
    rng = T._rng(SEED, 3)
    n = 500
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = rng.permutation(gaps * (5.0 / gaps.sum()))
    assert np.allclose(T.arrival_times(m, n, 5.0, T._rng(SEED, 3)), np.concatenate([[0.0], np.cumsum(gaps)[:-1]]))


def test_choice_counts_and_zipf_picks():
    m = mix("fanout-backlog")
    m["questions"] = {"pool": 200, "per_request": {"kind": "choice", "values": [16, 64], "weights": [3, 1]},
                      "pick": {"kind": "zipf", "s": 1.1}}
    t = T.ServeTraffic(m, SEED, 5)
    assert sorted(set(t.counts)) == [16, 64] and abs((t.counts == 16).mean() - 0.75) < 1e-3
    assert T.count_mean(m["questions"]["per_request"]) == pytest.approx(28.0)
    qs = [q for i in range(200) for q in t.request(i)[1]]
    top = max(set(qs), key=qs.count)
    assert qs.count(top) > 10 * len(qs) / 200  # the head of the Zipf law repeats


def test_jpeg_payloads_decode_to_the_images():
    m = mix("fanout-backlog")
    m["images"] = dict(m["images"], distinct=4, format="jpeg", quality=95)
    t = T.ServeTraffic(m, SEED, 5)
    payload, _ = t.request(1)
    assert isinstance(payload, bytes) and payload[:2] == b"\xff\xd8"
    px = T.decode(payload)
    assert px.shape == (336, 336, 3) and px.dtype == np.uint8
    assert np.abs(px.astype(int) - t.images[1].astype(int)).mean() < 12


def test_the_corpus_is_written_once_for_a_seed(tmp_path):
    m = mix("vqa-med-train")
    m["corpus"].update(train_images=6, test_images=2, answers=40)
    a = T.cached_corpus(m, SEED, tmp_path)
    first = Path(a["samples"][0][0])
    stamp = first.stat().st_mtime_ns
    b = T.cached_corpus(m, SEED, tmp_path)
    assert a == b and first.stat().st_mtime_ns == stamp
    assert T.write_corpus(m, SEED, tmp_path / "plain")["samples"][0][1:] == a["samples"][0][1:]
    c = T.cached_corpus(m, SEED + 1, tmp_path)
    assert Path(c["samples"][0][0]).parents[2] != first.parents[2]
    # a folder left without its mark (a run cut while writing) is written again
    (first.parents[2] / "complete").unlink()
    first.write_bytes(b"")
    T.cached_corpus(m, SEED, tmp_path)
    assert first.stat().st_size > 0
