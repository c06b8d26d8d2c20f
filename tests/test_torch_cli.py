"""The port's command line (``python -m btia_tpu_torch.cli``) on the CPU,
mirroring ``tests/test_cli.py``: override parsing, train -> eval -> predict
-> serve on ``tiny_test`` over the synthetic corpus, the convert round trip
from a reference-layout checkpoint (``btia_tpu.convert.torch_ref``), and the
JSON contract of ``python -m btia_tpu_torch.bench``, as
``tests/test_bench_script.py`` holds the root ``bench.py``. Every command
runs with ``--device cpu``."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from btia_tpu.configs import get_config as jax_get_config
from btia_tpu.convert.torch_ref import build_torch_model
from btia_tpu.ops.answers import topn_real_np as jax_topn_real_np
from btia_tpu_torch.cli import _parse_overrides, main
from btia_tpu_torch.configs import get_config
from btia_tpu_torch.convert.convert import convert_state_dict
from btia_tpu_torch.data.synthetic import generate_synthetic_dataset
from btia_tpu_torch.data.vocab import AnswerVocab, WordVocab
from btia_tpu_torch.infer.predict import Predictor
from btia_tpu_torch.models.model import build_model
from btia_tpu_torch.ops.answers import topn_real_np

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("clidata")
    generate_synthetic_dataset(root)
    workdir = tmp_path_factory.mktemp("clirun")
    return root, workdir


def _train(root, workdir):
    main(["train", "--config", "tiny_test", "--workdir", str(workdir), "--set", "data.dataset=vqa_rad",
          "--set", f"data.data_dir={root}", "--set", "train.epochs=1", *CPU])


class TestOverrides:
    def test_parse_types(self):
        out = _parse_overrides(["train.lr=0.01", "model.head=ad", "train.epochs=3"])
        assert out == {"train.lr": 0.01, "model.head": "ad", "train.epochs": 3}

    def test_bad_pair_raises(self):
        with pytest.raises(SystemExit):
            _parse_overrides(["nonsense"])

    def test_bool_override_text_forms(self):
        flag = lambda v: get_config("tiny_test", **_parse_overrides([f"model.remat={v}"])).model.remat
        assert flag("False") is False and flag("no") is False and flag("false") is False
        assert flag("True") is True and flag("true") is True
        with pytest.raises(ValueError):
            flag("maybe")


class TestEndToEnd:
    def test_train_eval_predict(self, cli_env, capsys):
        root, workdir = cli_env
        _train(root, workdir)
        assert "val_accuracy" in capsys.readouterr().out

        main(["eval", "--workdir", str(workdir), "--split", "test", *CPU])
        metrics = json.loads(capsys.readouterr().out)
        assert 0.0 <= metrics["accuracy"] <= 1.0

        img = str(next((root / "images").glob("*.jpg")))
        main(["predict", "--workdir", str(workdir), "--image", img, "--question", "is the lung normal", *CPU])
        pred = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert pred["question"] == "is the lung normal"
        assert len(pred["top"]) == 3
        assert all(a["answer"] != "<unk>" for a in pred["top"])

    def test_serve_directory(self, cli_env, capsys):
        """``serve`` streams a directory with top-k fetch and question dedup:
        one row per image, two real answers each."""
        root, workdir = cli_env
        if not (workdir / "checkpoints").exists():  # run alone
            _train(root, workdir)
            capsys.readouterr()
        main(["serve", "--workdir", str(workdir), "--image-dir", str(root / "images"),
              "--question", "is the lung normal", "--question", "what organ is shown",
              "--batch", "2", "--topk", "2", "--dedup", *CPU])
        captured = capsys.readouterr()
        rows = [json.loads(ln) for ln in captured.out.strip().splitlines()]
        images = sorted(p.name for p in (root / "images").iterdir())
        assert sorted(r["image"] for r in rows) == images
        for r in rows:
            assert len(r["answers"]) == 2
            assert all(isinstance(a, str) and a != "<unk>" for a in r["answers"])
        summary = json.loads(captured.err.strip().splitlines()[-1])
        assert summary["pairs"] == 2 * len(images) and "p50_ms" in summary["latency_ms"]

    def test_convert_roundtrip(self, tmp_path, capsys):
        """A reference-layout checkpoint -> ``cli convert`` -> a workdir that
        ``Predictor.from_checkpoint`` serves, with the logits of the port
        model converted in process."""
        sd = build_torch_model(jax_get_config("tiny_test").model, seed=1).state_dict()
        ckpt_path = tmp_path / "ref.pt"
        torch.save({"state_dict": sd}, ckpt_path)
        workdir = tmp_path / "converted"
        main(["convert", "--config", "tiny_test", "--torch-ckpt", str(ckpt_path), "--workdir", str(workdir), *CPU])
        assert "converted" in capsys.readouterr().out
        assert (workdir / "checkpoints" / "config.json").exists()

        questions = ["is the lung normal", "what organ is shown", "is there a fracture"]
        vocab, answers = WordVocab.build(questions), AnswerVocab([f"answer {i}" for i in range(20)])
        (workdir / "vocabs").mkdir()
        vocab.save(workdir / "vocabs" / "question_vocab.json")
        answers.save(workdir / "vocabs" / "answer_vocab.json")
        img = np.random.RandomState(0).randint(0, 256, (200, 240, 3)).astype(np.uint8)
        got = Predictor.from_checkpoint(workdir, device="cpu").predict_batch(img, questions)

        cfg = get_config("tiny_test")
        model = convert_state_dict(sd, build_model(cfg.model, device="cpu", seed=5))
        want = Predictor(model, None, vocab, answers, cfg, device="cpu").predict_batch(img, questions)
        np.testing.assert_array_equal(got, want)

    def test_bench_subcommand_passes_exit_code(self):
        with pytest.raises(SystemExit) as e:
            main(["bench", "--config", "no_such_config", *CPU])
        assert e.value.code != 0


def test_bench_json_contract():
    out = subprocess.run(
        [sys.executable, "-m", "btia_tpu_torch.bench", "--config", "tiny_test", "--batch", "2",
         "--questions", "2", "--steps", "2", "--warmup", "0", "--json-only", *CPU],
        capture_output=True, text=True, timeout=240, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["metric"] == "image_question_pairs_per_sec_per_chip"
    assert result["unit"] == "pairs/s/chip"
    assert result["value"] > 0
    assert result["vs_baseline"] == round(result["value"] / 5000.0, 3)


@pytest.mark.parametrize("n,limit", [(3, 32), (3, 10), (5, 4), (1, 2)])
def test_topn_real_np_matches_jax(n, limit):
    """``predict``'s ranking of real answers: ids 1..limit-1, ties (logits
    rounded to a few values) and a limit under the head size included."""
    logits = np.round(np.random.RandomState(limit).randn(6, 32), 1).astype(np.float32)
    got = topn_real_np(logits, n, limit)
    np.testing.assert_array_equal(got, jax_topn_real_np(logits, n, limit))
    assert got.shape == (6, min(n, limit - 1)) and ((got >= 1) & (got < limit)).all()
