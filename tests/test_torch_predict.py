"""The port's Predictor against ``btia_tpu.infer.predict.Predictor``.

Both are built on the same flax weights of a small ``streaming_vitl``
(fp32), the same toy WordPiece vocab and answer vocab, and get the same
uint8 image at the ingest size (256), or the same image as JPEG bytes, an
off-size array or a DICOM file, which both decode and resize on the host
with the same code. Question counts are padded up to a
bucket with all-PAD rows, which the two packages treat differently (0 vs
mean(V) attention) and both slice off, so the real rows must agree: logits
to 1e-4, answer strings exactly.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from btia_tpu.configs import get_config as jax_get_config
from btia_tpu.data import native as jax_native
from btia_tpu.data.vocab import AnswerVocab as JaxAnswerVocab
from btia_tpu.data.wordpiece import WordPieceTokenizer as JaxWordPiece
from btia_tpu.infer.predict import Predictor as JaxPredictor
from btia_tpu.models.model import build_model as jax_build_model
from btia_tpu_torch.configs import get_config
from btia_tpu_torch.convert.from_jax import load_jax_params
from btia_tpu_torch.data import native as torch_native
from btia_tpu_torch.data.dicom import write_dicom
from btia_tpu_torch.data.synthetic import generate_synthetic_vqa_med
from btia_tpu_torch.data.vocab import AnswerVocab
from btia_tpu_torch.data.wordpiece import WordPieceTokenizer
from btia_tpu_torch.infer.predict import Predictor, _bucket, predict
from btia_tpu_torch.models.model import build_model
from btia_tpu_torch.train.trainer import Trainer

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
    "is the lung normal",
    "what organ is shown in this image",
    "is there a fracture of the left femur",
    "which side is the lesion on",
    "does the chest x ray show pleural effusion",
]
ANSWERS = ["yes", "no", "lung", "left", "right", "brain", "liver", "kidney"]


@pytest.fixture(scope="module")
def predictors():
    jcfg = jax_get_config("streaming_vitl", **SMALL)
    jm = jax_build_model(jcfg.model)
    key = jax.random.PRNGKey(1)
    variables = jax.jit(jm.init)(
        {"params": key, "dropout": key},
        jnp.zeros((1, 256, 256, 3), jnp.uint8), jnp.ones((1, 32), jnp.int32),
    )
    jp = JaxPredictor(
        jm, variables, JaxWordPiece.toy_vocab(CORPUS), JaxAnswerVocab(ANSWERS), jcfg
    )
    cfg = get_config("streaming_vitl", **SMALL)
    tm = build_model(cfg.model, device="cpu")
    load_jax_params(tm, variables["params"])
    tp = Predictor(
        tm, None, WordPieceTokenizer.toy_vocab(CORPUS), AnswerVocab(ANSWERS), cfg,
        device="cpu",
    )
    return jp, tp


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(0).randint(0, 256, (256, 256, 3)).astype(np.uint8)


def test_predict_batch_logits(predictors, image):
    jp, tp = predictors
    questions = CORPUS[:3]  # bucket 4: one all-PAD row, sliced off
    ref = jp.predict_batch(image, questions)
    out = tp.predict_batch(image, questions)
    assert out.shape == ref.shape == (3, 64)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_predict_answers_strings(predictors, image):
    jp, tp = predictors
    assert tp.predict_answers(image, CORPUS) == jp.predict_answers(image, CORPUS)
    assert tp.predict_answer(image, CORPUS[1]) == jp.predict_answer(image, CORPUS[1])


def test_grayscale_image_and_size_check(predictors, image):
    """A grayscale array, and an off-size one, which both packages resize on
    the host to the ingest size (256)."""
    jp, tp = predictors
    gray = image[:, :, 0]
    np.testing.assert_allclose(
        tp.predict(gray, CORPUS[0]), jp.predict(gray, CORPUS[0]), atol=1e-4, rtol=0
    )
    assert tp._prep_image(image[:100]).shape == (256, 256, 3)
    np.testing.assert_allclose(
        tp.predict(image[:100], CORPUS[0]), jp.predict(image[:100], CORPUS[0]), atol=1e-4, rtol=0
    )


def test_jpeg_bytes_and_dicom_path(predictors, image, tmp_path, monkeypatch):
    """JPEG bytes, and a DICOM file that both packages decode with the
    Python reader: the native library, where it loads, may differ from it
    by one grey level, and each package (each test worker) loads it or not
    on its own. ``test_dicom_native_route_matches`` covers the library."""
    jp, tp = predictors
    monkeypatch.setattr(jax_native, "dicom_decode_resize", lambda *a, **k: None)
    monkeypatch.setattr(torch_native, "dicom_decode_resize", lambda *a, **k: None)
    buf = io.BytesIO()
    Image.fromarray(image[:200, :150]).save(buf, format="JPEG")
    jpeg = buf.getvalue()
    np.testing.assert_allclose(
        tp.predict_batch(jpeg, CORPUS[:2]), jp.predict_batch(jpeg, CORPUS[:2]), atol=1e-4, rtol=0
    )
    path = tmp_path / "q.dcm"
    write_dicom(path, (np.random.RandomState(1).rand(48, 40) * 3000).astype(np.uint16))
    np.testing.assert_allclose(
        tp.predict(str(path), CORPUS[3]), jp.predict(str(path), CORPUS[3]), atol=1e-4, rtol=0
    )
    assert tp.predict_answer(path, CORPUS[3]) == jp.predict_answer(str(path), CORPUS[3])


def test_dicom_native_route_matches(predictors):
    """The native library's decode of a DICOM, made once, reaches both
    predictors as the same array: logits to 1e-4, the same answer."""
    jp, tp = predictors
    blob = write_dicom(None, (np.random.RandomState(2).rand(56, 44) * 3000).astype(np.uint16))
    arr = torch_native.dicom_decode_resize(blob, 256, 256)
    assert arr is not None, "the native ingest library did not build or load"
    assert arr.shape == (256, 256, 3) and arr.dtype == np.uint8
    np.testing.assert_allclose(tp.predict(arr, CORPUS[1]), jp.predict(arr, CORPUS[1]), atol=1e-4, rtol=0)
    assert tp.predict_answer(arr, CORPUS[1]) == jp.predict_answer(arr, CORPUS[1])


def test_from_checkpoint_round_trip(tmp_path):
    """A port Trainer's workdir (config, vocabs, best checkpoint) serves
    through Predictor.from_checkpoint and predict() with the trained
    weights, bit for bit."""
    root = tmp_path / "data"
    generate_synthetic_vqa_med(root, num_images=4)
    cfg = get_config("vqa_med_full", **{
        k: v for k, v in SMALL.items() if k != "model.num_answer_queries"}, **{
        "data.data_dir": str(root), "data.num_workers": 1, "train.batch_size": 4,
        "train.eval_batch_size": 8, "train.epochs": 1,
    })
    trainer = Trainer(cfg, tmp_path / "run", device="cpu")
    trainer.fit()
    pred = Predictor.from_checkpoint(tmp_path / "run", device="cpu")
    assert pred.cfg.to_json() == cfg.to_json()
    assert list(pred.answer_vocab.itos) == list(trainer.data.answer_vocab.itos)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(pred.model.state_dict()[k], v), k
    img = trainer.data.train[0].image_path
    direct = Predictor(trainer.model, None, trainer.data.text_encoder, trainer.data.answer_vocab,
                       cfg, device="cpu")
    want = direct.predict(img, "what organ is shown")
    np.testing.assert_array_equal(pred.predict(img, "what organ is shown"), want)
    np.testing.assert_array_equal(predict(img, "what organ is shown", tmp_path / "run", device="cpu"), want)


@pytest.mark.parametrize("n,b", [(1, 1), (3, 4), (8, 8), (9, 16), (64, 64), (65, 128)])
def test_bucket(n, b):
    assert _bucket(n) == b
