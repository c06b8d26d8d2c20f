"""The mlp head (``SimpleClassifier``) and the GloVe loader
(``data/embeddings.py``) against the JAX package's, on the CPU.

The head: flax initialises it, the bridge carries the weights, both get the
same numpy image and text tokens and a text mask with an all-PAD row.
fp32 logits within 1e-5 absolute (magnitude ~1; one f32 sum order apart);
bf16 within 1e-2 absolute, since the two round the pooled tokens and fc1's
output to bf16 at other points (observed 1.9e-3). The loader: a synthetic
GloVe file in a temporary directory (a header line, a truncated line, words
in and out of the vocabulary); the matrices must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btia_tpu.core.dtypes import default_policy as jax_policy
from btia_tpu.data import embeddings as JE
from btia_tpu.data.vocab import WordVocab as JaxWordVocab
from btia_tpu.models.heads import SimpleClassifier as JaxSimpleClassifier
from btia_tpu_torch.configs import get_config
from btia_tpu_torch.convert.from_jax import load_jax_params
from btia_tpu_torch.core.dtypes import default_policy
from btia_tpu_torch.data import embeddings as E
from btia_tpu_torch.data.vocab import WordVocab
from btia_tpu_torch.models.heads import SimpleClassifier
from btia_tpu_torch.models.layers import Dropout
from btia_tpu_torch.models.model import build_model

D, V, B, NI, NT = 48, 30, 4, 7, 9


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randn(B, NI, D).astype(np.float32)
    txt = rng.randn(B, NT, D).astype(np.float32)
    mask = rng.rand(B, NT) > 0.4
    mask[0] = True
    mask[1] = False  # an all-PAD question: its text mean is 0
    return img, txt, mask


@pytest.mark.parametrize("mixed,tol", [(False, 1e-5), (True, 1e-2)], ids=["fp32", "bf16"])
def test_simple_classifier_matches_jax(mixed, tol):
    jm = JaxSimpleClassifier(dim=D, vocab_size=V, policy=jax_policy(mixed))
    img, txt, mask = _inputs()
    cd = jnp.bfloat16 if mixed else jnp.float32
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(img, cd), jnp.asarray(txt, cd),
                              jnp.asarray(mask))["params"]
    tm = SimpleClassifier(D, V, policy=default_policy(mixed), device="cpu")
    load_jax_params(tm, params)
    assert tm.fc1.kernel.shape == (2 * D, 2 * D) and tm.fc_out.kernel.shape == (2 * D, V)
    want = jax.jit(lambda p, a, b, m: jm.apply({"params": p}, a, b, m))(
        params, jnp.asarray(img, cd), jnp.asarray(txt, cd), jnp.asarray(mask))
    tdt = torch.bfloat16 if mixed else torch.float32
    with torch.no_grad():
        got = tm(torch.from_numpy(img).to(tdt), torch.from_numpy(txt).to(tdt), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)


def test_simple_classifier_dropout_and_masked_mean():
    """Dropout sits after the GELU (drawn from the caller's generator); the
    text mean skips PAD tokens."""
    tm = SimpleClassifier(D, V, policy=default_policy(False), device="cpu")
    with torch.no_grad():
        for p in tm.parameters():
            p.normal_(0, 0.1)
    img, txt, mask = (torch.from_numpy(a) for a in _inputs(1))
    run = lambda seed: tm(img, txt, mask, Dropout(0.5, torch.Generator().manual_seed(seed)), train=True)
    with torch.no_grad():
        a, b, c, plain = run(3), run(3), run(4), tm(img, txt, mask)
        txt_junk = txt.clone()
        txt_junk[~mask] = 1e3  # PAD positions do not reach the logits
        same = tm(img, txt_junk, mask)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, plain)
    torch.testing.assert_close(same, plain, atol=1e-5, rtol=0)


def _glove(tmp_path, dim):
    lines = [f"400000 {dim}",  # a header: skipped
             "lung " + " ".join(f"{0.1 * i:.3f}" for i in range(dim)),
             "normal " + " ".join(f"{-0.05 * i:.3f}" for i in range(dim)),
             "truncated 0.5 0.25",  # the wrong length: skipped
             "absent " + " ".join("1.0" for _ in range(dim))]
    path = tmp_path / "glove.txt"
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return path


def test_glove_parse_and_matrix_match_jax(tmp_path):
    dim = 8
    path = _glove(tmp_path, dim)
    corpus = ["is the lung normal", "what organ is shown"]
    got = E.parse_glove_file(path, dim)
    want = JE.parse_glove_file(path, dim)
    assert sorted(got) == sorted(want) == ["absent", "lung", "normal"]
    for w in got:
        np.testing.assert_array_equal(got[w], want[w])
    m, hits = E.build_embedding_matrix(WordVocab.build(corpus), got, dim, seed=3)
    jm, jhits = JE.build_embedding_matrix(JaxWordVocab.build(corpus), want, dim, seed=3)
    assert hits == jhits == 2
    np.testing.assert_array_equal(m, jm)
    assert not m[0].any()  # PAD


def test_load_word_embeddings_into_the_lstm_model(tmp_path):
    """Into tiny_test's ``question_encoder.word_embed.embedding``, as the
    reference's loader writes its params; a missing file raises."""
    cfg = get_config("tiny_test")
    dim = cfg.model.word_embed_dim
    path = _glove(tmp_path, dim)
    words = ["lung", "normal"] + [f"w{i}" for i in range(cfg.model.question_vocab_size - 4)]
    vocab = WordVocab(words)
    model = build_model(cfg.model, device="cpu")
    assert E.load_word_embeddings(model, vocab, path) == 2
    want, hits = JE.load_word_embeddings_into_params(
        {"question_encoder": {"word_embed": {"embedding": np.zeros((len(vocab), dim), np.float32)}}},
        JaxWordVocab(words), path)
    assert hits == 2
    np.testing.assert_array_equal(model.question_encoder.word_embed.embedding.detach().numpy(),
                                  want["question_encoder"]["word_embed"]["embedding"])
    with pytest.raises(FileNotFoundError):
        E.load_word_embeddings(model, vocab, tmp_path / "missing.txt")
    with pytest.raises(ValueError, match="vocab size"):
        E.load_word_embeddings(model, WordVocab(words[:5]), path)
