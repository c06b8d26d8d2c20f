"""The slice as a whole: the serving step of ``python -m btia_tpu_torch.bench``
(``serve_step``: encode_image -> answer_questions -> top-k) against the root
``bench.py``'s, the JAX package's ``encode_image`` -> ``answer_questions``
-> ``lax.top_k``, on the same weights (flax variables bridged with
``load_jax_variables``) and the same host-staged inputs: a reduced-depth
``streaming_vitl`` (vit_test, 2 BERT layers at width 128, one BTIA layer, 8
answer queries over 64 answers) at the bench's ingest size of 256, 2 images
x 4 questions of 32 tokens, top-5.

Top-k values agree within ``tests/test_torch_model.py``'s tolerance (fp32
1e-4, bf16 1e-2 absolute); the ids agree wherever the JAX values around a
rank are further apart than that tolerance, so that rounding cannot swap
them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btia_tpu.configs import get_config as jax_get_config
from btia_tpu.models.model import build_model as jax_build_model
from btia_tpu_torch.bench import serve_step
from btia_tpu_torch.configs import get_config
from btia_tpu_torch.convert.from_jax import load_jax_variables
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
}
B, Q, K = 2, 4, 5


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("mixed,tol", [(False, 1e-4), (True, 1e-2)])
def test_serve_step_matches_jax_bench_step(mixed, tol):
    over = dict(SMALL, **{"model.mixed_precision": mixed})
    jcfg = jax_get_config("streaming_vitl", **over)
    jm = jax_build_model(jcfg.model)
    L = jcfg.model.max_question_len
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (B, 256, 256, 3)).astype(np.uint8)
    qids = np.zeros((B, Q, L), np.int32)
    for b in range(B):
        for q in range(Q):
            k = rng.randint(3, L + 1)
            qids[b, q, :k] = rng.randint(1, jcfg.model.bert_vocab_size, k)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(jm.init, static_argnames=("train",))(
        {"params": key, "dropout": key}, jnp.zeros((2, 256, 256, 3), jnp.uint8), jnp.zeros((2, L), jnp.int32),
        train=False)

    @jax.jit
    def jax_step(v, imgs, ids):
        tokens = jm.apply(v, imgs, method="encode_image")
        return jax.lax.top_k(jm.apply(v, tokens, ids, method="answer_questions"), K)

    want_vals, want_ids = (np.asarray(a) for a in jax_step(variables, images, qids))
    model = build_model(get_config("streaming_vitl", **over).model, device="cpu")
    load_jax_variables(model, variables)
    vals, ids = serve_step(model, torch.from_numpy(images), torch.from_numpy(qids.astype(np.int64)), K)
    vals, ids = vals.float().numpy(), ids.numpy()
    assert vals.shape == ids.shape == (B, Q, K)
    assert np.abs(vals - want_vals).max() <= tol, np.abs(vals - want_vals).max()
    # An id is held where its JAX value is further than tol from both
    # neighbours in the ranking.
    gaps = np.abs(np.diff(want_vals, axis=-1))
    apart = np.ones_like(want_vals, bool)
    apart[..., 1:] &= gaps > tol
    apart[..., :-1] &= gaps > tol
    assert apart.sum() >= B * Q  # the check is not empty
    np.testing.assert_array_equal(ids[apart], want_ids[apart])
