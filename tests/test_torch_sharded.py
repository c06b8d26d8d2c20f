"""The port's sharded serving against ``btia_tpu.infer.sharded`` at the same
mesh.

A small ``streaming_vitl`` (vit_test, 2 BERT layers at width 128, one BTIA
layer, 8 answer queries over 64 answers, fp32) is initialised in flax and
bridged into the port (``convert/from_jax.py``). The port runs as CPU ranks
on gloo (``tests/torch_mesh_worker.py``), one spawned run per mesh making
every check; the reference runs in this process on the virtual CPU devices,
``make_mesh(MeshConfig(dp, tp), devices=jax.devices()[:dp * tp])``, its
Pallas sites in interpret mode where the fused road is forced, as
``tests/test_sharded_serving.py`` runs them.

fp32 logits agree within 1e-4, the whole-model tolerance of
``tests/test_torch_model.py``. At (1, 2) the model axis splits every
attention site's heads and every MLP's hidden units over two ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btia_tpu.configs import get_config as jax_get_config
from btia_tpu.infer.sharded import (
    make_sharded_serve_fn,
    make_sharded_serve_indexed_fn,
    shard_serving_params,
)
from btia_tpu.models.model import build_model as jax_build_model
from btia_tpu.ops import fused_attn as JFA
from btia_tpu.parallel.mesh import MeshConfig, make_mesh
from torch_mesh_worker import spawn

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
L = 32
ATOL = 1e-4
VOCAB_LIMIT = 20
QUESTIONS = ["is the lung normal", "which side is the lesion on", "what organ is shown"]


def _qids(rng, n):
    """Question rows with 3..L real tokens, then PAD (no all-PAD row, whose
    masked softmax the two packages define differently)."""
    ids = np.zeros((n, L), np.int32)
    for i in range(n):
        k = rng.randint(3, L + 1)
        ids[i, :k] = rng.randint(1, 500, k)
    return ids


def _site(rng):
    """One K1 site (and K2 on the same weights): Din = HD = Dout = 32 over 2
    heads, pre-LNs, residual and post-LN."""
    r = lambda *s: rng.randn(*s).astype(np.float32) * 0.3
    x_kv = r(2, 12, 32)
    mask = np.ones((2, 12), bool)
    mask[1, 9:] = False
    return dict(x_q=r(2, 8, 32), x_kv=x_kv, mask=mask, queries=r(4, 32), heads=2,
                wq=r(32, 32), bq=r(32), wk=r(32, 32), bk=r(32), wv=r(32, 32), bv=r(32),
                wo=r(32, 32), bo=r(32), ln_s=1 + r(32), ln_b=r(32))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = jax_get_config("streaming_vitl", **SMALL)
    model = jax_build_model(cfg.model)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(model.init)({"params": key, "dropout": key},
                                    jnp.zeros((1, 96, 96, 3), jnp.uint8), jnp.ones((1, L), jnp.int32))
    variables = jax.device_get(variables)
    rng = np.random.RandomState(0)
    flat = _qids(rng, 6)
    inputs = dict(
        config="streaming_vitl", overrides=SMALL, weights=variables,
        images=rng.randint(0, 256, (2, 120, 120, 3)).astype(np.uint8),
        qids=flat.reshape(2, 3, L), uniq=_qids(rng, 4), qmap=rng.randint(0, 4, (2, 3)).astype(np.int32),
        vocab_limit=VOCAB_LIMIT, site=_site(rng), questions=QUESTIONS,
        # at the Predictor's ingest size, so that no host resize comes between
        predict_image=rng.randint(0, 256, (256, 256, 3)).astype(np.uint8),
        pair_images=rng.randint(0, 256, (2, 256, 256, 3)).astype(np.uint8),
        pairs=[(np.array([0, 1, 1, 0, 1]), np.array([3, 0, 2, 2, 1])), (np.array([1, 0, 1, 0]), np.array([0, 3, 3, 1]))],
        answers=["yes", "no", "left", "right"],
    )
    runs = {}
    for dp, tp in ((2, 1), (1, 2)):
        workdir = tmp_path_factory.mktemp(f"sharded_{dp}x{tp}")
        torch.save(inputs, workdir / "inputs.pt")
        runs[(dp, tp)] = spawn("serve", dp, tp, workdir)
    return model, variables, inputs, runs


def _mesh(dp, tp):
    return make_mesh(MeshConfig(dp, tp), devices=jax.devices()[: dp * tp])


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def reference(setup):
    """The reference's outputs at each mesh: plain, indexed, top-k and the
    fused road forced with interpret=True."""
    model, variables, inputs, _ = setup
    out = {}
    orig_dense, orig_static = JFA.fused_dense_attention, JFA.fused_static_q_attention
    for dp, tp in ((2, 1), (1, 2)):
        mesh = _mesh(dp, tp)
        v = shard_serving_params(variables, mesh)
        args = (inputs["images"], inputs["qids"])
        r = {
            "plain": make_sharded_serve_fn(model, mesh)(v, *args),
            "indexed": make_sharded_serve_indexed_fn(model, mesh)(v, inputs["images"], inputs["uniq"],
                                                                  inputs["qmap"]),
            "topk": make_sharded_serve_fn(model, mesh, topk=3, vocab_limit=VOCAB_LIMIT)(v, *args),
        }
        JFA.fused_dense_attention = lambda *a, **k: orig_dense(*a, interpret=True, **k)
        JFA.fused_static_q_attention = lambda *a, **k: orig_static(*a, interpret=True, **k)
        try:
            r["fused_plain"] = make_sharded_serve_fn(model, mesh)(v, *args)
        finally:
            JFA.fused_dense_attention, JFA.fused_static_q_attention = orig_dense, orig_static
        out[(dp, tp)] = jax.device_get(r)
    return out


MESHES = [(2, 1), (1, 2)]


@pytest.mark.parametrize("mesh", MESHES)
def test_plain_serving_matches_reference(setup, reference, mesh):
    runs = setup[3][mesh]
    for r in runs:  # every rank returns the whole batch
        assert tuple(r["plain"].shape) == (2, 3, 64)
        _close(r["plain"], reference[mesh]["plain"])


@pytest.mark.parametrize("mesh", MESHES)
def test_indexed_serving_matches_reference(setup, reference, mesh):
    for r in setup[3][mesh]:
        _close(r["indexed"], reference[mesh]["indexed"])


@pytest.mark.parametrize("mesh", MESHES)
def test_topk_matches_reference(setup, reference, mesh):
    vals_ref, idx_ref = reference[mesh]["topk"]
    for r in setup[3][mesh]:
        vals, idxs = r["topk"]
        assert tuple(vals.shape) == (2, 3, 3)
        _close(vals, vals_ref)
        np.testing.assert_array_equal(idxs.numpy(), np.asarray(idx_ref))
        assert idxs.max() < VOCAB_LIMIT and (idxs != 0).all()


@pytest.mark.parametrize("mesh", MESHES)
def test_topk_requires_vocab_limit_and_batches_must_divide(setup, mesh):
    for r in setup[3][mesh]:
        assert "vocab_limit" in r["vocab_limit_error"]
        if mesh[0] > 1:  # one image row over two data ranks
            assert "does not divide" in r["indivisible_error"]
        else:
            assert r["indivisible_error"] is None


@pytest.mark.parametrize("mesh", MESHES)
def test_forced_fused_road_matches_reference(setup, reference, mesh):
    """interpret=True takes every K1 / K2 site onto the fused road; under
    tp 2 each rank runs its heads' cut-down site and the partial outputs
    are summed, as ``_fused_over_mesh`` / ``_staticq_over_mesh`` do."""
    for r in setup[3][mesh]:
        _close(r["fused_plain"], reference[mesh]["fused_plain"])
        _close(r["fused_indexed"], reference[mesh]["indexed"])


def test_fused_mesh_site_matches_reference_at_tp2(setup):
    """One K1 site and one K2 site alone under ``fused_mesh`` at (1, 2),
    against the reference's mesh road (shard_map, Pallas in interpret mode)."""
    s = setup[2]["site"]
    mesh = _mesh(1, 2)
    w = [jnp.asarray(s[n]) for n in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")]
    ln = (jnp.asarray(s["ln_s"]), jnp.asarray(s["ln_b"]), 1e-6)
    with JFA.fused_mesh(mesh):
        dense = jax.jit(lambda xq, xkv, m: JFA.fused_dense_attention(
            xq, xkv, m, *w, s["heads"], interpret=True, q_ln=ln, kv_ln=ln, residual=True, post_ln=ln))(
            s["x_q"], s["x_kv"], s["mask"])
        static = jax.jit(lambda q, xkv, m: JFA.fused_static_q_attention(
            q, xkv, m, *w, s["heads"], interpret=True, kv_ln=ln, residual=True))(
            s["queries"], s["x_kv"], s["mask"])
    for r in setup[3][(1, 2)]:
        assert r["site_launches"] == 0  # the CPU runs the twin: nothing launched
        _close(r["site"], dense, 1e-5)
        _close(r["site_static"], static, 1e-5)


def test_model_axis_holds_shards_and_round_trips(setup):
    """At (1, 2) every TP leaf holds half its width on each rank, and the
    gathered state dict equals the whole one bit for bit."""
    runs = setup[3][(1, 2)]
    shapes = runs[0]["shapes"]
    assert shapes["question_encoder.layer0.attn.q_proj.kernel"] == (128, 64)
    assert shapes["question_encoder.layer0.attn.o_proj.kernel"] == (64, 128)
    assert shapes["question_encoder.layer0.attn.o_proj.bias"] == (128,)
    assert shapes["question_encoder.layer0.mlp.fc1.bias"] == (256,)
    assert shapes["head.answer_queries"] == (8, 128)
    for r in runs + setup[3][(2, 1)]:
        assert r["round_trip"]


@pytest.mark.parametrize("mesh", MESHES)
def test_predictor_on_a_mesh(setup, reference, mesh):
    """Predictor(mesh=): a 1-image predict (its batch of 1 stays whole on
    every rank at data 2) and predict_batch, against the one-image rows of
    the reference's serve step."""
    model, variables, inputs, runs = setup
    from btia_tpu_torch.data.wordpiece import WordPieceTokenizer

    tok = WordPieceTokenizer.toy_vocab(QUESTIONS)
    qids = np.zeros((1, 4, L), np.int32)  # the Predictor's bucket of 4
    qids[0, :3] = [tok.encode(q, L) for q in QUESTIONS]
    ref = np.asarray(make_sharded_serve_fn(model, _mesh(1, 1))(
        variables, inputs["predict_image"][None], qids))[0, :3]
    for r in runs[mesh]:
        _close(r["predict"], ref[0])
        _close(r["predict_batch"], ref)
        assert len(r["predict_answers"]) == 3


@pytest.mark.parametrize("mesh", MESHES)
def test_predictor_dedup_and_pair_forwards_on_a_mesh(setup, mesh):
    """The forwards a StreamingServer drives through Predictor(mesh=): the
    dedup form and the packed pair list (5 pairs stay whole on every data
    rank, 4 split over them), against the port's one-process model."""
    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.convert.from_jax import load_jax_variables
    from btia_tpu_torch.models.model import build_model

    _, variables, inputs, runs = setup
    model = build_model(get_config("streaming_vitl", **SMALL).model, device="cpu")
    load_jax_variables(model, variables)
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    with torch.inference_mode():
        img = model.encode_image(torch.from_numpy(inputs["pair_images"]))
        indexed = model.answer_questions_indexed(img, t(inputs["uniq"]), t(inputs["qmap"]))
        pairs = [model.answer_pairs(img, t(inputs["uniq"]), t(pi), t(pq)) for pi, pq in inputs["pairs"]]
    for r in runs[mesh]:
        _close(r["pred_indexed"], indexed)
        for got, want in zip(r["pred_pairs"], pairs):
            assert tuple(got.shape) == tuple(want.shape)
            _close(got, want)
