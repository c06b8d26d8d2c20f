"""The port's mesh, sharding rules and process-group set-up against the JAX
package's, and a ``Trainer`` that reads ``cfg.mesh``.

* ``MeshConfig.resolve`` and ``best_mesh_config``, case by case against the
  reference's, errors included;
* the port's ``param_shardings`` against the reference's on the same small
  ``streaming_vitl`` tree, leaf by leaf (flax's "a/b/c" is the port's
  "a.b.c"), and on a small mlp-head tree, where the one leaf that differs
  is named with its reason;
* the slicing helpers, the errors of a model axis that does not divide a
  width, ``fused_mesh``'s no-op cases, int8 FFNs under TP against one process;
* ``Trainer`` under ``streaming_vitl``'s registered mesh (data -1, model 2),
  and under (data 2, model 1), as two CPU ranks on gloo
  (``tests/torch_mesh_worker.py``): one epoch on a synthetic VQA-Med corpus
  (K-step chunks of 2), then a one-process ``Predictor`` of the primary's
  checkpoint gives the ranks' logits (fp32, within 1e-4), and a second
  ``Trainer`` under the same mesh resumes from it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btia_tpu.configs import get_config as jax_get_config
from btia_tpu.models.model import build_model as jax_build_model
from btia_tpu.parallel import mesh as jmesh
from btia_tpu.parallel import sharding as jsharding
from btia_tpu_torch.configs import get_config
from btia_tpu_torch.models.model import build_model
from btia_tpu_torch.ops.fused_attn import fused_dense_attention, fused_mesh
from btia_tpu_torch.parallel import distributed, sharding
from btia_tpu_torch.parallel.mesh import (
    Mesh, MeshConfig, active_mesh, best_mesh_config, make_mesh, single_device_mesh, use_mesh,
)
from torch_mesh_worker import spawn

RESOLVE_CASES = [(-1, 1, 8), (-1, 2, 8), (2, -1, 8), (4, 2, 8), (8, 1, 8), (-1, -1, 4), (3, 1, 8),
                 (-1, 3, 8), (-1, 2, 1), (1, 1, 1), (-1, 1, 1), (2, 2, 4), (-1, 4, 2)]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("data,model,n", RESOLVE_CASES)
def test_mesh_config_resolve_matches_reference(data, model, n):
    assert _outcome(lambda: MeshConfig(data, model).resolve(n)) == \
        _outcome(lambda: jmesh.MeshConfig(data, model).resolve(n))


def test_best_mesh_config_matches_reference():
    for n in range(1, 9):
        for max_model in range(1, 5):
            got, want = best_mesh_config(n, max_model), jmesh.best_mesh_config(n, max_model)
            assert (got.data, got.model) == (want.data, want.model)


def test_one_process_mesh():
    """One process: the default MeshCfg gives a 1 x 1 mesh with no process
    group; streaming_vitl's registered (data -1, model 2) does not factor
    one rank and raises, as the reference's resolve does."""
    m = make_mesh(MeshConfig())
    assert m.shape == {"data": 1, "model": 1} and m.size == 1 and m.coord == (0, 0)
    assert m.group("data") is None and m.group("model") is None
    cfg = get_config("streaming_vitl")
    with pytest.raises(ValueError, match="0x2 != 1"):
        make_mesh(MeshConfig(cfg.mesh.data, cfg.mesh.model))
    assert single_device_mesh().size == 1
    # Row-major ranks: the model axis is the contiguous one.
    assert [Mesh(2, 2, r).coord for r in range(4)] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_distributed_without_a_process_group():
    assert distributed.maybe_initialize() is False
    assert distributed.process_count() == 1 and distributed.is_primary()
    with pytest.raises(ValueError, match="backend"):
        distributed.maybe_initialize("127.0.0.1:1", 2, 0, backend="mpi")
    assert distributed.default_backend() == ("nccl" if torch.cuda.is_available() else "gloo")


SMALL = {
    "model.image_encoder": "vit_test", "model.bert_layers": 2, "model.bert_hidden": 128,
    "model.bert_heads": 2, "model.hidden_dim": 128, "model.num_heads": 2, "model.btia_layers": 1,
    "model.answer_vocab_size": 64, "model.num_answer_queries": 8,
}
MLP_HEAD = {
    "model.image_encoder": "resnet_tiny", "model.hidden_dim": 64, "model.num_heads": 2,
    "model.btia_layers": 1, "model.answer_vocab_size": 32, "model.question_vocab_size": 100,
    "model.word_embed_dim": 32, "model.lstm_hidden": 32, "model.max_question_len": 12,
}
# The one leaf whose spec differs from the reference's: the mlp head's fc1
# matches the fc1 rule but has no fc2 after it (its output goes whole into
# fc_out), so the port keeps it whole; the reference shards it and XLA
# gathers the output.
DIFFERING = {"head.fc1.kernel", "head.fc1.bias"}


def _reference_specs(config, over, image, L):
    cfg = jax_get_config(config, **over)
    model = jax_build_model(cfg.model)
    key = jax.random.PRNGKey(0)
    variables = jax.eval_shape(lambda: model.init({"params": key, "dropout": key},
                                                  jnp.zeros((1, image, image, 3), jnp.uint8),
                                                  jnp.ones((1, L), jnp.int32)))
    mesh = jmesh.make_mesh(jmesh.MeshConfig(1, 2), devices=jax.devices()[:2])
    out = {}
    for mp in (False, True):
        sh = jsharding.param_shardings(variables["params"], mesh, model_parallel=mp)
        flat = jax.tree_util.tree_flatten_with_path(sh)[0]
        out[mp] = {jsharding._path_str(p).replace("/", "."): tuple(s.spec) for p, s in flat}
    return out


@pytest.mark.parametrize("config,over,image,L", [("streaming_vitl", SMALL, 96, 32),
                                                 ("vqa_rad_lstm", MLP_HEAD, 64, 12)])
def test_param_shardings_match_reference_leaf_by_leaf(config, over, image, L):
    ref = _reference_specs(config, over, image, L)
    model = build_model(get_config(config, **over).model, device="cpu")
    params = dict(model.named_parameters())
    for mp in (False, True):
        got = {k: v for k, v in sharding.param_shardings(model, Mesh(1, 2), mp).items() if k in params}
        assert got.keys() == ref[mp].keys()
        differ = {k for k in got if got[k] != ref[mp][k]}
        if mp and config == "vqa_rad_lstm":
            assert differ == DIFFERING and all(got[k] == () for k in DIFFERING)
        else:
            assert differ == set()
    specs = sharding.param_shardings(model, Mesh(1, 2), True)
    if config == "streaming_vitl":  # every attention site and MLP is split
        assert specs["btia.layer0.i2t_q_proj.kernel"] == (None, "model")
        assert specs["btia.layer0.i2t_o_proj.kernel"] == ("model", None)
        assert specs["btia.layer0.i2t_o_proj.bias"] == ()
        assert specs["image_encoder.block0.mlp.fc2.kernel"] == ("model", None)
        assert specs["head.mlp.fc1.bias"] == ("model",)
    # buffers (BatchNorm statistics) are in the state dict and replicated
    assert all(specs[k] == () for k, _ in model.named_buffers())


def test_shard_blocks_tile_the_whole_and_batches_split_by_rank():
    model = build_model(get_config("streaming_vitl", **SMALL).model, device="cpu")
    state = model.state_dict()
    specs = sharding.param_shardings(model, Mesh(1, 2), True)
    blocks = [sharding.shard_state_dict(state, specs, Mesh(1, 2, r)) for r in range(2)]
    for k, v in state.items():
        d = sharding.sharded_dim(specs[k])
        if d is None:
            assert blocks[0][k] is v and blocks[1][k] is v
        else:
            assert torch.equal(torch.cat([blocks[0][k], blocks[1][k]], dim=d), v)
    x = np.arange(24).reshape(6, 4)
    got = [sharding.shard_batch({"a": x, "b": [torch.arange(6)]}, Mesh(2, 1, r)) for r in range(2)]
    np.testing.assert_array_equal(got[1]["a"], x[3:])
    assert got[0]["b"][0].tolist() == [0, 1, 2]
    np.testing.assert_array_equal(sharding.shard_chunk(x.reshape(2, 6, 2), Mesh(2, 1, 1)), x.reshape(2, 6, 2)[:, 3:])
    assert sharding.shard_batch(x, Mesh(1, 2, 1)) is x  # model ranks keep the same rows
    assert sharding.shard_batch_local(x, Mesh(2, 1, 1)) is x
    with pytest.raises(ValueError, match="does not divide"):
        sharding.shard_batch(np.zeros((5, 2)), Mesh(2, 1))


def test_model_axis_that_does_not_divide_raises():
    model = build_model(get_config("streaming_vitl", **SMALL).model, device="cpu")
    with pytest.raises(ValueError, match="heads do not divide over model=4"):
        sharding.shard_params(model, Mesh(1, 4))
    with pytest.raises(ValueError, match="does not divide over model=2"):
        sharding.shard_tensor(torch.zeros(4, 6 + 1), (None, "model"), Mesh(1, 2), "fc1.kernel")
    with use_mesh(Mesh(1, 4)), pytest.raises(ValueError, match="do not divide over model=4"):
        fused_dense_attention(torch.zeros(1, 2, 8), torch.zeros(1, 2, 8), None,
                              *[torch.zeros(8, 8), torch.zeros(8)] * 4, 2)


def test_fused_mesh_none_and_one_rank_are_no_ops():
    rng = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    args = (t(2, 3, 8), t(2, 5, 8), None, t(8, 8), t(8), t(8, 8), t(8), t(8, 8), t(8), t(8, 8), t(8), 2)
    plain = fused_dense_attention(*args, residual=True)
    for m in (None, Mesh(1, 1), single_device_mesh()):
        with fused_mesh(m):
            assert active_mesh() is None
            assert torch.equal(fused_dense_attention(*args, residual=True), plain)
    with fused_mesh(Mesh(2, 1)):
        assert active_mesh().shape == {"data": 2, "model": 1}
    assert active_mesh() is None


INT8 = {**SMALL, "model.int8_ffn": True, "model.mixed_precision": True}


@pytest.fixture(scope="module")
def int8_run(tmp_path_factory):
    """A small streaming_vitl with int8 FFNs (bf16) under (1, 2), two gloo
    ranks: an Mlp alone and the sharded serve (``scenario_int8``)."""
    root = tmp_path_factory.mktemp("int8_mesh")
    rng = np.random.RandomState(14)
    ids = np.zeros((2, 32, 32), np.int64)
    ids[..., :6] = rng.randint(1, 500, (2, 32, 6))
    inputs = {"config": "streaming_vitl", "overrides": INT8,
              "mlp_x": (rng.randn(2, 40, 128) * 2).astype(np.float32),
              "images": rng.randint(0, 256, (2, 96, 96, 3)).astype(np.uint8), "qids": ids}
    torch.save(inputs, root / "inputs.pt")
    return inputs, spawn("int8", 1, 2, root)


def test_int8_mlp_under_a_model_axis_is_the_one_process_mlp(int8_run):
    """An int8 Mlp under (1, 2) (fc1 column-parallel, fc2 row-parallel on
    K8's row-parallel road) equals the one-process int8 Mlp bit for bit:
    fc1's columns are exact on a shard, fc2's row and column scales are the
    group's maxima, and its int32 partial products are summed exactly before
    the epilogue, so tolerance 0. The first call all-reduces fc2's column
    amaxes (its weight is prepared once), and every call its 80 rows'
    amaxes (f32) and int32 partials."""
    inputs, ranks = int8_run
    cfg = get_config("streaming_vitl", **INT8)
    model = build_model(cfg.model, device="cpu")
    assert model.policy.int8
    mlp = model.btia.layer0.mlp_img
    x = torch.from_numpy(inputs["mlp_x"]).to(torch.bfloat16)
    with torch.inference_mode():
        want = mlp(x)
    rows, dim = 80, 128
    for r in ranks:
        assert r["fc2_shape"] == (mlp.fc2.kernel.shape[0] // 2, dim)
        for got in r["mlp"]:
            assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        step = rows * 4 + rows * dim * 4
        assert r["mlp_reduced"] == [{"calls": 3, "bytes": dim * 4 + step}, {"calls": 2, "bytes": step}]


def test_int8_serve_under_a_model_axis_matches_one_process(int8_run):
    """The sharded serve of the int8 model under (1, 2) against the
    one-process serve. The int8 FFNs are exact on the mesh, but every
    attention site's row-parallel output projection sums bf16 partials in
    another order than one process's product (the fp road), so a logit
    moves by a few bf16 steps, and such a change can move an int8
    quantization step of a later FFN: logits within 3 % of the largest
    (1.0-1.1 % at three seeds of these inputs).
    Both ranks return the same logits."""
    inputs, ranks = int8_run
    cfg = get_config("streaming_vitl", **INT8)
    model = build_model(cfg.model, device="cpu")
    with torch.inference_mode():
        imgs, qids = torch.from_numpy(inputs["images"]), torch.from_numpy(inputs["qids"])
        want = model.answer_questions(model.encode_image(imgs), qids).float()
    scale = want.abs().max().item()
    for r in ranks:
        got = r["serve"].float()
        assert got.shape == want.shape and torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        assert err <= 0.03 * scale, (err, scale)
    torch.testing.assert_close(ranks[0]["serve"], ranks[1]["serve"], rtol=0, atol=0)


# cfg.mesh: streaming_vitl's registered (data -1, model 2), and (2, 1)
TRAINER_MESHES = {"registered": {}, "data": {"mesh.data": 2, "mesh.model": 1}}


@pytest.fixture(scope="module", params=sorted(TRAINER_MESHES))
def trainer_run(request, tmp_path_factory):
    from btia_tpu_torch.data.synthetic import generate_synthetic_vqa_med

    root = tmp_path_factory.mktemp(f"trainer_mesh_{request.param}")
    generate_synthetic_vqa_med(root / "data", num_images=8)
    over = {**SMALL, "model.mixed_precision": False, "data.dataset": "vqa_med",
            "data.data_dir": str(root / "data"), "train.batch_size": 4, "train.eval_batch_size": 8,
            "train.epochs": 1, "train.steps_per_call": 2, "train.warmup_steps": 1,
            **TRAINER_MESHES[request.param]}
    rng = np.random.RandomState(0)
    ids = np.zeros((4, 32), np.int64)
    ids[:, :5] = rng.randint(1, 500, (4, 5))
    inputs = {"config": "streaming_vitl", "overrides": over, "workdir": str(root / "run"),
              "images": rng.randint(0, 256, (4, 96, 96, 3)).astype(np.uint8), "qids": ids}
    torch.save(inputs, root / "inputs.pt")
    return inputs, spawn("trainer", 1, 2, root)  # the world of 2; cfg.mesh lays it out


def test_trainer_builds_its_mesh_from_cfg_mesh(trainer_run):
    inputs, ranks = trainer_run
    mesh = get_config("streaming_vitl").mesh
    assert (mesh.data, mesh.model) == (-1, 2)
    want = (2, 1) if inputs["overrides"].get("mesh.data") == 2 else (1, 2)
    assert [r["mesh"] for r in ranks] == [want, want]
    assert [r["primary"] for r in ranks] == [True, False]
    for r in ranks:  # under TP each rank holds half of every TP leaf
        assert r["local_shapes"]["btia.layer0.i2t_q_proj.kernel"] == (128, 128 // want[1])
        assert r["step"] == 4 and r["resumed"] and r["resumed_step"] == 4 and r["resumed_equal"]
        assert np.isfinite(r["history"][0]["train_loss"])
    assert ranks[0]["eval"] == ranks[1]["eval"]
    torch.testing.assert_close(ranks[0]["logits"], ranks[1]["logits"], rtol=0, atol=0)


def test_primary_only_checkpoint_loads_into_a_one_process_predictor(trainer_run):
    from pathlib import Path

    from btia_tpu_torch.infer.predict import Predictor

    inputs, ranks = trainer_run
    workdir = Path(inputs["workdir"])
    rows = [line for line in (workdir / "metrics.jsonl").read_text().splitlines() if '"epoch"' in line]
    assert len(rows) == 1  # one writer
    pred = Predictor.from_checkpoint(workdir, best=False, device="cpu")
    with torch.no_grad():
        logits = pred.model(torch.from_numpy(inputs["images"]), torch.from_numpy(inputs["qids"]))
    np.testing.assert_allclose(logits.numpy(), ranks[0]["logits"].numpy(), atol=1e-4, rtol=0)


def test_bench_serves_over_torchrun_ranks():
    """``python -m btia_tpu_torch.bench --mesh 2,1`` under torchrun (two CPU
    ranks on gloo): one JSON line, from the primary; the first step's best
    logits as on one device; the value per device.

    The bench rounds the per-device value and the global rate to 0.1 each,
    so the global rate is twice the value within 0.15 (0.1 from doubling
    the value's rounding, 0.05 from its own), whatever the rate: a slow host
    serves ~50 pairs/s here. torchrun's standalone rendezvous binds its own
    free port."""
    import json
    import os
    import subprocess
    import sys

    from torch_mesh_worker import REPO

    args = ["--config", "tiny_test", "--batch", "4", "--questions", "2", "--steps", "2", "--warmup", "0",
            "--reps", "1", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(REPO))
    mesh = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                           "-m", "btia_tpu_torch.bench", *args, "--mesh", "2,1"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    one = subprocess.run([sys.executable, "-m", "btia_tpu_torch.bench", *args], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=180)
    assert mesh.returncode == 0 and one.returncode == 0, mesh.stderr[-3000:] + one.stderr[-3000:]
    lines = [json.loads(x) for x in mesh.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 1 and lines[0]["metric"] == "image_question_pairs_per_sec_per_chip"
    detail = [json.loads(x) for x in mesh.stderr.splitlines() if x.startswith('{"config"')]
    want = [json.loads(x) for x in one.stderr.splitlines() if x.startswith('{"config"')][0]
    assert len(detail) == 1 and detail[0]["mesh"] == {"data": 2, "model": 1}
    assert abs(detail[0]["top1_mean"] - want["top1_mean"]) < 1e-4
    assert abs(detail[0]["global_pairs_per_sec"] - 2 * lines[0]["value"]) <= 0.15 + 1e-9
