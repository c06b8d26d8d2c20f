"""Ranks of a (data, model) mesh for the port's parallel tests, as CPU
processes on gloo.

``spawn(scenario, dp, tp, workdir)`` starts dp * tp copies of this script on
a free localhost port, each with a timeout, and returns the results each
rank saved (``workdir/rank<r>.pt``). A rank that fails, or a run that
outlives its timeout, fails the caller with the ranks' output. The scenario
reads its inputs from ``workdir/inputs.pt`` (numpy arrays and options the
test wrote there) and returns a dict of tensors and values.

One spawned run makes every check of its mesh, so that each test file pays
for few process starts.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 150
GLOO_TIMEOUT_S = 60


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(scenario: str, dp: int, tp: int, workdir, timeout: float = RANK_TIMEOUT_S):
    import torch

    workdir = Path(workdir)
    world = dp * tp
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(REPO))
    env.pop("XLA_FLAGS", None)
    procs = []
    for r in range(world):
        log = open(workdir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, scenario, str(dp), str(tp), str(r), str(port), str(workdir)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    failed = []
    for r, (p, log) in enumerate(procs):
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            rc = "timeout"
        log.close()
        if rc != 0:
            failed.append((r, rc))
    if failed:
        logs = "\n".join(f"--- rank {r} ({rc}):\n" + (workdir / f"rank{r}.log").read_text()[-4000:]
                         for r, rc in failed)
        raise AssertionError(f"{scenario} at ({dp}, {tp}) failed:\n{logs}")
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# the rank side


def _model(inputs, device="cpu"):
    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.convert.from_jax import load_jax_variables
    from btia_tpu_torch.models.model import build_model

    cfg = get_config(inputs["config"], **inputs["overrides"])
    model = build_model(cfg.model, device=device)
    if "weights" in inputs:
        load_jax_variables(model, inputs["weights"])
    return cfg, model


def _t(a):
    import numpy as np
    import torch

    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" and a.dtype != np.uint8 else a)


def _forced_fused():
    """Every K1 / K2 site of the model with interpret=True: the fused road
    past the gate, as the reference's sharded-serving tests force it."""
    import functools

    from btia_tpu_torch.models import btia, heads, layers
    from btia_tpu_torch.ops import fused_attn as FA

    layers.fused_dense_attention = functools.partial(FA.fused_dense_attention, interpret=True)
    btia.fused_dense_attention = functools.partial(FA.fused_dense_attention, interpret=True)
    heads.fused_static_q_attention = functools.partial(FA.fused_static_q_attention, interpret=True)


def scenario_serve(mesh, inputs):
    """Sharded serving: plain, indexed, top-k and the vocab_limit error; the
    fused road forced; a site alone on the fused mesh road; Predictor(mesh=)
    with a 1-image predict; the shard -> gather round trip."""
    import torch

    from btia_tpu_torch.infer.predict import Predictor
    from btia_tpu_torch.infer.sharded import (
        make_sharded_serve_fn, make_sharded_serve_indexed_fn, shard_serving_params,
    )
    from btia_tpu_torch.ops import fused_attn as FA
    from btia_tpu_torch.parallel.sharding import gather_state_dict

    cfg, model = _model(inputs)
    full = {k: v.clone() for k, v in model.state_dict().items()}
    specs = shard_serving_params(model, mesh)
    out = {"shapes": {k: tuple(v.shape) for k, v in model.state_dict().items()}}
    back = gather_state_dict(model.state_dict(), specs, mesh)
    out["round_trip"] = all(torch.equal(back[k], full[k]) for k in full)
    imgs, qids = _t(inputs["images"]), _t(inputs["qids"])
    uniq, qmap = _t(inputs["uniq"]), _t(inputs["qmap"])
    out["plain"] = make_sharded_serve_fn(model, mesh)(imgs, qids)
    out["indexed"] = make_sharded_serve_indexed_fn(model, mesh)(imgs, uniq, qmap)
    vals, idxs = make_sharded_serve_fn(model, mesh, topk=3, vocab_limit=inputs["vocab_limit"])(imgs, qids)
    out["topk"] = (vals, idxs)
    try:
        make_sharded_serve_fn(model, mesh, topk=3)
        out["vocab_limit_error"] = None
    except ValueError as e:
        out["vocab_limit_error"] = str(e)
    try:
        make_sharded_serve_fn(model, mesh)(imgs[:1], qids[:1])
        out["indivisible_error"] = None
    except ValueError as e:
        out["indivisible_error"] = str(e)
    # One K1 site alone on the fused mesh road (interpret=True).
    site = inputs["site"]
    w = [_t(site[n]) for n in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")]
    from btia_tpu_torch.parallel.sharding import shard_tensor, spec_for

    names = ("q_proj.kernel", "q_proj.bias", "k_proj.kernel", "k_proj.bias", "v_proj.kernel",
             "v_proj.bias", "o_proj.kernel", "o_proj.bias")
    w = [shard_tensor(t, spec_for(n, t.ndim, True), mesh, n) for t, n in zip(w, names)]
    ln = (_t(site["ln_s"]), _t(site["ln_b"]), 1e-6)
    with FA.fused_mesh(mesh):
        before = FA.fused_dense_attention.launches
        out["site"] = FA.fused_dense_attention(
            _t(site["x_q"]), _t(site["x_kv"]), _t(site["mask"]), *w, site["heads"], interpret=True,
            q_ln=ln, kv_ln=ln, residual=True, post_ln=ln)
        out["site_static"] = FA.fused_static_q_attention(
            _t(site["queries"]), _t(site["x_kv"]), _t(site["mask"]), *w, site["heads"], interpret=True,
            kv_ln=ln, residual=True)
        out["site_launches"] = FA.fused_dense_attention.launches - before
    # The fused road forced through the whole model.
    _forced_fused()
    out["fused_plain"] = make_sharded_serve_fn(model, mesh)(imgs, qids)
    out["fused_indexed"] = make_sharded_serve_indexed_fn(model, mesh)(imgs, uniq, qmap)
    # Predictor(mesh=) over a fresh model (it shards it), 1-image predict.
    from btia_tpu_torch.data.vocab import AnswerVocab
    from btia_tpu_torch.data.wordpiece import WordPieceTokenizer

    _, model2 = _model(inputs)
    qs = inputs["questions"]
    pred = Predictor(model2, None, WordPieceTokenizer.toy_vocab(qs), AnswerVocab(inputs["answers"]), cfg,
                     device="cpu", mesh=mesh)
    img = inputs["predict_image"]
    out["predict"] = pred.predict(img, qs[0])
    out["predict_batch"] = pred.predict_batch(img, qs)
    out["predict_answers"] = pred.predict_answers(img, qs)
    # The dedup and packed-pair forwards a StreamingServer drives, with
    # pair lists of 5 (whole on every data rank) and 4 (split) rows.
    imgs_np = inputs["pair_images"]
    out["pred_indexed"] = pred._fanout_forward_indexed(2, 3, 4)(imgs_np, inputs["uniq"], inputs["qmap"])
    out["pred_pairs"] = [pred._pairs_forward(2, 4, len(pi))(imgs_np, inputs["uniq"], pi, pq)
                         for pi, pq in inputs["pairs"]]
    return out


def scenario_int8(mesh, inputs):
    """int8 FFNs under the mesh (``model.int8_ffn``): one Mlp of the sharded
    model alone, twice (the first call prepares its weights), with the
    bytes each call all-reduced; then the sharded serve."""
    import torch

    from btia_tpu_torch.infer.sharded import make_sharded_serve_fn, shard_serving_params
    from btia_tpu_torch.parallel import collectives as C
    from btia_tpu_torch.parallel.mesh import use_mesh

    _, model = _model(inputs)
    shard_serving_params(model, mesh)
    mlp = model.btia.layer0.mlp_img
    x = _t(inputs["mlp_x"]).to(torch.bfloat16)
    out = {"fc2_shape": tuple(mlp.fc2.kernel.shape), "mlp": [], "mlp_reduced": []}
    with torch.inference_mode(), use_mesh(mesh):
        for _ in range(2):
            C.reset_stats()
            out["mlp"].append(mlp(x))
            out["mlp_reduced"].append(dict(C.stats.get("model", {})))
    out["serve"] = make_sharded_serve_fn(model, mesh)(_t(inputs["images"]), _t(inputs["qids"]))
    return out


def train_run(cfg, batches, mesh=None, seed=0):
    """Train steps of a model built from `seed` on global batches (numpy
    dicts), each rank on its rows: the metrics of every step and the whole
    state dict after them (gathered over the model group)."""
    from btia_tpu_torch.models.model import build_model
    from btia_tpu_torch.parallel.sharding import shard_batch
    from btia_tpu_torch.train.steps import create_state, make_train_step

    model = build_model(cfg.model, device="cpu", seed=seed)
    state = create_state(model, cfg, steps_per_epoch=10, mesh=mesh)
    step = make_train_step(model, cfg, mesh)
    metrics = []
    for b in batches:
        local = shard_batch(b, mesh) if mesh is not None else b
        _, m = step(state, {k: _t(v) for k, v in local.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state.state_dict()["params"]


def scenario_train(mesh, inputs):
    """DP or TP train steps against which the test holds the one-process
    steps; with `inputs["forced_fused"]` again with every K1 / K2 site on
    its fused road (interpret=True); then the same under the negative
    control `inputs["fault"]`: per-rank BatchNorm statistics or a per-rank
    clip norm."""
    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.models import resnet
    from btia_tpu_torch.train import steps

    cfg = get_config(inputs["config"], **inputs["overrides"])
    out = dict(zip(("metrics", "params"), train_run(cfg, inputs["batches"], mesh)))
    if inputs.get("forced_fused"):  # the sites' fused road and its backward
        _forced_fused()
        out["fused_metrics"], out["fused_params"] = train_run(cfg, inputs["batches"], mesh)
    fault = inputs.get("fault")
    if fault == "per_rank_bn":
        resnet.axis_size = lambda axis: 1
    elif fault == "per_rank_clip":
        steps.all_reduce_ = lambda t, axis, mesh=None: t
    if fault:
        out["fault_metrics"], out["fault_params"] = train_run(cfg, inputs["batches"], mesh)
    return out


def scenario_trainer(mesh, inputs):
    """``Trainer`` under the mesh ``cfg.mesh`` names (over both ranks): one
    epoch, eval, then a second Trainer under the same mesh resumes from the
    primary's checkpoint. Returns what the test holds against a one-process
    Predictor of that checkpoint."""
    import torch

    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.ops.fused_attn import fused_mesh
    from btia_tpu_torch.parallel.sharding import shard_batch
    from btia_tpu_torch.train.trainer import Trainer

    cfg = get_config(inputs["config"], **inputs["overrides"])
    t = Trainer(cfg, inputs["workdir"], device="cpu")
    out = {"mesh": (t.mesh.shape["data"], t.mesh.shape["model"]), "primary": t.primary}
    out["history"] = t.fit()
    out["eval"] = t.evaluate("test")
    imgs, qids = _t(inputs["images"]), _t(inputs["qids"])
    with torch.no_grad(), fused_mesh(t.mesh):
        local = t.model(*shard_batch((imgs, qids), t.mesh), train=False)
    from btia_tpu_torch.parallel.collectives import gather_rows

    out["logits"] = gather_rows(local, t.mesh)
    out["local_shapes"] = {k: tuple(v.shape) for k, v in t.model.state_dict().items()}
    t2 = Trainer(cfg, inputs["workdir"], device="cpu")
    out["resumed"] = t2.resume_if_available()
    out["resumed_step"] = t2.state.step
    out["resumed_equal"] = all(torch.equal(a, b) for a, b in zip(t.model.state_dict().values(),
                                                                 t2.model.state_dict().values()))
    out["step"] = t.state.step
    return out


def main(argv):
    scenario, dp, tp, rank, port, workdir = argv
    dp, tp, rank = int(dp), int(tp), int(rank)
    import torch

    torch.set_num_threads(2)
    from btia_tpu_torch.parallel.distributed import maybe_initialize
    from btia_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    maybe_initialize(f"127.0.0.1:{port}", dp * tp, rank, backend="gloo", timeout_s=GLOO_TIMEOUT_S)
    mesh = make_mesh(MeshConfig(dp, tp))
    inputs = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
    out = globals()[f"scenario_{scenario}"](mesh, inputs)
    torch.save(out, Path(workdir) / f"rank{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
