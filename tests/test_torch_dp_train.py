"""The port's data- and tensor-parallel train steps against its one-process
step on the same global batch.

CPU ranks on gloo (``tests/torch_mesh_worker.py``) take train steps at
dropout 0:

* DP (2, 1): one step of a reduced ``vqa_rad_lstm`` (ResNet with
  BatchNorm, bi-LSTM, BTIA, the mlp head), each rank on its 4 of the 8
  rows. The gradients average over the data group, and BatchNorm
  normalises with the global batch's statistics and moves its running
  averages by them. One step: after a first update, whose clipped Adam
  moves nearly every weight by the full learning rate, this small ResNet's
  early gradients move by up to 15 % for a 1e-7 relative change of its
  weights in one process alone, so a second step would compare rounding,
  not the data parallelism;
* TP (1, 2): two steps of a reduced ``streaming_vitl`` (ViT, BERT, BTIA,
  the AD head), every attention site's heads and every MLP's hidden units
  split over the two ranks, the global gradient norm summed over both;
* both, (2, 2): the same steps on four ranks, each data rank on its 2 of
  the 4 rows.

Each is held to the one-process steps in this process: the loss and the
global norm of every step, and every parameter and BatchNorm statistic of
the gathered state dict after them. The clip (``train.grad_clip`` 1e-5)
acts at every step, so a wrong norm moves every update. The negative
controls run the same ranks with per-rank BatchNorm statistics (DP) or a
per-rank clip norm (TP) and must move the result past the tolerance: the
test can see the fault. The steps also run once more with every K1 / K2
site forced onto its fused road (``interpret=True``).

Tolerances (fp32): the loss and the norm within 1e-5 relative; parameters
and statistics within 2e-6 absolute (the updates are up to lr = 1e-3, and a
summation order apart).
"""

import numpy as np
import pytest
import torch

from btia_tpu_torch.configs import get_config
from torch_mesh_worker import spawn, train_run

STEP = {"model.dropout": 0.0, "model.mixed_precision": False, "train.warmup_steps": 0,
        "train.grad_clip": 1e-5, "train.lr": 1e-3}
LSTM = {**STEP, "model.image_encoder": "resnet_tiny", "model.hidden_dim": 64, "model.num_heads": 2,
        "model.btia_layers": 1, "model.answer_vocab_size": 32, "model.question_vocab_size": 100,
        "model.word_embed_dim": 32, "model.lstm_hidden": 32, "model.max_question_len": 12}
VIT = {**STEP, "model.image_encoder": "vit_test", "model.bert_layers": 2, "model.bert_hidden": 128,
       "model.bert_heads": 2, "model.hidden_dim": 128, "model.num_heads": 2, "model.btia_layers": 1,
       "model.answer_vocab_size": 64, "model.num_answer_queries": 8, "model.max_question_len": 16}
REL = 1e-5
PARAM_ATOL = 2e-6


def _batches(rng, B, size, L, vocab, answers, steps):
    out = []
    for _ in range(steps):
        ids = np.zeros((B, L), np.int64)
        for i in range(B):
            k = rng.randint(3, L + 1)
            ids[i, :k] = rng.randint(1, vocab, k)
        out.append({"images": rng.randint(0, 256, (B, size, size, 3)).astype(np.uint8),
                    "question_ids": ids, "answer_ids": rng.randint(1, answers, B).astype(np.int64),
                    "valid": np.ones(B, bool)})
    return out


CASES = {
    "dp": ("vqa_rad_lstm", LSTM, (2, 1), "per_rank_bn", dict(B=8, size=64, L=12, vocab=100, answers=32, steps=1)),
    "tp": ("streaming_vitl", VIT, (1, 2), "per_rank_clip",
           dict(B=4, size=96, L=16, vocab=500, answers=64, steps=2)),
    "dp_tp": ("streaming_vitl", VIT, (2, 2), "per_rank_clip",
              dict(B=4, size=96, L=16, vocab=500, answers=64, steps=2)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request, tmp_path_factory):
    config, over, (dp, tp), fault, shape = CASES[request.param]
    torch.set_num_threads(2)
    batches = _batches(np.random.RandomState(0), **shape)
    workdir = tmp_path_factory.mktemp(f"train_{request.param}")
    torch.save({"config": config, "overrides": over, "batches": batches, "fault": fault,
                "forced_fused": True}, workdir / "inputs.pt")
    ranks = spawn("train", dp, tp, workdir)
    single = train_run(get_config(config, **over), batches)
    return request.param, ranks, single


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _max_param_diff(a, b):
    assert a.keys() == b.keys()
    return max((a[k].float() - b[k].float()).abs().max().item() for k in b)


def test_loss_and_global_norm_match_one_process(run):
    _, ranks, (metrics, _) = run
    for r in ranks:
        for got, want in zip(r["metrics"], metrics):
            assert _rel(got["loss"], want["loss"]) < REL, (got, want)
            assert _rel(got["grad_norm"], want["grad_norm"]) < REL, (got, want)
            assert got["grad_norm"] > 1e-5  # the clip acts
            assert _rel(got["accuracy"], want["accuracy"]) < REL


def test_parameters_and_statistics_match_one_process(run):
    name, ranks, (_, params) = run
    for r in ranks:
        assert _max_param_diff(r["params"], params) < PARAM_ATOL
    if name == "dp":  # BatchNorm's running statistics moved, by the global batch
        stats = [k for k in params if k.endswith((".mean", ".var"))]
        assert stats and all(not torch.equal(params[k], torch.zeros_like(params[k])) for k in stats
                             if k.endswith(".mean"))


def test_fused_road_matches_one_process(run):
    """Every K1 / K2 site forced onto its fused road: at (1, 2) the cut-down
    sites, the bias shares and the LN parameters' gradients summed over the
    model group, at (2, 1) each rank's rows, give the one-process (unfused)
    steps."""
    _, ranks, (metrics, params) = run
    for r in ranks:
        for got, want in zip(r["fused_metrics"], metrics):
            assert _rel(got["loss"], want["loss"]) < REL and _rel(got["grad_norm"], want["grad_norm"]) < REL
        assert _max_param_diff(r["fused_params"], params) < PARAM_ATOL


def test_negative_control_moves_the_result(run):
    """Per-rank BatchNorm statistics (DP) or a per-rank clip norm (TP):
    the result moves past the tolerance the positive run met."""
    name, ranks, (metrics, params) = run
    for r in ranks:
        moved = _max_param_diff(r["fault_params"], params)
        assert moved > 10 * PARAM_ATOL, (name, moved)
        if name == "dp":
            stats = {k: v for k, v in params.items() if k.endswith((".mean", ".var"))}
            assert _max_param_diff({k: r["fault_params"][k] for k in stats}, stats) > 1e-3
        elif name == "tp":
            # a rank's own norm is not the model's
            assert _rel(r["fault_metrics"][0]["grad_norm"], metrics[0]["grad_norm"]) > 1e-3
