"""Headline benchmark of the port: image-question pairs per second on one
card, streaming inference (the port of the root ``bench.py``).

    python -m btia_tpu_torch.bench [--config streaming_vitl] [--batch 16]
        [--questions 128] [--steps 20] [--warmup 3] [--reps 3] [--topk 5]
        [--json-only] [--device cuda] [--mesh [DATA,MODEL]]

Measures the serving step of a registered config, ``serve_step``: on-device
resize / normalize -> image encoder (once per image) -> question tower ->
BTIA fusion -> answer head fanned out over Q questions per image -> top-k,
on weights made at random from a seed (throughput does not depend on the
weights). Four host-staged uint8 image buffers at the ingest size
``max(256, image_size)`` and four question-id buffers are copied to the card
inside the timed window, as the reference's ``jit`` copies its numpy
inputs. A window dispatches every step and then fetches every output to the
host; it is timed on CUDA events (the host clock with ``--device cpu``) and
ends with that fetch. The median of ``--reps`` windows is the headline.

Prints one JSON line on stdout, ``metric``, ``value``, ``unit`` and
``vs_baseline`` = value / 5000 (the reference publishes no numbers; 5,000
pairs/s/chip is its build target), and the detail on stderr.

``--mesh`` serves the same step over the ranks that ``torchrun`` started
(``parallel.distributed.maybe_initialize``: NCCL, one card a rank), under
the config's registered mesh or the DATA,MODEL given
(``infer/sharded.py``): each data rank serves its images, the model ranks
split the weights. The value is then the global pairs/s over the number of
cards, and only the primary prints:

    torchrun --nproc-per-node 2 -m btia_tpu_torch.bench --mesh          # streaming_vitl: data 1, model 2
    torchrun --nproc-per-node 4 -m btia_tpu_torch.bench --mesh 2,2
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from btia_tpu_torch.configs import get_config
from btia_tpu_torch.core.device import resolve_device
from btia_tpu_torch.models.model import BTIAADNet, build_model
from btia_tpu_torch.utils.profiling import Timer, fetch

TARGET_PAIRS_PER_SEC = 5000.0
N_BUFS = 4


@torch.inference_mode()
def serve_step(model: BTIAADNet, images: torch.Tensor, question_ids: torch.Tensor, topk: int):
    """images (B, S, S, 3) uint8, question ids (B, Q, L) on the model's
    device -> (values, ids) of the top-k logits (B, Q, k), launched and not
    waited for. Fetching k answers, not the whole answer vocabulary, is what
    a server sends back."""
    logits = model.answer_questions(model.encode_image(images), question_ids)
    return torch.topk(logits, topk)


def _mesh_setup(cfg, shape, device):
    """(device, mesh) of this rank of a torchrun-started mesh."""
    from btia_tpu_torch.parallel.distributed import local_rank, maybe_initialize
    from btia_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    dev = resolve_device(device)
    if not maybe_initialize():
        raise RuntimeError("--mesh serves over the ranks torchrun starts (MASTER_ADDR, WORLD_SIZE, RANK unset)")
    local_rank()
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    data, model = (cfg.mesh.data, cfg.mesh.model) if shape is None else shape
    return dev, make_mesh(MeshConfig(data, model))


def run(config: str = "streaming_vitl", batch: int = 16, questions: int = 128, steps: int = 20,
        warmup: int = 3, reps: int = 3, topk: int = 5, device="cuda", seed: int = 0,
        mesh=None) -> dict:
    """One benchmark run -> {"result": the stdout line, "detail": ...}.
    `mesh`: None (one card), "config" (the config's mesh over the torchrun
    ranks) or a (data, model) pair."""
    cfg = get_config(config)
    if mesh is None:
        dev, grid = resolve_device(device), None
    else:
        dev, grid = _mesh_setup(cfg, None if mesh == "config" else mesh, device)
    t0 = time.perf_counter()
    model = build_model(cfg.model, device=dev, seed=seed)
    if grid is not None:
        from btia_tpu_torch.infer.sharded import make_sharded_serve_fn, shard_serving_params

        shard_serving_params(model, grid)
        sharded = make_sharded_serve_fn(model, grid, topk, cfg.model.answer_vocab_size)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    B, Q, L = batch, questions, cfg.model.max_question_len
    ingest = max(256, cfg.model.image_size)
    # Ids from the question tower's own vocabulary: an id past it is an
    # error here, where JAX's gather clamps it.
    vocab = cfg.model.bert_vocab_size if cfg.model.question_encoder == "bert" else cfg.model.question_vocab_size
    rng = np.random.RandomState(0)
    image_bufs = [rng.randint(0, 255, (B, ingest, ingest, 3)).astype(np.uint8) for _ in range(N_BUFS)]
    qid_bufs = [rng.randint(1, vocab, (B, Q, L)).astype(np.int64) for _ in range(N_BUFS)]

    def step(i):
        images = torch.from_numpy(image_bufs[i % N_BUFS]).to(dev)
        qids = torch.from_numpy(qid_bufs[i % N_BUFS]).to(dev)
        if grid is not None:
            return sharded(images, qids)
        return serve_step(model, images, qids, topk)

    # The first call builds the CUDA kernels (nvcc) unless a build is cached.
    t0 = time.perf_counter()
    first = fetch(step(0))
    compile_s = time.perf_counter() - t0
    for i in range(warmup):
        fetch(step(i))

    # A window: every step dispatched, then every output fetched; the span
    # ends with the fetch (CUDA events on the card).
    pairs, timer, rates = steps * B * Q, Timer(), []
    for _ in range(max(reps, 1)):
        before, outs = timer.total, []
        with timer.span(result=outs):
            outs.extend(step(i) for i in range(steps))
        rates.append(pairs / (timer.total - before))
    cards = 1 if grid is None else grid.size
    rates = sorted(r / cards for r in rates)
    pairs_per_sec = rates[len(rates) // 2]  # the median window
    result = {
        "metric": "image_question_pairs_per_sec_per_chip",
        "value": round(pairs_per_sec, 1),
        "unit": "pairs/s/chip",
        "vs_baseline": round(pairs_per_sec / TARGET_PAIRS_PER_SEC, 3),
    }
    detail = {
        "config": config,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "images_per_step": B,
        "questions_per_image": Q,
        "steps": steps,
        "steps_run": 1 + warmup + steps * len(rates),
        "reps_pairs_per_sec": [round(r, 1) for r in rates],
        "step_ms": round(1000 * pairs / pairs_per_sec / steps, 2),
        "init_s": round(init_s, 1),
        "compile_s": round(compile_s, 1),
        # the first step's mean best logit: the same weights and inputs give
        # the same value on one card and over a mesh, up to rounding
        "top1_mean": round(float(first[0][..., 0].float().mean()), 5),
    }
    if grid is not None:
        detail["mesh"] = dict(grid.shape)
        detail["global_pairs_per_sec"] = round(pairs_per_sec * cards, 1)
    return {"result": result, "detail": detail}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="btia_tpu_torch.bench")
    ap.add_argument("--config", default="streaming_vitl")
    ap.add_argument("--batch", type=int, default=16, help="images per step")
    ap.add_argument("--questions", type=int, default=128, help="questions/image")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3,
                    help="timed windows; the MEDIAN is the headline")
    ap.add_argument("--topk", type=int, default=5, help="answers fetched/question")
    ap.add_argument("--json-only", action="store_true")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--mesh", nargs="?", const="config", default=None, metavar="DATA,MODEL",
                    help="serve over the torchrun ranks, under the config's mesh or DATA,MODEL")
    args = ap.parse_args(argv)
    mesh = args.mesh
    if mesh not in (None, "config"):
        mesh = tuple(int(x) for x in mesh.split(","))
    out = run(args.config, args.batch, args.questions, args.steps, args.warmup, args.reps,
              args.topk, args.device, mesh=mesh)
    from btia_tpu_torch.parallel.distributed import is_primary

    if is_primary():
        if not args.json_only:
            print(json.dumps(out["detail"]), file=sys.stderr)
        print(json.dumps(out["result"]), flush=True)
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
