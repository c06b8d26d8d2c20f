"""Command-line interface of the port — train / eval / predict / convert /
serve / bench (the port of ``btia_tpu/cli.py``).

    python -m btia_tpu_torch.cli train   --config vqa_rad_lstm --workdir runs/rad \\
        --set data.data_dir=/data/vqa_rad --set train.epochs=40
    python -m btia_tpu_torch.cli eval    --workdir runs/rad --split test
    python -m btia_tpu_torch.cli predict --workdir runs/rad \\
        --image chest.dcm --question "is the lung normal"
    python -m btia_tpu_torch.cli serve   --workdir runs/rad --image-dir scans/ \\
        --question "is the lung normal" --topk 3 --dedup
    python -m btia_tpu_torch.cli convert --config vqa_rad_lstm \\
        --torch-ckpt ref.pt --workdir runs/converted
    python -m btia_tpu_torch.cli bench   --config streaming_vitl

Every subcommand runs on the card; ``--device cpu`` runs it on the CPU (the
kernels' plain PyTorch versions), as ``JAX_PLATFORMS=cpu`` does for the
reference. Without a GPU and without ``--device cpu`` a subcommand fails; it
never falls back to the CPU.

Under ``torchrun`` ``train`` joins the ranks into one process group and
trains under the config's mesh (``cfg.mesh``, e.g. ``--set mesh.data=-1``),
one card a rank:

    torchrun --nproc-per-node 2 -m btia_tpu_torch.cli train --config vqa_rad_lstm \
        --workdir runs/rad --set data.data_dir=/data/vqa_rad
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def _parse_overrides(pairs):
    out = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise SystemExit(f"--set expects key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        out[k] = v
    return out


def cmd_train(args) -> None:
    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.parallel.distributed import is_primary, local_rank, maybe_initialize
    from btia_tpu_torch.train.trainer import Trainer

    if maybe_initialize(backend="gloo" if args.device == "cpu" else None):
        local_rank()
    cfg = get_config(args.config, **_parse_overrides(args.set))
    trainer = Trainer(cfg, args.workdir, device=args.device)
    # SIGTERM / SIGINT -> finish the step in flight, checkpoint, return;
    # --resume continues from there.
    trainer.install_preemption_handler()
    if args.resume:
        resumed = trainer.resume_if_available()
        print(f"resume: {'ok' if resumed else 'no checkpoint found'}")
    history = trainer.fit()
    if is_primary():
        print(json.dumps(history[-1] if history else {}, indent=2))


def cmd_eval(args) -> None:
    from btia_tpu_torch.train.checkpoint import Checkpointer
    from btia_tpu_torch.train.trainer import Trainer

    cfg = Checkpointer(Path(args.workdir) / "checkpoints").load_config()
    trainer = Trainer(cfg, args.workdir, device=args.device)
    trainer.ckpt.restore(trainer.state, best=args.best)
    metrics = trainer.evaluate(args.split)
    print(json.dumps(metrics, indent=2, sort_keys=True))


def cmd_predict(args) -> None:
    from btia_tpu_torch.infer.predict import Predictor
    from btia_tpu_torch.ops.answers import real_limit, topn_real_np

    p = Predictor.from_checkpoint(args.workdir, best=args.best, device=args.device)
    questions = args.question
    logits = p.predict_batch(args.image, questions)
    for q, l_ in zip(questions, logits):
        limit = real_limit(len(p.answer_vocab), l_.shape[-1])
        top = topn_real_np(l_, 3, limit)
        answers = [{"answer": p.answer_vocab.decode(int(i)), "logit": float(l_[i])} for i in top]
        print(json.dumps({"question": q, "top": answers}))


def cmd_convert(args) -> None:
    import torch

    from btia_tpu_torch.configs import get_config
    from btia_tpu_torch.convert.convert import convert_state_dict
    from btia_tpu_torch.models.model import build_model
    from btia_tpu_torch.train.checkpoint import Checkpointer
    from btia_tpu_torch.train.steps import create_state

    cfg = get_config(args.config, **_parse_overrides(args.set))
    model = build_model(cfg.model, device=args.device)
    state = create_state(model, cfg, steps_per_epoch=1)
    sd = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    convert_state_dict(sd, model)
    ckpt = Checkpointer(Path(args.workdir) / "checkpoints")
    ckpt.save_config(cfg)
    ckpt.save(state)
    ckpt.wait_until_finished()
    print(f"converted {args.torch_ckpt} → {args.workdir}")


def cmd_serve(args) -> None:
    """Streaming inference over a directory of DICOM / JPEG / PNG images:
    each image is answered with the given questions."""
    from btia_tpu_torch.infer.predict import Predictor
    from btia_tpu_torch.infer.streaming import StreamingServer
    from btia_tpu_torch.ops.answers import argmax_real, real_limit

    p = Predictor.from_checkpoint(args.workdir, best=args.best, device=args.device)
    exts = {".dcm", ".dicom", ".jpg", ".jpeg", ".png"}
    images = sorted(f for f in Path(args.image_dir).iterdir() if f.suffix.lower() in exts)
    if not images:
        raise SystemExit(f"error: no images under {args.image_dir}")
    questions = args.question
    server = StreamingServer(
        p,
        image_batch=args.batch,
        questions_per_image=max(len(questions), 1),
        decode_threads=args.threads,
        topk=args.topk,
        dedup_questions=args.dedup,
        max_wait_ms=args.max_wait_ms,
        adaptive_q=args.adaptive_q,
        q_max=args.q_max,
    )
    # The first batch builds the CUDA kernels unless a build is cached: do
    # it before taking requests, and say so.
    print("serve: warming up ...", file=sys.stderr, flush=True)
    warm_s = server.warmup()
    print(f"serve: ready (warmup {warm_s:.1f}s)", file=sys.stderr, flush=True)
    limit = real_limit(len(p.answer_vocab), p.cfg.model.answer_vocab_size)
    reqs = ((str(f), questions) for f in images)
    # Results arrive in completion order with the request index: decode
    # threads reorder requests, so indexing (not zipping) attributes each
    # answer row to its image, even when bad files are skipped.
    for idx, out, n in server.serve(reqs):
        if args.topk:
            _vals, ids = out  # already excludes <unk> and head padding
            answers = [p.answer_vocab.decode(int(ids[i, 0])) for i in range(n)]
        else:
            answers = [p.answer_vocab.decode(int(argmax_real(out[i], limit))) for i in range(n)]
        print(json.dumps({"image": images[idx].name, "answers": answers}))
    for idx, exc in server.errors:
        print(json.dumps({"image": images[idx].name, "error": str(exc)[:200]}), file=sys.stderr)
    lat = server.latency_summary()
    print(
        json.dumps({
            "pairs": server.pairs_processed,
            "pairs_per_sec": round(server.pairs_per_second, 1),
            "latency_ms": {k: round(v, 1) for k, v in lat.items() if k.endswith("_ms")},
        }),
        file=sys.stderr,
    )


def cmd_bench(args) -> None:
    import subprocess

    cmd = [sys.executable, "-m", "btia_tpu_torch.bench", "--device", args.device]
    if args.config:
        cmd += ["--config", args.config]
    raise SystemExit(subprocess.call(cmd, cwd=Path(__file__).resolve().parent.parent))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="btia_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, fn, help_):
        p = sub.add_parser(name, help=help_)
        p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
        p.set_defaults(fn=fn)
        return p

    p = add("train", cmd_train, "train a registered config")
    p.add_argument("--config", required=True)
    p.add_argument("--workdir", default="runs/default")
    p.add_argument("--set", action="append", metavar="key=value")
    p.add_argument("--resume", action="store_true")

    p = add("eval", cmd_eval, "evaluate a checkpoint")
    p.add_argument("--workdir", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--best", action="store_true")

    p = add("predict", cmd_predict, "predict(image, question)")
    p.add_argument("--workdir", required=True)
    p.add_argument("--image", required=True)
    p.add_argument("--question", action="append", required=True)
    p.add_argument("--best", action="store_true")

    p = add("convert", cmd_convert, "reference PyTorch checkpoint -> the port's checkpoint")
    p.add_argument("--config", required=True)
    p.add_argument("--torch-ckpt", required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--set", action="append", metavar="key=value")

    p = add("serve", cmd_serve, "stream a directory of images")
    p.add_argument("--workdir", required=True)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--question", action="append", required=True)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--best", action="store_true")
    p.add_argument("--topk", type=int, default=None,
                   help="fetch only top-k ranked answers (smaller device->host transfer)")
    p.add_argument("--dedup", action="store_true",
                   help="encode unique questions once per device batch (exact)")
    p.add_argument("--max-wait-ms", type=float, default=None,
                   help="bound per-request latency: ship a padded partial batch once "
                   "the oldest pending request has waited this long")
    p.add_argument("--adaptive-q", action="store_true",
                   help="grow the fan-out launch shape per batch (up to --q-max) "
                   "when requests carry more questions than the base bucket")
    p.add_argument("--q-max", type=int, default=None,
                   help="question cap per request with --adaptive-q (default 2x base)")

    p = add("bench", cmd_bench, "run the headline benchmark")
    p.add_argument("--config", default=None)

    args = ap.parse_args(argv)
    try:
        args.fn(args)
    except (KeyError, FileNotFoundError, ValueError) as e:
        # Clean one-line errors at the CLI surface; tracebacks on demand.
        if os.environ.get("BTIA_DEBUG"):
            raise
        raise SystemExit(f"error: {e}") from e


if __name__ == "__main__":
    main()
