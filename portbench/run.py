"""Run one cell of the port's benchmark once:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit,
which also close standard error. Without CUDA, with fewer cards than the
cell asks for, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits with 1, 2 or 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import bench

    bench.env_setup()
    reg = bench.Registry()
    cell = reg.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; a run measures the card and does not fall back", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    run = bench.Run(cell=cell, cfg_file=reg.config(cell["config"]), mix=reg.mix(cell["traffic"]),
                    limits=reg.limits(cell["name"]), seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), t_start=T0)
    bench.drive(run)
    bad = bench.forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process once the window closed: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    breakdown = None
    if run.trace:
        device["busy_s"] = run.ctx["trace"].busy_s
        device["window_s"] = run.ctx["trace"].window_s
        breakdown = run.ctx["trace"].breakdown()
    line = bench.result_line(run, reg, device, breakdown)
    for k, v in sorted(run.info.items()):
        print(f"info {k}: {v}", file=sys.stderr)
    bench.print_checks(run)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
