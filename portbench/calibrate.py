"""Read the numbers that decide ``correct`` on many seeds in one process,
for the program, its lower-precision control or a planted fault, to set
and check a cell's limits (``limits/<cell>.json``):

    python3 -m portbench.calibrate --workload medfull-train --seeds 1,2,3 --variant program --seconds 3

prints one JSON line a seed with each compared number and ``correct``.
``--variant control`` runs the control: for a serve cell the program with
its int8 FFN path switched on, for a train cell the reference with every
product rounded to fp8 put in the program's place. ``--variant <fault>``
plants a fault: serve cells ``alter_answer``, ``ascending_topk``,
``partial_topk``, ``one_slot`` (``drivers/serve.py``); train cells
``state_unchanged``, ``half_batch``, ``no_allreduce`` (``drivers/train.py``).
The benchmark's own runs never run these.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", default="program")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    from portbench import bench

    bench.env_setup()
    import torch

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 1
    reg = bench.Registry()
    cell = reg.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        variant = args.variant if args.variant == "control" else None
        fault = None if args.variant in ("program", "control") else args.variant
        run = bench.Run(cell=cell, cfg_file=reg.config(cell["config"]), mix=reg.mix(cell["traffic"]),
                        limits=reg.limits(cell["name"]), seed=seed, seconds=args.seconds, trace=False,
                        variant=variant, fault=fault, t_start=time.perf_counter())
        bench.drive(run)
        print(json.dumps({"seed": seed, "variant": args.variant, "correct": run.correct,
                          **{k: c["value"] for k, c in run.checks.items()},
                          "e2e": run.e2e, "setup_s": run.setup_s,
                          "memory_peak_gib": run.memory_peak_bytes / 2**30}), flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
