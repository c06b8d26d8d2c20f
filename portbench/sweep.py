"""Find the highest rate an open-loop serve cell sustains, once, on the chip:

    python3 -m portbench.sweep --workload vitl-mixed-open --rates 200,300,400 --seconds 10 --seed 7

runs the cell's mix at each rate in turn (each a full set-up and window in
this process) and prints one JSON line a rate: the p50 and p95 due-time
latency, the share of due requests answered by the end of the drain, how
late the generator ran at the end (the backlog), and whether the rate is
sustained: p95 at most 1,000 ms, at least 99 % answered, and the backlog
not growing (the last request handed out less than 250 ms late).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests/s")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    from portbench import bench

    bench.env_setup()
    import torch

    if not torch.cuda.is_available():
        print("portbench.sweep: no CUDA device", file=sys.stderr)
        return 1
    reg = bench.Registry()
    cell = reg.cell(args.workload)
    best = None
    for rate in (float(x) for x in args.rates.split(",")):
        mix = copy.deepcopy(reg.mix(cell["traffic"]))
        mix["rate_rps"] = rate
        run = bench.Run(cell=cell, cfg_file=reg.config(cell["config"]), mix=mix, limits=reg.limits(cell["name"]),
                        seed=args.seed, seconds=args.seconds, trace=False, t_start=time.perf_counter())
        bench.drive(run)
        i = run.info
        ok = bool(run.e2e["latency_p95_ms"] <= 1000.0 and i["answered_share"] >= 0.99
                  and i["generator_late_ms_end"] < 250.0)
        best = rate if ok and (best is None or rate > best) else best
        print(json.dumps({"rate_rps": rate, "p50_ms": run.ctx["latency_p50_ms"],
                          "p95_ms": run.e2e["latency_p95_ms"], "answered_share": i["answered_share"],
                          "late_end_ms": i["generator_late_ms_end"], "late_max_ms": i["generator_late_ms_max"],
                          "pairs_per_s": run.e2e["pairs_per_s"], "launches": i["launches"],
                          "pair_fill": 100.0 * i["real_pairs"] / max(i["slot_pairs"], 1),
                          "correct": run.correct, "sustained": ok}), flush=True)
    print(json.dumps({"knee_rps": best, "chosen_rps": None if best is None else 0.8 * best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
