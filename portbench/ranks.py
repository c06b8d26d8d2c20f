"""The ranks of a cell that runs on several cards: the process that runs the
cell is rank 0 and starts the others as

    python3 -m portbench.ranks <run file> <rank>

each with torch.distributed's rendezvous in its environment (localhost, a
free port, the world size, its rank and local rank), one card a rank. Rank
0 waits for every other rank to end; a rank that fails or outlives the
limit fails the run.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

from portbench import bench

RANK_LIMIT_S = 900.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rendezvous(rank: int, world: int, port: int) -> dict:
    return {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": str(world),
            "RANK": str(rank), "LOCAL_RANK": str(rank)}


_FIELDS = ("cell", "cfg_file", "mix", "limits", "seed", "seconds", "trace", "device", "overrides", "fault",
           "variant", "t_start")


def start(r: bench.Run, world: int) -> list:
    """Start ranks 1 .. world - 1 for the run `r` (rank 0 is this process,
    whose environment gets the rendezvous too). Returns their processes."""
    port = free_port()
    spec = r.scratch / "run.json"
    spec.write_text(json.dumps({k: getattr(r, k) for k in _FIELDS}))
    os.environ.update(rendezvous(0, world, port))
    procs = []
    for rank in range(1, world):
        log = open(r.scratch / f"rank{rank}.log", "w")
        procs.append(subprocess.Popen([sys.executable, "-m", "portbench.ranks", str(spec), str(rank)],
                                      env={**os.environ, **rendezvous(rank, world, port)},
                                      cwd=bench.ROOT, stdout=log, stderr=subprocess.STDOUT))
    return procs


def join(r: bench.Run, procs: list) -> list:
    """Wait for the other ranks; returns what each reported. A rank that
    fails or does not end in time is stopped and fails the run."""
    for k in rendezvous(0, 1, 0):
        os.environ.pop(k, None)
    deadline = time.perf_counter() + RANK_LIMIT_S
    out = []
    for i, p in enumerate(procs, start=1):
        try:
            code = p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            code = "timeout"
        if code != 0:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
            log = (r.scratch / f"rank{i}.log").read_text()[-4000:]
            raise RuntimeError(f"rank {i} ended with {code}:\n{log}")
        out.append(json.loads((r.scratch / f"rank{i}.json").read_text()))
    return out


def main(argv=None) -> int:
    spec, rank = (argv or sys.argv[1:])[:2]
    fields = json.loads(Path(spec).read_text())
    bench.env_setup()
    run = bench.Run(**fields)
    run.rank = int(rank)
    run.scratch = Path(spec).parent / f"rank{rank}"
    run.scratch.mkdir(exist_ok=True)
    from portbench.drivers import train

    train.run(run)
    Path(spec).with_name(f"rank{rank}.json").write_text(json.dumps({"memory_peak_bytes": run.memory_peak_bytes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

