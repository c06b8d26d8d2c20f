"""On the card, at each cell's own size: a short run of the program is
correct, and its lower-precision control is not (the serve cells: the
program with its int8 FFN path switched on; the train cells: the reference
with every product rounded to fp8 in the program's place). Run on the card
with ``python3 -m pytest portbench/tests/test_portbench_chip.py``; skipped
where there is none."""

import time

import pytest

from portbench import bench

CELLS = [w["name"] for w in bench.Registry().benchmark()["workloads"] if w["chips"] == 1]


def run(cell: str, seed: int, variant=None) -> bench.Run:
    reg = bench.Registry()
    w = reg.cell(cell)
    r = bench.Run(cell=w, cfg_file=reg.config(w["config"]), mix=reg.mix(w["traffic"]), limits=reg.limits(cell),
                  seed=seed, seconds=3.0, trace=False, variant=variant, t_start=time.perf_counter())
    return bench.drive(r)


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct_and_its_control_is_not(card, cell):
    bench.env_setup()
    assert run(cell, 3_400_000_001).correct
    control = run(cell, 3_400_000_002, variant="control")
    assert not control.correct, control.checks
