"""The comparison that decides ``correct`` fails each fault a cell can
have, planted underneath the timed path, and fails the lower-precision
control of the train cells; on the CPU at a tiny size, the harness's look
for a card skipped. The serve cells' control (the program's int8 FFNs) is
held at the cells' own size on the card (``test_portbench_chip.py``); the
readings that set the limits come from ``python3 -m portbench.calibrate``."""

import pytest

from portbench.bench import Registry
from portbench.tests.tiny import tiny_run

KINDS = {w["name"]: Registry().mix(w["traffic"])["kind"] for w in Registry().benchmark()["workloads"]}
SERVE = [c for c, k in KINDS.items() if k == "serve"]
TRAIN = [c for c, k in KINDS.items() if k == "train"]


@pytest.mark.parametrize("cell", SERVE)
def test_an_altered_answer_is_not_correct(cell):
    run = tiny_run(cell, fault="alter_answer")
    assert not run.correct, run.checks


@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("fault, caught_by", [("ascending_topk", "bad_answers"), ("partial_topk", "topk_gap_sd"),
                                              ("one_slot", "worst_request_off_pct")])
def test_wrong_answers_with_right_values_are_not_correct(cell, fault, caught_by):
    """The top-k served in the wrong order, or over part of the answers with
    the right values at the ids it serves, or one image slot's requests
    given another image's answers: each fails the number that is there for
    it."""
    run = tiny_run(cell, fault=fault)
    assert not run.checks[caught_by]["ok"], run.checks


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(cell, fault):
    run = tiny_run(cell, fault=fault)
    assert not run.correct, run.checks


@pytest.mark.parametrize("cell", TRAIN)
def test_the_fp8_control_is_not_correct(cell):
    run = tiny_run(cell, variant="control")
    assert not run.correct, run.checks

