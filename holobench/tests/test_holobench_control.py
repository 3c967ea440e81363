"""The control: the plain reference computed in the precision below the
configuration's (TF32 operands for the compressed phase product). On the card, at the cell's own size, it has to
fail the cell's limits while the program passes them. On the CPU, at the
rehearsal shapes, where the control moves the numbers less (a smaller SLM
has smaller phases), it has to stand at least a hundred times above the
program on one of the numbers the cell compares."""

import pytest

from conftest import CELLS
from holobench import calibrate, harness, judge


def _fails(numbers, limits):
    return not judge.passed(judge.checks(numbers, limits))


@pytest.mark.parametrize("workload", CELLS)
def test_holobench_control_stands_apart(workload):
    _, config, _, _, _ = harness.load_cell(workload, True)
    out = calibrate.readings(workload, seeds=2, controls=2, rehearse=True)
    assert all(not _fails(r, config["limits"]) for r in out["program"])
    apart = [name for name in config["limits"]
             if min(r[name] for r in out["control"])
             >= 100 * max(r[name] for r in out["program"])]
    assert apart, out


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_holobench_control_fails_the_limits_on_the_card(card, workload):
    _, config, _, _, _ = harness.load_cell(workload)
    out = calibrate.readings(workload, seeds=3, controls=3)
    assert all(not _fails(r, config["limits"]) for r in out["program"])
    assert all(_fails(r, config["limits"]) for r in out["control"]), out["control"]
