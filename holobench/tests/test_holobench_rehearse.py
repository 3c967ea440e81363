"""Each cell, rehearsed on the CPU at tiny shapes, from the command to the
last line's keys."""

import pytest

from conftest import CELLS, MANIFEST, ROOT


def check_line(line, err, workload, trace):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, err[-3000:]
    assert line["failed"] == 0 and line["attempted"] >= 1
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in MANIFEST[kind]
             if "workloads" not in m or workload in m["workloads"]}
    assert set(line["metrics"]) == names
    # A rehearsal writes no number under a device metric's name.
    assert all(m["value"] is None for m in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    assert line["checks"] and all(
        c["value"] <= c["limit"] for c in line["checks"].values())
    # The numbers compared end standard error, each beside its limit.
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_holobench_cell_rehearsal(run_cell, workload, trace):
    line, err = run_cell(workload, trace=trace)
    check_line(line, err, workload, trace)


def test_holobench_refuses_without_card():
    """Without ``--rehearse`` a run on a machine with no card exits non-zero
    and prints no result."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    done = subprocess.run(
        [sys.executable, "holobench/run.py", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
