"""Fixtures of holobench's tests. A test marked ``cuda`` asks for the
``card`` fixture, which decides at run time whether a card is there."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def run_inline(workload, root=ROOT, trace=0, seconds=0.3, seed=2718281828):
    """``(line, stderr)`` of a ``--rehearse`` run driven in this process."""
    import contextlib
    import io
    import time

    from holobench import harness

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds",
                           str(seconds), "--trace", str(trace), "--rehearse"],
                          time.perf_counter(), root=root)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.fixture()
def card():
    """The first CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")
    return torch.device("cuda", 0)


@pytest.fixture()
def run_cell():
    """``run_cell(workload, trace=0, seconds=0.5, root=ROOT)``: the last line
    of a ``--rehearse`` run of ``holobench/run.py``, parsed."""
    import subprocess

    def run(workload, trace=0, seconds=2.0, root=ROOT):
        done = subprocess.run(
            [sys.executable, str(Path(root) / "holobench" / "run.py"), "--workload", workload,
             "--seed", "4294967311", "--seconds", str(seconds), "--trace", str(trace),
             "--rehearse"],
            cwd=root, capture_output=True, text=True, timeout=600)
        assert done.returncode == 0, done.stderr[-4000:]
        return json.loads(done.stdout.strip().splitlines()[-1]), done.stderr

    return run
