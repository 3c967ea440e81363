"""
The port's mesh, multipoint-calibration and remote-hardware examples run on
the CPU, in a subprocess, with plots (``tests/_torch_examples.py``); the
remote example serves and drives its hardware on loopback.
"""

import pytest

from _torch_examples import run_example


@pytest.mark.parametrize("name", ["multichip_scaling", "multipoint_calibration",
                                  "remote_hardware"])
def test_example_runs(name, tmp_path):
    result = run_example(name, tmp_path)
    if name == "multipoint_calibration":
        assert set(result) == {"term_2", "term_3", "term_4"}
    if name == "remote_hardware":
        assert result["flush_ms"] > 0
