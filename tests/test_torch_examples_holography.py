"""
The port's computational examples run on the CPU, in a subprocess, with
plots (``tests/_torch_examples.py``): structured light, computational and
batched holography.
"""

import pytest

from _torch_examples import run_example


@pytest.mark.parametrize("name", ["structured_light", "computational_holography",
                                  "batched_holography"])
def test_example_runs(name, tmp_path):
    result = run_example(name, tmp_path)
    if name == "structured_light":
        assert result["patterns"] == 9
    if name == "computational_holography":
        assert result["spot_efficiency"] > 0.5 and result["spot_uniformity"] > 0.9
    if name == "batched_holography":
        assert abs(result["frame_efficiency_min"] - result["solo_efficiency"]) < 1e-3
