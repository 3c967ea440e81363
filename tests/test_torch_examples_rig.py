"""
The port's examples on the simulated rig run on the CPU, in a subprocess,
with plots (``tests/_torch_examples.py``): Zernike holography,
experimental holography and the superpixel wavefront calibration.
"""

import pytest

from _torch_examples import run_example


@pytest.mark.parametrize("name", ["zernike_holography", "experimental_holography",
                                  "wavefront_calibration"])
def test_example_runs(name, tmp_path):
    result = run_example(name, tmp_path)
    if name == "zernike_holography":
        assert result["lattice_cv"] < 0.05
    if name == "experimental_holography":
        assert result["placement_error_px"] <= 3
    if name == "wavefront_calibration":
        assert result["strehl_gain"] > 1
