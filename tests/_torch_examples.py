"""
Running the port's examples in a subprocess on the CPU, with plots, for
``tests/test_torch_examples_*.py``: each exits 0, prints its ``RESULT``
line, writes its figures, and its efficiencies and uniformities are finite
and in [0, 1] (up to float32 rounding).
"""

import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The float32 rounding an efficiency or uniformity may carry past 1.
F32_SLACK = 1e-6

#: The figures each example writes.
FIGURES = {
    "structured_light": ["structured_light_patterns.png", "structured_light_imprint.png"],
    "computational_holography": ["computational_spot_array.png", "computational_stats.png",
                                 "computational_mraf_ring.png"],
    "batched_holography": ["batched_frame0.png", "batched_frame_last.png"],
    "zernike_holography": [],
    "experimental_holography": ["experimental_spots.png"],
    "multichip_scaling": [],
    "wavefront_calibration": ["wavefront_calibration.png"],
    "multipoint_calibration": ["multipoint_calibration.png"],
    "remote_hardware": ["remote_hardware.png"],
}


def run_example(name, output):
    """Run ``slmsuite_torch.examples.<name>`` on the CPU with plots into
    ``output``; return its result."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
               SLMSUITE_TORCH_EXAMPLES_OUTPUT=str(output), MPLBACKEND="Agg")
    done = subprocess.run(
        [sys.executable, "-m", f"slmsuite_torch.examples.{name}", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert done.returncode == 0, f"{name} failed:\n{done.stdout[-2000:]}\n{done.stderr[-3000:]}"
    last = done.stdout.strip().splitlines()[-1]
    assert last.startswith("RESULT "), last
    result = json.loads(last[len("RESULT "):])
    for key, value in result.items():
        if "efficiency" in key or "uniformity" in key:
            # F32_SLACK: an efficiency of 1 summed in float32.
            assert math.isfinite(value) and 0 <= value <= 1 + F32_SLACK, (key, value)
    for figure in FIGURES[name]:
        assert os.path.getsize(os.path.join(output, figure)) > 0, figure
    return result
