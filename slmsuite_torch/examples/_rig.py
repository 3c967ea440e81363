"""
What the examples share: the device and plot switches, a simulated rig, and
the figure and result output.

Every example runs hardware-free: a :class:`SimulatedSLM` (Gaussian source)
imaged by a :class:`SimulatedCamera` through a known affine placement. Swap
:func:`make_rig` for your own ``FourierSLM(camera, slm)`` to run the same
scripts on real hardware.

Each script's ``main(device=..., plots=...)`` runs on ``device`` (the
port's objects take it as their default) and writes its figures into
``OUTPUT_DIR`` when ``plots`` is on; matplotlib is
imported only then. Run as a script, ``--device cpu`` runs on the CPU and
``--no-plots`` draws nothing; the last line printed is ``RESULT`` and the
JSON of the numbers ``main`` returns.
"""

import argparse
import contextlib
import json
import os
import sys

import numpy as np

#: Where the figures go: ``SLMSUITE_TORCH_EXAMPLES_OUTPUT``, else ``output/``
#: beside the scripts.
OUTPUT_DIR = os.environ.get("SLMSUITE_TORCH_EXAMPLES_OUTPUT") or os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "output")


@contextlib.contextmanager
def on_device(device):
    """The port's default device set to ``device`` for the block."""
    import slmsuite_torch

    before = slmsuite_torch.resolve_device()
    slmsuite_torch.set_default_device(device)
    try:
        yield slmsuite_torch.resolve_device()
    finally:
        slmsuite_torch.set_default_device(before)


def make_slm(resolution=(512, 512)):
    """A simulated SLM of ``resolution`` (width, height) with a Gaussian
    source."""
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM

    slm = SimulatedSLM(resolution=resolution, pitch_um=(8, 8), wav_um=0.78)
    slm.set_source_analytic(
        "gaussian2d", sim=True, x0=0, y0=0, a=1, c=0,
        wx=0.35 * resolution[0] * slm.pitch[0],
        wy=0.35 * resolution[1] * slm.pitch[1],
    )
    return slm


def make_rig(resolution=(512, 512)):
    """A ``FourierSLM`` around simulated hardware, on the default device."""
    from slmsuite_torch.hardware.cameras.simulated import SimulatedCamera
    from slmsuite_torch.hardware.cameraslms import FourierSLM

    slm = make_slm(resolution)
    camera = SimulatedCamera(
        slm,
        resolution=resolution,
        pitch_um=(5.5, 5.5),
        M=np.array([[8.0e3, 200.0], [-200.0, 8.0e3]]),
        b=np.array([[resolution[0] / 2], [resolution[1] / 2]]),
    )
    camera.set_exposure(1.0)
    return FourierSLM(camera, slm)


def fourier_calibrate(fs):
    """The rig's Fourier calibration: measured from a spot array
    (:meth:`FourierSLM.fourier_calibrate`, which needs OpenCV); without
    OpenCV, the camera's known placement (:meth:`fourier_calibrate_analytic`),
    and the choice is printed."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        print("  OpenCV is not installed: the analytic Fourier calibration")
        fs.fourier_calibrate_analytic(fs.cam.M, fs.cam.b)
        return "analytic"
    fs.fourier_calibrate(array_shape=5, array_pitch=16, verbose=False)
    return "measured"


def pyplot():
    """matplotlib's pyplot on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_figure(name):
    """Save the current matplotlib figure into ``OUTPUT_DIR``."""
    plt = pyplot()
    os.makedirs(OUTPUT_DIR, exist_ok=True)
    path = os.path.join(OUTPUT_DIR, name)
    plt.savefig(path, dpi=120, bbox_inches="tight")
    plt.close("all")
    print(f"  saved {path}")
    return path


def last(holo, group, key):
    """The last recorded value of a stat of ``holo``."""
    return float(holo.stats["stats"][group][key][-1])


def run(main, shape_arg=False):
    """Run ``main`` from the command line (``--device``, ``--no-plots``,
    and ``--shape H W`` where the example takes a shape) and print its
    result as the last line."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--no-plots", action="store_true", help="draw no figure")
    if shape_arg:
        parser.add_argument("--shape", type=int, nargs=2, default=None)
    args = parser.parse_args()
    kwargs = dict(device=args.device, plots=not args.no_plots)
    if shape_arg and args.shape is not None:
        kwargs["shape"] = tuple(args.shape)
    result = main(**kwargs)
    sys.stdout.flush()
    print("RESULT " + json.dumps(result))
