"""The ``compressed`` driver: one client that builds a new
:class:`CompressedSpotHologram` of 3D spots for every request, as
``examples/zernike_holography.py`` does.

The client makes its SLM once, at set-up: a simulated SLM whose measured
source amplitude is the configuration's illumination (``slm.source``: a
centred Gaussian, ``gaussian2d``, of ``w_frac`` of each side, as a wavefront
calibration would record it; none means uniform). A request draws a lattice
of spots from the seed (kx, ky on a grid in +-``extent`` with a jitter of up
to ``jitter`` of the spacing, focal power uniform in +-``focus``, and, past
the three kxy terms, every other Zernike term uniform in
+-``aberration_rad`` with piston 0), converts the kxy rows to Zernike
coefficients with the toolbox, builds the hologram on the SLM (its Zernike
basis with it), gives it an initial phase drawn on the device by a seeded
``torch.Generator``, runs ``optimize`` and copies ``get_phase()`` to the
host.

Traffic keys: ``spots`` ([columns, rows]), ``terms`` (3: the ``kxy`` basis,
ANSI 2, 1, 4; more: ANSI 0 .. terms - 1), ``extent``, ``jitter``,
``focus``, ``aberration_rad`` and ``iterations``.
"""

import math
import warnings

import numpy as np
import torch

from holobench.drivers import request_generator, request_rng


def indices(traffic):
    """The ANSI indices of the traffic's basis."""
    terms = int(traffic["terms"])
    return [2, 1, 4] if terms == 3 else list(range(terms))


def draw_coefficients(traffic, rng):
    """(D, N) coefficients in ``indices(traffic)`` order, with the rows of
    ANSI 2, 1 and 4 in kxy (normalised kx, ky and focal power)."""
    cols, rows = traffic["spots"]
    extent, jitter = float(traffic["extent"]), float(traffic["jitter"])
    spacing = (2 * extent / max(cols - 1, 1), 2 * extent / max(rows - 1, 1))
    kx, ky = np.meshgrid(np.linspace(-extent, extent, cols), np.linspace(-extent, extent, rows))
    n = kx.size
    kx = kx.ravel() + rng.uniform(-jitter, jitter, n) * spacing[0]
    ky = ky.ravel() + rng.uniform(-jitter, jitter, n) * spacing[1]
    focus = rng.uniform(-traffic["focus"], traffic["focus"], n)
    idx = indices(traffic)
    coeffs = rng.uniform(-traffic["aberration_rad"], traffic["aberration_rad"], (len(idx), n))
    rows_of = {j: i for i, j in enumerate(idx)}
    if 0 in rows_of:
        coeffs[rows_of[0]] = 0.0
    coeffs[[rows_of[2], rows_of[1], rows_of[4]]] = np.vstack([kx, ky, focus])
    return coeffs


def make_slm(slm):
    """The simulated SLM of a configuration's ``slm`` entry, its measured
    source set where the entry gives one."""
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM

    h, w = slm["shape"]
    out = SimulatedSLM(resolution=(w, h), pitch_um=tuple(slm["pitch_um"]), wav_um=slm["wav_um"])
    source = slm.get("source")
    if source is not None:
        frac = float(source["w_frac"])
        out.set_source_analytic(source["function"], x0=0, y0=0, a=1, c=0,
                                wx=frac * w * out.pitch[0], wy=frac * h * out.pitch[1])
    return out


class Client:
    """One closed-loop client of the ``compressed`` kind."""

    def __init__(self, config, traffic, device, seed):
        self.config, self.traffic, self.device, self.seed = config, traffic, device, seed
        self.slm_shape = tuple(config["slm"]["shape"])
        self.slm = make_slm(config["slm"])
        self.indices = indices(traffic)
        self.holo = None

    def _spots(self, coeffs):
        """``(kxy, zernike)``: the kxy rows, and every row in Zernike
        coefficients by the toolbox."""
        from slmsuite_torch.holography import toolbox

        rows = [self.indices.index(j) for j in (2, 1, 4)]
        kxy = coeffs[rows]
        zernike = np.array(coeffs, float)
        zernike[rows] = toolbox.convert_vector(kxy, "kxy", "zernike", hardware=self.slm)
        return kxy, zernike

    def draw(self, index):
        """The request's parameters, drawn from the seed (host)."""
        return {"index": index,
                "coefficients": draw_coefficients(self.traffic, request_rng(self.seed, index))}

    def phase0(self, index):
        """The request's initial phase, drawn on the device."""
        gen = request_generator(self.seed, index, self.device)
        return (torch.rand(self.slm_shape, generator=gen, device=self.device) * 2 - 1) * math.pi

    def prep(self, req):
        from slmsuite_torch.holography.algorithms import CompressedSpotHologram

        self.holo = None
        kxy, zernike = self._spots(req["coefficients"])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # Piston in the basis.
            if self.indices == [2, 1, 4]:
                holo = CompressedSpotHologram(kxy, basis="kxy", cameraslm=self.slm,
                                              device=self.device)
            else:
                holo = CompressedSpotHologram(zernike, basis=self.indices, cameraslm=self.slm,
                                              device=self.device)
        holo.reset_phase(custom_phase=self.phase0(req["index"]).cpu().numpy())
        self.holo = holo

    def optimize(self, req):
        c = self.config
        self.holo.optimize(c["method"], maxiter=int(self.traffic["iterations"]),
                           feedback=c["feedback"], stat_groups=list(c["stat_groups"]),
                           verbose=False)

    def readback(self, req):
        return np.asarray(self.holo.get_phase(), dtype=np.float32)

    def outputs(self, req):
        """The final unit farfield's amplitudes, the weights and the last
        stats."""
        holo = self.holo
        stats = holo.stats["stats"][self.config["stat_groups"][-1]]
        return {"spot_amp": np.asarray(holo.amp_ff, dtype=np.float32),
                "weights": np.asarray(holo.get_weights(), dtype=np.float32),
                "efficiency": float(stats["efficiency"][-1]),
                "uniformity": float(stats["uniformity"][-1])}

    def reference_inputs(self, req):
        c = self.config
        return {"slm": c["slm"], "indices": self.indices,
                "coefficients": req["coefficients"], "phase0": self.phase0(req["index"]),
                "iterations": int(self.traffic["iterations"]),
                "feedback_exponent": c["feedback_exponent"],
                "fix_phase_iteration": c["fix_phase_iteration"]}

    def close(self):
        self.holo = None
