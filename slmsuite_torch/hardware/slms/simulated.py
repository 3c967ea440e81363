"""
A simulated SLM (port of :mod:`slmsuite_tpu.hardware.slms.simulated`):
the write stores the display, and the ``"amplitude_sim"`` /
``"phase_sim"`` source keys are the illumination a simulated camera sees.
"""

import numpy as np

from slmsuite_torch.hardware.slms.slm import SLM


class SimulatedSLM(SLM):
    """A virtual SLM with a ground-truth ``source`` (uniform amplitude and
    flat phase by default)."""

    def __init__(self, resolution, pitch_um=(8, 8), source=None, **kwargs):
        """Explicit sim keys in ``source`` win; a measured-only source
        derives them (the sim phase is the negative of the measured
        correction); no source means uniform, flat illumination."""
        super().__init__(resolution, pitch_um=pitch_um, settle_time_s=0, **kwargs)

        self.source.update(source or {})
        if "amplitude_sim" not in self.source:
            truth = (
                {
                    "amplitude_sim": self.source["amplitude"],
                    "phase_sim": -self.source["phase"],
                }
                if source
                else {
                    "amplitude_sim": np.ones_like(self.grid[0]),
                    "phase_sim": np.zeros_like(self.grid[0]),
                }
            )
            self.source.update(truth)

        self.set_phase(None)

    def close(self):
        pass

    def _set_phase_hw(self, display):
        """No hardware: :meth:`set_phase` has already written
        :attr:`display` and :attr:`phase`."""
