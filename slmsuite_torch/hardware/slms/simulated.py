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
        """No hardware, but the written data is stored, so that a write
        that bypasses the local :meth:`set_phase` (a remote client's, which
        ships only the integer display) reaches the simulation: the
        display is range-checked and stored, and :attr:`phase` follows it
        by the inverse mapping of ``set_phase``'s integer path. A local
        write has already stored both."""
        display = np.asarray(display)
        if display is self.display:
            return  # The local write stored both.
        if display.shape != self.display.shape:
            raise ValueError(
                f"Display write of shape {display.shape} does not match "
                f"the SLM shape {self.display.shape}."
            )
        # Range-check like set_phase's integer fast path: silently
        # narrowing >= bitresolution values via astype would render
        # wrapped garbage for a buggy remote client without any error.
        if not np.issubdtype(display.dtype, np.integer):
            raise TypeError(
                f"Expected integer display data; got {display.dtype}."
            )
        if display.size and (
            np.any(display >= self.bitresolution) or np.any(display < 0)
        ):
            raise TypeError(
                f"Display data exceeds the SLM bitdepth "
                f"(bitresolution={self.bitresolution}): range "
                f"[{display.min()}, {display.max()}]."
            )
        np.copyto(self.display, display.astype(self.display.dtype))
        self.phase = 2 * np.pi - self.display * (
            2 * np.pi / self.phase_scaling / self.bitresolution
        )
