"""
HOLOEYE SLMs via the HOLOEYE SLM Display SDK (python module ``holoeye``).

Parity: reference ``slmsuite/hardware/slms/holoeye.py`` (``Holoeye``).
"""

import numpy as np

from slmsuite_torch.hardware import _optional_import
from slmsuite_torch.hardware.slms.slm import SLM

slmdisplaysdk = None  # Imported by _import_sdk() when the hardware is built.


def _import_sdk():
    """HOLOEYE's slmdisplaysdk, imported on first use; None where it is not installed."""
    global slmdisplaysdk
    if slmdisplaysdk is None:
        slmdisplaysdk = _optional_import("holoeye.slmdisplaysdk")
    return slmdisplaysdk


class Holoeye(SLM):
    """
    HOLOEYE SLM through the vendor SLM Display SDK.

    The SDK owns the display window and accepts 8-bit grayscale frames;
    :meth:`_set_phase_hw` hands it the integer phase image directly.
    """

    def __init__(self, verbose=True, wav_um=1, pitch_um=(8, 8), **kwargs):
        """
        Parameters
        ----------
        verbose : bool
            Print connection progress.
        wav_um, pitch_um, **kwargs
            See :meth:`.SLM.__init__`.
        """
        if _import_sdk() is None:
            raise ImportError(
                "The `holoeye` package (HOLOEYE SLM Display SDK) is required."
            )
        if verbose:
            print("HOLOEYE SLM initializing... ", end="")
        self.slm_sdk = slmdisplaysdk.SLMInstance()
        error = self.slm_sdk.open()
        self._check(error)
        if verbose:
            print("success")

        super().__init__(
            (int(self.slm_sdk.width_px), int(self.slm_sdk.height_px)),
            bitdepth=8,
            name=kwargs.pop("name", "Holoeye"),
            wav_um=wav_um,
            pitch_um=pitch_um,
            **kwargs,
        )
        self.set_phase(None)

    def _check(self, error):
        if error != slmdisplaysdk.ErrorCode.NoError:
            raise RuntimeError(
                "HOLOEYE SDK error: " + self.slm_sdk.errorString(error)
            )

    def _set_phase_hw(self, display):
        data = np.ascontiguousarray(display, dtype=np.uint8)
        error = self.slm_sdk.showData(data)
        self._check(error)

    def load_vendor_phase_correction(self, file_path):
        """
        Load a HOLOEYE-provided wavefront-compensation file *directly
        into the SDK* (the SDK applies it to every subsequent frame) —
        this bypasses the framework's ``source["phase"]`` convention.
        """
        error = self.slm_sdk.wavefrontcompensationLoad(
            str(file_path), self.wav_um * 1e3, 0, False, 0, 0
        )
        self._check(error)

    def close(self):
        """Close the SDK display window."""
        if getattr(self, "slm_sdk", None) is not None:
            self.slm_sdk.close()
            self.slm_sdk = None

    @staticmethod
    def info(verbose=True):
        """The HOLOEYE SDK connects to the single configured device."""
        if _import_sdk() is None:
            raise ImportError("The `holoeye` package is required.")
        if verbose:
            print("HOLOEYE SDK present; device selection is SDK-managed.")
        return []
