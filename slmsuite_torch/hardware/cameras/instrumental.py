"""
Adapter exposing any :mod:`instrumental` (instrumental-lib) camera as a
slmsuite-tpu :class:`~slmsuite_torch.hardware.cameras.camera.Camera`.

Parity: reference ``slmsuite/hardware/cameras/instrumental.py``
(``Instrumental``).
"""

import numpy as np

from slmsuite_torch.hardware import _optional_import
from slmsuite_torch.hardware.cameras.camera import Camera

# instrumental-lib's entry points, imported by _import_sdk() when the
# hardware is built.
instrument = None
list_instruments = None
_units = None


def _import_sdk():
    """instrumental-lib's ``instrument``, imported on first use (with
    ``list_instruments`` and its units); None where it is not installed."""
    global instrument, list_instruments, _units
    if instrument is None:
        module = _optional_import("instrumental")
        if module is not None:
            instrument, list_instruments, _units = (
                module.instrument, module.list_instruments, module.u)
    return instrument


class Instrumental(Camera):
    """
    Wraps an instrumental-lib camera (``instrumental.drivers.cameras.Camera``).
    """

    def __init__(self, cam=None, paramset=None, verbose=True, **kwargs):
        """
        Parameters
        ----------
        cam : instrumental camera OR None
            An opened instrumental camera; if None, one is opened from
            ``paramset`` (or the first listed camera).
        paramset
            An entry of :func:`instrumental.list_instruments` to open.
        **kwargs
            Passed to :meth:`.Camera.__init__`.
        """
        if _import_sdk() is None:
            raise ImportError("instrumental-lib is required for this adapter.")

        if cam is None:
            if paramset is None:
                cameras = [
                    p for p in list_instruments() if "camera" in str(p).lower()
                ]
                if not cameras:
                    raise RuntimeError("No instrumental cameras found.")
                paramset = cameras[0]
            cam = instrument(paramset)
        self.cam = cam

        if verbose:
            print(f"Instrumental camera {type(cam).__name__} initializing... ", end="")
        width = int(getattr(cam, "width", 0) or cam.max_width)
        height = int(getattr(cam, "height", 0) or cam.max_height)
        if verbose:
            print("success")

        self._exposure_s = 1e-3
        super().__init__(
            (width, height),
            bitdepth=int(kwargs.pop("bitdepth", 8)),
            name=kwargs.pop("name", f"Instrumental_{type(cam).__name__}"),
            **kwargs,
        )

    def close(self):
        """Close the underlying instrumental camera."""
        if getattr(self, "cam", None) is not None:
            self.cam.close()
            self.cam = None

    @staticmethod
    def info(verbose=True):
        """Return instrumental's instrument paramsets for cameras."""
        if _import_sdk() is None:
            raise ImportError("instrumental-lib is required.")
        found = [p for p in list_instruments() if "camera" in str(p).lower()]
        if verbose:
            print("Instrumental cameras:", found)
        return found

    def set_woi(self, woi=None):
        """Not supported by instrumental's generic camera interface
        (parity with the reference driver)."""
        raise NotImplementedError()

    def _get_exposure_hw(self):
        # instrumental has no exposure getter on the base interface;
        # the last set value is tracked host-side.
        return self._exposure_s

    def _set_exposure_hw(self, exposure_s):
        self._exposure_s = float(exposure_s)

    def _get_image_hw(self, timeout_s=1):
        frame = self.cam.grab_image(
            timeout=f"{timeout_s}s", copy=True,
            exposure_time=f"{self._exposure_s * 1e3}ms",
        )
        return np.squeeze(np.asarray(frame))
