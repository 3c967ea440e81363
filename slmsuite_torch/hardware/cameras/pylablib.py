"""
Adapter exposing any :mod:`pylablib` camera as a slmsuite-tpu
:class:`~slmsuite_torch.hardware.cameras.camera.Camera`.

pylablib wraps dozens of vendor SDKs behind one interface
(``pylablib.devices.*.Camera`` with ``snap``, ``get_exposure``, ...);
this shim forwards to that interface, so every camera pylablib supports
works here.

Parity: reference ``slmsuite/hardware/cameras/pylablib.py`` (``PyLabLib``).
"""

import numpy as np

from slmsuite_torch.hardware import _optional_import
from slmsuite_torch.hardware.cameras.camera import Camera


class PyLabLib(Camera):
    """
    Wraps an already-constructed pylablib camera instance.

    Example
    -------
    .. code-block:: python

        from pylablib.devices import DCAM
        cam = PyLabLib(DCAM.DCAMCamera(idx=0))
    """

    def __init__(self, cam, verbose=True, **kwargs):
        """
        Parameters
        ----------
        cam : pylablib camera
            An opened pylablib camera object (subclass of
            ``pylablib.devices.interface.camera.ICamera``).
        **kwargs
            Passed to :meth:`.Camera.__init__`.
        """
        if _optional_import("pylablib") is None:
            raise ImportError("pylablib is required for this adapter.")
        self.cam = cam

        if verbose:
            print(f"PyLabLib camera {type(cam).__name__} initializing... ", end="")
        # (width, height) from pylablib's detector size.
        width, height = self.cam.get_detector_size()

        # Infer bitdepth from one frame if not supplied.
        bitdepth = kwargs.pop("bitdepth", None)
        if bitdepth is None:
            frame = self.cam.snap()
            bitdepth = 16 if frame.dtype.itemsize > 1 else 8
        if verbose:
            print("success")

        super().__init__(
            (int(width), int(height)),
            bitdepth=int(bitdepth),
            name=kwargs.pop("name", f"PyLabLib_{type(cam).__name__}"),
            **kwargs,
        )

    def close(self):
        """Close the underlying pylablib camera."""
        if getattr(self, "cam", None) is not None:
            self.cam.close()
            self.cam = None

    @staticmethod
    def info(verbose=True):
        """Enumeration is vendor-specific in pylablib; see its docs."""
        raise NotImplementedError(
            "Use the pylablib vendor module's enumeration "
            "(e.g. pylablib.devices.DCAM.get_cameras_number())."
        )

    def _get_exposure_hw(self):
        return float(self.cam.get_exposure())

    def _set_exposure_hw(self, exposure_s):
        self.cam.set_exposure(float(exposure_s))

    def set_woi(self, woi=None):
        """Forward to pylablib's ROI interface ``(x, width, y, height)``."""
        if woi is None:
            self.cam.set_roi()
            width, height = self.cam.get_detector_size()
            woi = (0, width, 0, height)
        else:
            x, w, y, h = (int(v) for v in woi)
            self.cam.set_roi(hstart=x, hend=x + w, vstart=y, vend=y + h)
        self.woi = woi
        return woi

    def _get_image_hw(self, timeout_s=1):
        return np.asarray(self.cam.snap(timeout=timeout_s))
