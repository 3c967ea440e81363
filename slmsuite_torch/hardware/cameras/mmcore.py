"""
Micro-Manager-controlled cameras via :mod:`pymmcore` (MMCore).

Any camera with a Micro-Manager device adapter works: point this driver
at your Micro-Manager install and a device config.

Parity: reference ``slmsuite/hardware/cameras/mmcore.py`` (``MMCore``).
"""

import os

import numpy as np

from slmsuite_torch.hardware import _optional_import
from slmsuite_torch.hardware.cameras.camera import Camera

pymmcore = None  # Imported by _import_sdk() when the hardware is built.


def _import_sdk():
    """pymmcore (Micro-Manager), imported on first use; None where it is not installed."""
    global pymmcore
    if pymmcore is None:
        pymmcore = _optional_import("pymmcore")
    return pymmcore

_DEFAULT_MM_PATHS = [
    "C:\\Program Files\\Micro-Manager-2.0",
    "/usr/local/lib/micro-manager",
    "/opt/micro-manager",
]


class MMCore(Camera):
    """Camera through Micro-Manager's core."""

    def __init__(
        self,
        config_path=None,
        adapter_name=None,
        device_name=None,
        mm_path=None,
        verbose=True,
        **kwargs,
    ):
        """
        Parameters
        ----------
        config_path : str OR None
            A Micro-Manager ``.cfg`` system configuration to load.
        adapter_name, device_name : str OR None
            Alternatively, load a single camera device directly
            (e.g. ``adapter_name='DemoCamera'``, ``device_name='DCam'``).
        mm_path : str OR None
            Micro-Manager install directory for device adapters.
        **kwargs
            Passed to :meth:`.Camera.__init__`.
        """
        if _import_sdk() is None:
            raise ImportError("pymmcore is required for Micro-Manager cameras.")
        if verbose:
            print("MMCore initializing... ", end="")
        self.core = pymmcore.CMMCore()

        paths = [mm_path] if mm_path else []
        paths += [p for p in _DEFAULT_MM_PATHS if os.path.isdir(p)]
        if paths:
            self.core.setDeviceAdapterSearchPaths(paths)

        if config_path is not None:
            self.core.loadSystemConfiguration(config_path)
        elif adapter_name is not None:
            label = device_name or "Camera"
            self.core.loadDevice(label, adapter_name, device_name or label)
            self.core.initializeAllDevices()
            self.core.setCameraDevice(label)
        else:
            raise ValueError("Provide config_path or adapter_name/device_name.")

        self.core.snapImage()  # Prime geometry.
        width = int(self.core.getImageWidth())
        height = int(self.core.getImageHeight())
        bitdepth = int(self.core.getImageBitDepth())
        if verbose:
            print("success")

        super().__init__(
            (width, height),
            bitdepth=bitdepth,
            name=kwargs.pop("name", f"MMCore_{self.core.getCameraDevice()}"),
            **kwargs,
        )

    def close(self):
        """Unload all Micro-Manager devices."""
        if getattr(self, "core", None) is not None:
            self.core.unloadAllDevices()
            self.core = None

    @staticmethod
    def info(verbose=True):
        """Micro-Manager enumerates via config files; none to list here."""
        raise NotImplementedError(
            "Device discovery is configuration-driven in Micro-Manager; "
            "pass config_path or adapter_name to MMCore()."
        )

    def _get_exposure_hw(self):
        return float(self.core.getExposure()) / 1e3

    def _set_exposure_hw(self, exposure_s):
        self.core.setExposure(float(exposure_s * 1e3))

    def set_woi(self, woi=None):
        """Set the hardware ROI ``(x, width, y, height)``."""
        if woi is None:
            self.core.clearROI()
            woi = (0, self.default_shape[1], 0, self.default_shape[0])
        else:
            x, w, y, h = (int(v) for v in woi)
            self.core.setROI(x, y, w, h)
        self.woi = woi
        return woi

    def _get_image_hw(self, timeout_s=1):
        self.core.snapImage()
        return np.copy(self.core.getImage())
