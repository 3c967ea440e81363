"""
Basler cameras via :mod:`pypylon`.

Parity: reference ``slmsuite/hardware/cameras/basler.py`` (``Basler``).
"""

import numpy as np

from slmsuite_torch.hardware import _optional_import
from slmsuite_torch.hardware.cameras.camera import Camera

pylon = None  # Imported by _import_sdk() when the hardware is built.


def _import_sdk():
    """pypylon's pylon, imported on first use; None where it is not installed."""
    global pylon
    if pylon is None:
        pylon = _optional_import("pypylon.pylon")
    return pylon


class Basler(Camera):
    """Basler camera through the pylon SDK."""

    def __init__(self, serial="", verbose=True, **kwargs):
        """
        Parameters
        ----------
        serial : str
            Serial number; empty selects the first camera found.
        **kwargs
            Passed to :meth:`.Camera.__init__`.
        """
        if _import_sdk() is None:
            raise ImportError("pypylon is required for Basler cameras.")

        factory = pylon.TlFactory.GetInstance()
        devices = factory.EnumerateDevices()
        if not devices:
            raise RuntimeError("No Basler cameras found.")

        device = None
        if serial:
            for candidate in devices:
                if candidate.GetSerialNumber() == str(serial):
                    device = candidate
                    break
            if device is None:
                raise RuntimeError(f"Basler camera with serial {serial} not found.")
        else:
            device = devices[0]

        if verbose:
            print(f"Basler {device.GetSerialNumber()} initializing... ", end="")
        self.cam = pylon.InstantCamera(factory.CreateDevice(device))
        self.cam.Open()

        # Manual exposure/gain; no gamma; mono format.
        self.cam.ExposureAuto.SetValue("Off")
        self.cam.GainAuto.SetValue("Off")
        try:
            self.cam.Gamma.SetValue(1.0)
        except Exception:
            pass

        pixel_format = str(self.cam.PixelFormat.GetValue())
        bitdepth = 12 if "12" in pixel_format else (10 if "10" in pixel_format else 8)
        width = int(self.cam.Width.GetMax())
        height = int(self.cam.Height.GetMax())
        self.cam.Width.SetValue(width)
        self.cam.Height.SetValue(height)
        if verbose:
            print("success")

        super().__init__(
            (width, height),
            bitdepth=bitdepth,
            name=f"Basler_{device.GetSerialNumber()}",
            **kwargs,
        )

    def close(self):
        """Close the camera."""
        if getattr(self, "cam", None) is not None:
            self.cam.Close()
            self.cam = None

    @staticmethod
    def close_sdk():
        """pylon holds no process-level state beyond open cameras; kept
        for API parity with SDK-context drivers."""

    def get_properties(self, properties=None):
        """Print name/value for pylon node-map features (all when ``None``)."""
        nodemap = self.cam.GetNodeMap()
        if properties is None:
            properties = [node.GetNode().GetName() for node in nodemap.GetNodes()]
        for name in properties:
            try:
                node = nodemap.GetNode(name)
                print(name, node.ToString() if node is not None else "?", sep="\t")
            except Exception as err:
                print(f"Error accessing property '{name}': {err}")

    def set_adc_bitdepth(self, bitdepth):
        """Set the digitization bitdepth via the ``PixelSize`` enum."""
        bitdepth = int(bitdepth)
        for entry in self.cam.PixelSize.GetEntries():
            name = entry.GetNode().GetName()
            if str(bitdepth) in name:
                self.cam.PixelSize.SetValue(entry.GetValue())
                return
        raise RuntimeError(f"ADC bitdepth {bitdepth} not found.")

    def get_adc_bitdepth(self):
        """Current digitization bitdepth."""
        value = str(self.cam.PixelSize.GetValue())
        return int("".join(char for char in value if char.isdigit()))

    def is_grabbing(self):
        """Whether the camera is actively grabbing images."""
        return bool(self.cam.IsGrabbing())

    def _set_woi_hw(self, woi):
        # Shrink first so the new offsets cannot exceed sensor bounds.
        self.cam.Height.SetValue(8)
        self.cam.Width.SetValue(8)
        x, w, y, h = woi
        self.cam.OffsetX.SetValue(x)
        self.cam.OffsetY.SetValue(y)
        self.cam.Height.SetValue(h)
        self.cam.Width.SetValue(w)

    def set_woi(self, woi=None):
        """Set the hardware window of interest ``(x, width, y, height)``;
        restores the previous window if the request is rejected."""
        maxwoi = (0, int(self.cam.Width.GetMax()), 0, int(self.cam.Height.GetMax()))
        if woi is None:
            woi = maxwoi
        try:
            self._set_woi_hw(woi)
            self.woi = tuple(int(v) for v in woi)
        except Exception:
            self._set_woi_hw(self.woi if self.woi is not None else maxwoi)
            raise
        self.shape = (self.woi[3], self.woi[1])
        return self.woi

    @staticmethod
    def info(verbose=True):
        """Return serial numbers of connected Basler cameras."""
        if _import_sdk() is None:
            raise ImportError("pypylon is required.")
        devices = pylon.TlFactory.GetInstance().EnumerateDevices()
        serials = [device.GetSerialNumber() for device in devices]
        if verbose:
            print("Basler serials:", serials)
        return serials

    def _get_exposure_hw(self):
        # USB3 models expose ExposureTime (us); GigE models ExposureTimeAbs.
        try:
            return float(self.cam.ExposureTime.GetValue()) / 1e6
        except Exception:
            return float(self.cam.ExposureTimeAbs.GetValue()) / 1e6

    def _set_exposure_hw(self, exposure_s):
        try:
            self.cam.ExposureTime.SetValue(float(exposure_s * 1e6))
        except Exception:
            self.cam.ExposureTimeAbs.SetValue(float(exposure_s * 1e6))

    def _get_image_hw(self, timeout_s=1):
        result = self.cam.GrabOne(int(timeout_s * 1e3))
        if not result.GrabSucceeded():
            raise RuntimeError(
                f"Basler grab failed: {result.GetErrorDescription()}."
            )
        frame = np.array(result.GetArray(), copy=True)
        result.Release()
        return frame
