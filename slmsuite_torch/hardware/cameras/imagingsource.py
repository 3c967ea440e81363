"""
The Imaging Source cameras via :mod:`imagingcontrol4` (IC4).

Parity: reference ``slmsuite/hardware/cameras/imagingsource.py``
(``ImagingSource``).
"""

import numpy as np

from slmsuite_torch.hardware import _optional_import
from slmsuite_torch.hardware.cameras.camera import Camera

ic4 = None  # Imported by _import_sdk() when the hardware is built.


def _import_sdk():
    """imagingcontrol4, imported on first use; None where it is not installed."""
    global ic4
    if ic4 is None:
        ic4 = _optional_import("imagingcontrol4")
    return ic4


class ImagingSource(Camera):
    """The Imaging Source camera through the IC4 SDK."""

    _library_initialized = False

    def __init__(self, serial="", verbose=True, **kwargs):
        """
        Parameters
        ----------
        serial : str
            Device serial; empty selects the first device found.
        **kwargs
            Passed to :meth:`.Camera.__init__`.
        """
        if _import_sdk() is None:
            raise ImportError(
                "imagingcontrol4 (IC4) is required for Imaging Source cameras."
            )
        ImagingSource.init_sdk()

        devices = ic4.DeviceEnum.devices()
        if not devices:
            raise RuntimeError("No Imaging Source cameras found.")
        device = None
        if serial:
            for candidate in devices:
                if candidate.serial == str(serial):
                    device = candidate
                    break
            if device is None:
                raise RuntimeError(f"Imaging Source serial {serial} not found.")
        else:
            device = devices[0]

        if verbose:
            print(f"ImagingSource {device.serial} initializing... ", end="")
        self.grabber = ic4.Grabber()
        self.grabber.device_open(device)
        self.prop_map = self.grabber.device_property_map

        for name, value in [
            ("ExposureAuto", "Off"), ("GainAuto", "Off"), ("Gain", 0.0),
        ]:
            try:
                self.prop_map.set_value(name, value)
            except ic4.IC4Exception:
                pass

        width = int(self.prop_map.get_value_int("Width"))
        height = int(self.prop_map.get_value_int("Height"))

        self.sink = ic4.SnapSink()
        self.grabber.stream_setup(
            self.sink, setup_option=ic4.StreamSetupOption.ACQUISITION_START
        )
        if verbose:
            print("success")

        super().__init__(
            (width, height),
            bitdepth=8,
            name=f"ImagingSource_{device.serial}",
            **kwargs,
        )

    def close(self):
        """Stop the stream and close the device."""
        if getattr(self, "grabber", None) is not None:
            if self.grabber.is_streaming:
                self.grabber.stream_stop()
            self.grabber.device_close()
            self.grabber = None

    @classmethod
    def init_sdk(cls):
        """Initialize the IC4 library once per process."""
        if _import_sdk() is None:
            raise ImportError("imagingcontrol4 is required.")
        if not cls._library_initialized:
            ic4.Library.init()
            cls._library_initialized = True

    @staticmethod
    def safe_call(cb, to_raise, *args, **kwargs):
        """
        Call ``cb(*args, **kwargs)``, converting an SDK failure into an
        exception (``to_raise``) or a printed warning. Returns the result
        or the caught exception.

        Reference-API parity (ref ``imagingsource.py:68``): the
        reference wraps its legacy DLL calls with this; the modern ic4
        binding used here raises natively, so internal paths do not need
        it — it remains public for user scripts written against the
        reference.
        """
        try:
            return cb(*args, **kwargs)
        except Exception as err:
            message = f"Error performing operation {cb.__name__}: {err}"
            if to_raise:
                raise RuntimeError(message) from err
            print(message)
            return err

    @staticmethod
    def info(verbose=True):
        """Return serials of connected Imaging Source cameras."""
        ImagingSource.init_sdk()
        serials = [device.serial for device in ic4.DeviceEnum.devices()]
        if verbose:
            print("ImagingSource serials:", serials)
        return serials

    def set_woi(self, woi=None):
        """Set the hardware window of interest ``(x, width, y, height)``;
        the stream is stopped and re-armed around the geometry change."""
        streaming = self.grabber.is_streaming
        if streaming:
            self.grabber.stream_stop()
        try:
            if woi is None:
                for name in ("OffsetX", "OffsetY"):
                    try:
                        self.prop_map.set_value(name, 0)
                    except ic4.IC4Exception:
                        pass
                width = int(self.prop_map.find_integer("Width").maximum)
                height = int(self.prop_map.find_integer("Height").maximum)
                self.prop_map.set_value("Width", width)
                self.prop_map.set_value("Height", height)
                woi = (0, width, 0, height)
            else:
                x, w, y, h = (int(v) for v in woi)
                # Shrink first so offsets cannot exceed sensor bounds.
                self.prop_map.set_value("Width", int(self.prop_map.find_integer("Width").minimum))
                self.prop_map.set_value("Height", int(self.prop_map.find_integer("Height").minimum))
                self.prop_map.set_value("OffsetX", x)
                self.prop_map.set_value("OffsetY", y)
                self.prop_map.set_value("Width", w)
                self.prop_map.set_value("Height", h)
            self.woi = tuple(int(v) for v in woi)
            self.shape = (self.woi[3], self.woi[1])
        finally:
            if streaming:
                self.grabber.stream_setup(
                    self.sink,
                    setup_option=ic4.StreamSetupOption.ACQUISITION_START,
                )
        return self.woi

    def _get_exposure_hw(self):
        return float(self.prop_map.get_value_float("ExposureTime")) / 1e6

    def _set_exposure_hw(self, exposure_s):
        self.prop_map.set_value("ExposureTime", float(exposure_s * 1e6))

    def _get_image_hw(self, timeout_s=1):
        buffer = self.sink.snap_single(int(timeout_s * 1e3))
        frame = np.copy(np.squeeze(buffer.numpy_wrap()))
        buffer.release()
        return frame
