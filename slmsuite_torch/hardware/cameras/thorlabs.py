"""
Thorlabs scientific cameras via :mod:`thorlabs_tsi_sdk`.

Parity: reference ``slmsuite/hardware/cameras/thorlabs.py``
(``ThorCam``).
"""

import numpy as np

from slmsuite_torch.hardware import _optional_import
from slmsuite_torch.hardware.cameras.camera import Camera

TLCameraSDK = None  # Imported by _import_sdk() when the hardware is built.


def _import_sdk():
    """Thorlabs' TLCameraSDK, imported on first use; None where it is not installed."""
    global TLCameraSDK
    if TLCameraSDK is None:
        TLCameraSDK = getattr(_optional_import("thorlabs_tsi_sdk.tl_camera"), "TLCameraSDK", None)
    return TLCameraSDK


class ThorCam(Camera):
    """
    Thorlabs camera through the TSI SDK.

    The SDK singleton is shared across instances; frames are acquired in
    software-triggered mode so exposure changes apply deterministically.
    """

    sdk = None
    _instances = 0

    def __init__(self, serial="", verbose=True, **kwargs):
        """
        Parameters
        ----------
        serial : str
            Camera serial; empty selects the first camera found.
        **kwargs
            Passed to :meth:`.Camera.__init__`.
        """
        if _import_sdk() is None:
            raise ImportError(
                "thorlabs_tsi_sdk is required for Thorlabs cameras."
            )

        if ThorCam.sdk is None:
            if verbose:
                print("TLCameraSDK initializing... ", end="")
            ThorCam.sdk = TLCameraSDK()
            if verbose:
                print("success")

        serials = ThorCam.sdk.discover_available_cameras()
        if not serials:
            raise RuntimeError("No Thorlabs cameras found.")
        serial = str(serial) if serial else serials[0]

        if verbose:
            print(f"ThorCam {serial} initializing... ", end="")
        self.cam = ThorCam.sdk.open_camera(serial)
        ThorCam._instances += 1

        self.cam.is_led_on = False
        try:
            self.cam.gain = 0
        except Exception:
            pass

        # Software-triggered continuous acquisition.
        self.profile = None
        self.cam.image_poll_timeout_ms = 1000
        self.setup("free")

        width = int(self.cam.image_width_pixels)
        height = int(self.cam.image_height_pixels)
        bitdepth = int(self.cam.bit_depth)
        if verbose:
            print("success")

        super().__init__(
            (width, height),
            bitdepth=bitdepth,
            name=f"ThorCam_{serial}",
            **kwargs,
        )

    def close(self, close_sdk=False):
        """Disarm and release the camera; optionally dispose the SDK."""
        if getattr(self, "cam", None) is not None:
            try:
                self.cam.disarm()
            except Exception:
                pass
            self.cam.dispose()
            self.cam = None
            ThorCam._instances -= 1
        if (close_sdk or ThorCam._instances <= 0) and ThorCam.sdk is not None:
            ThorCam.sdk.dispose()
            ThorCam.sdk = None

    @staticmethod
    def info(verbose=True):
        """Return serials of connected Thorlabs cameras."""
        if _import_sdk() is None:
            raise ImportError("thorlabs_tsi_sdk is required.")
        own = ThorCam.sdk is None
        sdk = ThorCam.sdk or TLCameraSDK()
        serials = sdk.discover_available_cameras()
        if own:
            sdk.dispose()
        if verbose:
            print("ThorCam serials:", serials)
        return serials

    @staticmethod
    def close_sdk():
        """Dispose the shared TLCameraSDK instance."""
        if ThorCam.sdk is not None:
            ThorCam.sdk.dispose()
            ThorCam.sdk = None

    def _get_exposure_hw(self):
        return float(self.cam.exposure_time_us) / 1e6

    def _set_exposure_hw(self, exposure_s):
        self.cam.exposure_time_us = int(exposure_s * 1e6)

    def setup(self, profile):
        """
        Set the operation mode: ``"free"`` (software-triggered,
        continuous), ``"single"`` (one frame per software trigger),
        ``"single_hardware"`` (one frame per hardware trigger), or
        ``None`` (disarmed).
        """
        if profile == self.profile:
            return
        if self.cam.is_armed:
            self.cam.disarm()
        if profile == "free":
            self.cam.frames_per_trigger_zero_for_unlimited = 0
            self.cam.operation_mode = 0  # Software triggered.
            self.cam.arm(2)
            self.cam.issue_software_trigger()
        elif profile == "single":
            self.cam.frames_per_trigger_zero_for_unlimited = 1
            self.cam.operation_mode = 0
            self.cam.arm(2)
        elif profile == "single_hardware":
            self.cam.frames_per_trigger_zero_for_unlimited = 1
            self.cam.operation_mode = 1  # Hardware triggered.
            self.cam.arm(2)
        elif profile is not None:
            raise ValueError(f"Unknown profile '{profile}'.")
        self.profile = profile

    def set_binning(self, bx=None, by=None):
        """Set sensor binning (errors if the value is unsupported);
        ``None`` leaves that axis unchanged. The camera is disarmed
        during the change and re-armed after, and the software-facing
        geometry (``shape``/WOI) is refreshed to the binned sensor
        dimensions."""
        profile = self.profile
        self.setup(None)
        if bx is not None:
            self.cam.binx = int(bx)
        if by is not None:
            self.cam.biny = int(by)
        # Binning changes the sensor geometry every downstream consumer
        # (calibration grids, viewer range, software crops) reads.
        self.shape = (
            int(self.cam.image_height_pixels),
            int(self.cam.image_width_pixels),
        )
        self.default_shape = self.shape
        self.set_woi()
        self.setup(profile)

    def is_capturing(self):
        """Whether the camera is free-running."""
        return self.profile == "free"

    def flush(self, timeout_s=1):
        """Drain stale buffered frames: poll until the buffer is empty or
        frames stop returning instantly (cached), or the timeout hits."""
        import time

        start = time.perf_counter()
        frame = self.cam.get_pending_frame_or_null()
        frametime = 0.0
        while (
            time.perf_counter() - start < timeout_s
            and frame is not None
            and frametime < 0.003
        ):
            t = time.perf_counter()
            frame = self.cam.get_pending_frame_or_null()
            frametime = time.perf_counter() - t

    def set_woi(self, woi=None):
        """Set the hardware region of interest ``(x, width, y, height)``."""
        was_armed = self.cam.is_armed
        if was_armed:
            self.cam.disarm()
        if woi is None:
            woi = (0, self.default_shape[1], 0, self.default_shape[0])
        x, w, y, h = (int(v) for v in woi)
        self.cam.roi = (x, y, x + w - 1, y + h - 1)
        self.woi = woi
        if was_armed:
            self.cam.arm(2)
            self.cam.issue_software_trigger()
        return woi

    def _get_image_hw(self, timeout_s=1):
        self.cam.image_poll_timeout_ms = int(timeout_s * 1e3)
        frame = self.cam.get_pending_frame_or_null()
        if frame is None:
            raise RuntimeError("ThorCam frame poll timed out.")
        return np.copy(frame.image_buffer).reshape(
            self.cam.image_height_pixels, self.cam.image_width_pixels
        )
