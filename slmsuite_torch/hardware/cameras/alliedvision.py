"""
Allied Vision cameras via :mod:`vmbpy` (Vimba X).

The Vimba API is context-manager based; this driver holds the system and
camera contexts open between :meth:`__init__` and :meth:`close` so the
camera behaves like the other drivers.

Parity: reference ``slmsuite/hardware/cameras/alliedvision.py``
(``AlliedVision``).
"""

import numpy as np

from slmsuite_torch.hardware import _optional_import
from slmsuite_torch.hardware.cameras.camera import Camera

vmbpy = None  # Imported by _import_sdk() when the hardware is built.


def _import_sdk():
    """vmbpy (Vimba X), imported on first use; None where it is not installed."""
    global vmbpy
    if vmbpy is None:
        vmbpy = _optional_import("vmbpy")
    return vmbpy


class AlliedVision(Camera):
    """Allied Vision camera through vmbpy."""

    sdk = None

    def __init__(self, serial="", verbose=True, **kwargs):
        """
        Parameters
        ----------
        serial : str
            Camera ID; empty selects the first camera found.
        **kwargs
            Passed to :meth:`.Camera.__init__`.
        """
        if _import_sdk() is None:
            raise ImportError("vmbpy (Vimba X) is required for Allied Vision cameras.")

        if AlliedVision.sdk is None:
            if verbose:
                print("vmbpy initializing... ", end="")
            AlliedVision.sdk = vmbpy.VmbSystem.get_instance()
            AlliedVision.sdk.__enter__()
            if verbose:
                print("success")

        cameras = AlliedVision.sdk.get_all_cameras()
        if not cameras:
            raise RuntimeError("No Allied Vision cameras found.")
        if serial:
            self.cam = AlliedVision.sdk.get_camera_by_id(str(serial))
        else:
            self.cam = cameras[0]

        if verbose:
            print(f"AlliedVision {self.cam.get_id()} initializing... ", end="")
        self.cam.__enter__()

        for feature, value in [
            ("ExposureAuto", "Off"), ("GainAuto", "Off"), ("Gain", 0),
        ]:
            try:
                self.cam.get_feature_by_name(feature).set(value)
            except Exception:
                pass

        width = int(self.cam.get_feature_by_name("WidthMax").get())
        height = int(self.cam.get_feature_by_name("HeightMax").get())
        if verbose:
            print("success")

        super().__init__(
            (width, height),
            bitdepth=8,
            name=f"AlliedVision_{self.cam.get_id()}",
            **kwargs,
        )

    def close(self, close_sdk=True):
        """Exit the camera (and optionally system) contexts."""
        if getattr(self, "cam", None) is not None:
            self.cam.__exit__(None, None, None)
            self.cam = None
        if close_sdk:
            AlliedVision.close_sdk()

    @classmethod
    def close_sdk(cls):
        """Exit the shared vmbpy system context."""
        if cls.sdk is not None:
            cls.sdk.__exit__(None, None, None)
            cls.sdk = None

    def get_properties(self, properties=None):
        """Print name/value/unit for camera features (all when ``None``)."""
        features = (
            self.cam.get_all_features()
            if properties is None
            else [self.cam.get_feature_by_name(name) for name in properties]
        )
        for feature in features:
            line = [feature.get_name()]
            for getter in ("get", "get_unit"):
                try:
                    line.append(str(getattr(feature, getter)()))
                except Exception:
                    pass
            print("\t".join(line))

    def set_adc_bitdepth(self, bitdepth):
        """Set the digitization bitdepth (matched against the sensor's
        ``SensorBitDepth`` enum entries)."""
        bitdepth = int(bitdepth)
        feature = self.cam.get_feature_by_name("SensorBitDepth")
        for entry in feature.get_all_entries():
            name, value = entry.as_tuple()
            if str(bitdepth) in name:
                feature.set(value)
                return
        raise RuntimeError(f"ADC bitdepth {bitdepth} not found.")

    def get_adc_bitdepth(self):
        """Current digitization bitdepth."""
        value = str(self.cam.get_feature_by_name("SensorBitDepth").get())
        return int("".join(char for char in value if char.isdigit()))

    def _set_woi_hw(self, woi):
        # Shrink first so the new offsets cannot exceed sensor bounds.
        self.cam.get_feature_by_name("Height").set(8)
        self.cam.get_feature_by_name("Width").set(8)
        x, w, y, h = woi
        self.cam.get_feature_by_name("OffsetX").set(x)
        self.cam.get_feature_by_name("OffsetY").set(y)
        self.cam.get_feature_by_name("Height").set(h)
        self.cam.get_feature_by_name("Width").set(w)

    def set_woi(self, woi=None):
        """Set the hardware window of interest ``(x, width, y, height)``;
        restores the previous window if the request is rejected."""
        maxwoi = (
            0, int(self.cam.get_feature_by_name("WidthMax").get()),
            0, int(self.cam.get_feature_by_name("HeightMax").get()),
        )
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
        """Return IDs of connected Allied Vision cameras."""
        if _import_sdk() is None:
            raise ImportError("vmbpy is required.")
        with vmbpy.VmbSystem.get_instance() as sdk:
            ids = [camera.get_id() for camera in sdk.get_all_cameras()]
        if verbose:
            print("AlliedVision IDs:", ids)
        return ids

    def _get_exposure_hw(self):
        return float(self.cam.get_feature_by_name("ExposureTime").get()) / 1e6

    def _set_exposure_hw(self, exposure_s):
        self.cam.get_feature_by_name("ExposureTime").set(float(exposure_s * 1e6))

    def _get_image_hw(self, timeout_s=1):
        frame = self.cam.get_frame(timeout_ms=int(timeout_s * 1e3))
        return np.squeeze(np.array(frame.as_numpy_ndarray(), copy=True))
