"""
MindVision cameras via the vendor's :mod:`mvsdk` ctypes binding.

Parity: reference ``slmsuite/hardware/cameras/mindvision.py``
(``MindVision``).
"""

import numpy as np

from slmsuite_torch.hardware import _optional_import
from slmsuite_torch.hardware.cameras.camera import Camera

mvsdk = None  # Imported by _import_sdk() when the hardware is built.


def _import_sdk():
    """mvsdk, imported on first use; None where it is not installed."""
    global mvsdk
    if mvsdk is None:
        mvsdk = _optional_import("mvsdk")
    return mvsdk


class MindVision(Camera):
    """MindVision camera through mvsdk."""

    def __init__(self, serial="", verbose=True, **kwargs):
        """
        Parameters
        ----------
        serial : str
            Friendly name or serial; empty selects the first camera found.
        **kwargs
            Passed to :meth:`.Camera.__init__`.
        """
        if _import_sdk() is None:
            raise ImportError(
                "mvsdk (MindVision SDK python binding) is required."
            )

        devices = mvsdk.CameraEnumerateDevice()
        if not devices:
            raise RuntimeError("No MindVision cameras found.")
        device = None
        if serial:
            for candidate in devices:
                if str(serial) in (
                    candidate.GetFriendlyName(), candidate.GetSn()
                ):
                    device = candidate
                    break
            if device is None:
                raise RuntimeError(f"MindVision camera '{serial}' not found.")
        else:
            device = devices[0]

        if verbose:
            print(f"MindVision {device.GetFriendlyName()} initializing... ", end="")
        self.handle = mvsdk.CameraInit(device, -1, -1)

        capability = self.capability = mvsdk.CameraGetCapability(self.handle)
        mono = capability.sIspCapacity.bMonoSensor != 0
        mvsdk.CameraSetIspOutFormat(
            self.handle,
            mvsdk.CAMERA_MEDIA_TYPE_MONO8 if mono else mvsdk.CAMERA_MEDIA_TYPE_BGR8,
        )
        self._mono = mono

        mvsdk.CameraSetTriggerMode(self.handle, 0)  # Continuous.
        mvsdk.CameraSetAeState(self.handle, 0)      # Manual exposure.
        mvsdk.CameraSetAnalogGain(self.handle, capability.sExposeDesc.uiAnalogGainMin)

        width = capability.sResolutionRange.iWidthMax
        height = capability.sResolutionRange.iHeightMax
        buffer_size = width * height * (1 if mono else 3)
        self._frame_buffer = mvsdk.CameraAlignMalloc(buffer_size, 16)

        mvsdk.CameraPlay(self.handle)
        if verbose:
            print("success")

        super().__init__(
            (int(width), int(height)),
            bitdepth=8,
            name=f"MindVision_{device.GetSn()}",
            **kwargs,
        )

    def close(self):
        """Stop acquisition and free resources."""
        if getattr(self, "handle", None) is not None:
            mvsdk.CameraUnInit(self.handle)
            self.handle = None
        if getattr(self, "_frame_buffer", None) is not None:
            mvsdk.CameraAlignFree(self._frame_buffer)
            self._frame_buffer = None

    @staticmethod
    def info(verbose=True):
        """Return (friendly name, serial) of connected MindVision cameras."""
        if _import_sdk() is None:
            raise ImportError("mvsdk is required.")
        found = [
            (device.GetFriendlyName(), device.GetSn())
            for device in mvsdk.CameraEnumerateDevice()
        ]
        if verbose:
            print("MindVision cameras:", found)
        return found

    def set_woi(self, woi=None):
        """Hardware WOI is unsupported by this SDK wrapper; the base
        class's software crop applies (parity with the reference driver)."""
        return self.woi

    def print_capability(self):
        """Print the camera's trigger and resolution capability tables."""
        cap = self.capability
        for i in range(cap.iTriggerDesc):
            desc = cap.pTriggerDesc[i]
            print(f"{desc.iIndex}: {desc.GetDescription()}")
        for i in range(cap.iImageSizeDesc):
            desc = cap.pImageSizeDesc[i]
            print(f"{desc.iIndex}: {desc.GetDescription()}")

    def _get_exposure_hw(self):
        return float(mvsdk.CameraGetExposureTime(self.handle)) / 1e6

    def _set_exposure_hw(self, exposure_s):
        mvsdk.CameraSetExposureTime(self.handle, float(exposure_s * 1e6))

    def _get_image_hw(self, timeout_s=1):
        raw, head = mvsdk.CameraGetImageBuffer(self.handle, int(timeout_s * 1e3))
        try:
            mvsdk.CameraImageProcess(self.handle, raw, self._frame_buffer, head)
        finally:
            mvsdk.CameraReleaseImageBuffer(self.handle, raw)

        depth = 1 if self._mono else 3
        frame = np.ctypeslib.as_array(
            (np.ctypeslib.ctypes.c_ubyte * (head.iWidth * head.iHeight * depth)
             ).from_address(self._frame_buffer)
        ).reshape(
            (head.iHeight, head.iWidth) if depth == 1
            else (head.iHeight, head.iWidth, 3)
        )
        if depth == 3:
            frame = frame.mean(axis=2).astype(np.uint8)
        return np.copy(frame)
