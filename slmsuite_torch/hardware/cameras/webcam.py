"""
Webcam / generic video-capture camera via OpenCV.

Parity: reference ``slmsuite/hardware/cameras/webcam.py``.
"""

import numpy as np

from slmsuite_torch.hardware import _optional_import
from slmsuite_torch.hardware.cameras.camera import Camera

cv2 = None  # OpenCV, imported by _import_cv2() when a webcam is opened.


def _import_cv2():
    """OpenCV, imported on first use; raises ImportError where it is not
    installed."""
    global cv2
    if cv2 is None:
        cv2 = _optional_import("cv2")
        if cv2 is None:
            raise ImportError("OpenCV (cv2) is required for webcam cameras.")
    return cv2


class Webcam(Camera):
    """
    Camera driven through :class:`cv2.VideoCapture` (webcams, capture
    cards, video files). Frames are converted to grayscale by default.
    """

    def __init__(self, identifier=0, grayscale=True, verbose=True, **kwargs):
        """
        Parameters
        ----------
        identifier : int OR str
            cv2 device index (or stream/file path).
        grayscale : bool
            Convert BGR frames to grayscale.
        verbose : bool
            Print connection progress.
        **kwargs
            Passed to :meth:`.Camera.__init__`.
        """
        _import_cv2()
        if verbose:
            print(f"Webcam {identifier} initializing... ", end="")
        self.cap = cv2.VideoCapture(identifier)
        if not self.cap.isOpened():
            raise RuntimeError(f"Could not open video source '{identifier}'.")
        self.grayscale = grayscale

        width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        if verbose:
            print("success")

        super().__init__(
            (width, height),
            bitdepth=8,
            name=f"Webcam_{identifier}",
            **kwargs,
        )

    def close(self):
        """Release the capture device."""
        if hasattr(self, "cap") and self.cap is not None:
            self.cap.release()
            self.cap = None

    @staticmethod
    def info(verbose=True, max_index=8):
        """Probe device indices 0..max_index for openable cameras."""
        _import_cv2()
        found = []
        for index in range(max_index):
            cap = cv2.VideoCapture(index)
            if cap.isOpened():
                found.append(index)
            cap.release()
        if verbose:
            print("Webcam indices:", found)
        return found

    def set_woi(self, woi=None):
        """Request a capture resolution of ``(width, height)`` from the
        ``woi``; offsets are unsupported by the cv2 capture API."""
        import time

        if woi is not None:
            self.cap.set(cv2.CAP_PROP_FRAME_WIDTH, int(woi[1]))
            self.cap.set(cv2.CAP_PROP_FRAME_HEIGHT, int(woi[3]))
            self.shape = self.default_shape = (
                int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            )
            time.sleep(1)  # Many UVC devices need time to re-mode.
        self.woi = (0, self.shape[1], 0, self.shape[0])
        return self.woi

    def get_auto_exposure(self):
        """Current cv2 auto-exposure state (backend-specific encoding)."""
        return self.cap.get(cv2.CAP_PROP_AUTO_EXPOSURE)

    def set_auto_exposure(self, enable):
        """Enable (3) or disable (1) auto-exposure — the V4L2/UVC
        convention; toggled through 3 first to force a mode change."""
        self.cap.set(cv2.CAP_PROP_AUTO_EXPOSURE, 3)
        self.cap.set(cv2.CAP_PROP_AUTO_EXPOSURE, 3 if enable else 1)

    def _get_exposure_hw(self):
        exposure = self.cap.get(cv2.CAP_PROP_EXPOSURE)
        # Many webcams report log2 seconds; fall back to 1s when unsupported.
        if exposure in (0, -1):
            return self.exposure_s
        return float(2.0**exposure) if exposure < 0 else float(exposure)

    def _set_exposure_hw(self, exposure_s):
        self.cap.set(cv2.CAP_PROP_EXPOSURE, float(np.log2(exposure_s)))

    def _get_image_hw(self, timeout_s=1):
        ok, frame = self.cap.read()
        if not ok:
            raise RuntimeError("Webcam frame grab failed.")
        if self.grayscale and frame.ndim == 3:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        return frame
