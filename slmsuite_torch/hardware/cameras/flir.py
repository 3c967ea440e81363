"""
FLIR/Teledyne cameras via the Spinnaker SDK (:mod:`PySpin`).

Parity: reference ``slmsuite/hardware/cameras/flir.py`` (``FLIR``).
"""

import warnings

import numpy as np

from slmsuite_torch.hardware import _optional_import
from slmsuite_torch.hardware.cameras.camera import Camera

PySpin = None  # Imported by _import_sdk() when the hardware is built.


def _import_sdk():
    """PySpin (Spinnaker), imported on first use; None where it is not installed."""
    global PySpin
    if PySpin is None:
        PySpin = _optional_import("PySpin")
    return PySpin


class FLIR(Camera):
    """
    FLIR camera through Spinnaker.

    The Spinnaker ``System`` singleton is shared across instances and
    released when the last camera closes.
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
            raise ImportError("PySpin (Spinnaker SDK) is required for FLIR cameras.")

        if FLIR.sdk is None:
            if verbose:
                print("PySpin initializing... ", end="")
            FLIR.sdk = PySpin.System.GetInstance()
            if verbose:
                print("success")

        camera_list = FLIR.sdk.GetCameras()
        try:
            if not serial:
                if camera_list.GetSize() == 0:
                    raise RuntimeError("No FLIR cameras found.")
                self.cam = camera_list.GetByIndex(0)
            else:
                self.cam = camera_list.GetBySerial(str(serial))
        finally:
            camera_list.Clear()

        if verbose:
            print(f"FLIR camera {serial or '(first)'} initializing... ", end="")
        self.cam.Init()
        FLIR._instances += 1

        # Manual exposure/gain so feedback measurements are repeatable.
        self.cam.ExposureAuto.SetValue(PySpin.ExposureAuto_Off)
        self.cam.GainAuto.SetValue(PySpin.GainAuto_Off)
        self.cam.Gain.SetValue(0)
        try:
            self.cam.GammaEnable.SetValue(False)
        except PySpin.SpinnakerException:
            pass
        self.cam.AcquisitionMode.SetValue(PySpin.AcquisitionMode_Continuous)

        width = int(self.cam.WidthMax.GetValue())
        height = int(self.cam.HeightMax.GetValue())
        bitdepth = self._configure_adc_depth(kwargs.pop("bitdepth", None))
        self._configure_frame_rate()

        self.cam.BeginAcquisition()
        if verbose:
            print("success")

        super().__init__(
            (width, height),
            bitdepth=bitdepth,
            name=f"FLIR_{serial or self.cam.DeviceSerialNumber.GetValue()}",
            **kwargs,
        )

    def _configure_adc_depth(self, bitdepth=None):
        """
        Select the sensor ADC bit depth (8/10/12) and the matching
        transport pixel format (Mono8 for 8-bit, Mono16 otherwise — the
        sensor left-justifies into 16-bit containers). ``None`` picks
        the deepest ADC the model offers. Returns the selected depth.
        Ref ``flir.py:317-385``.
        """
        if bitdepth is not None and bitdepth not in (8, 10, 12):
            raise ValueError(
                f"Unsupported bitdepth {bitdepth}; FLIR ADCs are 8/10/12-bit."
            )
        try:
            adc = self.cam.AdcBitDepth
            entries = [
                e for e in adc.GetEntries()
                if PySpin.IsAvailable(e) and PySpin.IsReadable(e)
            ]
            depths = sorted(
                int(e.GetSymbolic().replace("Bit", "")) for e in entries
            )
            chosen = bitdepth if bitdepth in depths else depths[-1]
            if bitdepth is not None and chosen != bitdepth:
                warnings.warn(
                    f"Requested ADC bitdepth {bitdepth} is not offered by "
                    f"this model (available: {depths}); using {chosen}."
                )
            adc.SetIntValue(
                adc.GetEntryByName(f"Bit{chosen}").GetValue()
            )
        except (PySpin.SpinnakerException, AttributeError, IndexError):
            # Model exposes no ADC selector; fall back to the pixel size.
            try:
                chosen = int(
                    PySpin.CEnumerationPtr(
                        self.cam.GetNodeMap().GetNode("PixelSize")
                    ).GetIntValue()
                )
            except Exception:
                chosen = bitdepth or 8
        # Mono16 transport left-justifies the ADC value; record the
        # shift so _get_image_hw returns data spanning [0, 2^bitdepth)
        # and Camera.bitresolution-based overexposure/autoexposure logic
        # stays correct. The shift applies ONLY if the Mono16 format
        # actually took — shifting Mono8 frames would zero valid data.
        self._transport_shift = 0
        set_ok = False
        try:
            fmt = PySpin.PixelFormat_Mono8 if chosen == 8 else \
                PySpin.PixelFormat_Mono16
            self.cam.PixelFormat.SetValue(fmt)
            set_ok = True
        except PySpin.SpinnakerException:
            pass
        # Trust the read-back format, not the request: if the Mono16
        # switch was rejected the camera still transports Mono8 and the
        # deeper ADC reading is unreachable.
        try:
            mono16 = (
                self.cam.PixelFormat.GetIntValue()
                == PySpin.PixelFormat_Mono16
            )
        except PySpin.SpinnakerException:
            mono16 = set_ok and chosen != 8
        if mono16:
            self._transport_shift = max(0, 16 - int(chosen))
        else:
            chosen = 8
        return int(chosen)

    def _configure_frame_rate(self):
        """Disable automatic frame rate and drive the camera at its
        maximum — an auto-limited frame rate silently caps the exposure
        range autoexposure can reach. Ref ``flir.py:387-420``."""
        try:
            if hasattr(self.cam, "AcquisitionFrameRateAuto"):
                self.cam.AcquisitionFrameRateAuto.SetValue(
                    self.cam.AcquisitionFrameRateAuto.GetEntryByName("Off").GetValue()
                )
            if hasattr(self.cam, "AcquisitionFrameRateEnable"):
                self.cam.AcquisitionFrameRateEnable.SetValue(True)
            rate = self.cam.AcquisitionFrameRate
            if rate.GetAccessMode() == PySpin.RW:
                rate.SetValue(rate.GetMax())
        except PySpin.SpinnakerException:
            pass

    def close(self):
        """End acquisition and release the camera (and SDK if last)."""
        if getattr(self, "cam", None) is None:
            return
        try:
            self.cam.EndAcquisition()
        except Exception:
            pass
        self.cam.DeInit()
        del self.cam
        self.cam = None
        FLIR._instances -= 1
        if FLIR._instances <= 0 and FLIR.sdk is not None:
            FLIR.sdk.ReleaseInstance()
            FLIR.sdk = None

    @staticmethod
    def info(verbose=True):
        """Return serial numbers of connected FLIR cameras."""
        if _import_sdk() is None:
            raise ImportError("PySpin (Spinnaker SDK) is required.")
        own_sdk = FLIR.sdk is None
        sdk = FLIR.sdk or PySpin.System.GetInstance()
        camera_list = sdk.GetCameras()
        serials = []
        for i in range(camera_list.GetSize()):
            cam = camera_list.GetByIndex(i)
            serials.append(
                PySpin.CStringPtr(
                    cam.GetTLDeviceNodeMap().GetNode("DeviceSerialNumber")
                ).GetValue()
            )
        camera_list.Clear()
        if own_sdk:
            sdk.ReleaseInstance()
        if verbose:
            print("FLIR serials:", serials)
        return serials

    def _get_exposure_hw(self):
        return float(self.cam.ExposureTime.GetValue()) / 1e6

    def _set_exposure_hw(self, exposure_s):
        exposure_us = float(
            np.clip(
                exposure_s * 1e6,
                self.cam.ExposureTime.GetMin(),
                self.cam.ExposureTime.GetMax(),
            )
        )
        self.cam.ExposureTime.SetValue(exposure_us)

    def _get_image_hw(self, timeout_s=1):
        image = self.cam.GetNextImage(int(timeout_s * 1e3))
        try:
            if image.IsIncomplete():
                raise RuntimeError(
                    f"FLIR image incomplete: {image.GetImageStatus()}."
                )
            frame = np.array(image.GetNDArray(), copy=True)
        finally:
            image.Release()
        shift = getattr(self, "_transport_shift", 0)
        if shift:
            # Undo the Mono16 left-justification (see _configure_adc_depth).
            frame = frame >> shift
        return frame

    def flush(self, timeout_s=1):
        """Drain buffered frames so the next grab is fresh."""
        while True:
            try:
                image = self.cam.GetNextImage(30)
            except PySpin.SpinnakerException:
                break
            image.Release()

    @classmethod
    def close_sdk(cls):
        """Release the shared Spinnaker System instance."""
        if cls.sdk is not None:
            cls.sdk.ReleaseInstance()
            cls.sdk = None

    def get_properties(self, verbose=True):
        """
        Collect readable GenICam properties by recursive nodemap
        traversal; prints when ``verbose``, else returns ``{name: value}``.
        """
        properties = {}

        def visit(node):
            kind = node.GetPrincipalInterfaceType()
            if kind == PySpin.intfICategory:
                for feature in PySpin.CCategoryPtr(node).GetFeatures():
                    if PySpin.IsReadable(feature):
                        visit(feature)
            else:
                try:
                    properties[node.GetName()] = PySpin.CValuePtr(node).ToString()
                except PySpin.SpinnakerException:
                    pass

        root = self.cam.GetNodeMap().GetNode("Root")
        if root is not None and PySpin.IsReadable(root):
            visit(root)
        if verbose:
            for name, value in properties.items():
                print(f"{name}\t{value}")
            return None
        return properties

    def set_woi(self, woi=None):
        """
        Set the hardware window of interest ``(x, width, y, height)``.
        Values snap to the sensor's increment requirements; acquisition
        is paused and restarted around the change.
        """
        w_max = int(self.cam.WidthMax.GetValue())
        h_max = int(self.cam.HeightMax.GetValue())
        if woi is None:
            woi = (0, w_max, 0, h_max)
        x, w, y, h = (int(v) for v in woi)

        def snap(node, value):
            try:
                inc = int(node.GetInc())
                return (value // inc) * inc
            except Exception:
                return value

        x = snap(self.cam.OffsetX, x)
        y = snap(self.cam.OffsetY, y)
        w = snap(self.cam.Width, w)
        h = snap(self.cam.Height, h)
        try:
            w = max(int(self.cam.Width.GetMin()), min(w, w_max - x))
            h = max(int(self.cam.Height.GetMin()), min(h, h_max - y))
        except PySpin.SpinnakerException:
            pass

        streaming = False
        try:
            if self.cam.IsStreaming():
                self.cam.EndAcquisition()
                streaming = True
        except PySpin.SpinnakerException:
            pass

        try:
            # Shrink first so the new offsets cannot exceed sensor bounds.
            for node, value in (
                (self.cam.Height, int(self.cam.Height.GetMin())),
                (self.cam.Width, int(self.cam.Width.GetMin())),
                (self.cam.OffsetX, x),
                (self.cam.OffsetY, y),
                (self.cam.Width, w),
                (self.cam.Height, h),
            ):
                if node.GetAccessMode() == PySpin.RW:
                    node.SetValue(value)
            self.woi = (x, w, y, h)
            # Preserve the row/col convention from Camera.__init__
            # (swapped under 90/270-degree transforms).
            self.shape = (h, w) if self.default_shape[0] == h_max else (w, h)
        except PySpin.SpinnakerException as err:
            raise RuntimeError(f"Failed to set WOI: {err}")
        finally:
            if streaming:
                self.cam.BeginAcquisition()
        return self.woi
