"""
Xenics infrared cameras (Cheetah, Wildcat, Bobcat, ...) via the Xeneth
SDK, bound with :mod:`ctypes` (``xeneth64.dll`` / ``libxeneth.so``).

Parity: reference ``slmsuite/hardware/cameras/xenics.py`` (``Cheetah640``).
The reference's repeated get/set/verify property triplets are factored
into ``_get_*``/``_set_*`` helpers here; the public control surface
(triggers, cooling, framerate, gain, grabber, filters, WOI) matches.
"""

import ctypes
import ctypes.util
import time
import warnings

import numpy as np

from slmsuite_torch.hardware.cameras.camera import Camera

_LIB = None

#: Xeneth error codes (subset).
I_OK = 0

#: Frame-type constant: native frame format.
_FT_NATIVE = 0

#: GetFrame flags.
_XGF_BLOCKING = 1
_XGF_NOCONVERSION = 2

#: Hardware WOI granularity of the Cheetah640 focal plane.
_WOI_X_MULTIPLE = 16
_WOI_Y_MULTIPLE = 4

_INPUT_TRIGGER_MODES = {0: b"Free running", 1: b"Level", 2: b"Rising edge", 3: b"Falling edge"}
_INPUT_TRIGGER_SOURCES = {0: b"Trigger in", 1: b"Software", 2: b"CameraLink CC1"}
_OUTPUT_TRIGGER_MODES = {0: b"Active low", 1: b"Active high"}
_OUTPUT_TRIGGER_SOURCES = {0: b"Integration start", 1: b"Trigger input", 2: b"Integration period"}
_GRABBER_MODES = {
    0: b"Preview",             # Circular buffer.
    1: b"Synchronous bursts",  # Restart capture after every full buffer.
    2: b"Synchronous burst",   # Stop when the buffer fills.
}


def _load_sdk():
    global _LIB
    if _LIB is not None:
        return _LIB
    for name in ("xeneth64", "xeneth", "libxeneth.so"):
        try:
            path = ctypes.util.find_library(name) or name
            _LIB = ctypes.CDLL(path)
            break
        except OSError:
            continue
    if _LIB is None:
        raise ImportError(
            "Xeneth SDK not found (xeneth64.dll / libxeneth.so); install it "
            "from Xenics."
        )
    _LIB.XC_OpenCamera.restype = ctypes.c_uint32
    _LIB.XC_OpenCamera.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p]
    return _LIB


class Cheetah640(Camera):
    """
    Xenics camera through Xeneth. Despite the name (kept for parity with
    the reference driver), any Xeneth-enumerable camera works — geometry
    and bitdepth are queried from the device.
    """

    def __init__(self, url="cam://0", calibration=None, verbose=True, **kwargs):
        """
        Parameters
        ----------
        url : str
            Xeneth connection URL, e.g. ``'cam://0'`` or ``'gev://<ip>'``.
        calibration : str OR None
            Path to a ``.xca`` calibration pack to load.
        **kwargs
            Passed to :meth:`.Camera.__init__`.
        """
        self._lib = _load_sdk()
        #: Queued Xeneth image-filter tags, keyed by purpose.
        self.filters = {}
        if verbose:
            print(f"Xeneth camera '{url}' initializing... ", end="")
        self.handle = self._lib.XC_OpenCamera(url.encode(), None, None)
        if not self._lib.XC_IsInitialised(self.handle):
            raise RuntimeError(f"Could not initialize Xenics camera at '{url}'.")

        if calibration is not None:
            status = self._lib.XC_LoadCalibration(
                self.handle, calibration.encode(), ctypes.c_ulong(1)
            )
            if status != I_OK:
                warnings.warn(f"Calibration load failed with status {status}.")

        width = int(self._lib.XC_GetWidth(self.handle))
        height = int(self._lib.XC_GetHeight(self.handle))
        bitdepth = int(self._lib.XC_GetBitSize(self.handle))
        self._alloc_buffer((height, width), bitdepth)

        status = self._lib.XC_StartCapture(self.handle)
        if status != I_OK:
            raise RuntimeError(f"XC_StartCapture failed with status {status}.")
        if verbose:
            print("success")

        super().__init__(
            (width, height),
            bitdepth=bitdepth,
            name=f"Xenics_{url}",
            **kwargs,
        )

    def _alloc_buffer(self, shape, bitdepth=None):
        if bitdepth is None:
            bitdepth = self.bitdepth
        self._frame_bytes = int(self._lib.XC_GetFrameSize(self.handle))
        self._buffer = np.zeros(
            shape, dtype=np.uint16 if bitdepth > 8 else np.uint8
        )

    def close(self):
        """Stop capture, remove filters, and close the connection."""
        if getattr(self, "handle", None):
            self.close_filters()
            self._lib.XC_StopCapture(self.handle)
            self._lib.XC_CloseCamera(self.handle)
            self.handle = None

    @staticmethod
    def info(verbose=True):
        """Enumerate Xeneth devices (indices of ``cam://N``)."""
        lib = _load_sdk()
        count = ctypes.c_uint32(0)
        lib.XCD_EnumerateDevices(None, ctypes.byref(count), ctypes.c_uint32(1))
        found = [f"cam://{i}" for i in range(count.value)]
        if verbose:
            print("Xeneth devices:", found)
        return found

    # ------------------------------------------------------------------
    # Property helpers: each setter verifies by read-back and returns the
    # value the hardware actually accepted.
    # ------------------------------------------------------------------

    def _get_long(self, prop):
        value = ctypes.c_long(0)
        self._lib.XC_GetPropertyValueL(self.handle, prop, ctypes.byref(value))
        return int(value.value)

    def _get_double(self, prop):
        value = ctypes.c_double(0)
        self._lib.XC_GetPropertyValueF(self.handle, prop, ctypes.byref(value))
        return float(value.value)

    def _get_enum(self, prop):
        buffer = (ctypes.c_char * 128)(0)
        self._lib.XC_GetPropertyValueE(self.handle, prop, ctypes.byref(buffer), 128)
        return buffer.value.decode()

    def _set_long(self, prop, value, verbose=False):
        old = self._get_long(prop)
        err = self._lib.XC_SetPropertyValueL(
            self.handle, prop, ctypes.c_long(int(value)), b""
        )
        new = self._get_long(prop)
        if err:
            warnings.warn(f"Xeneth set {prop.decode()} error {err}.")
        if verbose:
            print(f"{prop.decode()}: {old} -> {new}")
        return new

    def _set_double(self, prop, value, verbose=False):
        old = self._get_double(prop)
        err = self._lib.XC_SetPropertyValueF(
            self.handle, prop, ctypes.c_double(float(value)), b""
        )
        new = self._get_double(prop)
        if err:
            warnings.warn(f"Xeneth set {prop.decode()} error {err}.")
        if verbose:
            print(f"{prop.decode()}: {old} -> {new}")
        return new

    def _set_enum(self, prop, value, verbose=False):
        old = self._get_enum(prop)
        err = self._lib.XC_SetPropertyValueE(self.handle, prop, value)
        new = self._get_enum(prop)
        if err:
            warnings.warn(f"Xeneth set {prop.decode()} error {err}.")
        if verbose:
            print(f"{prop.decode()}: '{old}' -> '{new}'")
        return new

    def set_property(self, name, value):
        """Set an arbitrary Xeneth property (numeric or string)."""
        if isinstance(value, str):
            self._lib.XC_SetPropertyValue(
                self.handle, name.encode(), value.encode(), b""
            )
        else:
            self._lib.XC_SetPropertyValueF(
                self.handle, name.encode(), ctypes.c_double(value), b""
            )

    def get_property(self, name):
        """Read a numeric Xeneth property."""
        return self._get_double(name.encode())

    def get_property_status(self, save_file_path=None, verbose=True):
        """
        Dump every camera property (name, category, type, value), as a
        list of tuples; optionally save to ``save_file_path`` and print.
        """
        count = int(self._lib.XC_GetPropertyCount(self.handle))
        rows = []
        name_buf = (ctypes.c_char * 128)(0)
        kind_buf = (ctypes.c_char * 128)(0)
        cat_buf = (ctypes.c_char * 128)(0)
        for i in range(count):
            self._lib.XC_GetPropertyName(self.handle, i, ctypes.byref(name_buf), 128)
            name = name_buf.value
            self._lib.XC_GetPropertyType(self.handle, name, ctypes.byref(kind_buf))
            self._lib.XC_GetPropertyCategory(self.handle, name, ctypes.byref(cat_buf), 128)
            value_buf = (ctypes.c_char * 128)(0)
            self._lib.XC_GetPropertyValue(self.handle, name, ctypes.byref(value_buf), 128)
            rows.append(
                (name.decode(), cat_buf.value.decode(), kind_buf.value.decode(),
                 value_buf.value.decode())
            )
        if verbose:
            for row in rows:
                print("%s | %s | %s | %s" % row)
        if save_file_path is not None:
            with open(save_file_path, "w") as f:
                f.write("name | category | type | value\n")
                for row in rows:
                    f.write("%s | %s | %s | %s\n" % row)
        return rows

    # ------------------------------------------------------------------
    # Imaging configuration.
    # ------------------------------------------------------------------

    def configure(self, format_file):
        """Load a pre-stored imaging profile (``XC_SaveSettings`` XCF file)."""
        if not self._lib.XC_IsInitialised(self.handle):
            raise RuntimeError("Camera not open.")
        status = self._lib.XC_LoadSettings(self.handle, format_file.encode())
        if status != I_OK:
            warnings.warn(f"XC_LoadSettings failed with status {status}.")

    def _get_exposure_hw(self):
        return self._get_double(b"IntegrationTime") / 1e6

    def _set_exposure_hw(self, exposure_s):
        self._set_double(b"IntegrationTime", exposure_s * 1e6)

    def set_framerate(self, framerate, verbose=False):
        """Set the camera framerate in fps; returns the accepted value."""
        return self._set_long(b"FrameRate", framerate, verbose)

    def get_frame_footer_length(self):
        """Length of the software frame tags appended to each frame."""
        return int(self._lib.XC_GetFrameFooterLength(self.handle))

    def set_buffer_api(self, frames=64, verbose=False):
        """Set the number of API-facing buffer frames."""
        return self._set_long(b"_API_FPC_BFRNUM", frames, verbose)

    def set_timeout_api(self, timeout_ms=10000, verbose=False):
        """Set the blocking get-frame timeout before ``E_NOFRAME``."""
        return self._set_long(b"_API_GETFRAME_TIMEOUT", timeout_ms, verbose)

    def set_temperature(self, temp_c, verbose=False):
        """Set the TEC settle temperature (Celsius); returns the readback."""
        return self._set_double(b"SettleTemperature", temp_c + 273.15, verbose) - 273.15

    def get_temperature(self):
        """Current sensor temperature in Celsius (-1 when unreadable)."""
        kelvin = self._get_double(b"Temperature")
        return kelvin - 273.15 if kelvin > 0 else -1.0

    def set_readout_orientation(self, flip_x=True, flip_y=True, verbose=False):
        """Set the focal-plane readout direction."""
        self._set_long(b"ReadoutFlipX", int(bool(flip_x)), verbose)
        self._set_long(b"ReadoutFlipY", int(bool(flip_y)), verbose)

    def enable_frametags(self, enable=False):
        """Stamp the frame number into the first two pixels (off by
        default: the tags corrupt autoexposure statistics)."""
        self._set_enum(b"FrameMarker", b"Enabled" if enable else b"Disabled")

    def set_low_gain(self, enable=True):
        """Enable/disable the low-gain (high-well-depth) readout mode."""
        if bool(self._get_long(b"LowGain")) != bool(enable):
            self._set_long(b"LowGain", int(bool(enable)))

    def enable_cooling(self, enable=True):
        """Enable/disable the TEC and high fan speed."""
        if bool(self._get_long(b"Fan")) != bool(enable):
            self._set_long(b"Fan", int(bool(enable)))

    # ------------------------------------------------------------------
    # Triggering.
    # ------------------------------------------------------------------

    def setup_input_trigger(self, mode=0, delay=0, source=0, skip=0, fpt=1,
                            verbose=False):
        """
        Configure capture control via input triggering.

        Parameters
        ----------
        mode : int
            0 free running, 1 level, 2 rising edge, 3 falling edge.
        delay : float
            Trigger delay in microseconds.
        source : int
            0 trigger in, 1 software, 2 CameraLink CC1.
        skip : int
            Frames to skip after each trigger.
        fpt : int
            Frames per trigger.
        """
        self._set_long(b"NrOfFrames", fpt, verbose)
        self._set_enum(b"TriggerMode", _INPUT_TRIGGER_MODES[mode], verbose)
        self._set_double(b"TriggerInputDelay", delay, verbose)
        self._set_enum(b"TriggerSource", _INPUT_TRIGGER_SOURCES[source], verbose)
        self._set_long(b"TriggerSkip", skip, verbose)

    def setup_output_trigger(self, enable=1, mode=1, source=2, delay=0,
                             width=10, verbose=False):
        """
        Configure the output trigger.

        Parameters
        ----------
        enable : bool
            Whether the output trigger fires.
        mode : int
            0 active low, 1 active high.
        source : int
            0 integration start, 1 trigger input, 2 integration period.
        delay, width : float
            Pulse delay and width in microseconds.
        """
        self._set_enum(b"TriggerOutEnable", b"On" if enable else b"Off", verbose)
        self._set_enum(b"TriggerOutMode", _OUTPUT_TRIGGER_MODES[mode], verbose)
        self._set_double(b"TriggerOutDelay", delay, verbose)
        self._set_enum(b"TriggerOutSource", _OUTPUT_TRIGGER_SOURCES[source], verbose)
        self._set_double(b"TriggerOutWidth", width, verbose)

    def setup_grabber(self, mode=0, frames=4000, verbose=False):
        """
        Configure the frame-grabber capture mode: 0 circular buffer,
        1 synchronous bursts (restart when full), 2 single burst (stop
        when full); ``frames`` sets the buffer length.
        """
        self._set_enum(b"Mode", _GRABBER_MODES[mode], verbose)
        return self._set_long(b"FrameCount", frames, verbose)

    # ------------------------------------------------------------------
    # Window of interest.
    # ------------------------------------------------------------------

    def set_woi(self, woi=None, verbose=False):
        """
        Set the *hardware* window of interest (smaller windows enable
        faster framerates). ``woi = (x, width, y, height)``; edges are
        conservatively widened to the focal plane's granularity
        (x multiples of 16, y multiples of 4).
        """
        if woi is None:
            woi = (0, self.default_shape[1], 0, self.default_shape[0])
        x, w, y, h = (int(v) for v in woi)

        # Conservative rounding: never smaller than requested.
        x0 = (x // _WOI_X_MULTIPLE) * _WOI_X_MULTIPLE
        y0 = (y // _WOI_Y_MULTIPLE) * _WOI_Y_MULTIPLE
        x1 = x + w - 1
        y1 = y + h - 1
        if (x1 - x0 + 1) % _WOI_X_MULTIPLE:
            x1 += _WOI_X_MULTIPLE - (x1 - x0 + 1) % _WOI_X_MULTIPLE
        if (y1 - y0 + 1) % _WOI_Y_MULTIPLE:
            y1 += _WOI_Y_MULTIPLE - (y1 - y0 + 1) % _WOI_Y_MULTIPLE

        capturing = self.is_capturing()
        if capturing:
            self.stop_capture()

        x0 = self._set_long(b"WoiSX(0)", x0, verbose)
        x1 = self._set_long(b"WoiEX(0)", x1, verbose)
        y0 = self._set_long(b"WoiSY(0)", y0, verbose)
        y1 = self._set_long(b"WoiEY(0)", y1, verbose)

        shape = (y1 - y0 + 1, x1 - x0 + 1)
        self.shape = shape
        self.woi = (x0, shape[1], y0, shape[0])
        self._alloc_buffer(shape)

        if capturing:
            self.start_capture()
        return self.woi

    # ------------------------------------------------------------------
    # Capture control.
    # ------------------------------------------------------------------

    def setup(self, profile, fpt=1):
        """
        Pre-configured imaging profiles: ``"triggered"`` (100 us exposure,
        rising-edge hardware trigger) or ``"free"`` (free running, 7 ms).
        """
        if profile == "triggered":
            self.set_exposure(100e-6)
            self.setup_input_trigger(mode=2, source=0, fpt=fpt)
            self.set_low_gain(False)
        elif profile == "free":
            self.setup_input_trigger()
            self.set_exposure(7e-3)
            self.start_capture()
        else:
            raise ValueError(f"Unknown profile '{profile}'.")

    def snap(self, conversion=False):
        """Start capture, grab one image, stop capture."""
        self.start_capture()
        try:
            return self._get_image_hw(convert=conversion)
        finally:
            self.stop_capture()

    def get_frame_number(self):
        """Frames captured since :meth:`start_capture`."""
        return int(self._lib.XC_GetFrameCount(self.handle))

    def start_capture(self):
        """Start the capture run (waits until the grabber reports live)."""
        status = self._lib.XC_StartCapture(self.handle)
        if status != I_OK:
            warnings.warn(f"XC_StartCapture failed with status {status}.")
        while not self.is_capturing():
            time.sleep(0.1)

    def stop_capture(self):
        """Terminate the capture run."""
        status = self._lib.XC_StopCapture(self.handle)
        if status != I_OK:
            warnings.warn(f"XC_StopCapture failed with status {status}.")

    def abort_capture(self):
        """Cancel a long in-flight exposure."""
        status = self._lib.XC_SetPropertyValueE(
            self.handle, b"AbortExposure", b"Abort"
        )
        if status != I_OK:
            warnings.warn(f"Abort failed with status {status}.")

    def is_capturing(self):
        """Whether the grabber is currently running."""
        return bool(self._lib.XC_IsCapturing(self.handle))

    def flush(self, timeout_s=1):
        """Drain buffered frames so the next grab is fresh."""
        time.sleep(0.1)  # Allow in-flight free-running frames to land.
        while self._grab(block=False) == I_OK:
            pass

    def _grab(self, block=True, convert=False):
        flags = _XGF_BLOCKING if block else 0
        frame_type = _FT_NATIVE
        if not convert:
            flags |= _XGF_NOCONVERSION
        return self._lib.XC_GetFrame(
            self.handle, frame_type, flags,
            self._buffer.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_uint32(self._buffer.nbytes),
        )

    def _get_image_hw(self, timeout_s=1, convert=False):
        status = self._grab(block=True, convert=convert)
        if status != I_OK:
            raise RuntimeError(f"XC_GetFrame failed with status {status}.")
        return np.copy(self._buffer)

    # ------------------------------------------------------------------
    # Xeneth image-filter stack.
    # ------------------------------------------------------------------

    def autogain(self, enable=True):
        """Queue/remove the Xeneth auto offset-and-gain filter."""
        if enable and "autogain" not in self.filters:
            self.filters["autogain"] = self._lib.XC_FLT_Queue(
                self.handle, b"AutoOffsetAndGain", b""
            )
        elif not enable and "autogain" in self.filters:
            self._lib.XC_RemImageFilter(self.handle, self.filters.pop("autogain"))

    def autoexpose_xenics(self, enable=True, t_settle=0):
        """
        Queue/remove the Xeneth on-camera autoexposure filter (targets
        50% of dynamic range); grabs frames for ``t_settle`` seconds to
        let it converge.
        """
        if enable and "autoexposure" not in self.filters:
            tag = self._lib.XC_FLT_Queue(self.handle, b"AutoExposure", b"")
            self._lib.XC_FLT_SetParameter(self.handle, tag, b"Target", b"50")
            self._lib.XC_FLT_SetParameter(self.handle, tag, b"Outliers", b"0.0")
            self.filters["autoexposure"] = tag
            t_start = time.perf_counter()
            while time.perf_counter() - t_start < t_settle:
                self._get_image_hw()
        elif not enable and "autoexposure" in self.filters:
            self._lib.XC_RemImageFilter(self.handle, self.filters.pop("autoexposure"))

    def close_filters(self):
        """Remove every tracked filter from the stack."""
        for tag in self.filters.values():
            self._lib.XC_RemImageFilter(self.handle, tag)
        self.filters = {}
