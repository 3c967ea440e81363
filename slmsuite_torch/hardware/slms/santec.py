"""
Santec LCOS-SLM (SLM-200/SLM-210/SLM-300) via ``SLMFunc.dll``.

The Santec SDK has two channels: a USB *control* interface (status,
temperature, memory-mode uploads, wavelength config) and a DVI *display*
interface (fast 10-bit phase streaming). Both are bound with
:mod:`ctypes` on demand; the module imports cleanly without the DLL.

Parity: reference ``slmsuite/hardware/slms/santec.py`` (``Santec``) and
``slmsuite/hardware/slms/_slm_win.py`` (the ctypes header; ours is a
lean binding of only the entry points used).
"""

import ctypes
import os
import warnings

import numpy as np

from slmsuite_torch.hardware.slms.slm import SLM

_DLL_NAMES = ["SLMFunc.dll", "slm_win.dll"]
_FUNC = None

# Santec status codes (subset).
SLM_OK = 0
SLM_NG = 1
SLM_BS = 2  # Busy.
SLM_ER = 3

#: SLM_STATUS meanings (Santec SDK manual; FT_* are FTDI USB-driver codes).
SLM_STATUS_DICT = {
    0: ("SLM_OK", "All good!"),
    1: ("SLM_NG", "NG"),
    2: ("SLM_BS", "SLM is busy."),
    3: ("SLM_ER", "Parameter error."),
    -1: ("SLM_INVAID_MONITOR", "Could not find specified display number."),
    -2: ("SLM_NOT_OPEN_MONITOR", "Display has not been opened."),
    -3: ("SLM_OPEN_WINDOW_ERR", "Window open error."),
    -4: ("SLM_DATA_FORMAT_ERR", "Data format error."),
    -101: ("SLM_FILE_READ_ERR", "File contained data over 1023."),
    -200: ("SLM_NOT_OPEN_USB", "USB is not open."),
    -1000: ("SLM_OTHER_ERROR", "Other error."),
    -10001: ("FT_INVALID_HANDLE", "USB driver error."),
    -10002: ("FT_DEVICE_NOT_FOUND", "Device not found. Check the device's power."),
    -10003: ("FT_DEVICE_NOT_OPENED", "Already opened."),
    -10004: ("FT_IO_ERROR", "USB driver error."),
    -10005: ("FT_INSUFFICIENT_RESOURCES", "USB driver error."),
    -10006: ("FT_INVALID_PARAMETER", "USB driver error."),
    -10007: ("FT_INVALID_BAUD_RATE", "USB driver error."),
    -10008: ("FT_DEVICE_NOT_OPENED_FOR_ERASE", "USB driver error."),
    -10009: ("FT_DEVICE_NOT_OPENED_FOR_WRITE", "USB driver error."),
    -10010: ("FT_FAILED_TO_WRITE_DEVICE", "USB driver error."),
    -10011: ("FT_EEPROM_READ_FAILED", "USB driver error."),
    -10012: ("FT_EEPROM_WRITE_FAILED", "USB driver error."),
    -10013: ("FT_EEPROM_ERASE_FAILED", "USB driver error."),
    -10014: ("FT_EEPROM_NOT_PRESENT", "USB driver error."),
    -10015: ("FT_EEPROM_NOT_PROGRAMMED", "USB driver error."),
    -10016: ("FT_INVALID_ARGS", "USB driver error."),
    -10017: ("FT_NOT_SUPPORTED", "USB driver error."),
    -10018: ("FT_NO_MORE_ITEMS", "USB driver error."),
    -10019: ("FT_TIMEOUT", "USB driver error."),
    -10020: ("FT_OPERATION_ABORTED", "USB driver error."),
}

#: Display-mode constants.
_DISP_MODE_DVI = 0
_DISP_MODE_MEMORY = 1


def _load_dll(search_path=None):
    """Load SLMFunc.dll and declare the signatures we use."""
    global _FUNC
    if _FUNC is not None:
        return _FUNC

    paths = []
    if search_path:
        paths.append(search_path)
    paths += _DLL_NAMES
    lib = None
    errors = []
    for path in paths:
        try:
            lib = ctypes.CDLL(path)
            break
        except OSError as err:
            errors.append(str(err))
    if lib is None:
        raise FileNotFoundError(
            "Santec SLMFunc.dll not found; install the Santec SLM SDK "
            f"or pass dll_path. Tried: {errors}"
        )

    u32, i32, u16 = ctypes.c_uint32, ctypes.c_int32, ctypes.c_uint16
    sigs = {
        "SLM_Ctrl_Open": ([u32], i32),
        "SLM_Ctrl_Close": ([u32], i32),
        "SLM_Ctrl_ReadSU": ([u32], i32),                       # Status.
        "SLM_Ctrl_WriteVI": ([u32, u32], i32),                 # Display mode.
        "SLM_Ctrl_WriteWL": ([u32, u32, u32], i32),            # Wavelength/phase range.
        "SLM_Ctrl_WriteAW": ([u32], i32),                      # Save wavelength.
        "SLM_Ctrl_ReadT": ([u32, ctypes.POINTER(i32), ctypes.POINTER(i32)], i32),
        "SLM_Ctrl_ReadEDO": ([u32, ctypes.POINTER(u32), ctypes.POINTER(u32)], i32),
        "SLM_Ctrl_WriteMI": (
            [u32, u32, u32, u32, u32, ctypes.POINTER(u16)], i32
        ),                                                     # Memory upload.
        "SLM_Ctrl_WriteDS": ([u32, u32], i32),                 # Display from memory.
        "SLM_Disp_Open": ([u32], i32),
        "SLM_Disp_Close": ([u32], i32),
        "SLM_Disp_ReadCSV": ([u32, u32, ctypes.c_char_p], i32),
        "SLM_Disp_Data": ([u32, u16, u16, u32, ctypes.POINTER(u16)], i32),
        "SLM_Disp_GrayScale": ([u32, u32, u16], i32),
        "SLM_Disp_Info2": (
            [u32, ctypes.POINTER(u16), ctypes.POINTER(u16),
             ctypes.c_char_p], i32
        ),
    }
    for name, (argtypes, restype) in sigs.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
    _FUNC = lib
    return lib


class Santec(SLM):
    """
    Santec LCOS-SLM driven over USB control + DVI display.

    Attributes
    ----------
    slm_number : int
        USB interface number of this SLM.
    display_number : int
        DVI display number of this SLM.
    """

    def __init__(
        self,
        slm_number=1,
        display_number=2,
        verbose=True,
        dll_path=None,
        wav_um=1,
        pitch_um=(8, 8),
        **kwargs,
    ):
        """
        Parameters
        ----------
        slm_number : int
            USB control interface index.
        display_number : int
            DVI display index carrying the SLM.
        dll_path : str OR None
            Explicit path to ``SLMFunc.dll``.
        wav_um, pitch_um, **kwargs
            See :meth:`.SLM.__init__`. ``wav_um`` is also programmed into
            the SLM's phase table.
        """
        self._lib = _load_dll(dll_path)
        self.slm_number = int(slm_number)
        self.display_number = int(display_number)

        if verbose:
            print(f"Santec SLM {slm_number} initializing... ", end="")
        if self._lib.SLM_Ctrl_Open(self.slm_number) != SLM_OK:
            raise RuntimeError(f"Could not open Santec SLM {slm_number} (USB).")

        # Wait until the device reports ready.
        for _ in range(100):
            if self._lib.SLM_Ctrl_ReadSU(self.slm_number) == SLM_OK:
                break

        # Program the operating wavelength (nm) and 2pi phase range (x100).
        self._lib.SLM_Ctrl_WriteWL(
            self.slm_number, int(wav_um * 1000), int(200)
        )
        self._lib.SLM_Ctrl_WriteAW(self.slm_number)

        # DVI streaming mode.
        self._lib.SLM_Ctrl_WriteVI(self.slm_number, _DISP_MODE_DVI)
        if self._lib.SLM_Disp_Open(self.display_number) != SLM_OK:
            raise RuntimeError(
                f"Could not open Santec display {display_number} (DVI)."
            )

        width = ctypes.c_uint16(0)
        height = ctypes.c_uint16(0)
        name_buffer = ctypes.create_string_buffer(128)
        self._lib.SLM_Disp_Info2(
            self.display_number, ctypes.byref(width), ctypes.byref(height),
            name_buffer,
        )
        shape = (int(width.value) or 1920, int(height.value) or 1200)
        if verbose:
            print("success")

        super().__init__(
            shape,
            bitdepth=10,
            name=kwargs.pop("name", f"Santec_{slm_number}"),
            wav_um=wav_um,
            pitch_um=pitch_um,
            **kwargs,
        )
        self.set_phase(None)

    def _set_phase_hw(self, display):
        data = np.ascontiguousarray(display, dtype=np.uint16)
        h, w = data.shape
        status = self._lib.SLM_Disp_Data(
            self.display_number, w, h, 0,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        )
        if status != SLM_OK:
            warnings.warn(f"Santec SLM_Disp_Data returned status {status}.")

    def write_memory(self, memory_number, display):
        """Upload a frame to on-board memory slot ``memory_number``."""
        data = np.ascontiguousarray(display, dtype=np.uint16)
        h, w = data.shape
        return self._lib.SLM_Ctrl_WriteMI(
            self.slm_number, int(memory_number), w, h, 0,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        )

    def display_memory(self, memory_number):
        """Display a previously uploaded memory slot."""
        return self._lib.SLM_Ctrl_WriteDS(self.slm_number, int(memory_number))

    def get_temperature(self):
        """Return ``(drive_board_C, option_board_C)`` temperatures."""
        drive = ctypes.c_int32(0)
        option = ctypes.c_int32(0)
        self._lib.SLM_Ctrl_ReadT(
            self.slm_number, ctypes.byref(drive), ctypes.byref(option)
        )
        return (drive.value / 10.0, option.value / 10.0)

    @staticmethod
    def _parse_status(status, raise_error=True):
        """Resolve an ``SLM_STATUS`` code to ``(num, name, note)``;
        raise (or warn) when it is not ``SLM_OK``."""
        status = int(status)
        if status not in SLM_STATUS_DICT:
            raise ValueError(f"SLM status '{status}' not recognized.")
        name, note = SLM_STATUS_DICT[status]
        if status != 0:
            message = f"Santec error {name}; '{note}'"
            if raise_error:
                raise RuntimeError(message)
            warnings.warn(message)
        return (status, name, note)

    def get_status(self, raise_error=True):
        """Read and parse the SLM's ``SLM_STATUS``; returns
        ``(num, name, note)``."""
        return Santec._parse_status(
            self._lib.SLM_Ctrl_ReadSU(self.slm_number), raise_error
        )

    def load_csv(self, filename):
        """Display the SLM-sized phase image stored in a Santec .csv."""
        Santec._parse_status(
            self._lib.SLM_Disp_ReadCSV(self.display_number, 0, filename.encode())
        )

    def load_vendor_phase_correction(self, file_path, smooth=False, overwrite=True):
        """
        Load the Santec-provided phase-correction .csv (first row/column
        are coordinates) into ``source["phase"]``. Only fully valid at
        the wavelength it was collected at. Returns the phase map.
        """
        import cv2

        table = np.loadtxt(file_path, skiprows=1, dtype=int, delimiter=",")[:, 1:]
        phase = (-2 * np.pi / self.bitresolution) * table.astype(float)

        if smooth:
            ksize = 15
            re = cv2.GaussianBlur(np.cos(phase), (ksize, ksize), 0)
            im = cv2.GaussianBlur(np.sin(phase), (ksize, ksize), 0)
            phase = np.arctan2(im, re) + np.pi

        if overwrite:
            self.source["phase"] = phase
        return phase

    def get_error(self):
        """Return raw (drive_error, option_error) flag words."""
        drive = ctypes.c_uint32(0)
        option = ctypes.c_uint32(0)
        self._lib.SLM_Ctrl_ReadEDO(
            self.slm_number, ctypes.byref(drive), ctypes.byref(option)
        )
        return (drive.value, option.value)

    def close(self):
        """Close both the display and control interfaces."""
        if getattr(self, "_lib", None) is None:
            return
        self._lib.SLM_Disp_Close(self.display_number)
        self._lib.SLM_Ctrl_Close(self.slm_number)
        self._lib = None

    @staticmethod
    def info(verbose=True, dll_path=None):
        """Enumerate DVI displays visible to the Santec SDK."""
        lib = _load_dll(dll_path)
        found = []
        for display_number in range(1, 9):
            width = ctypes.c_uint16(0)
            height = ctypes.c_uint16(0)
            name_buffer = ctypes.create_string_buffer(128)
            status = lib.SLM_Disp_Info2(
                display_number, ctypes.byref(width), ctypes.byref(height),
                name_buffer,
            )
            if status == SLM_OK:
                name = name_buffer.value.decode(errors="replace")
                found.append((display_number, name,
                              (int(width.value), int(height.value))))
        if verbose:
            for entry in found:
                print(entry)
        return found
