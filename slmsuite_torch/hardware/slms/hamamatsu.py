"""
Hamamatsu LCOS-SLM heads via ``hpkSLMdaLV.dll`` / ``hpkSLMda.dll``.

These USB-controlled heads expose frame-memory slots: a frame is uploaded
to a slot with ``Write_FMemArray`` and the displayed slot is selected with
``Change_DispSlot``. The DLLs are Windows-only and loaded lazily with
:mod:`ctypes`; this module imports cleanly without them.

Parity: reference ``slmsuite/hardware/slms/hamamatsu.py`` (``Hamamatsu``).
"""

import ctypes
import os
import warnings

import numpy as np

from slmsuite_torch.hardware.slms.slm import SLM

_LIB = None


def _load_dll(dll_path=None):
    """Load hpkSLMdaLV.dll (searching ``dll_path``, cwd, and this dir)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    name = "hpkSLMdaLV.dll"
    candidates = []
    if dll_path:
        candidates.append(os.path.join(dll_path, name))
    candidates += [name, os.path.join(os.path.dirname(os.path.abspath(__file__)), name)]
    for candidate in candidates:
        try:
            if hasattr(os, "add_dll_directory") and os.path.dirname(candidate):
                os.add_dll_directory(os.path.dirname(candidate))
            _LIB = ctypes.WinDLL(candidate)
            return _LIB
        except (OSError, AttributeError):
            continue
    raise FileNotFoundError(
        "Hamamatsu DLLs (hpkSLMdaLV.dll, hpkSLMda.dll) not found; place them "
        "in the working directory or pass dll_path."
    )


class Hamamatsu(SLM):
    """
    Hamamatsu LCOS-SLM head over USB frame-memory control.

    Attributes
    ----------
    board_id : int
        USB board handle returned by ``Open_Dev``.
    slot_number : int
        Frame-memory slot currently used for display.
    """

    def __init__(
        self,
        board_id=None,
        slot_number=0,
        resolution=(1272, 1024),
        verbose=True,
        dll_path=None,
        wav_um=1,
        pitch_um=(12.5, 12.5),
        **kwargs,
    ):
        """
        Parameters
        ----------
        board_id : int OR None
            USB board to open; None opens the first found.
        slot_number : int
            Frame-memory slot used by :meth:`_set_phase_hw`.
        resolution : (int, int)
            ``(width, height)`` of the head (the DLL does not report it).
        dll_path : str OR None
            Directory containing the Hamamatsu DLLs.
        wav_um, pitch_um, **kwargs
            See :meth:`.SLM.__init__`.
        """
        self._lib = _load_dll(dll_path)
        if verbose:
            print("Hamamatsu SLM initializing... ", end="")

        ids = (ctypes.c_uint8 * 16)()
        n = self._lib.Open_Dev(ctypes.byref(ids), ctypes.c_int32(16))
        if n <= 0:
            raise RuntimeError("No Hamamatsu SLM heads found (Open_Dev).")
        available = [int(ids[i]) for i in range(n)]
        self.board_id = int(board_id) if board_id is not None else available[0]
        if self.board_id not in available:
            raise RuntimeError(
                f"Board {board_id} not in detected boards {available}."
            )
        self.slot_number = int(slot_number)

        serial = ctypes.c_uint32(0)
        self._lib.Check_HeadSerial(
            ctypes.c_uint8(self.board_id), ctypes.byref(serial), ctypes.c_int32(4)
        )
        self.serial = int(serial.value)
        if verbose:
            print(f"success (serial {self.serial})")

        # Frame-memory writes require the head in USB/trigger mode; heads
        # left in DVI mode by other software are switched and rebooted
        # (matching the reference driver's init, ref hamamatsu.py:124-143).
        mode = self.get_mode()
        if mode == 0:
            if verbose:
                print("head in DVI mode; switching to USB and rebooting...")
            self.set_mode(1)
            self.reboot()
            # The controller drops off USB while rebooting; re-open the
            # device and confirm the mode took before any frame upload.
            self._reopen_after_reboot()
        elif mode != 1:
            self.close()
            raise RuntimeError(f"Unknown Hamamatsu SLM mode {mode}.")

        super().__init__(
            tuple(int(x) for x in resolution),
            bitdepth=8,
            name=kwargs.pop("name", f"Hamamatsu_{self.serial}"),
            wav_um=wav_um,
            pitch_um=pitch_um,
            **kwargs,
        )
        self.set_phase(None)

    def _set_phase_hw(self, display, slot_number=None):
        """Upload to the active frame-memory slot and display it."""
        slot = self.slot_number if slot_number is None else int(slot_number)
        data = np.ascontiguousarray(display, dtype=np.uint8)
        h, w = data.shape
        status = self._lib.Write_FMemArray(
            ctypes.c_uint8(self.board_id),
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int32(data.size),
            ctypes.c_uint32(w), ctypes.c_uint32(h),
            ctypes.c_uint32(slot),
        )
        if status != 1:
            warnings.warn(f"Write_FMemArray returned {status}.")
        self._lib.Change_DispSlot(
            ctypes.c_uint8(self.board_id), ctypes.c_uint32(slot)
        )

    def set_slot_number(self, slot_number=0):
        """Select which frame-memory slot future writes use."""
        self.slot_number = int(slot_number)
        self._lib.Change_DispSlot(
            ctypes.c_uint8(self.board_id), ctypes.c_uint32(self.slot_number)
        )

    def get_display(self):
        """Read back the pattern the SLM head is currently displaying."""
        display = np.zeros(self.shape, dtype=np.uint8)
        count = int(self.shape[0] * self.shape[1])
        status = self._lib.Check_Disp_IMG(
            ctypes.c_uint8(self.board_id),
            ctypes.c_int32(count),
            ctypes.c_uint32(self.shape[1]),
            ctypes.c_uint32(self.shape[0]),
            display.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if status != 1:
            raise RuntimeError("Failed to read from Hamamatsu SLM.")
        return display

    def get_temperature(self):
        """Return ``(head_C, board_C)`` temperatures."""
        head = ctypes.c_double(0)
        board = ctypes.c_double(0)
        self._lib.Check_Temp(
            ctypes.c_uint8(self.board_id), ctypes.byref(head), ctypes.byref(board)
        )
        return (float(head.value), float(board.value))

    def get_led_status(self):
        """Return the raw front-panel LED status word."""
        led = ctypes.c_uint32(0)
        self._lib.Check_LED(ctypes.c_uint8(self.board_id), ctypes.byref(led))
        return int(led.value)

    def get_mode(self):
        """Current control mode: ``0`` = DVI (video input), ``1`` =
        USB/trigger (frame-memory slots)."""
        mode = ctypes.c_uint32(0)
        status = self._lib.Mode_Check(
            ctypes.c_uint8(self.board_id), ctypes.byref(mode)
        )
        if status != 1:
            raise RuntimeError("Failed to read Hamamatsu SLM mode.")
        return int(mode.value)

    def set_mode(self, mode):
        """Set the control mode (``0`` = DVI, ``1`` = USB/trigger). A
        mode change only takes effect after :meth:`reboot`."""
        if mode not in (0, 1):
            raise ValueError(f"Unknown Hamamatsu SLM mode {mode}.")
        status = self._lib.Mode_Select(
            ctypes.c_uint8(self.board_id), ctypes.c_uint32(mode)
        )
        if status != 1:
            raise RuntimeError("Failed to set Hamamatsu SLM mode.")

    def reboot(self):
        """Reboot the head."""
        self._lib.Reboot(ctypes.c_uint8(self.board_id))

    def _reopen_after_reboot(self, timeout_s=20.0, poll_s=1.0):
        """Wait for a rebooting controller to re-enumerate on USB, then
        re-open it and verify it came back in USB/trigger mode. The
        board drops off the bus for several seconds after ``Reboot``;
        writing to the stale handle during that window fails."""
        import time

        deadline = time.monotonic() + timeout_s
        last_exc = None
        while time.monotonic() < deadline:
            time.sleep(poll_s)
            try:
                ids = (ctypes.c_uint8 * 16)()
                n = self._lib.Open_Dev(ctypes.byref(ids), ctypes.c_int32(16))
                if n > 0 and self.board_id in [int(ids[i]) for i in range(n)]:
                    if self.get_mode() == 1:
                        return
            except (OSError, RuntimeError) as exc:
                last_exc = exc
        raise RuntimeError(
            f"Hamamatsu head {self.board_id} did not return in USB mode "
            f"within {timeout_s:.0f} s of the mode-switch reboot."
        ) from last_exc

    def close(self):
        """Close the USB device."""
        if getattr(self, "_lib", None) is None:
            return
        ids = (ctypes.c_uint8 * 1)(self.board_id)
        self._lib.Close_Dev(ctypes.byref(ids), ctypes.c_int32(1))
        self._lib = None

    @staticmethod
    def info(verbose=True, dll_path=None):
        """Enumerate attached boards (board IDs)."""
        lib = _load_dll(dll_path)
        ids = (ctypes.c_uint8 * 16)()
        n = lib.Open_Dev(ctypes.byref(ids), ctypes.c_int32(16))
        found = [int(ids[i]) for i in range(max(n, 0))]
        if n > 0:
            lib.Close_Dev(ctypes.byref(ids), ctypes.c_int32(n))
        if verbose:
            print("Hamamatsu boards:", found)
        return found
