"""
Texas Instruments Phase Light Modulators (PLM EVMs) — piston-motion MEMS
phase modulators driven by DLPC900 controllers.

A PLM pixel is a micromirror with 16 discrete piston heights. Each pixel
is addressed through 4 memory bits laid out spatially as a 2x2 electrode
block, so an ``(H, W)`` phase-state image becomes a ``(2H, 2W)`` binary
bitmap on the video input. This driver:

1. quantizes continuous phase to the nearest of the 16 (non-uniform)
   height-derived phase levels,
2. maps states through the memory LUT and spreads bits onto the
   electrode grid,
3. displays the bitmap through a mirrored video output
   (:class:`~slmsuite_torch.hardware.slms.screenmirrored.ScreenMirrored`),
4. configures the DLPC900 controller(s) over USB HID.

Model geometry/LUT constants are Texas Instruments' published EVM
specifications (TI's MIT-licensed ti-phase-light-modulator repository).

Parity: reference ``slmsuite/hardware/slms/texasinstruments.py``
(``PLM``, ``DLPC900``) and ``texas_instruments.yaml``.
"""

import os
import time
import warnings
from enum import IntEnum

import numpy as np

from slmsuite_torch.hardware import _optional_import
from slmsuite_torch.hardware.slms.screenmirrored import ScreenMirrored

hid = None  # hidapi, imported by _import_sdk() when a controller is opened.


def _import_sdk():
    """hidapi's ``hid``, imported on first use; None where it is not
    installed."""
    global hid
    if hid is None:
        hid = _optional_import("hid")
    return hid


#: Package-data model database (TI-published PLM EVM specifications;
#: ref ships the same facts in ``texas_instruments.yaml``).
MODEL_DB_PATH = os.path.join(os.path.dirname(__file__), "texas_instruments.yaml")


def _load_model_db(path=MODEL_DB_PATH):
    """
    Load the PLM model database from :data:`MODEL_DB_PATH`.

    ``displacement_ratios`` are the 16 mirror heights as fractions of
    full stroke; ``memory_lut`` maps a height state to its 4-bit memory
    code; ``electrode_layout`` places memory bit b within the pixel's
    2x2 electrode block; ``data_flip`` flips the bitpacked frame.
    Values are normalized to hashable tuples (the in-memory schema the
    driver code indexes).
    """
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    models = {}
    for key, spec in raw.items():
        models[key] = {
            "name": str(spec["name"]),
            "shape": tuple(int(v) for v in spec["shape"]),
            "pitch_um": tuple(float(v) for v in spec["pitch_um"]),
            "displacement_ratios": tuple(
                float(v) for v in spec["displacement_ratios"]
            ),
            "memory_lut": tuple(int(v) for v in spec["memory_lut"]),
            "electrode_layout": tuple(
                tuple(int(v) for v in row) for row in spec["electrode_layout"]
            ),
            "data_flip": tuple(bool(v) for v in spec["data_flip"]),
        }
    return models


PLM_MODELS = _load_model_db()

#: USB identifiers for the DLPC900 HID interface.
DLPC900_VENDOR_ID = 0x0451
DLPC900_PRODUCT_ID = 0xC900


class DisplayMode(IntEnum):
    """DLPC900 display modes (programmer's guide, USB 0x1A1B)."""
    VIDEO = 0
    PRE_STORED_PATTERN = 1
    VIDEO_PATTERN = 2
    OTF_PATTERN = 3


class DLPC900Command(IntEnum):
    """USB command words (CMD3<<8 | CMD2) from the DLPC900 programmer's guide."""
    HARDWARE_STATUS = 0x1A0A
    SYSTEM_STATUS = 0x1A0B
    MAIN_STATUS = 0x1A0C
    FIRMWARE_VERSION = 0x0205
    POWER_MODE = 0x0200
    INPUT_SOURCE = 0x1A00
    IT6535_POWER = 0x1A01
    PORT_CLOCK = 0x1A03
    DISPLAY_MODE = 0x1A1B
    PATTERN_START_STOP = 0x1A24
    PATTERN_LUT_CONFIG = 0x1A31
    PATTERN_LUT_DEFINE = 0x1A34
    PATTERN_TRIGGER_MODE = 0x1A23


class DLPC900:
    """
    One DLPC900 controller over USB HID.

    Write transactions: 64-byte HID reports with a 4-byte header
    (flags, sequence, 16-bit payload length) followed by the 16-bit USB
    command and payload, continuing headerless in subsequent reports.
    """

    _REPORT_SIZE = 64

    def __init__(self, vendor_id=None, product_id=None, serial=None):
        if _import_sdk() is None:
            raise ImportError(
                "The `hidapi` package (module `hid`) is required for DLPC900 "
                "control. Video display still works without it."
            )
        self.device = hid.device()
        self.device.open(
            vendor_id or DLPC900_VENDOR_ID,
            product_id or DLPC900_PRODUCT_ID,
            serial,
        )
        self._sequence = 0

    def _transact(self, command, payload=b"", read=False, read_length=0):
        """Send one command; optionally read back a reply payload."""
        self._sequence = (self._sequence + 1) % 256
        flags = 0xC0 if read else 0x40  # host->device write, reply requested bit.
        body = bytes(
            [flags, self._sequence]
        ) + (len(payload) + 2).to_bytes(2, "little") + command.to_bytes(
            2, "little"
        ) + bytes(payload)

        # Chunk into 64-byte reports, report ID 0 prefix on each.
        for start in range(0, len(body), self._REPORT_SIZE):
            chunk = body[start:start + self._REPORT_SIZE]
            chunk += b"\x00" * (self._REPORT_SIZE - len(chunk))
            self.device.write(b"\x00" + chunk)

        if not read:
            return None
        reply = bytes(self.device.read(self._REPORT_SIZE, timeout_ms=2000))
        if not reply:
            raise RuntimeError(f"DLPC900 read timeout on {command:#06x}.")
        length = int.from_bytes(reply[2:4], "little")
        return reply[4:4 + max(length, read_length)]

    def get_hardware_status(self):
        """Return the hardware status byte; bit 0 set means healthy init."""
        return self._transact(DLPC900Command.HARDWARE_STATUS, read=True)[0]

    def get_main_status(self):
        """Return the main status byte (mirror parked/sequencer state)."""
        return self._transact(DLPC900Command.MAIN_STATUS, read=True)[0]

    def get_firmware_version(self):
        """Return ``(app, api, software)`` version tuples."""
        data = self._transact(DLPC900Command.FIRMWARE_VERSION, read=True)
        def unpack(word):
            value = int.from_bytes(word, "little")
            return (value >> 24, (value >> 16) & 0xFF, value & 0xFFFF)
        return tuple(unpack(data[i:i + 4]) for i in range(0, 12, 4))

    def set_input_source(self, source=0, bitdepth=0):
        """Select parallel RGB (0), test pattern (1), flash (2), FPD (3)."""
        self._transact(DLPC900Command.INPUT_SOURCE, bytes([source, bitdepth]))

    def set_port_clock(self, data_port=0, px_clock=0, data_enable=0, vhsync=0):
        """Route the parallel-bus port/clock/sync configuration."""
        self._transact(
            DLPC900Command.PORT_CLOCK,
            bytes([data_port | (px_clock << 2) | (data_enable << 4) | (vhsync << 6)]),
        )

    def set_display_mode(self, mode):
        """Set :class:`DisplayMode`; poll until the sequencer settles."""
        self._transact(DLPC900Command.DISPLAY_MODE, bytes([int(mode)]))
        for _ in range(20):
            if self.get_display_mode() == int(mode):
                return
            time.sleep(0.25)
        raise RuntimeError(f"DLPC900 did not enter display mode {mode}.")

    def get_display_mode(self):
        return self._transact(DLPC900Command.DISPLAY_MODE, read=True)[0]

    def start_pattern(self):
        self._transact(DLPC900Command.PATTERN_START_STOP, bytes([2]))

    def pause_pattern(self):
        self._transact(DLPC900Command.PATTERN_START_STOP, bytes([1]))

    def stop_pattern(self):
        self._transact(DLPC900Command.PATTERN_START_STOP, bytes([0]))

    def configure_pattern_lut(self, num_entries, num_repeats=0):
        """Set the pattern LUT length and repeat count (0 = forever)."""
        payload = (num_entries.to_bytes(2, "little")
                   + num_repeats.to_bytes(4, "little"))
        self._transact(DLPC900Command.PATTERN_LUT_CONFIG, payload)

    def define_pattern(
        self,
        index,
        exposure_us,
        bitdepth=1,
        dark_time_us=0,
        color=7,
        trigger_wait=False,
        clear_after=False,
        bit_position=0,
    ):
        """
        Define pattern-LUT entry ``index`` (video-pattern mode): which bit
        slice of the incoming 24-bit video frame to display and for how long.
        """
        byte5 = (
            ((bitdepth - 1) & 0x7)
            | ((color & 0x7) << 3)
            | (0x80 if trigger_wait else 0)
        )
        payload = (
            index.to_bytes(2, "little")
            + exposure_us.to_bytes(3, "little")
            + bytes([byte5])
            + dark_time_us.to_bytes(3, "little")
            + bytes([0x01 if clear_after else 0x00, bit_position])
        )
        self._transact(DLPC900Command.PATTERN_LUT_DEFINE, payload)

    def set_it6535_power(self, mode=1):
        """Power the IT6535 receiver: 0 off, 1 HDMI, 2 DisplayPort."""
        self._transact(DLPC900Command.IT6535_POWER, bytes([mode]))

    def standby(self):
        self._transact(DLPC900Command.POWER_MODE, bytes([1]))

    def wakeup(self):
        self._transact(DLPC900Command.POWER_MODE, bytes([0]))

    def reset(self):
        """Soft-reset the DLPC900 controller."""
        self._transact(DLPC900Command.POWER_MODE, bytes([2]))

    def close(self):
        if getattr(self, "device", None) is not None:
            self.device.close()
            self.device = None


class PLM(ScreenMirrored):
    """
    TI PLM EVM: phase quantization + electrode packing on top of a
    mirrored video output, with DLPC900 USB configuration.

    Attributes
    ----------
    model : dict
        Entry of :data:`PLM_MODELS`.
    controllers : list of DLPC900
        USB controller handles (may be empty if ``hid`` is unavailable).
    """

    def __init__(
        self,
        display_number,
        model="p67",
        wav_um=0.633,
        wav_design_um=None,
        configure_usb=True,
        verbose=True,
        **kwargs,
    ):
        """
        Parameters
        ----------
        display_number : int
            Video output carrying the PLM (see :meth:`ScreenMirrored.info`).
        model : str
            Key of :data:`PLM_MODELS` (``'p47'``, ``'p67'``).
        wav_um : float
            Operating wavelength.
        wav_design_um : float OR None
            Wavelength at which full mirror stroke gives exactly 2pi of
            (double-pass) phase; defaults to ``wav_um``.
        configure_usb : bool
            Configure the DLPC900(s) into video-pattern mode over HID.
        **kwargs
            Passed to :meth:`ScreenMirrored.__init__`.
        """
        if model not in PLM_MODELS:
            raise ValueError(f"Unknown PLM model '{model}'; see PLM.get_model_list().")
        self.model = PLM_MODELS[model]
        self.plm_shape = tuple(self.model["shape"])  # (H, W) mirrors.

        wav_design_um = wav_um if wav_design_um is None else wav_design_um
        self._init_quantize_lut(wav_um, wav_design_um)

        super().__init__(
            display_number,
            bitdepth=8,
            verbose=verbose,
            wav_um=wav_um,
            pitch_um=self.model["pitch_um"],
            **kwargs,
        )

        # The video output is the electrode grid: 2x the mirror count per
        # axis. Sanity-check against the detected screen.
        expected = (2 * self.plm_shape[0], 2 * self.plm_shape[1])
        if self.shape[0] < expected[0] or self.shape[1] < expected[1]:
            warnings.warn(
                f"Screen {self.shape} smaller than electrode grid {expected}."
            )

        self.controllers = []
        if configure_usb:
            self._configure_usb(verbose=verbose)

    def _configure_usb(self, verbose=True):
        """Put every attached DLPC900 into video-pattern (1-bit) mode."""
        if _import_sdk() is None:
            warnings.warn("hidapi not installed; skipping DLPC900 USB config.")
            return
        for info in hid.enumerate(DLPC900_VENDOR_ID, DLPC900_PRODUCT_ID):
            controller = DLPC900(serial=info.get("serial_number"))
            controller.set_it6535_power(1)
            controller.set_input_source(0)
            controller.stop_pattern()
            controller.set_display_mode(DisplayMode.VIDEO_PATTERN)
            # One 1-bit pattern per frame, displayed from video bit 0.
            controller.configure_pattern_lut(1, 0)
            controller.define_pattern(0, exposure_us=0, bitdepth=1, bit_position=0)
            controller.start_pattern()
            self.controllers.append(controller)
        if verbose:
            print(f"Configured {len(self.controllers)} DLPC900 controller(s).")

    def _init_quantize_lut(self, wav_um, wav_design_um):
        """
        Build the 256-entry gray-level -> electrode-bitcode LUT.

        Mirror state k sits at height ``ratios[k] * stroke`` where the full
        stroke retards ``2pi * wav_design / wav`` of double-pass phase.
        Each of the 256 uniform phase bins maps to the circularly-nearest
        state, then through the memory LUT to its 4-bit code.
        """
        ratios = np.asarray(self.model["displacement_ratios"], dtype=float)
        state_phase = 2 * np.pi * ratios * (wav_design_um / wav_um)
        gray_phase = 2 * np.pi * np.arange(256) / 256

        # Circular distance on the unit circle.
        delta = np.angle(
            np.exp(1j * (gray_phase[:, None] - state_phase[None, :]))
        )
        nearest_state = np.argmin(np.abs(delta), axis=1)
        memory_lut = np.asarray(self.model["memory_lut"], dtype=np.uint8)
        self._gray_to_code = memory_lut[nearest_state]  # (256,) uint8 codes.

    def _electrode_map(self, codes):
        """
        Spread 4-bit ``codes`` (H, W) onto the (2H, 2W) electrode grid
        as a full-scale binary image, honoring the model's bit layout
        and scan flips.
        """
        h, w = codes.shape
        layout = self.model["electrode_layout"]
        out = np.zeros((2 * h, 2 * w), dtype=np.uint8)
        for dy in range(2):
            for dx in range(2):
                bit = layout[dy][dx]
                out[dy::2, dx::2] = ((codes >> bit) & 1) * 255
        flip_y, flip_x = self.model["data_flip"]
        if flip_y:
            out = out[::-1, :]
        if flip_x:
            out = out[:, ::-1]
        return np.ascontiguousarray(out)

    def _pack_frame(self, display):
        """8-bit gray ``display`` (already cropped to :attr:`plm_shape`)
        -> (2H, 2W) electrode bitmap. Prefers the fused one-pass C kernel
        (:meth:`slmsuite_torch.native.plm_electrode_map_native`: LUT gather
        + bit spread + scan flips together); falls back to the numpy
        passes."""
        from slmsuite_torch.native import plm_electrode_map_native

        display = np.ascontiguousarray(display, dtype=np.uint8)
        h, w = display.shape
        out = np.empty((2 * h, 2 * w), dtype=np.uint8)
        layout = self.model["electrode_layout"]
        flip_y, flip_x = self.model["data_flip"]
        if plm_electrode_map_native(
            display, out, self._gray_to_code,
            [layout[dy][dx] for dy in range(2) for dx in range(2)],
            flip_y, flip_x,
        ):
            return out
        return self._electrode_map(self._gray_to_code[display])

    def _set_phase_hw(self, display, block=True):
        """Quantize to PLM states, pack electrodes, and render."""
        display = np.asarray(display, dtype=np.uint8)
        # 8-bit gray from SLM._phase2gray -> 4-bit electrode code -> bitmap.
        bitmap = self._pack_frame(
            display[: self.plm_shape[0], : self.plm_shape[1]]
        )

        # Pad to the full screen if the electrode grid undershoots it.
        full = np.zeros((self.shape[0], self.shape[1]), dtype=np.uint8)
        full[: bitmap.shape[0], : bitmap.shape[1]] = bitmap[
            : self.shape[0], : self.shape[1]
        ]
        self.window_thread.render(full, block=block)

    def close(self):
        for controller in getattr(self, "controllers", []):
            try:
                controller.stop_pattern()
                controller.close()
            except Exception:
                pass
        self.controllers = []
        super().close()

    @staticmethod
    def get_model_list():
        """Names of supported PLM EVMs."""
        return list(PLM_MODELS.keys())

    @staticmethod
    def load_model_config(model_name):
        """Return the configuration dict for a PLM EVM model key."""
        if model_name not in PLM_MODELS:
            raise ValueError(
                f"Model '{model_name}' not found. "
                f"Available models: {list(PLM_MODELS)}"
            )
        return dict(PLM_MODELS[model_name])

    @staticmethod
    def bitpack(bitmaps):
        """
        Pack 8 (or 24) binary CGH bitmaps into one 8-bit (or RGB 24-bit)
        frame: bitmap ``k``'s LSB becomes bit ``k`` of the (per-channel)
        output. The DLPC900 replays the packed bitplanes sequentially.

        Returns an array of shape ``(1, H, W)`` (8 bitmaps) or
        ``(3, H, W)`` (24 bitmaps), dtype uint8.
        """
        bitmaps = [np.asarray(bm) for bm in bitmaps]
        if len(bitmaps) not in (8, 24):
            raise ValueError(
                f"bitpack expects 8 or 24 bitmaps; got {len(bitmaps)}."
            )

        def pack8(maps):
            from slmsuite_torch.native import plm_bitpack8_native

            stacked = np.ascontiguousarray(np.stack(maps), dtype=np.uint8)
            out = np.empty(stacked.shape[1:], dtype=np.uint8)
            if plm_bitpack8_native(stacked, out):
                return out
            stacked &= 1
            shifts = np.arange(8, dtype=np.uint8)[:, None, None]
            return np.bitwise_or.reduce(np.left_shift(stacked, shifts), axis=0)

        if len(bitmaps) == 8:
            return pack8(bitmaps)[None, ...]
        return np.stack([pack8(bitmaps[8 * n:8 * (n + 1)]) for n in range(3)])
