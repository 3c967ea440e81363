"""
Meadowlark Optics SLMs via the Blink SDK (``Blink_C_wrapper.dll``).

Meadowlark has shipped several generations of the Blink SDK whose C
entry points differ in name AND arity: the HDMI-interfaced SDK, three
"modern" PCIe SDK revisions, and the legacy PCIe ("HSP") SDK. The
generation is detected by parsing the argument counts of
``Create_SDK``/``Write_image`` out of the SDK's own ``Blink_C_wrapper.h``
header (the vendor keeps the header next to the DLL), falling back to a
symbol heuristic when no header ships. All per-generation differences —
constructor arity, write-call arity, geometry/telemetry function names —
live in the :data:`SDK_VARIANTS` table rather than branchy methods.

The SDK is Windows-only and loaded with :mod:`ctypes`; this module
imports cleanly without it.

Parity: reference ``slmsuite/hardware/slms/meadowlark.py`` (``Meadowlark``,
``_SDK_MODE`` at ``:34-68``, header tracing at ``:846-880``).
"""

import ctypes
import os
import warnings

import numpy as np

from slmsuite_torch.hardware.slms.slm import SLM

#: Default install roots searched for the Blink SDK.
_DEFAULT_SDK_ROOTS = [
    "C:\\Program Files\\Meadowlark Optics\\Blink OverDrive Plus\\SDK",
    "C:\\Program Files\\Meadowlark Optics\\Blink 1920 HDMI\\SDK",
    "C:\\Program Files\\Meadowlark Optics",
]


#: Package-data SDK compatibility matrix (feature support per Blink SDK
#: generation; same facts as the reference's ``meadowlark.csv`` table).
SDK_TABLE_PATH = os.path.join(os.path.dirname(__file__), "meadowlark.csv")

#: Per-generation SDK description. ``traces`` are the
#: ``(len(args(Create_SDK)), len(args(Write_image)))`` pairs seen in that
#: generation's header; ``temperature``/``coverglass`` map to the
#: ``(function_name, takes_board_argument)`` pair for telemetry; the
#: geometry entries likewise. ``write`` names the dispatch style used by
#: :meth:`Meadowlark._set_phase_hw`.
SDK_VARIANTS = {
    "hdmi": dict(
        traces={(0, 2), (1, 2), (0, 3)},
        pcie=False,
        width=("Get_Width", False),
        height=("Get_Height", False),
        depth=("Get_Depth", False),
        serial=(None, False),  # HDMI SDK exposes no serial read.
        temperature=("Get_SLMTemp", False),
        coverglass=("Get_SLMVCom", False),
        write="hdmi",
    ),
    "pcie_modern_3": dict(
        traces={(2, 3)},
        pcie=True,
        width=("Get_image_width", True),
        height=("Get_image_height", True),
        depth=("Get_image_depth", True),
        serial=("Read_Serial_Number", True),
        temperature=("Read_SLM_temperature", True),
        # All modern PCIe generations (incl. the 3-argument one) read the
        # coverglass through Get_cover_voltage (ref meadowlark.py:515-527).
        coverglass=("Get_cover_voltage", True),
        write="pcie_3",
    ),
    "pcie_modern_6": dict(
        traces={(2, 6)},
        pcie=True,
        width=("Get_image_width", True),
        height=("Get_image_height", True),
        depth=("Get_image_depth", True),
        serial=("Read_Serial_Number", True),
        temperature=("Get_SLMTemp", True),
        coverglass=("Get_cover_voltage", True),
        write="pcie_6",
    ),
    "pcie_modern_8": dict(
        traces={(2, 8)},
        pcie=True,
        width=("Get_image_width", True),
        height=("Get_image_height", True),
        depth=("Get_image_depth", True),
        serial=("Read_Serial_Number", True),
        temperature=("Get_SLMTemp", True),
        coverglass=("Get_cover_voltage", True),
        write="pcie_8",
    ),
    "pcie_legacy": dict(
        traces={(8, 8)},
        pcie=True,
        width=("Get_image_width", True),
        height=("Get_image_height", True),
        depth=("Get_image_depth", True),
        serial=("Read_Serial_Number", True),
        # The legacy HSP SDK exposes no temperature/coverglass telemetry
        # (ref meadowlark.py:496-499,527-530 raises NotImplementedError).
        temperature=(None, False),
        coverglass=(None, False),
        write="pcie_8",  # Legacy HSP boards share the 8-argument write.
    ),
}


def sdk_feature_table(path=SDK_TABLE_PATH):
    """
    Blink-SDK compatibility matrix as
    ``{feature: {"hdmi": ..., "pcie": ..., "legacy_pcie": ...}}``.
    Boolean-ish cells parse to bools; free-text cells (tested models,
    resolutions, versions) stay strings. Use to check whether a call
    like :meth:`Meadowlark.get_temperature` is meaningful on the
    detected ``sdk_interface`` before driving hardware.
    """
    import csv

    def parse(cell):
        if cell in ("yes", "y"):
            return True
        if cell in ("no", "n", ""):
            return False
        return cell

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header = rows[0][1:]
    return {
        row[0]: dict(zip(header, (parse(c) for c in row[1:])))
        for row in rows[1:]
    }


def _find_dll(sdk_path=None):
    """Locate ``Blink_C_wrapper.dll`` under ``sdk_path`` or default roots
    (calibration-kit copies excluded). Root order is deterministic — the
    FIRST root containing a DLL wins (mtime only breaks ties within a
    root; an unrelated reinstall must not silently flip which SDK
    generation drives the hardware)."""
    roots = [sdk_path] if sdk_path else _DEFAULT_SDK_ROOTS
    for root in roots:
        if root is None or not os.path.isdir(root):
            continue
        found = []
        for dirpath, _, filenames in os.walk(root):
            if "Cal Kit" in dirpath:
                continue
            for fname in filenames:
                if fname.lower() == "blink_c_wrapper.dll":
                    found.append(os.path.join(dirpath, fname))
        if found:
            found.sort(key=os.path.getmtime, reverse=True)
            return found[0]
    raise FileNotFoundError(
        "Blink_C_wrapper.dll not found. Install the Meadowlark Blink SDK "
        "or pass sdk_path pointing at it."
    )


def _parse_sdk_header(dll_path):
    """
    Argument-count trace ``(n_args(Create_SDK), n_args(Write_image))``
    from the ``Blink_C_wrapper.h`` header shipped next to ``dll_path``,
    or None when the header is absent/unparsable. This is the reliable
    generation fingerprint — the vendor changed these aritites with each
    SDK revision (see :data:`SDK_VARIANTS`).
    """
    header = os.path.join(os.path.dirname(dll_path), "Blink_C_wrapper.h")
    if not os.path.isfile(header):
        return None
    try:
        # Vendor headers carry CP1252 banner bytes on occasion; decode
        # permissively — only the ASCII prototypes matter here.
        with open(header, errors="replace") as f:
            text = f.read()
        trace = []
        for name in ("Create_SDK(", "Write_image("):
            start = text.find(name)
            if start < 0:
                return None
            args = text[start:].split("(", 1)[1].split(")", 1)[0].strip()
            trace.append(0 if len(args) < 2 else args.count(",") + 1)
        return tuple(trace)
    except (OSError, ValueError):
        return None


def _detect_variant(dll_path, lib):
    """SDK generation name (:data:`SDK_VARIANTS` key) for a loaded DLL:
    header-trace match first, exported-symbol heuristic as fallback."""
    trace = _parse_sdk_header(dll_path)
    if trace is not None:
        for name, spec in SDK_VARIANTS.items():
            if trace in spec["traces"]:
                return name
        warnings.warn(
            f"Unrecognized Blink SDK header trace {trace}; "
            f"falling back to symbol detection."
        )
    # No/unknown header: split on the symbols unique to each family.
    # Exported symbols cannot distinguish the modern PCIe revisions
    # (only the header arity can) — warn, since calling the wrong
    # Write_image arity mis-feeds the vendor ABI.
    if hasattr(lib, "Get_Width") and not hasattr(lib, "Get_image_width"):
        return "hdmi"
    if hasattr(lib, "Get_last_error_message"):
        warnings.warn(
            "Blink_C_wrapper.h not found next to the DLL: a modern PCIe "
            "SDK was detected by symbols, but the Write_image revision "
            "(6- vs 8-argument) cannot be distinguished without the "
            "header. Assuming the 6-argument revision — reinstall the "
            "SDK with its header if writes fail."
        )
        return "pcie_modern_6"
    if hasattr(lib, "Set_true_frames") or hasattr(lib, "Get_image_width"):
        return "pcie_legacy"
    return "hdmi"


class Meadowlark(SLM):
    """
    Meadowlark SLM through the Blink SDK.

    Attributes
    ----------
    slm_lib : ctypes.CDLL
        Handle to ``Blink_C_wrapper``.
    sdk_variant : str
        Which SDK generation was detected (:data:`SDK_VARIANTS` key).
    sdk_interface : {'hdmi', 'pcie'}
        Coarse interface class (back-compatible alias of the variant).
    slm_number : int
        Board index (PCIe SDKs support multiple boards).
    """

    #: Loaded DLLs, one per variant — the vendor SDK misbehaves when the
    #: same generation is constructed twice in a process.
    _lib_cache = {}
    #: Board count reported at Create_SDK time, per variant.
    _board_count = {}
    #: Header trace ``(create_args, write_args)`` per variant — the HDMI
    #: family shipped both 2- and 3-argument ``Write_image`` revisions.
    _trace = {}
    #: Live instances per variant; Delete_SDK runs when the LAST board
    #: closes (PCIe SDKs serve several boards from one SDK handle).
    _refcount = {}

    def __init__(
        self,
        verbose=True,
        sdk_path=None,
        lut_path=None,
        slm_number=1,
        wav_um=1,
        pitch_um=None,
        **kwargs,
    ):
        """
        Parameters
        ----------
        sdk_path : str OR None
            Root to search for the Blink SDK DLL (default: standard installs).
        lut_path : str OR None
            Path to a ``.lut`` calibration file, or a directory to search;
            the SDK's default LUT is used if None.
        slm_number : int
            1-indexed board number (PCIe only).
        pitch_um : (float, float) OR None
            Pixel pitch; None queries the SDK where supported
            (modern PCIe ``Get_pitch``), else defaults to 8 um.
        wav_um, **kwargs
            See :meth:`.SLM.__init__`.
        """
        if verbose:
            print("Meadowlark SLM initializing... ", end="")
        dll_path = _find_dll(sdk_path)
        self.slm_number = int(slm_number)
        self.sdk_variant, self.slm_lib = self._open_sdk(dll_path)
        Meadowlark._refcount[self.sdk_variant] = (
            Meadowlark._refcount.get(self.sdk_variant, 0) + 1
        )
        self.sdk_interface = (
            "pcie" if SDK_VARIANTS[self.sdk_variant]["pcie"] else "hdmi"
        )

        n_boards = Meadowlark._board_count.get(self.sdk_variant, 1)
        if self.is_pcie and n_boards < self.slm_number:
            raise RuntimeError(
                f"Blink SDK found {n_boards} board(s); requested "
                f"board {self.slm_number}."
            )

        width = self._query("width")
        height = self._query("height")
        depth = self._query("depth")
        bitdepth = int(depth) if depth in (8, 12, 16) else (
            12 if self.is_pcie else 8
        )
        if pitch_um is None:
            pitch_um = self._query_pitch()

        self._load_lut(lut_path)
        if verbose:
            print("success")

        super().__init__(
            (int(width), int(height)),
            bitdepth=bitdepth,
            name=kwargs.pop("name", f"Meadowlark_{slm_number}"),
            wav_um=wav_um,
            pitch_um=pitch_um,
            settle_time_s=kwargs.pop("settle_time_s", 0.3),
            **kwargs,
        )
        self.set_phase(None)

    # ---------------------------------------------------------------- SDK

    @classmethod
    def _open_sdk(cls, dll_path):
        """Load (or reuse) the DLL for ``dll_path`` and run the
        per-generation ``Create_SDK`` handshake. Returns
        ``(variant, lib)``."""
        lib = ctypes.CDLL(dll_path)
        variant = _detect_variant(dll_path, lib)
        cached = cls._lib_cache.get(variant)
        if cached is not None:
            return variant, cached

        spec = SDK_VARIANTS[variant]
        # Headerless fallback traces are the SAFE arity per family (the
        # HDMI set contains both 2- and 3-argument writes; set iteration
        # order must not pick the write arity).
        fallback = {
            "hdmi": (0, 2), "pcie_modern_3": (2, 3),
            "pcie_modern_6": (2, 6), "pcie_modern_8": (2, 8),
            "pcie_legacy": (8, 8),
        }[variant]
        trace = _parse_sdk_header(dll_path) or fallback
        cls._trace[variant] = trace
        if variant == "hdmi":
            if trace[0] == 1:
                lib.Create_SDK(ctypes.c_uint(1))  # 1 = "python caller".
            else:
                lib.Create_SDK()
            cls._board_count[variant] = 1
        elif variant == "pcie_legacy":
            # The legacy HSP Create_SDK takes the full option block; the
            # OverDrive-specific options stay at vendor defaults.
            n_boards = ctypes.c_uint(0)
            ok = ctypes.c_bool(False)
            lib.Create_SDK(
                ctypes.c_uint(8),            # bitdepth (HSP512 boards)
                ctypes.byref(n_boards),
                ctypes.byref(ok),
                ctypes.c_bool(True),         # is_nematic_type
                ctypes.c_bool(True),         # RAM_write_enable
                ctypes.c_bool(False),        # use_GPU (OverDrive only)
                ctypes.c_uint(10),           # max_transients (OverDrive)
                ctypes.c_int(0),             # regional LUT (OverDrive)
            )
            if not ok.value:
                raise RuntimeError("Blink legacy PCIe SDK init failed.")
            cls._board_count[variant] = int(n_boards.value)
        else:
            # Modern PCIe: Create_SDK(&n_boards, &status).
            n_boards = ctypes.c_uint(0)
            status = ctypes.c_int(-1)
            lib.Create_SDK(ctypes.byref(n_boards), ctypes.byref(status))
            if status.value not in (0, 1):  # 0 = success with no boards.
                raise RuntimeError(
                    f"Blink PCIe SDK init failed (status {status.value})."
                )
            cls._board_count[variant] = int(n_boards.value)
        cls._lib_cache[variant] = lib
        return variant, lib

    def _query(self, what):
        """Run a :data:`SDK_VARIANTS` geometry/telemetry getter; returns
        the raw value or None when the generation lacks the call."""
        name, takes_board = SDK_VARIANTS[self.sdk_variant][what]
        if name is None or not hasattr(self.slm_lib, name):
            return None
        fn = getattr(self.slm_lib, name)
        if takes_board:
            return fn(ctypes.c_int(self.slm_number))
        return fn()

    def _query_pitch(self):
        """Pixel pitch in um from the SDK (modern PCIe ``Get_pitch``),
        or the 8 um default every current Meadowlark model uses."""
        if self.is_pcie and hasattr(self.slm_lib, "Get_pitch"):
            self.slm_lib.Get_pitch.restype = ctypes.c_double
            pitch = float(self.slm_lib.Get_pitch(ctypes.c_int(self.slm_number)))
            if pitch > 0:
                return (pitch, pitch)
        return (8, 8)

    # ---------------------------------------------------------------- LUT

    @staticmethod
    def _locate_lut_file(search_path, slm_shape=None):
        """
        Pick the ``.lut`` file to load from ``search_path`` (searched
        recursively). Meadowlark ships per-device calibrations named like
        ``slm5758_at532.lut``; when several files are present, prefer one
        whose name carries the SLM's own dimensions, else fall back to
        the most recently created file (warning). Ref
        ``meadowlark.py:968-1018``.
        """
        import glob

        files = set(
            glob.glob(os.path.join(str(search_path), "**", "*.lut"),
                      recursive=True)
        )
        if len(files) == 1:
            return files.pop()
        if not files:
            raise FileNotFoundError(f"No .lut file found in '{search_path}'.")
        if slm_shape:
            matching = {
                f for f in files
                if str(slm_shape[1]) in os.path.basename(f)
                and str(slm_shape[0]) in os.path.basename(f)
            }
            if len(matching) == 1:
                return matching.pop()
            if matching:
                files = matching
        best = max(files, key=os.path.getctime)
        warnings.warn(
            f"Multiple LUT files located. Defaulting to the most recent "
            f"one: {best}.")
        return best

    def _load_lut(self, lut_path):
        """Load a voltage lookup table (the phase-to-voltage calibration
        of the liquid crystal); directories are searched via
        :meth:`_locate_lut_file`, preferring a file matching this SLM's
        dimensions."""
        if lut_path is not None and os.path.isdir(lut_path):
            slm_shape = tuple(self.shape) if hasattr(self, "shape") else None
            lut_path = self._locate_lut_file(lut_path, slm_shape)
        if lut_path is None:
            return None
        if not os.path.exists(lut_path):
            raise FileNotFoundError(f"Failed to locate LUT at: '{lut_path}'.")
        encoded = str(lut_path).encode("utf-8")
        if self.is_pcie:
            success = self.slm_lib.Load_LUT_file(
                ctypes.c_uint(self.slm_number), encoded
            )
            if success != 1:
                warnings.warn(f"Failed to load LUT file: '{lut_path}'.")
        else:
            self.slm_lib.Load_lut(encoded)
        return str(lut_path)

    def load_lut(self, lut_path):
        """Load a voltage lookup table (``.lut`` file, or a directory to
        search for one — see :meth:`_locate_lut_file` for the selection
        rules). Returns the path that was loaded."""
        return self._load_lut(lut_path)

    # -------------------------------------------------------------- write

    #: Whether image writes wait for an external input trigger (PCIe).
    _wait_for_trigger = False
    #: Whether image writes emit an output trigger pulse (PCIe).
    _output_pulse = False
    #: Whether an output pulse also fires on every SLM refresh (PCIe 8-arg).
    _output_pulse_refresh = False

    @property
    def is_pcie(self):
        """Whether the detected SDK uses a PCIe connection."""
        return self.sdk_interface == "pcie"

    def _set_phase_hw(self, display, timeout_s=5.0):
        data = np.ascontiguousarray(display)
        ptr = data.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        style = SDK_VARIANTS[self.sdk_variant]["write"]
        board = ctypes.c_uint(self.slm_number)
        timeout = ctypes.c_uint(int(timeout_s * 1000))

        if style == "hdmi":
            # The HDMI family shipped 2- and 3-argument Write_image
            # revisions (the 3-argument one takes the board first).
            if Meadowlark._trace.get("hdmi", (0, 2))[1] == 3:
                self.slm_lib.Write_image(
                    board, ptr, ctypes.c_uint(self.bitdepth == 8)
                )
            else:
                self.slm_lib.Write_image(
                    ptr, ctypes.c_uint(self.bitdepth == 8)
                )
            return
        # The PCIe writes never flip_immediate: the flip must wait for
        # vsync so all pixels land on the same frame.
        if style == "pcie_3":
            status = self.slm_lib.Write_image(board, ptr, timeout)
        elif style == "pcie_6":
            status = self.slm_lib.Write_image(
                board, ptr,
                ctypes.c_bool(self._wait_for_trigger),
                ctypes.c_bool(False),                  # flip_immediate
                ctypes.c_bool(self._output_pulse),
                timeout,
            )
        else:  # pcie_8 (modern 8-argument and legacy HSP)
            status = self.slm_lib.Write_image(
                board, ptr, ctypes.c_uint(data.size),
                ctypes.c_bool(self._wait_for_trigger),
                ctypes.c_bool(False),                  # flip_immediate
                ctypes.c_bool(self._output_pulse),
                ctypes.c_bool(self._output_pulse_refresh),
                timeout,
            )
        if status != 1:
            raise RuntimeError("Blink SDK Write_image failed (DMA error).")
        status = self.slm_lib.ImageWriteComplete(board, timeout)
        if status != 1:
            raise RuntimeError(
                "Blink SDK ImageWriteComplete failed — trigger never "
                "received within the timeout?"
            )

    # ----------------------------------------------------------- triggers

    def set_input_trigger(self, on=False):
        """Wait for an external input trigger before each image write
        (PCIe SDKs only)."""
        if not self.is_pcie:
            raise NotImplementedError("HDMI SLMs do not support input triggering.")
        if hasattr(self.slm_lib, "SetWaitForTrigger"):
            self.slm_lib.SetWaitForTrigger(
                ctypes.c_uint(self.slm_number), ctypes.c_bool(on)
            )
            self.slm_lib.SetFlipImmediate(
                ctypes.c_uint(self.slm_number), ctypes.c_bool(False)
            )
        self._wait_for_trigger = bool(on)

    def set_output_trigger(self, on=False, on_refresh=None):
        """Emit an output trigger pulse synchronized with each image
        write (PCIe SDKs only). ``on_refresh`` additionally pulses at the
        SLM refresh rate — only the 8-argument SDK generation supports
        it; other generations warn and ignore."""
        if not self.is_pcie:
            raise NotImplementedError("HDMI SLMs do not support output triggering.")
        style = SDK_VARIANTS[self.sdk_variant]["write"]
        if style == "pcie_3" and hasattr(self.slm_lib, "SetOutputPulse"):
            self.slm_lib.SetOutputPulse(
                ctypes.c_uint(self.slm_number), ctypes.c_bool(on)
            )
        if on_refresh is not None:
            # Only the modern 8-argument SDK supports refresh-rate pulses;
            # legacy HSP boards share the write style but lack the flag.
            if self.sdk_variant == "pcie_modern_8":
                self._output_pulse_refresh = bool(on_refresh)
            else:
                warnings.warn(
                    "on_refresh is not supported by this Blink SDK "
                    "generation; ignored."
                )
        self._output_pulse = bool(on)

    # ---------------------------------------------------------- telemetry

    def get_last_error_message(self):
        """Last SDK error message (PCIe SDKs only)."""
        if not self.is_pcie or not hasattr(self.slm_lib, "Get_last_error_message"):
            raise NotImplementedError(
                "Error message retrieval not supported for this model."
            )
        self.slm_lib.Get_last_error_message.restype = ctypes.c_char_p
        return self.slm_lib.Get_last_error_message().decode("utf-8")

    def get_version_info(self):
        """Blink SDK version string."""
        self.slm_lib.Get_version_info.restype = ctypes.c_char_p
        return self.slm_lib.Get_version_info().decode("utf-8")

    def get_serial(self):
        """Board serial number (PCIe SDKs; HDMI boards expose none)."""
        serial = self._query("serial")
        if serial is None:
            raise NotImplementedError(
                "Serial readout not supported for this model."
            )
        return int(serial)

    def _query_double(self, what, label):
        """Run a :data:`SDK_VARIANTS` double-valued telemetry getter,
        raising :class:`NotImplementedError` when the generation lacks
        the call (ref meadowlark.py:496-499,527-530)."""
        name, takes_board = SDK_VARIANTS[self.sdk_variant][what]
        if name is None:
            raise NotImplementedError(
                f"{label} not supported for this model."
            )
        fn = getattr(self.slm_lib, name)
        fn.restype = ctypes.c_double
        return float(
            fn(ctypes.c_int(self.slm_number)) if takes_board else fn()
        )

    def get_temperature(self):
        """Return the SLM temperature in deg C."""
        return self._query_double("temperature", "Temperature reading")

    def get_coverglass_voltage(self):
        """Return the coverglass voltage in V."""
        return self._query_double(
            "coverglass", "Coverglass voltage reading"
        )

    # ------------------------------------------------------------- close

    def close(self):
        """Release this board; the shared SDK is deleted when the LAST
        open board of its generation closes (sibling instances keep a
        live handle until then)."""
        if getattr(self, "slm_lib", None) is None:
            return
        variant = self.sdk_variant
        self.slm_lib = None
        remaining = Meadowlark._refcount.get(variant, 1) - 1
        Meadowlark._refcount[variant] = max(remaining, 0)
        if remaining <= 0:
            lib = Meadowlark._lib_cache.pop(variant, None)
            Meadowlark._board_count.pop(variant, None)
            Meadowlark._refcount.pop(variant, None)
            if lib is not None:
                lib.Delete_SDK()

    def close_sdk(self):
        """Release the SDK (alias of :meth:`close` for API parity)."""
        self.close()

    @staticmethod
    def info(verbose=True, sdk_path=None):
        """Enumerate boards on the detected SDK: ``[(board, description)]``.
        For HDMI SDKs the display window opens as a side effect of the
        vendor's own enumeration call."""
        dll_path = _find_dll(sdk_path)
        variant, lib = Meadowlark._open_sdk(dll_path)
        spec = SDK_VARIANTS[variant]

        def query(what, board):
            name, takes_board = spec[what]
            if name is None or not hasattr(lib, name):
                return None
            fn = getattr(lib, name)
            return fn(ctypes.c_int(board)) if takes_board else fn()

        boards = range(1, Meadowlark._board_count.get(variant, 1) + 1)
        out = [
            (
                b,
                f"{query('serial', b) or 'Meadowlark HDMI'} "
                f"({query('width', b)}x{query('height', b)}, "
                f"{query('depth', b)}-bit)",
            )
            for b in boards
        ]
        if verbose:
            print(f"Using Blink SDK variant '{variant}' at {dll_path}")
            for b, desc in out:
                print(f"SLM {b}: {desc}")
            if not out:
                print("No boards found.")
        return out
