"""
Native (C) host helpers, loaded via ctypes: the frame-rate SLM write-path
conversion (``phase2gray.c``, used by :meth:`.SLM._phase2gray`) and the TI
PLM electrode packing (``plm_pack.c``, used by
:class:`~slmsuite_torch.hardware.slms.texasinstruments.PLM`). The port's
copy of :mod:`slmsuite_tpu.native`, with the same sources and entry points.

Each source is compiled on first use with ``$CC`` (else ``cc``) into
``build/slmsuite_torch/native-<hash>/`` beside the package (the hash covers
the compiler and the source, as the CUDA library's does), written to a
temporary file and moved into place, so processes that build at once each
load a whole library; importing this module builds nothing. Where no
compiler is found it warns once and the callers take their numpy route.
:data:`ROUTES` counts, for each helper, the calls that ran natively and
those that left the work to numpy (the library missing, or dtypes and
shapes it does not take), so a change of route shows.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import warnings
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_BUILD_ROOT = _HERE.parents[1] / "build" / "slmsuite_torch"
_CFLAGS = ["-O3", "-shared", "-fPIC"]
_LIBS = {}

#: Calls of each helper by route: ``"native"`` ran the C kernel,
#: ``"numpy"`` returned False so the caller ran its numpy passes.
ROUTES = {name: {"native": 0, "numpy": 0}
          for name in ("phase2gray", "plm_electrode_map", "plm_bitpack8")}


def reset_routes():
    """Set every count of :data:`ROUTES` to 0."""
    for counts in ROUTES.values():
        counts.update(native=0, numpy=0)


def _count(name, native):
    ROUTES[name]["native" if native else "numpy"] += 1
    return native


def build(stem):
    """Compile ``<stem>.c`` (once per compiler and source hash) and return
    the shared library's path."""
    source = _HERE / (stem + ".c")
    cc = os.environ.get("CC", "cc")
    digest = hashlib.sha256(" ".join([cc, *_CFLAGS]).encode())
    digest.update(source.read_bytes())
    out_dir = _BUILD_ROOT / f"native-{digest.hexdigest()[:16]}"
    target = out_dir / f"lib{stem}.so"
    if target.exists():
        return target
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"lib{stem}.", suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        subprocess.run([cc, *_CFLAGS, "-o", tmp, str(source), "-lm"], check=True,
                       capture_output=True)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def _get_library(stem, declare):
    """Load (building if needed) a native library, or None. ``declare``
    receives the loaded CDLL to set up prototypes (called once)."""
    if stem in _LIBS:
        return _LIBS[stem]
    try:
        lib = ctypes.CDLL(str(build(stem)))
        declare(lib)
    except (OSError, subprocess.CalledProcessError, AttributeError) as err:
        warnings.warn(f"Native {stem} unavailable ({err}); using numpy.")
        lib = None
    _LIBS[stem] = lib
    return lib


def _declare_phase2gray(lib):
    for name, phase_t, disp_t in [
        ("phase2gray_u8", ctypes.c_double, ctypes.c_uint8),
        ("phase2gray_u16", ctypes.c_double, ctypes.c_uint16),
        ("phase2gray_f32_u8", ctypes.c_float, ctypes.c_uint8),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = [
            ctypes.POINTER(phase_t),
            ctypes.POINTER(disp_t),
            ctypes.c_size_t,
            ctypes.c_int,
        ]
        fn.restype = None


def _declare_plm_pack(lib):
    lib.plm_electrode_map.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),  # display
        ctypes.POINTER(ctypes.c_uint8),  # out
        ctypes.c_size_t, ctypes.c_size_t,  # h, w
        ctypes.POINTER(ctypes.c_uint8),  # lut[256]
        ctypes.POINTER(ctypes.c_uint8),  # layout[4]
        ctypes.c_int, ctypes.c_int,      # flips
    ]
    lib.plm_electrode_map.restype = None
    lib.plm_bitpack8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_size_t,
    ]
    lib.plm_bitpack8.restype = None


def _u8ptr(array):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def phase2gray_native(phase, out, bitresolution):
    """
    Single-pass ``phase`` (radians) -> integer ``out`` conversion for
    power-of-two ``bitresolution`` and ``phase_scaling == 1``; ``phase`` is
    left untouched.

    Returns ``True`` on success, ``False`` if the native path is
    unavailable or unsupported for these dtypes (caller falls back).
    """
    return _count("phase2gray", _phase2gray(phase, out, bitresolution))


def _phase2gray(phase, out, bitresolution):
    lib = _get_library("phase2gray", _declare_phase2gray)
    if lib is None:
        return False
    if bitresolution & (bitresolution - 1):
        return False
    if not (phase.flags["C_CONTIGUOUS"] and out.flags["C_CONTIGUOUS"]):
        return False
    if phase.size != out.size:
        return False

    n = phase.size
    if phase.dtype == np.float64 and out.dtype == np.uint8:
        lib.phase2gray_u8(
            phase.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            _u8ptr(out), n, bitresolution,
        )
    elif phase.dtype == np.float64 and out.dtype == np.uint16:
        lib.phase2gray_u16(
            phase.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            n, bitresolution,
        )
    elif phase.dtype == np.float32 and out.dtype == np.uint8:
        lib.phase2gray_f32_u8(
            phase.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            _u8ptr(out), n, bitresolution,
        )
    else:
        return False
    return True


def plm_electrode_map_native(display, out, lut, layout, flip_y, flip_x):
    """
    Fused PLM packing: 8-bit gray ``display`` (H, W) through the
    gray->code ``lut`` onto the (2H, 2W) binary electrode bitmap ``out``
    in one pass (LUT gather + bit spread + scan flips). Returns ``True``
    on success; ``False`` means fall back to numpy.
    """
    return _count("plm_electrode_map",
                  _plm_electrode_map(display, out, lut, layout, flip_y, flip_x))


def _plm_electrode_map(display, out, lut, layout, flip_y, flip_x):
    lib = _get_library("plm_pack", _declare_plm_pack)
    if lib is None:
        return False
    if display.dtype != np.uint8 or out.dtype != np.uint8:
        return False
    if not (display.flags["C_CONTIGUOUS"] and out.flags["C_CONTIGUOUS"]):
        return False
    h, w = display.shape
    if out.shape != (2 * h, 2 * w):
        return False
    lut = np.ascontiguousarray(lut, dtype=np.uint8)
    layout = np.ascontiguousarray(np.asarray(layout).ravel(), dtype=np.uint8)
    if lut.size != 256 or layout.size != 4:
        return False
    lib.plm_electrode_map(
        _u8ptr(display), _u8ptr(out), h, w, _u8ptr(lut), _u8ptr(layout),
        int(flip_y), int(flip_x),
    )
    return True


def plm_bitpack8_native(maps, out):
    """
    Pack 8 stacked binary bitmaps (8, H, W) into one uint8 frame (LSB of
    bitmap k -> bit k). Returns ``True`` on success.
    """
    return _count("plm_bitpack8", _plm_bitpack8(maps, out))


def _plm_bitpack8(maps, out):
    lib = _get_library("plm_pack", _declare_plm_pack)
    if lib is None:
        return False
    if maps.dtype != np.uint8 or out.dtype != np.uint8:
        return False
    if maps.ndim != 3 or maps.shape[0] != 8 or maps.shape[1:] != out.shape:
        return False
    if not (maps.flags["C_CONTIGUOUS"] and out.flags["C_CONTIGUOUS"]):
        return False
    lib.plm_bitpack8(_u8ptr(maps), _u8ptr(out), out.size)
    return True
