"""
CUDA kernels of the carry-mode WGS loop (counterpart of
:mod:`slmsuite_tpu.ops.pallas_fft`'s carry section), their build and
their wrappers.

The sources are ``slmsuite_torch/csrc/*.cu`` and ``*.cuh``. On the first
launch they are compiled with ``nvcc`` for ``sm_90a`` into
``build/slmsuite_torch/<hash of the sources>/libslmsuite_torch.so``
(beside the package, in the checkout) and loaded with ``ctypes``;
importing this module builds nothing. Each wrapper checks its inputs
(CUDA, float32, contiguous, one shape, sides powers of two in
[64, 4096]) and raises on anything else, allocates its outputs, launches
on the current stream, raises if the launcher reports an error, and
counts its launches in :data:`LAUNCHES`.

The plain PyTorch version of each kernel is the underscored function of
the same name in :mod:`slmsuite_torch.ops.fft`.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from slmsuite_torch.ops.fft import SCALAR_KEYS, is_scalar_amp, kernel_len_ok

#: Launches per wrapper since the last :meth:`reset_launch_counts`.
LAUNCHES = {
    "carry_entry": 0,
    "cols_wgs_roundtrip": 0,
    "rows_normfwd": 0,
    "carry_exit": 0,
}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "slmsuite_torch"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_RULES = {"leonardo": 0, "kim": 0, "wu": 1, "tanh": 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "slm_carry_entry": [_P, _P, _P, _P, _I, _I, _P, _P],
    "slm_cols_wgs_roundtrip": [_P] * 15 + [_I, _I, _I, _P, _P, _I, _I, _I, _P],
    "slm_rows_normfwd": [_P] * 5 + [_I, _I, _P, _P, _P],
    "slm_carry_exit": [_P, _P, _P, _I, _I, _P, _P],
}

_LIB = None


def reset_launch_counts():
    """Set every launch count to 0."""
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built.")


def build():
    """
    Compile the kernels (once per source hash) and return ``(path,
    seconds, log)``: the library, the compile time (0.0 when it was
    already built) and nvcc's output (its ``-Xptxas -v`` register and
    shared-memory report).
    """
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = _BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / "libslmsuite_torch.so"
    if lib_path.exists():
        return lib_path, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libslmsuite_torch.{os.getpid()}.so"
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    start = time.perf_counter()
    done = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    if done.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({done.returncode}):\n{done.stdout}\n{done.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path, seconds, done.stdout + done.stderr


def _lib():
    global _LIB
    if _LIB is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=32)
def _twiddles(n, inverse, device):
    """exp(sign 2 pi i k / n), k < n/2, computed in float64, stored f32
    as (n/2, 2) (re, im) pairs on ``device``."""
    sign = 1.0 if inverse else -1.0
    w = np.exp(sign * 2j * np.pi * np.arange(n // 2) / n)
    table = np.stack([w.real, w.imag], axis=-1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def _cols_tile(H):
    """Columns per block of the cols kernel: 64 KiB of shared memory."""
    return max(1, min(8, 8192 // H))


def _check_planes(*planes):
    """Raise unless every plane is a contiguous f32 CUDA (H, W) tensor of
    one shape whose sides the kernels take."""
    shape = planes[0].shape
    for x in planes:
        if not torch.is_tensor(x) or not x.is_cuda:
            raise ValueError("CUDA kernel wrappers take CUDA tensors only.")
        if x.dtype != torch.float32:
            raise ValueError(f"Expected float32, got {x.dtype}.")
        if not x.is_contiguous():
            raise ValueError("Expected a contiguous tensor.")
        if x.shape != shape or x.ndim != 2:
            raise ValueError(f"Shape mismatch: {tuple(x.shape)} vs {tuple(shape)}.")
        if x.device.index != torch.cuda.current_device():
            raise ValueError(
                f"Tensor on {x.device}, but the current CUDA device is "
                f"{torch.cuda.current_device()}: launches go to the current device."
            )
    if not (kernel_len_ok(shape[0]) and kernel_len_ok(shape[1])):
        raise ValueError(
            f"Sides must be powers of two in [64, 4096]; got {tuple(shape)}."
        )
    return shape


def _amp_plane(amp, shape):
    """The amplitude plane, or None for a scalar amplitude."""
    if is_scalar_amp(amp):
        return None
    _check_planes(amp)
    if amp.shape != shape:
        raise ValueError(f"amp {tuple(amp.shape)} does not match {tuple(shape)}.")
    return amp


def _ptr(x):
    return None if x is None else x.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: error {rc}.")


def carry_entry(psi, amp):
    """#1: psi -> rows-transformed carry ``(gr, gi)`` of ``e^{i psi}``
    (scalar ``amp``) or ``amp * e^{i psi}``."""
    H, W = _check_planes(psi)
    amp_plane = _amp_plane(amp, psi.shape)
    gr, gi = torch.empty_like(psi), torch.empty_like(psi)
    rc = _lib().slm_carry_entry(
        _ptr(psi), _ptr(amp_plane), _ptr(gr), _ptr(gi), H, W,
        _ptr(_twiddles(W, False, psi.device)), _stream(),
    )
    _raise_on(rc, "carry_entry")
    LAUNCHES["carry_entry"] += 1
    return gr, gi


def cols_wgs_roundtrip(gr, gi, weights, target, mask, phase_ff, scal,
                       *, rule, kim, stats_on):
    """#2: forward column FFT, WGS epilogue, inverse column FFT, plus the
    stats reduction. Returns ``(hr, hi, weights', phase_ff' | None, sums,
    maxs)``."""
    planes = [gr, gi, weights, target]
    if stats_on:
        planes.append(mask)
    if kim:
        planes += list(phase_ff)
    H, W = _check_planes(*planes)
    if rule not in _RULES:
        raise ValueError(f"Unfusable rule '{rule}'.")
    if (scal.device != gr.device or scal.dtype != torch.float32
            or scal.shape != (len(SCALAR_KEYS),) or not scal.is_contiguous()):
        raise ValueError("scal must be a contiguous f32 (9,) tensor on the plane's device.")
    tc = _cols_tile(H)
    hr, hi, wout = (torch.empty_like(gr) for _ in range(3))
    pff_out = (torch.empty_like(gr), torch.empty_like(gr)) if kim else (None, None)
    partials = torch.empty((W // tc, 8), dtype=torch.float32, device=gr.device)
    sums_maxs = torch.empty(8, dtype=torch.float32, device=gr.device)
    pff_in = phase_ff if kim else (None, None)
    rc = _lib().slm_cols_wgs_roundtrip(
        _ptr(gr), _ptr(gi), _ptr(weights), _ptr(target),
        _ptr(mask if stats_on else None), _ptr(pff_in[0]), _ptr(pff_in[1]),
        _ptr(hr), _ptr(hi), _ptr(wout), _ptr(pff_out[0]), _ptr(pff_out[1]),
        _ptr(scal), _ptr(partials), _ptr(sums_maxs), H, W, tc,
        _ptr(_twiddles(H, False, gr.device)), _ptr(_twiddles(H, True, gr.device)),
        _RULES[rule], int(kim), int(stats_on), _stream(),
    )
    _raise_on(rc, "cols_wgs_roundtrip")
    LAUNCHES["cols_wgs_roundtrip"] += 1
    return (hr, hi, wout, pff_out if kim else None,
            sums_maxs[:4], sums_maxs[4:])


def rows_normfwd(hr, hi, amp):
    """#3: inverse row FFT, amplitude replacement, forward row FFT."""
    H, W = _check_planes(hr, hi)
    amp_plane = _amp_plane(amp, hr.shape)
    gr, gi = torch.empty_like(hr), torch.empty_like(hr)
    rc = _lib().slm_rows_normfwd(
        _ptr(hr), _ptr(hi), _ptr(amp_plane), _ptr(gr), _ptr(gi), H, W,
        _ptr(_twiddles(W, False, hr.device)), _ptr(_twiddles(W, True, hr.device)),
        _stream(),
    )
    _raise_on(rc, "rows_normfwd")
    LAUNCHES["rows_normfwd"] += 1
    return gr, gi


def carry_exit(gr, gi):
    """#4: rows-transformed carry -> psi (inverse row FFT, atan2)."""
    H, W = _check_planes(gr, gi)
    psi = torch.empty_like(gr)
    rc = _lib().slm_carry_exit(
        _ptr(gr), _ptr(gi), _ptr(psi), H, W,
        _ptr(_twiddles(W, True, gr.device)), _stream(),
    )
    _raise_on(rc, "carry_exit")
    LAUNCHES["carry_exit"] += 1
    return psi


def carry_step(gr, gi, amp, weights, phase_ff, target, mask, scal,
               *, rule, kim, stats_on):
    """One WGS iteration on the carry: :meth:`cols_wgs_roundtrip` then
    :meth:`rows_normfwd` (same contract as
    :meth:`slmsuite_torch.ops.fft._wgs_carry_step`)."""
    hr, hi, wout, pff_out, sums, maxs = cols_wgs_roundtrip(
        gr, gi, weights, target, mask, phase_ff, scal,
        rule=rule, kim=kim, stats_on=stats_on,
    )
    gr2, gi2 = rows_normfwd(hr, hi, amp)
    return gr2, gi2, wout, pff_out, sums, maxs
