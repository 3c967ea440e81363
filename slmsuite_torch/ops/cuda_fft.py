"""
CUDA kernels of the GS engine (counterpart of
:mod:`slmsuite_tpu.ops.pallas_fft`), their build and their wrappers:
the carry-mode WGS loop (``csrc/wgs_carry.cu``), the two column passes
of the carry-mode MRAF step (``csrc/mraf_carry.cu``) and the
natural-order transforms of the natural step (``csrc/natural_fft.cu``).

The sources are ``slmsuite_torch/csrc/*.cu`` and ``*.cuh``. On the first
launch each ``.cu`` is compiled with ``nvcc`` for ``sm_90a``, all at
once in parallel, and the objects are linked into
``build/slmsuite_torch/<hash of the sources>/libslmsuite_torch.so``
(beside the package, in the checkout), loaded with ``ctypes``;
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

from slmsuite_torch.ops.fft import (
    SCALAR_KEYS,
    is_scalar_amp,
    kernel_len_ok,
    ortho_scale,
    post_scale,
    wgs_phasor_entry,
    wgs_phasor_exit,
)

#: Launches per wrapper since the last :meth:`reset_launch_counts`.
LAUNCHES = {
    "carry_entry": 0,
    "cols_wgs_roundtrip": 0,
    "rows_normfwd": 0,
    "carry_exit": 0,
    "rows_fft": 0,
    "cols_fft": 0,
    "cols_fwd_polar": 0,
    "cols_wexp_inv": 0,
    "cols_mraf_fwd": 0,
    "cols_mraf_mix_inv": 0,
}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "slmsuite_torch"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_NVCC_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_RULES = {"leonardo": 0, "kim": 0, "wu": 1, "tanh": 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "slm_carry_entry": [_P, _P, _P, _P, _I, _I, _P, _P],
    "slm_cols_wgs_roundtrip": [_P] * 16 + [_I, _I, _I, _P, _P, _I, _I, _I, _P],
    "slm_rows_normfwd": [_P] * 5 + [_I, _I, _P, _P, _P],
    "slm_carry_exit": [_P, _P, _P, _I, _I, _P, _P],
    "slm_rows_fft": [_P] * 4 + [_I, _I, _P, _F, _P],
    "slm_cols_fft": [_P] * 4 + [_I, _I, _I, _P, _F, _P],
    "slm_cols_fwd_polar": [_P] * 4 + [_I, _I, _I, _P, _F, _P],
    "slm_cols_wexp_inv": [_P] * 4 + [_I, _I, _I, _P, _P],
    "slm_cols_mraf_fwd": [_P] * 12 + [_I, _I, _I, _P, _I, _I, _P],
    "slm_cols_mraf_mix_inv": [_P] * 16 + [_I, _I, _I, _P, _I, _I, _P],
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
    seconds, log)``: the library, the build time (0.0 when it was already
    built) and nvcc's output (its ``-Xptxas -v`` register and
    shared-memory report). One ``nvcc`` per source runs at the same time;
    every one is waited for before a failure is raised.
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
    tag = os.getpid()
    nvcc = _nvcc()
    start = time.perf_counter()
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs, failed = [], []
    for obj, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{obj.name} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out_dir / f"libslmsuite_torch.{tag}.so"
    done = subprocess.run(
        [nvcc, *_ARCH, "-shared", "-o", str(tmp), *[str(obj) for obj, _ in jobs]],
        capture_output=True, text=True,
    )
    if done.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({done.returncode}):\n{done.stdout}\n{done.stderr}"
        )
    os.replace(tmp, lib_path)
    seconds = time.perf_counter() - start
    return lib_path, seconds, "".join(logs) + done.stdout + done.stderr


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


def _check_scal(scal, like):
    """Raise unless ``scal`` is the contiguous f32 :data:`SCALAR_KEYS`
    buffer on the planes' device."""
    if (scal.device != like.device or scal.dtype != torch.float32
            or scal.shape != (len(SCALAR_KEYS),) or not scal.is_contiguous()):
        raise ValueError(
            f"scal must be a contiguous f32 ({len(SCALAR_KEYS)},) tensor on the "
            "plane's device."
        )


def _check_rule(rule):
    if rule not in _RULES:
        raise ValueError(f"Unfusable rule '{rule}'.")


def _with_post(scal, post):
    """A copy of ``scal`` with its ``post`` lane set (on the device)."""
    scal = scal.clone()
    scal[SCALAR_KEYS.index("post")] = post
    return scal


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
    stats reduction. Returns ``(hr, hi, weights', phase_ff' | None, sums
    (float64), maxs)``."""
    planes = [gr, gi, weights, target]
    if stats_on:
        planes.append(mask)
    if kim:
        planes += list(phase_ff)
    H, W = _check_planes(*planes)
    _check_rule(rule)
    _check_scal(scal, gr)
    tc = _cols_tile(H)
    hr, hi, wout = (torch.empty_like(gr) for _ in range(3))
    pff_out = (torch.empty_like(gr), torch.empty_like(gr)) if kim else (None, None)
    partials = torch.empty((W // tc, 8), dtype=torch.float64, device=gr.device)
    sums = torch.empty(4, dtype=torch.float64, device=gr.device)
    maxs = torch.empty(4, dtype=torch.float32, device=gr.device)
    pff_in = phase_ff if kim else (None, None)
    rc = _lib().slm_cols_wgs_roundtrip(
        _ptr(gr), _ptr(gi), _ptr(weights), _ptr(target),
        _ptr(mask if stats_on else None), _ptr(pff_in[0]), _ptr(pff_in[1]),
        _ptr(hr), _ptr(hi), _ptr(wout), _ptr(pff_out[0]), _ptr(pff_out[1]),
        _ptr(scal), _ptr(partials), _ptr(sums), _ptr(maxs), H, W, tc,
        _ptr(_twiddles(H, False, gr.device)), _ptr(_twiddles(H, True, gr.device)),
        _RULES[rule], int(kim), int(stats_on), _stream(),
    )
    _raise_on(rc, "cols_wgs_roundtrip")
    LAUNCHES["cols_wgs_roundtrip"] += 1
    return hr, hi, wout, pff_out if kim else None, sums, maxs


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


def cols_mraf_fwd(gr, gi, weights, target, mask, scal, *, rule, stats_on):
    """#10, K1: forward column FFT, the scaled complex farfield, the
    unnormalized weight update and the stats, plus the stats reduction.
    Returns ``(fr, fi, uw, sums (float64), maxs)``."""
    planes = [gr, gi, weights, target] + ([mask] if stats_on else [])
    H, W = _check_planes(*planes)
    _check_rule(rule)
    _check_scal(scal, gr)
    tc = _cols_tile(H)
    fr, fi, uw = (torch.empty_like(gr) for _ in range(3))
    partials = torch.empty((W // tc, 8), dtype=torch.float64, device=gr.device)
    sums = torch.empty(4, dtype=torch.float64, device=gr.device)
    maxs = torch.empty(4, dtype=torch.float32, device=gr.device)
    rc = _lib().slm_cols_mraf_fwd(
        _ptr(gr), _ptr(gi), _ptr(weights), _ptr(target),
        _ptr(mask if stats_on else None), _ptr(fr), _ptr(fi), _ptr(uw),
        _ptr(scal), _ptr(partials), _ptr(sums), _ptr(maxs), H, W, tc,
        _ptr(_twiddles(H, False, gr.device)), _RULES[rule], int(stats_on), _stream(),
    )
    _raise_on(rc, "cols_mraf_fwd")
    LAUNCHES["cols_mraf_fwd"] += 1
    return fr, fi, uw, sums, maxs


def cols_mraf_mix_inv(fr, fi, uw, mcode, phase_ff, zw, sums, scal, *, kim, zero):
    """#10, K2: the region mix (norm read from the device ``sums``), Kim's
    phasor select, the zero-weight update, the inverse column FFT.
    Returns ``(hr, hi, phase_ff' | None, zw' | None)``."""
    planes = [fr, fi, uw, mcode]
    if kim:
        planes += list(phase_ff)
    if zero:
        planes += [zw[0], zw[1]]
    H, W = _check_planes(*planes)
    _check_scal(scal, fr)
    if (sums.device != fr.device or sums.dtype != torch.float64
            or sums.shape != (4,) or not sums.is_contiguous()):
        raise ValueError("sums must be the contiguous float64 (4,) stats sums.")
    hr, hi = torch.empty_like(fr), torch.empty_like(fr)
    pff_out = (torch.empty_like(fr), torch.empty_like(fr)) if kim else (None, None)
    zw_out = torch.empty((2, H, W), dtype=fr.dtype, device=fr.device) if zero else None
    pff_in = phase_ff if kim else (None, None)
    zw_in, zw_to = (zw, zw_out) if zero else ((None, None), (None, None))
    rc = _lib().slm_cols_mraf_mix_inv(
        _ptr(fr), _ptr(fi), _ptr(uw), _ptr(mcode), _ptr(pff_in[0]), _ptr(pff_in[1]),
        _ptr(zw_in[0]), _ptr(zw_in[1]), _ptr(hr), _ptr(hi), _ptr(pff_out[0]),
        _ptr(pff_out[1]), _ptr(zw_to[0]), _ptr(zw_to[1]), _ptr(scal), _ptr(sums),
        H, W, _cols_tile(H), _ptr(_twiddles(H, True, fr.device)), int(kim), int(zero),
        _stream(),
    )
    _raise_on(rc, "cols_mraf_mix_inv")
    LAUNCHES["cols_mraf_mix_inv"] += 1
    return hr, hi, pff_out if kim else None, zw_out


def mraf_carry_step(gr, gi, amp, weights, phase_ff, target, mask, mcode, zw, scal,
                    *, rule, kim, stats_on, zero):
    """One MRAF iteration on the carry: :meth:`cols_mraf_fwd`,
    :meth:`cols_mraf_mix_inv`, :meth:`rows_normfwd` (same contract as
    :meth:`slmsuite_torch.ops.fft._mraf_carry_step`)."""
    fr, fi, uw, sums, maxs = cols_mraf_fwd(
        gr, gi, weights, target, mask, scal, rule=rule, stats_on=stats_on
    )
    hr, hi, pff_out, zw_out = cols_mraf_mix_inv(
        fr, fi, uw, mcode, phase_ff, zw, sums, scal, kim=kim, zero=zero
    )
    gr2, gi2 = rows_normfwd(hr, hi, amp)
    return gr2, gi2, uw, pff_out, zw_out, sums, maxs


def rows_fft(xr, xi, *, inverse, scale=1.0):
    """#5, rows half: the FFT (``inverse``: the unnormalized inverse FFT)
    of every row of the pair, times ``scale``."""
    H, W = _check_planes(xr, xi)
    yr, yi = torch.empty_like(xr), torch.empty_like(xr)
    rc = _lib().slm_rows_fft(
        _ptr(xr), _ptr(xi), _ptr(yr), _ptr(yi), H, W,
        _ptr(_twiddles(W, inverse, xr.device)), float(scale), _stream(),
    )
    _raise_on(rc, "rows_fft")
    LAUNCHES["rows_fft"] += 1
    return yr, yi


def cols_fft(xr, xi, *, inverse, scale=1.0):
    """#5, cols half: the FFT (``inverse``: the unnormalized inverse FFT)
    of every column of the pair, times ``scale``."""
    H, W = _check_planes(xr, xi)
    yr, yi = torch.empty_like(xr), torch.empty_like(xr)
    rc = _lib().slm_cols_fft(
        _ptr(xr), _ptr(xi), _ptr(yr), _ptr(yi), H, W, _cols_tile(H),
        _ptr(_twiddles(H, inverse, xr.device)), float(scale), _stream(),
    )
    _raise_on(rc, "cols_fft")
    LAUNCHES["cols_fft"] += 1
    return yr, yi


def cols_fwd_polar(xr, xi, scale):
    """#5 polar and #6, cols half: the forward FFT of every column,
    returned as ``(scale * |F|, arg F)``."""
    H, W = _check_planes(xr, xi)
    amp, theta = torch.empty_like(xr), torch.empty_like(xr)
    rc = _lib().slm_cols_fwd_polar(
        _ptr(xr), _ptr(xi), _ptr(amp), _ptr(theta), H, W, _cols_tile(H),
        _ptr(_twiddles(H, False, xr.device)), float(scale), _stream(),
    )
    _raise_on(rc, "cols_fwd_polar")
    LAUNCHES["cols_fwd_polar"] += 1
    return amp, theta


def cols_wexp_inv(weights, phase):
    """#11, cols half: ``weights * e^{i phase}``, then the unnormalized
    inverse FFT of every column."""
    H, W = _check_planes(weights, phase)
    yr, yi = torch.empty_like(weights), torch.empty_like(weights)
    rc = _lib().slm_cols_wexp_inv(
        _ptr(weights), _ptr(phase), _ptr(yr), _ptr(yi), H, W, _cols_tile(H),
        _ptr(_twiddles(H, True, weights.device)), _stream(),
    )
    _raise_on(rc, "cols_wexp_inv")
    LAUNCHES["cols_wexp_inv"] += 1
    return yr, yi


def fft2(xr, xi):
    """Ortho 2D FFT: :meth:`rows_fft`, then :meth:`cols_fft` with the
    ortho scale (same contract as :meth:`slmsuite_torch.ops.fft._fft2`)."""
    hr, hi = rows_fft(xr, xi, inverse=False)
    return cols_fft(hr, hi, inverse=False, scale=ortho_scale(xr.shape))


def ifft2(xr, xi):
    """Ortho inverse 2D FFT: :meth:`cols_fft`, then :meth:`rows_fft`
    with the ortho scale."""
    hr, hi = cols_fft(xr, xi, inverse=True)
    return rows_fft(hr, hi, inverse=True, scale=ortho_scale(xr.shape))


def fft2_polar(xr, xi):
    """``(|F|, arg F)`` of the ortho 2D FFT: :meth:`rows_fft`, then
    :meth:`cols_fwd_polar`."""
    hr, hi = rows_fft(xr, xi, inverse=False)
    return cols_fwd_polar(hr, hi, ortho_scale(xr.shape))


def fft2_polar_from_phase(psi, amp):
    """``(|F|, arg F)`` of the ortho 2D FFT of ``amp * e^{i psi}``:
    :meth:`carry_entry`, then :meth:`cols_fwd_polar`."""
    scale = post_scale(amp, psi.shape)
    gr, gi = carry_entry(psi, amp)
    return cols_fwd_polar(gr, gi, scale)


def wexp_ifft2(weights, phase):
    """Ortho ``ifft2(weights * e^{i phase})`` as a pair:
    :meth:`cols_wexp_inv`, then :meth:`rows_fft` with the ortho scale."""
    hr, hi = cols_wexp_inv(weights, phase)
    return rows_fft(hr, hi, inverse=True, scale=ortho_scale(weights.shape))


def wexp_ifft2_phase(weights, phase):
    """``arg ifft2(weights * e^{i phase})``: :meth:`cols_wexp_inv`, then
    :meth:`carry_exit`."""
    return carry_exit(*cols_wexp_inv(weights, phase))


def ifft2_phase(xr, xi):
    """#13, ``arg ifft2``: :meth:`cols_fft` (inverse), then
    :meth:`carry_exit` (the inverse rows and atan2; the scale drops out)."""
    return carry_exit(*cols_fft(xr, xi, inverse=True))


def wgs_fused_step(psi, amp, weights, phase_ff, target, mask, scal,
                   *, rule, kim, stats_on):
    """#8, psi -> psi: :meth:`carry_entry`, :meth:`cols_wgs_roundtrip`,
    :meth:`carry_exit`, with Kim's angle store converted to and from a
    phasor around the round trip (same contract as
    :meth:`slmsuite_torch.ops.fft._wgs_fused_step`)."""
    scal = _with_post(scal, post_scale(amp, psi.shape))
    gr, gi = carry_entry(psi, amp)
    hr, hi, wout, pff_out, sums, maxs = cols_wgs_roundtrip(
        gr, gi, weights, target, mask, wgs_phasor_entry(phase_ff) if kim else None,
        scal, rule=rule, kim=kim, stats_on=stats_on,
    )
    pff_out = wgs_phasor_exit(*pff_out) if kim else None
    return carry_exit(hr, hi), wout, pff_out, sums, maxs


def mraf_fused_step(psi, amp, weights, phase_ff, target, mask, mcode, scal,
                    *, rule, kim, stats_on):
    """#9, psi -> psi: :meth:`carry_entry`, :meth:`cols_mraf_fwd`,
    :meth:`cols_mraf_mix_inv` (no zero weights), :meth:`carry_exit` (same
    contract as :meth:`slmsuite_torch.ops.fft._mraf_fused_step`)."""
    scal = _with_post(scal, post_scale(amp, psi.shape))
    gr, gi = carry_entry(psi, amp)
    fr, fi, uw, sums, maxs = cols_mraf_fwd(
        gr, gi, weights, target, mask, scal, rule=rule, stats_on=stats_on
    )
    hr, hi, pff_out, _ = cols_mraf_mix_inv(
        fr, fi, uw, mcode, wgs_phasor_entry(phase_ff) if kim else None, None, sums,
        scal, kim=kim, zero=False,
    )
    pff_out = wgs_phasor_exit(*pff_out) if kim else None
    return carry_exit(hr, hi), uw, pff_out, sums, maxs
