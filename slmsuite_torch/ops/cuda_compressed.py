"""
CUDA kernels of the compressed spot transforms (counterpart of
:mod:`slmsuite_tpu.ops.pallas_compressed`) and their wrappers. The source
is ``slmsuite_torch/csrc/compressed.cu``; it is built with the other
kernels by :func:`slmsuite_torch.ops.cuda_fft.build` on the first launch
(importing this module builds nothing).

Each wrapper checks its inputs (CUDA, float32, contiguous, consistent
lengths; ``fused_iter_cached`` a spot count whose shared memory fits,
:meth:`slmsuite_torch.ops.compressed.fused_iter_cached_ok`) and raises on
anything else, allocates its outputs and the per-block partials, launches
on the current stream, raises if the launcher reports an error, and
counts its call in :data:`LAUNCHES` (one per call, for the kernel and the
fixed-order passes that finish it) and the bytes it declares in
:data:`BYTES`. ``f2n`` and ``n2f`` take any spot count and any number of
Zernike terms (past 16 their wide kernels, up to ``slm_cmp_max_terms()``,
7,248, where eight spots' coefficients fill a block's shared memory);
``fused_iter`` beyond the spots of its kernel's warp (256) or the terms it
stages (``slm_cmp_fused_terms()``, 44) runs as the two of them (each
counted).

The plain PyTorch version of each kernel is the underscored function of
the same name in :mod:`slmsuite_torch.ops.compressed`. The kernels' sincos
is period-reduced (``sincos_reduced`` in the source); :meth:`sincos_reduced_model`
forms it in PyTorch from the same constants, so that its error can be held
on the CPU.
"""

import ctypes

import numpy as np
import torch

from slmsuite_torch.ops import compressed, cuda_fft
from slmsuite_torch.ops.cuda_fft import _ptr

#: Calls per wrapper since the last :meth:`reset_launch_counts`.
LAUNCHES = {"f2n": 0, "n2f": 0, "fused_iter": 0, "fused_iter_cached": 0}

#: Bytes each wrapper declares for its launches since the last
#: :meth:`reset_launch_counts`: the tensors its kernel reads, each once, and
#: writes, each once (the stats partials left out).
BYTES = dict.fromkeys(LAUNCHES, 0)


def _launched(name, reads, writes):
    """Count one launch of ``name`` and its declared bytes."""
    LAUNCHES[name] += 1
    BYTES[name] += sum(t.numel() * t.element_size()
                       for t in (*reads, *writes) if t is not None)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "slm_cmp_f2n": [_P] * 5 + [_I, _I, _I, _F, _I, _P, _P, _P],
    "slm_cmp_n2f": [_P] * 4 + [_I, _I, _I, _F, _I, _P, _P, _P, _P],
    "slm_cmp_fused": [_P] * 5 + [_I, _I, _I, _P, _P, _P, _P],
    "slm_cmp_fused_cached": [_P] * 4 + [_I, _I, _P, _I, _I, _P, _P, _P, _P],
    "slm_cmp_block_pixels": [],
    "slm_cmp_fused_spots": [],
    "slm_cmp_fused_terms": [],
    "slm_cmp_max_terms": [],
}

_BOUND = None

#: The period reduction of the kernels' sincos (``compressed.cu``): 1/(2 pi)
#: as f32, 2 pi split in three f32 terms (the first of 8 significant bits, so
#: that ``k`` times it is exact for ``|k| < 2**16``), pi and 2 pi as f32, and
#: the ``|phase|`` beyond which the kernels take libdevice's ``sincosf``.
INV_2PI = 0.15915493667125702
TWO_PI_TERMS = (6.28125, 0.0019353071693331003, 1.0253376273028358e-11)
PI_F32, TWO_PI_F32 = 3.1415927410125732, 6.2831854820251465
REDUCED_LIMIT = 1e5


def sincos_reduced_model(x):
    """``(sin, cos)`` of the float32 phases ``x`` as the kernels' sincos
    forms them, with ``torch.sin``/``torch.cos`` in place of the card's
    pair on [-pi, pi]: ``k = rint(x / 2 pi)``, ``y = x - k 2 pi`` by the
    three terms of :data:`TWO_PI_TERMS`, each step one ``fmaf`` (here a
    float64 product and difference rounded once to float32), ``y`` folded
    back into [-pi, pi] where rounding picked ``k`` off by one, and beyond
    :data:`REDUCED_LIMIT` the plain sin and cos of ``x``."""
    x = x.to(torch.float32)
    k = torch.round(x * np.float32(INV_2PI)).double()
    y = x
    for term in TWO_PI_TERMS:
        y = (y.double() - k * term).float()
    pi, two_pi = np.float32(PI_F32), np.float32(TWO_PI_F32)
    y = torch.where(y > pi, y - two_pi, torch.where(y < -pi, y + two_pi, y))
    far = x.abs() > REDUCED_LIMIT
    return (torch.where(far, torch.sin(x), torch.sin(y)),
            torch.where(far, torch.cos(x), torch.cos(y)))


def reset_launch_counts():
    """Set every launch count to 0."""
    for key in LAUNCHES:
        LAUNCHES[key] = 0
        BYTES[key] = 0


def _lib():
    """The kernels' library with this module's signatures bound."""
    global _BOUND
    lib = cuda_fft._lib()
    if _BOUND is not lib:
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _BOUND = lib
    return lib


def _check(*tensors, ndim=1):
    for x in tensors:
        if not torch.is_tensor(x) or not x.is_cuda:
            raise ValueError("CUDA kernel wrappers take CUDA tensors only.")
        if x.dtype != torch.float32:
            raise ValueError(f"Expected float32, got {x.dtype}.")
        if not x.is_contiguous():
            raise ValueError("Expected a contiguous tensor.")
        if x.ndim != ndim:
            raise ValueError(f"Expected {ndim} dimensions, got {tuple(x.shape)}.")
        if x.device.index != torch.cuda.current_device():
            raise ValueError(
                f"Tensor on {x.device}, but the current CUDA device is "
                f"{torch.cuda.current_device()}: launches go to the current device."
            )


def _check_transform(ff_or_nf, coeffs, basis):
    """Shapes ``(D, N)`` and ``(D, P)``; returns ``(D, N, P)``."""
    _check(*ff_or_nf)
    _check(coeffs, basis, ndim=2)
    D, N = coeffs.shape
    if basis.shape[0] != D:
        raise ValueError(f"coeffs {tuple(coeffs.shape)} and basis {tuple(basis.shape)} "
                         "disagree on the Zernike terms.")
    if not 1 <= D <= _lib().slm_cmp_max_terms():
        raise ValueError(f"{D} Zernike terms: the kernels take 1 to "
                         f"{_lib().slm_cmp_max_terms()}, the most whose coefficients "
                         "fit a block's shared memory.")
    return D, N, basis.shape[1]


def _check_spots(N):
    if not compressed.fused_iter_cached_ok(N):
        raise ValueError(f"{N} spots do not fit the kernels' shared memory.")


def _amp_plane(amp, n_pixels):
    """The (P,) amplitude, or None for a scalar amplitude (unit modulus: the
    scale drops out in the caller's normalization)."""
    if not torch.is_tensor(amp) or amp.ndim == 0:
        return None
    _check(amp)
    if amp.shape != (n_pixels,):
        raise ValueError(f"amp {tuple(amp.shape)} does not match {n_pixels} pixels.")
    return amp


def _partials(N, P, like):
    n_blocks = -(-P // _lib().slm_cmp_block_pixels())
    return torch.empty((2, n_blocks, N), dtype=torch.float32, device=like.device)


def _out(N, like):
    return torch.empty(N, dtype=torch.float32, device=like.device), torch.empty(
        N, dtype=torch.float32, device=like.device)


def f2n(ff_re, ff_im, coeffs, basis, amp=None):
    """#14: the ``(P,)`` nearfield pair ``P^-1/2 sum_n ff[n] e^{i Phi[n, p]}``;
    given ``amp`` (a scalar or ``(P,)``), the amplitude replacement ``amp
    nf/|nf|`` of the sum instead (scalar: unit amplitude), the first half
    of :meth:`fused_iter` past its kernels' shared memory. Any spot count;
    past 16 terms ``f2n_wide_kernel``."""
    D, N, P = _check_transform((ff_re, ff_im), coeffs, basis)
    if ff_re.shape != (N,) or ff_im.shape != (N,):
        raise ValueError(f"The farfield must have {N} spots.")
    replace = amp is not None
    amp_plane = _amp_plane(amp, P) if replace else None
    nfr = torch.empty(P, dtype=torch.float32, device=basis.device)
    nfi = torch.empty_like(nfr)
    rc = _lib().slm_cmp_f2n(_ptr(ff_re), _ptr(ff_im), _ptr(coeffs), _ptr(basis),
                            _ptr(amp_plane), P, N, D, float(P ** -0.5), int(replace),
                            _ptr(nfr), _ptr(nfi), cuda_fft._stream())
    cuda_fft._raise_on(rc, "f2n")
    _launched("f2n", (ff_re, ff_im, coeffs, basis, amp_plane), (nfr, nfi))
    return nfr, nfi


def n2f(nf_re, nf_im, coeffs, basis, normalize=True):
    """#15: the unit-norm ``(N,)`` farfield pair of ``P^-1/2 sum_p
    e^{-i Phi[n, p]} nf[p]``; ``normalize`` False gives the sum itself,
    neither scaled nor normalized (the second half of :meth:`fused_iter`
    past its kernels' shared memory). Any spot count; past 16 terms
    ``n2f_wide_kernel``."""
    D, N, P = _check_transform((nf_re, nf_im), coeffs, basis)
    if nf_re.shape != (P,) or nf_im.shape != (P,):
        raise ValueError(f"The nearfield must have {P} pixels.")
    if N < 1:
        raise ValueError("n2f needs at least one spot.")
    partials = _partials(N, P, basis)
    out_re, out_im = _out(N, basis)
    rc = _lib().slm_cmp_n2f(_ptr(nf_re), _ptr(nf_im), _ptr(coeffs), _ptr(basis), P, N, D,
                            float(P ** -0.5) if normalize else 1.0, int(normalize),
                            _ptr(partials), _ptr(out_re), _ptr(out_im), cuda_fft._stream())
    cuda_fft._raise_on(rc, "n2f")
    _launched("n2f", (nf_re, nf_im, coeffs, basis), (out_re, out_im))
    return out_re, out_im


def fused_iter(ff_re, ff_im, coeffs, basis, amp):
    """#16: one round trip ff -> nf -> amp nf/|nf| (padded pixels masked)
    -> the unnormalized ``(N,)`` farfield pair; ``amp`` is a scalar or
    ``(P,)``. Beyond the spots of the kernel's warp (``slm_cmp_fused_spots``,
    256) or the terms it stages (``slm_cmp_fused_terms``, 44), the round
    trip runs as :meth:`f2n` with the amplitude replacement, then
    :meth:`n2f` unnormalized (each counts its launch)."""
    D, N, P = _check_transform((ff_re, ff_im), coeffs, basis)
    if ff_re.shape != (N,) or ff_im.shape != (N,):
        raise ValueError(f"The farfield must have {N} spots.")
    if N < 1:
        raise ValueError("fused_iter needs at least one spot.")
    if N > _lib().slm_cmp_fused_spots() or D > _lib().slm_cmp_fused_terms():
        nf = f2n(ff_re, ff_im, coeffs, basis, amp=1.0 if amp is None else amp)
        return n2f(*nf, coeffs, basis, normalize=False)
    amp_plane = _amp_plane(amp, P)
    partials = _partials(N, P, basis)
    out_re, out_im = _out(N, basis)
    rc = _lib().slm_cmp_fused(_ptr(ff_re), _ptr(ff_im), _ptr(coeffs), _ptr(basis),
                              _ptr(amp_plane), P, N, D, _ptr(partials), _ptr(out_re),
                              _ptr(out_im), cuda_fft._stream())
    cuda_fft._raise_on(rc, "fused_iter")
    _launched("fused_iter", (ff_re, ff_im, coeffs, basis, amp_plane), (out_re, out_im))
    return out_re, out_im


def fused_iter_cached(ff_re, ff_im, kc, ks, amp, n_spots, n_pixels):
    """#17: the round trip of :meth:`fused_iter`, reading cos/sin from the
    ``(n_tiles, N8, T)`` cache of
    :meth:`slmsuite_torch.ops.compressed.build_kernel_cache`."""
    _check(ff_re, ff_im)
    _check(kc, ks, ndim=3)
    n_tiles, n8, tile = kc.shape
    N, P = int(n_spots), int(n_pixels)
    if ks.shape != kc.shape or not (1 <= N <= n8) or not (0 < P <= n_tiles * tile):
        raise ValueError(f"Cache {tuple(kc.shape)} does not hold {N} spots and "
                         f"{P} pixels.")
    if tile % 32:
        raise ValueError(f"The cache's tile ({tile}) must be a multiple of 32.")
    if ff_re.shape != (N,) or ff_im.shape != (N,):
        raise ValueError(f"The farfield must have {N} spots.")
    _check_spots(N)
    amp_plane = _amp_plane(amp, P)
    partials = _partials(N, P, kc)
    out_re, out_im = _out(N, kc)
    rc = _lib().slm_cmp_fused_cached(_ptr(ff_re), _ptr(ff_im), _ptr(kc), _ptr(ks),
                                     n8, tile, _ptr(amp_plane), P, N, _ptr(partials),
                                     _ptr(out_re), _ptr(out_im), cuda_fft._stream())
    cuda_fft._raise_on(rc, "fused_iter_cached")
    _launched("fused_iter_cached", (ff_re, ff_im, kc, ks, amp_plane), (out_re, out_im))
    return out_re, out_im

