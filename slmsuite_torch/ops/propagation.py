r"""
Shift-free centered Fourier propagation (PyTorch twin of
:mod:`slmsuite_tpu.ops.propagation`).

For even dimensions, with :math:`C_{ij} = (-1)^{i+j}` and
:math:`s = (-1)^{(H+W)/2}`,
``fftshift(fft2(fftshift(x))) = s C * fft2(C * x)`` elementwise. Carrying
the *folded* phase :math:`\psi = \phi + \pi(i+j)` absorbs the input
checkerboard, so the GS loop runs on plain ``fft2`` output; only the
user-facing conversions below apply the checkerboard and the sign.

These functions run once per ``optimize`` call, outside the loop, so they
use ``torch.fft``.
"""

import functools

import numpy as np
import torch

from slmsuite_torch.ops import fft as _fft


def pad_window_slices(shape, slm_shape):
    """
    Centered-pad window indices ``(y0, y1, x0, x1)`` of a ``slm_shape``
    window in a ``shape`` canvas (floor-biased).
    """
    dh = (shape[0] - slm_shape[0]) / 2.0
    dw = (shape[1] - slm_shape[1]) / 2.0
    if dh < 0 or dw < 0:
        raise ValueError(f"slm_shape {slm_shape} larger than canvas {shape}")
    y0 = int(np.floor(dh))
    x0 = int(np.floor(dw))
    return (y0, y0 + slm_shape[0], x0, x0 + slm_shape[1])


def checkerboard(slm_shape, window_offset=(0, 0), dtype=np.float32):
    r"""
    The fold phase :math:`\pi \cdot ((i + j + o_y + o_x) \bmod 2)` on the
    SLM window (host numpy, cached, read-only).
    """
    return _checkerboard_cached(
        tuple(int(v) for v in slm_shape),
        (int(window_offset[0]), int(window_offset[1])),
        np.dtype(dtype).str,
    )


@functools.lru_cache(maxsize=16)
def _checkerboard_cached(slm_shape, window_offset, dtype_str):
    parity = (window_offset[0] + window_offset[1]) % 2
    row = np.arange(slm_shape[1], dtype=np.int64)
    col = np.arange(slm_shape[0], dtype=np.int64)
    board = (np.pi * ((col[:, None] + row[None, :] + parity) % 2)).astype(
        np.dtype(dtype_str)
    )
    board.setflags(write=False)
    return board


def fold_phase(phase, shape):
    """User phase -> internal folded phase ``psi`` (numpy)."""
    phase = np.asarray(phase)
    y0, _, x0, _ = pad_window_slices(shape, phase.shape)
    return phase + checkerboard(phase.shape, (y0, x0), dtype=phase.dtype)


def unfold_phase(psi, shape):
    """Internal folded phase -> user phase (numpy)."""
    psi = np.asarray(psi)
    y0, _, x0, _ = pad_window_slices(shape, psi.shape)
    return psi - checkerboard(psi.shape, (y0, x0), dtype=psi.dtype)


def build_folded_nearfield(psi, amp, shape, kernel=None):
    """``amp * exp(1j * (psi + kernel))`` in the center window of a zero
    canvas of ``shape``, as an (re, im) pair."""
    total = psi if kernel is None else psi + kernel
    y0, y1, x0, x1 = pad_window_slices(shape, tuple(psi.shape))
    canvas = []
    for part in (torch.cos(total), torch.sin(total)):
        plane = torch.zeros(tuple(shape), dtype=torch.float32, device=psi.device)
        plane[y0:y1, x0:x1] = amp * part
        canvas.append(plane)
    return tuple(canvas)


def nearfield_to_farfield(re, im):
    """Forward propagation: orthonormal 2D FFT of an (re, im) pair."""
    return _fft.fft2(re, im)


def farfield_to_nearfield(re, im):
    """Inverse propagation: orthonormal inverse 2D FFT of an (re, im) pair."""
    return _fft.ifft2(re, im)


def extract_folded_phase(re, im, slm_shape, kernel=None):
    """The folded phase psi of the canvas window of an (re, im) pair,
    minus the propagation ``kernel`` if present."""
    y0, y1, x0, x1 = pad_window_slices(tuple(re.shape), tuple(slm_shape))
    psi = torch.atan2(im[y0:y1, x0:x1], re[y0:y1, x0:x1])
    return psi if kernel is None else psi - kernel


def farfield_sign(shape):
    """The global sign ``s = (-1)^((H+W)/2)`` of the folded basis."""
    return -1.0 if ((shape[0] + shape[1]) // 2) % 2 else 1.0


def unfold_farfield(farfield_folded):
    """
    fft-output-layout complex farfield ``G = fft2(Z)`` -> the centered
    complex farfield ``s * C * G`` (amplitudes unchanged).
    """
    H, W = farfield_folded.shape[-2:]
    if isinstance(farfield_folded, np.ndarray):
        iy = np.arange(H).reshape(-1, 1)
        ix = np.arange(W).reshape(1, -1)
    else:
        iy = torch.arange(H, device=farfield_folded.device).reshape(-1, 1)
        ix = torch.arange(W, device=farfield_folded.device).reshape(1, -1)
    cb = 1.0 - 2.0 * ((iy + ix) % 2)
    return farfield_sign((H, W)) * cb * farfield_folded


def _folded_farfield(psi, amp, shape, kernel):
    re, im = nearfield_to_farfield(*build_folded_nearfield(psi, amp, shape, kernel))
    return torch.complex(re, im)


def compute_farfield(psi, amp, shape, kernel=None):
    """Folded phase + amplitude -> centered complex farfield (device)."""
    return unfold_farfield(_folded_farfield(psi, amp, shape, kernel))


def forward_fields(psi, amp, shape, kernel=None):
    """Forward propagation returning the folded complex farfield plus its
    amplitude and phase."""
    farfield = _folded_farfield(psi, amp, shape, kernel)
    return farfield, torch.abs(farfield), torch.angle(farfield)
