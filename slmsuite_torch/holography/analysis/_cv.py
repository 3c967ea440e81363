r"""
The OpenCV image operations of the calibrations, in torch on the tensor's
device, so that the port needs no ``cv2``: ``cv2.GaussianBlur(img, (k, k),
0)`` (:meth:`gaussian_blur`) and ``cv2.resize`` with ``INTER_NEAREST`` and
``INTER_CUBIC`` (:meth:`resize`), each to OpenCV's conventions for a float64
image (its kernel tables and sigma rule, its reflect-101 border, its
pixel-centre mapping, its cubic coefficient -0.75 computed in float32, its
clamped border). ``tests/test_torch_superpixel.py`` holds them against
``cv2``.
"""

import numpy as np
import torch

#: Taps of OpenCV's small Gaussian kernels (``getGaussianKernel`` with
#: sigma <= 0 and an odd size up to 9), which ``cv2.GaussianBlur(img, (k,
#: k), 0)`` takes in place of the sampled Gaussian.
_SMALL_GAUSSIAN = {
    1: (1.0,),
    3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
    9: tuple(x / 256 for x in (4, 13, 30, 51, 60, 51, 30, 13, 4)),
}

#: ``interpolation`` of :meth:`resize`: OpenCV's ``INTER_NEAREST`` and
#: ``INTER_CUBIC``.
INTER_NEAREST, INTER_CUBIC = "nearest", "cubic"


def gaussian_taps(k):
    """The normalized taps of ``cv2.GaussianBlur``'s kernel of odd size
    ``k`` with sigma 0: the small tables, else the Gaussian of sigma
    ``0.3 ((k - 1) / 2 - 1) + 0.8`` sampled at the taps."""
    k = int(k)
    if k < 1 or k % 2 == 0:
        raise ValueError(f"The Gaussian kernel's size must be odd and positive, not {k}.")
    if k in _SMALL_GAUSSIAN:
        taps = np.asarray(_SMALL_GAUSSIAN[k])
    else:
        sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
        x = np.arange(k) - (k - 1) * 0.5
        taps = np.exp(-0.5 / sigma**2 * x * x)
    return taps / taps.sum()


def _reflect_101(index, n):
    """OpenCV's default border (``BORDER_REFLECT_101``, ``gfedcb|abcdefgh|
    gfedcba``) for any offset, also past a whole period."""
    if n == 1:
        return torch.zeros_like(index)
    period = 2 * (n - 1)
    index = torch.remainder(index, period)
    return torch.where(index >= n, period - index, index)


def gaussian_blur(image, k):
    """``cv2.GaussianBlur(image, (k, k), 0)`` on ``image``'s device and in
    its dtype (float64 for OpenCV's results): the separable kernel of
    :meth:`gaussian_taps` along each axis, with reflect-101 borders."""
    taps = gaussian_taps(k)
    for dim in (-1, -2):
        n = image.shape[dim]
        base = torch.arange(n, device=image.device) - len(taps) // 2
        out = torch.zeros_like(image)
        for j, weight in enumerate(taps):
            out += float(weight) * image.index_select(dim, _reflect_101(base + j, n))
        image = out
    return image


def _cubic_matrix(n_src, n_dst, dtype, device):
    """The ``(n_dst, n_src)`` matrix of ``cv2.resize``'s cubic interpolation
    along one axis: source position ``(d + 0.5) n_src / n_dst - 0.5`` (in
    float32), four taps of Keys' kernel at -0.75 (float32 coefficients, the
    last making the sum 1), indices clamped into the source."""
    dst = np.arange(n_dst)
    fx = ((dst + 0.5) * (n_src / n_dst) - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    x = (fx - sx).astype(np.float32)
    A = np.float32(-0.75)
    one = np.float32(1)
    c0 = ((A * (x + one) - 5 * A) * (x + one) + 8 * A) * (x + one) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + one
    c2 = ((A + 2) * (one - x) - (A + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    matrix = np.zeros((n_dst, n_src))
    for j, c in enumerate((c0, c1, c2, c3)):
        np.add.at(matrix, (dst, np.clip(sx - 1 + j, 0, n_src - 1)), c.astype(np.float64))
    return torch.as_tensor(matrix, dtype=dtype, device=device)


def _nearest_index(n_src, n_dst, device):
    """``cv2.resize``'s nearest source index along one axis:
    ``floor(d / (n_dst / n_src))``, clamped into the source."""
    scale = 1.0 / (n_dst / n_src)
    index = np.minimum(np.floor(np.arange(n_dst) * scale).astype(np.int64), n_src - 1)
    return torch.as_tensor(index, device=device)


def resize(image, size, interpolation):
    """``cv2.resize(image, size, interpolation=...)`` of a 2D ``image`` on
    its device: ``size`` is ``(width, height)`` as OpenCV takes it;
    ``interpolation`` is :data:`INTER_NEAREST` or :data:`INTER_CUBIC`."""
    width, height = (int(v) for v in size)
    h, w = image.shape
    if interpolation == INTER_NEAREST:
        rows = _nearest_index(h, height, image.device)
        cols = _nearest_index(w, width, image.device)
        return image.index_select(0, rows).index_select(1, cols)
    if interpolation == INTER_CUBIC:
        rows = _cubic_matrix(h, height, image.dtype, image.device)
        cols = _cubic_matrix(w, width, image.dtype, image.device)
        return rows @ image @ cols.T
    raise ValueError(f"Unrecognized interpolation '{interpolation}'.")
