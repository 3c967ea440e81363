r"""
Distributed 2D FFT: the row/column ("pencil") decomposition over a mesh
axis (PyTorch counterpart of :mod:`slmsuite_tpu.parallel.fft2d`).

A plane's rows are cut over the axis's D shards, ``(H/D, W)`` each. The 2D
transform is a row transform on every shard, a global transpose, a row
transform of the transposed blocks ``(W/D, H)``, and a global transpose
back. Both row transforms are the ``rows_fft`` kernel on the card
(:meth:`slmsuite_torch.ops.fft.rows_fft`, whose gate reads the line length
and takes any multiple of 8 rows). The global transpose is the tiled
all-to-all of the JAX package (split the columns, join the received chunks
along the rows) with its local ``swapaxes`` folded in: each shard's block
``(W/D, H)`` is one copy of the transposed chunks
(:meth:`slmsuite_torch.ops.collectives.all_to_all` on the transposed
views), so the column transform stays a row transform and no separate
transpose pass is made.
"""

import numpy as np
import torch

from slmsuite_torch.ops import collectives as C
from slmsuite_torch.ops import fft as _fft


def _transpose_global(shards):
    """Per-shard blocks ``(R, C)`` -> ``(C/D, R D)``: each shard's chunk of
    columns from every shard, transposed, joined in rank order."""
    return C.all_to_all([x.transpose(-2, -1) for x in shards], split_axis=-2, concat_axis=-1)


def transpose_pairs(re, im):
    """:meth:`_transpose_global` of the shards of a pair."""
    return _transpose_global(re), _transpose_global(im)


def rows_fft_shards(re, im, *, inverse, scale=1.0):
    """:meth:`slmsuite_torch.ops.fft.rows_fft` of every shard of a pair, each
    on its device."""
    out_re, out_im = [], []
    for r, i in zip(re, im):
        with C.on_device(r.device):
            yr, yi = _fft.rows_fft(r, i, inverse=inverse, scale=scale)
        out_re.append(yr)
        out_im.append(yi)
    return out_re, out_im


def fft2_shards(re, im, *, inverse):
    """The ortho 2D FFT (``inverse``: inverse) of a row-sharded plane given as
    lists of per-shard ``(H/D, W)`` pairs: rows, transpose, rows, transpose
    back."""
    H, W = re[0].shape[-2] * len(re), re[0].shape[-1]
    re, im = rows_fft_shards(re, im, inverse=inverse, scale=1.0 / np.sqrt(W))
    re, im = rows_fft_shards(*transpose_pairs(re, im), inverse=inverse, scale=1.0 / np.sqrt(H))
    return transpose_pairs(re, im)


def _check_divisible(x, mesh, axis_name):
    n_dev = mesh.shape[axis_name]
    H, W = x.shape[-2:]
    if H % n_dev or W % n_dev:
        raise ValueError(
            f"distributed_fft2 requires both dimensions of {(H, W)} "
            f"divisible by the mesh axis '{axis_name}' ({n_dev} devices) "
            f"- the pencil transpose exchanges equal column chunks."
        )


def _distributed_fft2(x, mesh, axis_name, inverse):
    _check_divisible(x, mesh, axis_name)
    devices = mesh.axis_devices(axis_name)
    x = torch.as_tensor(x)
    z = x.to(torch.complex64) if not x.is_complex() else x
    re = C.split(z.real.to(torch.float32), devices)
    im = C.split(z.imag.to(torch.float32), devices)
    re, im = fft2_shards(re, im, inverse=inverse)
    return torch.complex(C.gather(re, x.device), C.gather(im, x.device))


def distributed_fft2(x, mesh, axis_name="space"):
    """
    Orthonormal 2D FFT of the (H, W) tensor ``x`` with its rows sharded over
    ``axis_name`` of ``mesh``; returns the complex64 result gathered on
    ``x``'s device. Requires both dimensions divisible by the mesh axis
    size (validated here).
    """
    return _distributed_fft2(x, mesh, axis_name, False)


def distributed_ifft2(x, mesh, axis_name="space"):
    """Inverse of :meth:`distributed_fft2`."""
    return _distributed_fft2(x, mesh, axis_name, True)
