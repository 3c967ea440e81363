r"""
The differentiable transforms of gradient phase retrieval
(:meth:`~slmsuite_torch.holography.algorithms.Hologram.optimize_cg`).

The kernel wrappers read raw pointers, so a tensor that requires grad comes
out of them with no ``grad_fn``. Both transforms are linear, and the
adjoint of each is a transform the port already has, so each is a
:class:`torch.autograd.Function` whose forward and backward are the
dispatchers (the hand kernels on a CUDA tensor, the plain versions on a CPU
tensor; a CUDA tensor outside the kernels' gate raises):

- :class:`Fft2`: the ortho 2D FFT of an (re, im) pair. On real pairs the
  vector-Jacobian product of ``y = F x`` is ``F^H g``, which for the ortho
  transform is ``ifft2(g)``. Kernels: ``rows_fft`` and ``cols_fft``
  forward, ``cols_fft`` and ``rows_fft`` backward.
- :class:`CompressedOverlap`: the raw compressed overlap ``A nf = P^-1/2
  sum_p e^{-i Phi[n, p]} nf[p]``, whose adjoint ``A^H g = P^-1/2 sum_n
  e^{i Phi[n, p]} g[n]`` is the compressed exit transform. Kernels: ``n2f``
  unnormalized forward, ``f2n`` backward. ``coeffs`` and ``basis`` get no
  gradient.

Neither saves an activation: the maps are linear. Autograd may hand a
backward an expanded or non-contiguous gradient, which the kernels refuse,
so each backward makes it contiguous.
"""

import torch

from slmsuite_torch.ops import compressed as _comp
from slmsuite_torch.ops import fft as _fft


class Fft2(torch.autograd.Function):
    """Ortho 2D FFT of an (re, im) pair (:meth:`slmsuite_torch.ops.fft.fft2`),
    differentiable: the backward is :meth:`~slmsuite_torch.ops.fft.ifft2`."""

    @staticmethod
    def forward(ctx, re, im):
        return _fft.fft2(re, im)

    @staticmethod
    def backward(ctx, g_re, g_im):
        return _fft.ifft2(g_re.contiguous(), g_im.contiguous())


class CompressedOverlap(torch.autograd.Function):
    """The unnormalized ``(N,)`` farfield pair ``P^-1/2 sum_p e^{-i Phi[n,
    p]} nf[p]`` of a ``(P,)`` nearfield pair, differentiable in the
    nearfield: the backward is
    :meth:`~slmsuite_torch.ops.compressed.farfield_to_nearfield`."""

    @staticmethod
    def forward(ctx, nf_re, nf_im, coeffs, basis):
        ctx.save_for_backward(coeffs, basis)
        if _comp._on_card(basis):
            scale = float(basis.shape[1] ** -0.5)
            re, im = _comp._cuda().n2f(nf_re, nf_im, coeffs, basis, normalize=False)
            return re * scale, im * scale
        return _comp._nearfield_to_farfield_raw(nf_re, nf_im, coeffs, basis)

    @staticmethod
    def backward(ctx, g_re, g_im):
        coeffs, basis = ctx.saved_tensors
        nf_re, nf_im = _comp.farfield_to_nearfield(g_re.contiguous(), g_im.contiguous(),
                                                   coeffs, basis)
        return nf_re, nf_im, None, None


def fft2(re, im):
    """:class:`Fft2` applied to an (re, im) pair."""
    return Fft2.apply(re, im)


def compressed_farfield(nf_re, nf_im, coeffs, basis):
    """The unit-norm ``(N,)`` farfield pair of the ``(P,)`` nearfield pair,
    differentiable in the nearfield: :class:`CompressedOverlap`, then the
    unit norm in plain torch (``slmsuite_tpu.ops.compressed.
    nearfield_to_farfield``)."""
    return _comp._unit(*CompressedOverlap.apply(nf_re, nf_im, coeffs, basis))
