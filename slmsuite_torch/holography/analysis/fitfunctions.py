r"""
Fit functions (the port's copy of
:mod:`slmsuite_tpu.holography.analysis.fitfunctions`: lines, parabolas,
the beam-waist hyperbola, the source profiles, the calibrations' fringe,
focus and settle models). Each takes the
independent variable(s) ``x`` or ``(x, y)`` first, then its parameters,
as :meth:`scipy.optimize.curve_fit` calls them.
"""

import numpy as np
from scipy.special import factorial

__all__ = [
    "linear",
    "parabola",
    "hyperbola",
    "cos",
    "lorentzian",
    "gaussian",
    "gaussian2d",
    "tophat2d",
    "sinc2d",
    "exponential_jump",
]


def cos(x, b, a, c, k=1):
    r""":math:`y = c + \frac{a}{2}[1 + \cos(kx - b)]`."""
    return a * 0.5 * (1 + np.cos(k * x - b)) + c


def lorentzian(x, x0, a, c, w):
    r""":math:`y = c + a / [1 + ((x - x_0)/w)^2]`."""
    return a / (1 + np.square((x - x0) / w)) + c


def gaussian2d(xy, x0, y0, a, c, wx, wy, wxy=0):
    r"""
    2D Gaussian with optional shear:

    .. math:: z = c + a\exp[-\frac{1}{2}(\vec{r} - \vec{r}_0)^T M^{-1} (\vec{r} - \vec{r}_0)]

    where :math:`M = [[w_x^2, w_{xy}], [w_{xy}, w_y^2]]` holds the second
    central moments. ``wxy`` is clipped to magnitudes below ``wx*wy``.
    """
    x = xy[0] - x0
    y = xy[1] - y0

    wxy = np.sign(wxy) * np.min([np.abs(wxy), wx * wy])

    try:
        K = np.linalg.inv([[wx * wx, wxy], [wxy, wy * wy]])
    except np.linalg.LinAlgError:
        K = np.array([[1 / wx / wx, 0], [0, 1 / wy / wy]])

    argument = np.square(x) * K[0, 0] + np.square(y) * K[1, 1] + 2 * x * y * K[1, 0]
    return c + a * np.exp(-0.5 * argument)


def tophat2d(xy, x0, y0, R, a=1, c=0):
    r"""Circular tophat: ``a + c`` inside radius ``R``, ``c`` outside."""
    x = xy[0] - x0
    y = xy[1] - y0
    return np.where(np.square(x) + np.square(y) <= R * R, a + c, c)


def sinc2d(xy, x0, y0, R, a=1, b=0, c=0, d=0, kx=0, ky=0):
    r"""
    Rectangular :math:`\text{sinc}^2` distribution with optional sinusoidal
    modulation (the superpixel interference fringes):

    .. math:: z = d + \left(c + \frac{a}{2}[1 + \cos(k_xx + k_yy - b)]\right)
              \text{sinc}^2(\pi(x - x_0)/R)\,\text{sinc}^2(\pi(y - y_0)/R).
    """
    x = xy[0] - x0
    y = xy[1] - y0
    return (
        np.square(np.sinc((1 / R) * x) * np.sinc((1 / R) * y))
        * (a * 0.5 * (1 + np.cos(kx * x + ky * y - b)) + c)
        + d
    )


def _sinc2d_nomod(xy, x0, y0, R, a=1, d=0):
    r"""Unmodulated rectangular sinc²."""
    return (
        a * np.square(np.sinc((1 / R) * (xy[0] - x0)) * np.sinc((1 / R) * (xy[1] - y0)))
        + d
    )


def _sinc2d_centered(xy, R, a=1, b=0, c=0, d=0, kx=0, ky=0):
    r"""Modulated sinc² centered at the origin (the superpixel fringe fit)."""
    return sinc2d(xy, 0, 0, R, a, b, c, d, kx, ky)


def exponential_jump(x, x0, a, b, c):
    r"""
    Step and exponential relaxation (the settle calibration's model):
    :math:`y = c` for :math:`x < x_0`, else
    :math:`y = c + a(1 - e^{-(x - x_0)/b})`.
    """
    return np.where(x < x0, c, c + a * (1 - np.exp(-(x - x0) / np.abs(b))))


def linear(x, m, b):
    r""":math:`y = mx + b`."""
    return m * x + b



def parabola(x, a, x0, y0):
    r""":math:`y = a(x - x_0)^2 + y_0`."""
    return a * np.square(x - x0) + y0



def hyperbola(z, w0, z0, zr):
    r"""
    Gaussian-beam-waist hyperbola
    :math:`w(z) = w_0\sqrt{1 + ((z - z_0)/z_R)^2}`.
    """
    return w0 * np.sqrt(1 + np.square((z - z0) / zr))



def gaussian(x, x0, a, c, w):
    r""":math:`y = c + a\exp[-(x - x_0)^2/2w^2]`."""
    return c + a * np.exp(-0.5 * np.square((x - x0) / w))



def _sinc_taylor(x, order=12):
    """Taylor-series sinc (numpy normalization); good to the second zero at order 12."""
    squared = np.square(np.pi * x)
    monomial = squared.copy()
    result = 1
    for n in range(2, order + 2, 2):
        if n != 2:
            monomial = monomial * squared
        result = result + monomial * ((-1 if n % 4 == 2 else 1) / factorial(n + 1))
    return result



def _sinc2d_nomod_taylor(xy, x0, y0, R, a=1, d=0):
    r"""Unmodulated rectangular sinc² using the Taylor approximation (smooth for fits)."""
    return (
        a
        * np.square(
            _sinc_taylor((1 / R) * (xy[0] - x0)) * _sinc_taylor((1 / R) * (xy[1] - y0))
        )
        + d
    )



def _sinc2d_centered_taylor(xy, R, a=1, b=0, c=0, d=0, kx=0, ky=0):
    r"""Taylor variant of :meth:`_sinc2d_centered`."""
    sinc_term = np.square(_sinc_taylor((1 / R) * xy[0]) * _sinc_taylor((1 / R) * xy[1]))
    return sinc_term * (a * 0.5 * (1 + np.cos(kx * xy[0] + ky * xy[1] - b)) + c) + d



def _sinc2d_centered_jacobian(xy, R, a=1, b=0, c=0, d=0, kx=0, ky=0):
    r"""
    Analytic Jacobian of :meth:`_sinc2d_centered` with respect to
    ``(R, a, b, c, d, kx, ky)``, shape ``(npoints, 7)`` — usable as the
    ``jac`` argument of ``scipy.optimize.curve_fit`` for the superpixel
    fringe fit (ref ``fitfunctions.py:509-541``; unused by ``image_fit``
    in both packages).
    """
    scx = np.sinc((1 / R) * xy[0])
    scy = np.sinc((1 / R) * xy[1])
    cx = np.cos((np.pi / R) * xy[0])
    cy = np.cos((np.pi / R) * xy[1])
    sinc_term = np.square(scx * scy)
    phase = kx * xy[0] + ky * xy[1] - b
    cos_term = 0.5 * (1 + np.cos(phase))
    dcos_term = -0.5 * np.sin(phase)
    # d/dR of sinc(x/R)^2 = (2/R) sinc(x/R) (sinc(x/R) - cos(pi x/R));
    # the product rule couples the x and y factors.
    dsinc_dR = (2 / R) * scx * scy * (
        scx * (scy - cy) + scy * (scx - cx)
    )
    return np.vstack((
        dsinc_dR * (a * cos_term + c),                  # R
        sinc_term * cos_term,                           # a
        -sinc_term * a * dcos_term,                     # b
        sinc_term,                                      # c
        np.full_like(np.asarray(xy[0], dtype=float), 1.0),  # d
        xy[0] * sinc_term * a * dcos_term,              # kx
        xy[1] * sinc_term * a * dcos_term,              # ky
    )).T

