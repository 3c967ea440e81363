r"""
Fit functions (the port's copy of the two source profiles it uses from
:mod:`slmsuite_tpu.holography.analysis.fitfunctions`). Each takes the
independent variables ``(x, y)`` first, then its parameters.
"""

import numpy as np

__all__ = ["gaussian2d", "tophat2d"]


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
