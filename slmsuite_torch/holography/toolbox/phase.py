r"""
Phase patterns on an SLM grid: the part of
:mod:`slmsuite_tpu.holography.toolbox.phase` that the holograms need
(numpy and scipy only): the blazed grating and the lens of the quadratic
initial phase, the binary grating of the pixel calibration, and the Zernike polynomials of the compressed spot
hologram and of the Zernike wavefront calibration. Polynomials are
evaluated by their cached Cantor-monomial expansion and normalized to
peak-to-valley 2 on the unit pupil.
"""

import numpy as np
from scipy.special import factorial

from slmsuite_torch.holography.toolbox import REAL_TYPES, _process_grid


def blaze(grid, vector=(0, 0)):
    r"""
    Blazed grating (linear phase ramp) toward ``vector`` in k-space:
    :math:`\phi(\vec{x}) = 2\pi\,\vec{k}\cdot\vec{x}`. A third vector
    component adds a normalized-focal-power lens term
    :math:`\pi k_z |\vec{x}|^2`.
    """
    x_grid, y_grid = _process_grid(grid)

    if vector[0] == 0 and vector[1] == 0:
        result = np.zeros_like(x_grid)
    elif vector[1] == 0:
        result = (2 * np.pi * vector[0]) * x_grid
    elif vector[0] == 0:
        result = (2 * np.pi * vector[1]) * y_grid
    else:
        result = (2 * np.pi * vector[0]) * x_grid + (2 * np.pi * vector[1]) * y_grid

    if len(vector) > 2:
        result = result + (np.pi * vector[2]) * (np.square(x_grid) + np.square(y_grid))

    return result


def binary(grid, vector=(0, 0), shift=0, a=np.pi, b=0, duty_cycle=0.5):
    r"""
    Binary grating toward ``vector``: the value ``a`` for ``duty_cycle``
    of each period, ``b`` otherwise. Components of ``vector`` larger than 1
    are taken as integer pixel periods.
    """
    x_grid, y_grid = _process_grid(grid)
    dtype = x_grid.dtype
    duty_cycle = float(np.clip(duty_cycle, 0, 1))

    if np.any(np.abs(vector) > 1):
        # Pixel periods: a grid in pixel units.
        x_grid, y_grid = np.meshgrid(
            np.arange(x_grid.shape[1], dtype=float),
            np.arange(x_grid.shape[0], dtype=float),
        )
        vector = (
            0 if vector[0] == 0 else 1.0 / vector[0],
            0 if vector[1] == 0 else 1.0 / vector[1],
        )
    grid = (x_grid, y_grid)

    if vector[0] == 0 and vector[1] == 0:
        value = b
        if shift != 0 and np.mod(shift, 2 * np.pi) > (2 * np.pi * duty_cycle):
            value = a
        return np.full(x_grid.shape, value, dtype=dtype)

    decision = np.mod(blaze(grid, vector) + shift, 2 * np.pi)
    decision[np.isclose(decision, 2 * np.pi)] = 0
    decision -= 2 * np.pi * (1 - duty_cycle)

    return np.where(np.logical_or(decision > 0, np.isclose(decision, 0)), a, b)


def _parse_focal_length(f):
    """Normalize a focal length argument to a 2-element array."""
    if isinstance(f, REAL_TYPES):
        f = [f, f]
    if isinstance(f, (list, tuple, np.ndarray)):
        f = np.squeeze(f)
        if f.size != 2:
            raise ValueError(f"Expected two terms in focal list. Found {f}.")
        if np.any(f == 0):
            raise ValueError(f"Cannot interpret a focal length of zero. Found {f}.")
    return f


def lens(grid, f=(np.inf, np.inf)):
    r"""
    Thin parabolic lens
    :math:`\phi(x, y) = \pi[x^2/f_x + y^2/f_y]`
    with focal length(s) in normalized :math:`x/\lambda` units.
    """
    x_grid, y_grid = _process_grid(grid)
    f = _parse_focal_length(f)

    fx_finite, fy_finite = np.isfinite(f[0]), np.isfinite(f[1])
    if fx_finite and fy_finite:
        return (np.pi / f[0]) * np.square(x_grid) + (np.pi / f[1]) * np.square(y_grid)
    if fx_finite:
        return (np.pi / f[0]) * np.square(x_grid)
    if fy_finite:
        return (np.pi / f[1]) * np.square(y_grid)
    return np.zeros_like(x_grid)


def _ansi_to_radial(index):
    """ANSI index -> radial ``(n, l)``."""
    n = int(np.floor(0.5 * np.sqrt(8 * index + 1) - 0.5))
    l = int(2 * index - n * (n + 2))
    if (n + l) % 2 or abs(l) > n or n < 0:
        raise ValueError(f"Invalid Zernike index {index}: n={n}, l={l}.")
    return n, l


def zernike_aperture(grid, aperture=None):
    """
    The ``(x_scale, y_scale)`` mapping of grid coordinates onto the Zernike
    unit disk. ``aperture`` is ``"circular"`` (pupil touches the nearest
    grid edge), ``"elliptical"`` (touches both edges), ``"cropped"``
    (circumscribes the grid), a scalar or pair, or ``None`` (the SLM's
    source scaling when ``grid`` is an SLM, else ``"cropped"``).
    """
    x_grid, y_grid = _process_grid(grid)

    if aperture is None:
        obj = grid.slm if hasattr(grid, "slm") else grid
        if hasattr(obj, "get_source_zernike_scaling"):
            aperture = obj.get_source_zernike_scaling()
        else:
            aperture = "cropped"

    if isinstance(aperture, str):
        if aperture == "elliptical":
            x_scale = 1 / np.nanmax(x_grid)
            y_scale = 1 / np.nanmax(y_grid)
        elif aperture == "circular":
            x_scale = y_scale = 1 / np.amin([np.nanmax(x_grid), np.nanmax(y_grid)])
        elif aperture == "cropped":
            x_scale = y_scale = 1 / np.sqrt(
                np.nanmax(np.square(x_grid) + np.square(y_grid))
            )
        else:
            raise ValueError(f"Aperture '{aperture}' is not implemented.")
    elif np.isscalar(aperture):
        x_scale = y_scale = aperture
    elif isinstance(aperture, (list, tuple, np.ndarray)) and len(aperture) == 2:
        x_scale, y_scale = aperture[0], aperture[1]
    else:
        raise ValueError(f"Aperture type {type(aperture)} not recognized.")

    return (x_scale, y_scale)


# index -> {(a, b): coefficient} of the x^a y^b monomial expansion.
_zernike_cache = {}
# Dense (ANSI index, Cantor monomial index) -> coefficient matrix.
_zernike_cache_vectorized = np.zeros((0, 0), dtype=int)


def _cantor_pairing(xy):
    """Map 2D indices (a, b) to the unique Cantor 1D index."""
    xy = np.asarray(xy, dtype=int).reshape((-1, 2))
    s = xy[:, 0] + xy[:, 1]
    return (s * (s + 1)) // 2 + xy[:, 1]


def _inverse_cantor_pairing(z):
    """Cantor 1D indices back to ``(D, 2)``; negative indices (special
    terms) map to ``(z, 0)``."""
    z = np.asarray(z, dtype=int)
    if z.ndim != 1:
        raise ValueError("Expected a list of shape (D,)")

    w = ((np.sqrt(8 * z.clip(min=0) + 1) - 1) // 2).astype(int)
    t = (w * w + w) // 2
    y = z - t
    x = w - y

    y[z < 0] = 0
    x[z < 0] = z[z < 0]
    return np.vstack((x, y)).T


def _zernike_coefficients(index):
    """Monomial coefficients ``{(a, b): c}`` of the real Zernike polynomial
    with ANSI ``index`` (doi:10.1117/12.294412), cached."""
    index = int(index)
    if index in _zernike_cache:
        return _zernike_cache[index]

    n, l = _ansi_to_radial(index)
    l = -l

    if l % 2:
        q = (abs(l) - 1) // 2
    elif l > 0:
        q = abs(l) // 2 - 1
    else:
        q = abs(l) // 2
    p = 1 if l > 0 else 0
    l = abs(l)
    m = (n - l) // 2

    def comb(nn, kk):
        return factorial(nn) / (factorial(kk) * factorial(nn - kk))

    coefficients = {}
    for i in range(q + 1):
        for j in range(m + 1):
            for k in range(m - j + 1):
                factor = -1 if (i + j) % 2 else 1
                factor *= comb(l, 2 * i + p)
                factor *= comb(m - j, k)
                factor *= float(factorial(n - j)) / (
                    factorial(j) * factorial(m - j) * factorial(n - m - j)
                )
                key = (int(n - 2 * (i + j + k) - p), int(2 * (i + k) + p))
                coefficients[key] = coefficients.get(key, 0) + int(factor)

    coefficients = {k: v for k, v in coefficients.items() if v != 0}
    _zernike_cache[index] = coefficients

    global _zernike_cache_vectorized
    size = (n + 1) * (n + 2) // 2
    rows, cols = _zernike_cache_vectorized.shape
    if rows <= index or cols < size:
        new = np.zeros((max(rows, index + 1), max(cols, size)), dtype=int)
        new[:rows, :cols] = _zernike_cache_vectorized
        _zernike_cache_vectorized = new
    for key, factor in coefficients.items():
        _zernike_cache_vectorized[index, _cantor_pairing(key)[0]] = factor

    return coefficients


def _zernike_get_cantor(indices, weights):
    """Zernike-basis weights ``(D, N)`` -> Cantor-monomial terms ``(M, 2)``
    and weights ``(M, N)``. Negative indices (the vortex term) pass
    through."""
    indices = np.asarray(indices)
    weights = np.asarray(weights)

    negative_mask = indices < 0
    positive = indices[~negative_mask]
    for index in positive:
        _zernike_coefficients(index)

    zernike_cantor = _zernike_cache_vectorized[positive, :]  # (D, M)
    nonzero = np.any(zernike_cantor, axis=0)
    cantor_indices = np.arange(zernike_cantor.shape[1])[nonzero]
    zernike_cantor = zernike_cantor[:, nonzero].astype(float)
    cantor_pairing = _inverse_cantor_pairing(cantor_indices)

    cantor_weights = zernike_cantor.T @ weights[~negative_mask, :]  # (M, N)

    M, N = cantor_weights.shape
    MM = M + int(np.sum(negative_mask))
    final_pairing = np.zeros((MM, 2), dtype=int)
    final_pairing[:M, :] = cantor_pairing
    final_pairing[M:, 0] = indices[negative_mask]
    final_weights = np.zeros((MM, N))
    final_weights[:M, :] = cantor_weights
    final_weights[M:, :] = weights[negative_mask, :]
    return final_pairing, final_weights


def _zernike_indices_parse(indices=None, D=None, smaller_okay=False):
    """
    The Zernike index basis for data of dimension ``D``: ``[2, 1]`` (tilt),
    ``[2, 1, 4]`` (+focus), ``[2, 1, 4, 3]``, then ascending.
    """
    if np.isscalar(indices):
        DD = int(indices)
        if D is None:
            if not smaller_okay:
                D = DD
        elif not ((smaller_okay and D <= DD) or D == DD):
            raise ValueError(
                f"Data dimension {D} incompatible with requested indices {DD}."
            )
        D = DD
        indices = None

    if indices is None:
        if D is None:
            raise ValueError("Either dimension or indices must be defined.")
        if D == 2:
            indices = np.array([2, 1])
        elif D == 3:
            indices = np.array([2, 1, 4])
        elif D == 4:
            indices = np.array([2, 1, 4, 3])
        else:
            indices = np.hstack((np.array([2, 1, 4, 3]), np.arange(5, D + 1)))

    indices = np.ravel(indices)
    if D is not None and not ((smaller_okay and D <= len(indices)) or D == len(indices)):
        raise ValueError(
            f"Data dimension {D} incompatible with indices length {len(indices)}."
        )
    return indices


def _term_pathing(xy):
    """Order monomial terms into chains of non-decreasing powers, so one
    running monomial evaluates them with the fewest multiplications.
    Returns indices into ``xy``."""
    xy = np.asarray(xy, dtype=int)
    order = np.sum(xy, axis=1)
    cantor = _cantor_pairing(xy).astype(float)
    by_cantor_desc = np.argsort(-cantor)

    result = np.zeros(len(order), dtype=int)
    used = np.zeros(len(order), dtype=bool)

    def next_in_chain(current):
        best, best_cantor = -1, -1
        for candidate in range(len(order)):
            if used[candidate] or candidate == current:
                continue
            if (
                xy[candidate, 0] <= xy[current, 0]
                and xy[candidate, 1] <= xy[current, 1]
                and order[candidate] < order[current]
            ):
                if cantor[candidate] > best_cantor:
                    best, best_cantor = candidate, cantor[candidate]
        return best

    slot = len(order) - 1
    for start in by_cantor_desc:
        if used[start] or slot < 0:
            continue
        current = start
        while current >= 0 and slot >= 0:
            result[slot] = current
            used[current] = True
            slot -= 1
            current = next_in_chain(current)

    return result


def _polynomial(grid, weights, terms, out):
    r"""Monomial sums :math:`\sum w_{ab}\,x^a y^b` for each of the ``N``
    columns of ``weights (D, N)`` into ``out (N, ...)``; the term ``(-1,
    0)`` is the vortex (:math:`\arctan`) waveplate."""
    x_grid, y_grid = grid
    out.fill(0)
    weights = weights.astype(out.dtype)
    monomial = np.ones_like(x_grid)
    nx0 = ny0 = 0

    for index in _term_pathing(terms):
        nx, ny = terms[index, :]
        if nx >= 0:
            if nx - nx0 < 0 or ny - ny0 < 0:
                nx0 = ny0 = 0
                monomial.fill(1)
            for _ in range(nx - nx0):
                monomial *= x_grid
            for _ in range(ny - ny0):
                monomial *= y_grid
            nx0, ny0 = nx, ny
            for i in range(weights.shape[1]):
                if weights[index, i] != 0:
                    out[i, ...] += weights[index, i] * monomial
        elif nx == -1 and ny == 0:
            vortex = np.arctan2(np.real(y_grid), np.real(x_grid))
            for i in range(weights.shape[1]):
                if weights[index, i] > 0:
                    out[i, ...] += weights[index, i] * vortex
        else:
            raise ValueError(f"Unrecognized terms {(nx, ny)} for index {index}.")
    return out


def zernike(grid, index, weight=1, **kwargs):
    """One Zernike polynomial (ANSI ``index``) times ``weight``; the keyword
    arguments are :meth:`zernike_sum`'s."""
    return zernike_sum(grid, (int(index),), (float(weight),), **kwargs)


def zernike_sum(grid, indices, weights, aperture=None, use_mask=True):
    r"""
    Weighted sums of Zernike polynomials :math:`\sum_k w_k Z_{J_k}` on
    ``grid`` (meshgrids or an SLM). ``indices`` are ANSI (``None``: the
    default basis for the weights' dimension); ``weights`` is ``(D,)`` or
    ``(D, N)`` for a stack of ``N`` sums. ``aperture`` as in
    :meth:`zernike_aperture`. ``use_mask`` zeroes (or, as nan, fills with
    nan) the outside of the unit pupil; ``"return"`` returns the mask.
    """
    x_grid, y_grid = _process_grid(grid)
    x_scale, y_scale = zernike_aperture(grid, aperture)

    weights = np.squeeze(np.asarray(weights))
    if weights.ndim <= 1:
        if weights.ndim == 0:
            weights = np.array([weights])
        if indices is not None:
            if len(weights) != len(np.atleast_1d(np.squeeze(indices))):
                raise ValueError("weights must share a dimension with indices.")
        weights = weights.reshape((-1, 1))
    elif weights.ndim != 2:
        raise ValueError("Expected weights to be 1D or 2D.")

    D, N = weights.shape
    indices = _zernike_indices_parse(indices, D)
    out = np.zeros((N,) + tuple(x_grid.shape), dtype=x_grid.dtype)

    use_mask_flag, mask_value = False, 0
    if use_mask is not False:
        mask = np.square(x_grid * x_scale) + np.square(y_grid * y_scale) <= 1
        if isinstance(use_mask, str) and use_mask == "return":
            return mask
        if not isinstance(use_mask, (bool, np.bool_)) and np.isnan(use_mask):
            mask_value = np.nan
        use_mask_flag = bool(np.any(mask == 0))

    terms, cantor_weights = _zernike_get_cantor(indices, weights)
    if use_mask_flag:
        scaled = (x_grid[mask] * x_scale, y_grid[mask] * y_scale)
        out.fill(mask_value)
        out[:, mask] = _polynomial(
            scaled, cantor_weights, terms, np.zeros((N,) + scaled[0].shape, out.dtype)
        )
    else:
        scaled = (
            x_grid if x_scale == 1 else x_grid * x_scale,
            y_grid if y_scale == 1 else y_grid * y_scale,
        )
        _polynomial(scaled, cantor_weights, terms, out)

    if N == 1:
        return out.reshape(x_grid.shape)
    return out
