r"""
Analytic phase patterns (numpy and scipy only; a copy of
:mod:`slmsuite_tpu.holography.toolbox.phase`): gratings, lenses, the
Zernike polynomials with their index conventions, arbitrary polynomials,
and the structured-light modes. The functions evaluate on normalized
:math:`x/\lambda` meshgrids ``(x_grid, y_grid)``, or on an SLM's. The
compressed hologram's device basis (:mod:`slmsuite_torch.ops.compressed`)
is built from these Zernike sums.
"""

import numpy as np
from scipy import special
from scipy.special import factorial

from slmsuite_torch.holography.toolbox import (
    _process_grid,
    format_2vectors,
    imprint,
)
from slmsuite_torch.misc.math import REAL_TYPES

__all__ = [
    "blaze",
    "sinusoid",
    "binary",
    "bahtinov",
    "quadrants",
    "lens",
    "axicon",
    "zernike",
    "zernike_sum",
    "zernike_aperture",
    "zernike_convert_index",
    "zernike_order_number",
    "zernike_get_string",
    "zernike_pyramid_plot",
    "polynomial",
    "laguerre_gaussian",
    "hermite_gaussian",
    "ince_gaussian",
    "matheui_gaussian",
    "airy",
    "ZERNIKE_INDEXING",
    "ZERNIKE_NAMES",
]


# --------------------------------------------------------------------------
# Gratings (ref phase.py:37-404).
# --------------------------------------------------------------------------


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


def sinusoid(grid, vector=(0, 0), shift=0, a=np.pi, b=0):
    r"""
    Sinusoidal (holographic) grating
    :math:`\phi = \frac{a-b}{2}[1 + \sin(2\pi\vec{k}\cdot\vec{x} + s)] + b`.
    Power diffracts symmetrically into the :math:`\pm 1` orders.
    """
    if vector[0] == 0 and vector[1] == 0:
        x_grid, _ = _process_grid(grid)
        result = np.full_like(x_grid, (a - b) / 2 * (1 + np.sin(shift)))
    else:
        result = (a - b) / 2 * (1 + np.sin(blaze(grid, vector) + shift))
    if b != 0:
        result = result + b
    return result


def binary(grid, vector=(0, 0), shift=0, a=np.pi, b=0, duty_cycle=0.5):
    r"""
    Binary grating toward ``vector``: value ``a`` for ``duty_cycle`` of each
    period, ``b`` otherwise. Components of ``vector`` larger than 1 are
    interpreted as integer pixel periods.
    """
    x_grid, y_grid = _process_grid(grid)
    dtype = x_grid.dtype
    duty_cycle = float(np.clip(duty_cycle, 0, 1))

    if np.any(np.abs(vector) > 1):
        # Pixel-period mode: rebuild a pixel-unit grid.
        x_grid, y_grid = np.meshgrid(
            np.arange(x_grid.shape[1], dtype=float),
            np.arange(x_grid.shape[0], dtype=float),
        )
        vector = (
            0 if vector[0] == 0 else 1.0 / vector[0],
            0 if vector[1] == 0 else 1.0 / vector[1],
        )
        grid = (x_grid, y_grid)
    else:
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


def _quadrants(grid, vectors, grating=blaze):
    """Fill the four quadrants (TR, BR, TL, BL order) with gratings."""
    vectors = format_2vectors(vectors)
    if vectors.shape != (2, 4):
        raise ValueError(f"Expected four 2-vectors (2, 4); found {vectors.shape}.")

    x_grid, y_grid = _process_grid(grid)
    canvas = np.zeros_like(x_grid)

    for i, vector in enumerate(vectors.T):
        imprint(
            matrix=canvas,
            window=[
                (canvas.shape[1] // 2) * ((3 - i) // 2),
                canvas.shape[1] // 2,
                (canvas.shape[0] // 2) * (i % 2),
                canvas.shape[0] // 2,
            ],
            function=grating,
            grid=(x_grid, y_grid),
            vector=vector,
        )
    return canvas


def bahtinov(grid, radius=0.001, angle=10 * np.pi / 180, grating=binary):
    r"""
    Bahtinov focusing mask: left quadrants grate vertically, right quadrants
    at :math:`\pm` ``angle``; the farfield is symmetric exactly at focus.
    """
    s, c = np.sin(angle), np.cos(angle)
    vectors = format_2vectors(radius * np.array([(s, c), (s, -c), (0, 1), (0, 1)]).T)
    return _quadrants(grid, vectors, grating=grating)


def quadrants(grid, radius=0.001, center=(0, 0)):
    r"""
    Alignment mask: each quadrant blazes outward along its diagonal; equal
    spot intensities indicate the source is centered on the SLM.
    """
    vectors = format_2vectors(
        (radius / np.sqrt(2)) * np.array([(1, -1), (1, 1), (-1, -1), (-1, 1)]).T
    ) + format_2vectors(center)
    return _quadrants(grid, vectors, grating=blaze)


# --------------------------------------------------------------------------
# Lenses (ref phase.py:283-500).
# --------------------------------------------------------------------------


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


def axicon(grid, f=(np.inf, np.inf), w=None):
    r"""
    Axicon lens (Bessel-beam farfield):
    :math:`\phi(\vec{x}) = 2\pi|\vec{k}_g\cdot\vec{x}|` with
    :math:`\vec{k}_g = w/2\vec{f}`.
    """
    x_grid, y_grid = _process_grid(grid)
    w = _determine_source_radius(grid, w)
    f = _parse_focal_length(f)

    angle = [w / f[0] / 2, w / f[1] / 2]
    if angle[0] == 0 and angle[1] == 0:
        return 0 * x_grid
    if angle[0] == 0:
        return (2 * np.pi * angle[1]) * np.abs(y_grid)
    if angle[1] == 0:
        return (2 * np.pi * angle[0]) * np.abs(x_grid)
    return (2 * np.pi) * np.sqrt(
        np.square(x_grid * angle[0]) + np.square(y_grid * angle[1])
    )


# --------------------------------------------------------------------------
# Zernike indexing (ref phase.py:504-680).
# --------------------------------------------------------------------------

ZERNIKE_INDEXING_DIMENSION = {"ansi": 1, "noll": 1, "fringe": 1, "wyant": 1, "radial": 2}
ZERNIKE_INDEXING = ZERNIKE_INDEXING_DIMENSION.keys()

ZERNIKE_NAMES = [
    "Piston",
    "Vertical tilt",
    "Horizontal tilt",
    "Oblique astigmatism",
    "Defocus",
    "Vertical astigmatism",
    "Vertical trefoil",
    "Vertical coma",
    "Horizontal coma",
    "Oblique trefoil",
    "Oblique quadrafoil",
    "Oblique secondary astigmatism",
    "Spherical aberration",
    "Vertical secondary astigmatism",
    "Vertical quadrafoil",
    "Vertical pentafoil",
    "Vertical secondary trefoil",
    "Vertical secondary coma",
    "Horizontal secondary coma",
    "Oblique secondary trefoil",
    "Oblique pentafoil",
    "Oblique hexafoil",
    "Oblique secondary quadrafoil",
    "Oblique trinary astigmatism",
    "Secondary spherical aberration",
    "Vertical trinary astigmatism",
    "Vertical secondary quadrafoil",
    "Vertical hexafoil",
]


def zernike_order_number(radial_order):
    """Number of Zernike polynomials at or below ``radial_order``: (n+1)(n+2)/2."""
    return (radial_order + 1) * (radial_order + 2) // 2


def zernike_convert_index(indices, from_index="ansi", to_index="ansi"):
    """
    Convert between Zernike indexing conventions: ``"ansi"`` (0-based, the
    package default), ``"noll"``/``"fringe"`` (1-based), ``"wyant"``
    (fringe - 1), and 2D ``"radial"`` :math:`(n, l)`.

    Input shape ``(N, D)`` (D = 2 for radial); returns the same layout.
    """
    for name in (from_index, to_index):
        if name not in ZERNIKE_INDEXING:
            raise ValueError(f"Index '{name}' not in {list(ZERNIKE_INDEXING)}.")

    dimension = ZERNIKE_INDEXING_DIMENSION[from_index]
    indices = np.asarray(indices, dtype=int)
    if indices.size == dimension:
        indices = indices.reshape((1, dimension))
    if dimension > 1 and indices.shape[1] != dimension:
        raise ValueError(f"Expected shape (N, {dimension}); found {indices.shape}")

    if from_index == to_index:
        return indices

    # To radial (n, l).
    if from_index == "radial":
        n, l = indices[:, 0], indices[:, 1]
    elif from_index == "ansi":
        n = np.floor(0.5 * np.sqrt(8 * indices + 1) - 0.5).astype(int).ravel()
        l = (2 * indices.ravel() - n * (n + 2)).astype(int)
    else:
        raise NotImplementedError(f"from_index '{from_index}' is not supported currently.")

    if np.any((n + l) % 2):
        raise ValueError(f"Invalid Zernike index: n+l must be even. n={n}, l={l}.")
    if np.any(np.abs(l) > n):
        raise ValueError(f"Invalid Zernike index: |l| <= n required. n={n}, l={l}.")
    if np.any(n < 0):
        raise ValueError(f"Invalid Zernike index: n >= 0 required. n={n}, l={l}.")

    # From radial to the target.
    if to_index == "radial":
        return np.vstack((n, l)).T
    if to_index == "noll":
        result = (n * (n + 1)) // 2 + np.abs(l)
        result = result + np.logical_and(l >= 0, np.mod(n, 4) <= 1)
        result = result + np.logical_and(l <= 0, np.mod(n, 4) > 1)
        return result
    if to_index in ("wyant", "fringe"):
        return (
            np.square(1 + (n + np.abs(l)) / 2).astype(int)
            - 2 * np.abs(l)
            + (l < 0)
            - (to_index == "wyant")
        )
    # ansi
    return (n * (n + 2) + l) // 2


def zernike_aperture(grid, aperture=None):
    """
    Determine the ``(x_scale, y_scale)`` mapping of grid coordinates onto the
    Zernike unit disk.

    ``aperture`` may be ``"circular"`` (pupil touches nearest grid edge),
    ``"elliptical"`` (touches both edges), ``"cropped"`` (circumscribes the
    grid; default), a scalar/pair custom scale, or ``None`` (use the SLM's
    measured source scaling if available).
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


# --------------------------------------------------------------------------
# Zernike coefficient cache (ref phase.py:1357-1489).
# --------------------------------------------------------------------------

# index -> {(a, b): coefficient} for the x^a y^b monomial expansion.
_zernike_cache = {}
# Dense (zernike ANSI index, cantor monomial index) -> coefficient matrix.
_zernike_cache_vectorized = np.zeros((0, 0), dtype=int)


def _cantor_pairing(xy):
    """Map 2D indices (a, b) to the unique Cantor 1D index."""
    xy = np.asarray(xy, dtype=int).reshape((-1, 2))
    s = xy[:, 0] + xy[:, 1]
    return (s * (s + 1)) // 2 + xy[:, 1]


def _inverse_cantor_pairing(z):
    """
    Map Cantor 1D indices back to 2D ``(D, 2)``. Negative indices (special
    markers) map to ``(z, 0)``.
    """
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
    """
    Monomial coefficients ``{(a, b): c}`` of the real Zernike polynomial with
    ANSI ``index`` (combinatorial expansion per doi:10.1117/12.294412),
    cached globally.
    """
    index = int(index)
    if index in _zernike_cache:
        return _zernike_cache[index]

    n, l = zernike_convert_index(index, to_index="radial")[0]
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

    # Grow the vectorized cache to fit this order.
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


def _zernike_build_indices(indices):
    """Ensure all ``indices`` are present in the caches."""
    for index in np.ravel(indices):
        if index >= 0:
            _zernike_coefficients(index)


def _zernike_get_cantor(indices, weights, derivative=(0, 0)):
    """
    Convert Zernike-basis weights ``(D, N)`` into Cantor-monomial-basis terms
    and weights: returns ``(pairing (M, 2), weights (M, N))``. Negative
    indices (special terms, e.g. vortex) pass through.
    """
    indices = np.asarray(indices)
    weights = np.asarray(weights)

    negative_mask = indices < 0
    positive = indices[~negative_mask]
    negative = indices[negative_mask]
    weights_pos = weights[~negative_mask, :]
    weights_neg = weights[negative_mask, :]

    _zernike_build_indices(positive)
    zernike_cantor = _zernike_cache_vectorized[positive, :]  # (D, M)
    cantor_indices = np.arange(zernike_cantor.shape[1])

    nonzero = np.any(zernike_cantor, axis=0)
    cantor_indices = cantor_indices[nonzero]
    zernike_cantor = zernike_cantor[:, nonzero].astype(float)
    cantor_pairing = _inverse_cantor_pairing(cantor_indices)

    if np.any(derivative):
        for axis in (0, 1):
            order = int(derivative[axis])
            if order <= 0:
                continue
            power = cantor_pairing[:, axis].astype(int)  # (M,)
            keep = power >= order
            # Power rule: x^p -> p!/(p-k)! x^(p-k).
            scale = np.zeros_like(power, dtype=float)
            scale[keep] = factorial(power[keep]) / factorial(power[keep] - order)
            zernike_cantor = zernike_cantor * scale[np.newaxis, :]
            cantor_pairing[:, axis] = np.maximum(power - order, 0)

        nonzero = np.any(zernike_cantor, axis=0)
        cantor_pairing = cantor_pairing[nonzero, :]
        zernike_cantor = zernike_cantor[:, nonzero]

    cantor_weights = zernike_cantor.T @ weights_pos  # (M, N)

    M, N = cantor_weights.shape
    MM = M + int(np.sum(negative_mask))
    final_pairing = np.zeros((MM, 2), dtype=int)
    final_pairing[:M, :] = cantor_pairing
    final_pairing[M:, 0] = negative
    final_weights = np.zeros((MM, N))
    final_weights[:M, :] = cantor_weights
    final_weights[M:, :] = weights_neg

    return final_pairing, final_weights


def _zernike_indices_parse(indices=None, D=None, smaller_okay=False):
    """
    Resolve the Zernike index basis for data of dimension ``D``; defaults are
    ``[2,1]`` (tilt), ``[2,1,4]`` (+focus), ``[2,1,4,3]``, then ascending.
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


def _zernike_populate_basis_map(indices):
    """
    Build the compressed monomial maps used by device kernels:
    ``c_md (M, D)`` coefficients, ``i_md (M, D)`` per-monomial nonzero term
    indices (-1 padded), and ``pxy_m (2, M)`` monomial powers.
    Parity: reference ``phase.py:1445-1489``.
    """
    indices = np.atleast_1d(np.squeeze(indices))
    D = len(indices)

    zernike_indices = indices[indices >= 0]
    other_indices = indices[indices < 0]

    for index in zernike_indices:
        _zernike_coefficients(index)

    nonzero = np.any(_zernike_cache_vectorized[zernike_indices, :], axis=0)
    cantor_indices = np.arange(len(nonzero), dtype=int)[nonzero]
    M = len(cantor_indices)

    pxy_m = _inverse_cantor_pairing(cantor_indices).astype(np.int32)

    if len(other_indices) > 0:
        pxy_m = np.pad(pxy_m, ((0, len(other_indices)), (0, 0)))
        pxy_m[M:, 0] = other_indices

    c_md = (
        _zernike_cache_vectorized[zernike_indices, :][:, cantor_indices]
        .T.astype(np.float32)
    )
    i_md = np.full((M, D), -1, dtype=np.int32)
    darange = np.arange(len(zernike_indices))
    for m in range(M):
        hit = darange[c_md[m, :] != 0]
        i_md[m, : len(hit)] = hit

    return c_md, i_md, pxy_m.T


def _term_pathing(xy):
    """
    Order monomial terms to minimize multiplications when evaluating with a
    single running monomial: sort into chains of non-decreasing powers.
    Parity: reference ``phase.py:1579-1643``.

    Returns indices into ``xy`` (shape ``(M,)``).
    """
    xy = np.asarray(xy, dtype=int)
    order = np.sum(xy, axis=1)
    delta = np.diff(xy, axis=1).ravel()
    cantor = _cantor_pairing(xy).astype(float)
    by_cantor_desc = np.argsort(-cantor)

    result = np.zeros(len(order), dtype=int)
    used = np.zeros(len(order), dtype=bool)

    def next_in_chain(current):
        """Largest unused term reachable by only multiplying (both powers <=)."""
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


def _parse_out(x_grid, out, stack=1):
    """Allocate or validate the output canvas of shape (stack,) + grid."""
    shape = (stack,) + tuple(x_grid.shape)
    if out is None:
        return np.zeros(shape, dtype=x_grid.dtype)
    if out.size != int(np.prod(shape)):
        raise ValueError("out must have same size as the stacked grid.")
    if out.dtype != x_grid.dtype:
        raise ValueError("out must have same type as grid.")
    return out.reshape(shape)


def polynomial(grid, weights, terms=None, pathing=None, out=None):
    r"""
    Monomial sum :math:`\phi(x, y) = \sum w_{ab}\,x^a y^b`.

    Parameters
    ----------
    grid : (array_like, array_like) OR SLM
        Coordinate meshgrids.
    weights : array_like
        ``(D,)`` or ``(D, N)`` term weights (N = stack of polynomials).
    terms : array_like OR None
        ``(D, 2)`` powers or ``(D,)`` Cantor indices; defaults to the Cantor
        range. A term with ``a = -1, b = 0`` is the special vortex
        (:math:`\arctan`) waveplate.
    pathing : array_like OR None OR False
        Evaluation order; defaults to the multiplication-minimizing path.
    out : numpy.ndarray OR None
        Optional output buffer.

    Returns
    -------
    numpy.ndarray of shape grid.shape (N = 1) or (N,) + grid.shape.
    """
    weights = np.asarray(weights)
    if terms is None:
        D = weights.shape[0]
        terms = _inverse_cantor_pairing(np.arange(D))
    else:
        terms = np.asarray(terms)
        if terms.ndim == 1:
            terms = _inverse_cantor_pairing(terms)
    if terms.shape[1] != 2:
        raise ValueError(f"Terms must be (D, 2) or (D,). Found {terms.shape}.")
    D = terms.shape[0]

    if weights.ndim == 1:
        if len(weights) != D:
            raise ValueError("weights must share a dimension with terms.")
        weights = weights.reshape((-1, 1))
    elif weights.ndim != 2 or weights.shape[0] != D:
        raise ValueError("weights must be (D,) or (D, N).")
    N = weights.shape[1]

    if pathing is False:
        pathing = np.arange(D)
    elif pathing is None:
        pathing = _term_pathing(terms)

    x_grid, y_grid = _process_grid(grid)
    out = _parse_out(x_grid, out, stack=N)
    out.fill(0)

    weights = weights.astype(out.dtype)
    monomial = np.ones_like(x_grid)
    nx0 = ny0 = 0

    for index in pathing:
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
            for i in range(N):
                if weights[index, i] != 0:
                    out[i, ...] += weights[index, i] * monomial
        elif nx == -1 and ny == 0:
            # Special: vortex waveplate.
            vortex = np.arctan2(np.real(y_grid), np.real(x_grid))
            for i in range(N):
                if weights[index, i] > 0:
                    out[i, ...] += weights[index, i] * vortex
        else:
            raise ValueError(f"Unrecognized terms {(nx, ny)} for index {index}.")

    return out


def zernike(grid, index, weight=1, **kwargs):
    """Single Zernike polynomial (ANSI ``index``); see :meth:`zernike_sum`."""
    return zernike_sum(grid, (int(index),), (float(weight),), **kwargs)


def zernike_sum(grid, indices, weights, aperture=None, use_mask=True, derivative=(0, 0), out=None):
    r"""
    Weighted sum of Zernike polynomials
    :math:`\phi(\vec{x}) = \sum_k w_k Z_{J_k}(\vec{x})` evaluated by cached
    Cantor-monomial expansion.

    Polynomials are normalized to peak-to-valley 2 (:math:`\pm 1`) on the
    unit pupil.

    Parameters
    ----------
    grid : (array_like, array_like) OR SLM
        Coordinate meshgrids.
    indices : array_like of int OR None
        ANSI indices, shape ``(D,)``; ``None`` selects the default basis for
        the weight dimension (see :meth:`_zernike_indices_parse`).
    weights : array_like
        ``(D,)`` or ``(D, N)`` for a stack of N sums.
    aperture :
        See :meth:`zernike_aperture`.
    use_mask : bool OR "return" OR nan
        Zero (or nan) outside the unit pupil; ``"return"`` returns the mask.
    derivative : (int, int)
        Differentiate (via power rule) before evaluation.
    out : numpy.ndarray OR None
        Optional output buffer.

    Returns
    -------
    numpy.ndarray
    """
    x_grid, y_grid = _process_grid(grid)
    x_scale, y_scale = zernike_aperture(grid, aperture)
    if len(derivative) != 2:
        raise ValueError("Expected derivative to be (int, int)")

    weights = np.squeeze(np.asarray(weights))
    if weights.ndim <= 1:
        if weights.ndim == 0:
            weights = np.array([weights])
        if indices is not None:
            indices_arr = np.atleast_1d(np.squeeze(indices))
            if len(weights) != len(indices_arr):
                raise ValueError("weights must share a dimension with indices.")
        weights = weights.reshape((-1, 1))
    elif weights.ndim != 2:
        raise ValueError("Expected weights to be 1D or 2D.")

    D, N = weights.shape
    indices = _zernike_indices_parse(indices, D)

    out = _parse_out(x_grid, out, stack=N)

    if use_mask is False:
        mask = None
        use_mask_flag = False
        mask_value = 0
    else:
        mask = np.square(x_grid * x_scale) + np.square(y_grid * y_scale) <= 1
        if isinstance(use_mask, str) and use_mask == "return":
            return mask
        mask_value = 0
        if not isinstance(use_mask, (bool, np.bool_)) and np.isnan(use_mask):
            mask_value = np.nan
        use_mask_flag = bool(np.any(mask == 0))

    if use_mask_flag:
        x_scaled = x_grid[mask] * x_scale
        y_scaled = y_grid[mask] * y_scale
    else:
        x_scaled = x_grid if x_scale == 1 else x_grid * x_scale
        y_scaled = y_grid if y_scale == 1 else y_grid * y_scale

    cantor_terms, cantor_weights = _zernike_get_cantor(indices, weights, derivative)

    if use_mask_flag:
        out.fill(mask_value)
        out[:, mask] = polynomial(
            grid=(x_scaled, y_scaled),
            weights=cantor_weights,
            terms=cantor_terms,
        )
    else:
        out = polynomial(
            grid=(x_scaled, y_scaled),
            weights=cantor_weights,
            terms=cantor_terms,
            out=out,
        )

    if N == 1:
        return out.reshape(x_grid.shape)
    return out


def zernike_get_string(index, derivative=(0, 0)):
    r"""LaTeX-style cartesian expansion string of the Zernike polynomial."""
    cxy, cw = _zernike_get_cantor(np.array([index]), np.array([[1.0]]), derivative)
    result = ""
    for i in reversed(range(len(cw))):
        w = cw[i, 0]
        if w == 0:
            continue
        result += "{0:+}".format(int(w))
        for j, name in enumerate(["x", "y"]):
            if cxy[i, j] >= 1:
                result += name
                if cxy[i, j] > 1:
                    result += f"^{cxy[i, j]}"
    if not result:
        result = "0"
    return result.strip("+")


def zernike_pyramid_plot(grid, order, scale=1, titles=("ansi", "radial", "name"), **kwargs):
    """
    Plot all Zernike polynomials at or below radial ``order`` in the
    traditional pyramid arrangement.
    """
    import matplotlib.pyplot as plt

    indices = np.arange(zernike_order_number(order))
    radial = zernike_convert_index(indices, "ansi", "radial")

    fig, axes = plt.subplots(
        order + 1, 2 * order + 1, figsize=(2 * (2 * order + 1), 2 * (order + 1))
    )
    for ax in np.ravel(axes):
        ax.axis("off")

    for index in indices:
        n, l = radial[index]
        ax = axes[n, l + order] if order > 0 else axes
        canvas = zernike(grid, index, weight=scale, use_mask=np.nan, **kwargs)
        ax.imshow(canvas)
        ax.axis("off")
        title = []
        if "ansi" in titles:
            title.append(f"$Z_{{{index}}}$")
        if "radial" in titles:
            title.append(f"$Z_{{{n}}}^{{{l}}}$")
        if "name" in titles and index < len(ZERNIKE_NAMES):
            title.append(ZERNIKE_NAMES[index])
        ax.set_title("\n".join(title), fontsize=8)

    return fig


# --------------------------------------------------------------------------
# Structured light (ref phase.py:1800-2030).
# --------------------------------------------------------------------------


def _determine_source_radius(grid, w=None):
    r"""
    Assumed Gaussian source :math:`1/e` amplitude radius: explicit ``w``, the
    SLM's measured source radius, or a quarter of the smallest grid extent.
    """
    if w is not None:
        return w

    if hasattr(grid, "slm") and hasattr(grid, "cam"):
        grid = grid.slm
    if hasattr(grid, "get_source_radius"):
        return grid.get_source_radius()

    x_grid, y_grid = _process_grid(grid)
    return np.min([np.amax(x_grid), np.amax(y_grid)]) / 4


def laguerre_gaussian(grid, l, p=0, w=None):
    r"""
    Phase farfield of a Laguerre-Gaussian beam (doi:10.1364/JOSAA.25.001642):
    azimuthal vortex of order ``l`` plus :math:`\pi` rings at the sign flips
    of the generalized Laguerre polynomial of radial order ``p``.
    """
    x_grid, y_grid = _process_grid(grid)
    w = _determine_source_radius(grid, w)

    theta_grid = np.arctan2(x_grid, y_grid)
    rr_grid = y_grid * y_grid + x_grid * x_grid

    canvas = 0
    if l != 0:
        canvas = canvas + l * theta_grid
    if p != 0:
        canvas = canvas + np.pi * np.heaviside(
            -special.genlaguerre(p, np.abs(l))(16 * rr_grid / w / w), 0
        )
    if np.isscalar(canvas):
        canvas = np.zeros_like(x_grid)
    return canvas


def hermite_gaussian(grid, n, m, w=None):
    r"""
    Phase farfield of a Hermite-Gaussian beam (doi:10.1364/AO.54.008444):
    the checkerboard sign pattern of the HG mode amplitude.
    """
    x_grid, y_grid = _process_grid(grid)
    w = _determine_source_radius(grid, w)

    factor = 4 / w
    mode = special.hermite(n)(factor * x_grid) * special.hermite(m)(factor * y_grid)

    phase = np.zeros_like(mode)
    phase[mode > 0] = np.pi
    return phase


def _ince_coefficients(p, m, parity, ellipticity):
    r"""
    Fourier coefficients of the Ince polynomial :math:`C_p^m` /
    :math:`S_p^m` (Bandres & Gutierrez-Vega, doi:10.1364/OL.29.000144).

    Trigonometric solutions of the Ince equation
    :math:`\Theta'' + \varepsilon\sin(2\eta)\Theta'
    + (a - p\varepsilon\cos(2\eta))\Theta = 0`
    expanded as :math:`\sum_j A_j \cos(k_j\eta)` (even) or
    :math:`\sum_j B_j \sin(k_j\eta)` (odd) with
    :math:`k_j \equiv p \pmod 2`. Applying the Ince operator to one
    harmonic couples it only to :math:`k \pm 2`:

    .. math:: L[\mathrm{trig}(k\eta)] = -k^2\,\mathrm{trig}(k\eta)
        + \tfrac{\varepsilon}{2}(k-p)\,\mathrm{trig}((k{+}2)\eta)
        - \tfrac{\varepsilon}{2}(k+p)\,\mathrm{trig}((k{-}2)\eta),

    so the polynomials are eigenvectors of a small tridiagonal-plus-fold
    matrix; eigenvalues sorted ascending enumerate increasing ``m``.

    Returns ``(ks, coeffs)`` with the coefficient vector normalized to
    unit :math:`L_2(\eta)` norm and a deterministic sign
    (:math:`C(0) > 0`; :math:`S'(0) > 0`).
    """
    eps = float(ellipticity)
    if parity == 1:
        ks = np.arange(p % 2, p + 1, 2)
    else:
        ks = np.arange(2 - (p % 2), p + 1, 2)
    n = len(ks)
    M = np.zeros((n, n))
    index = {k: j for j, k in enumerate(ks)}
    for j, k in enumerate(ks):
        M[j, j] -= k * k
        up = k + 2
        if up in index:
            M[index[up], j] += 0.5 * eps * (k - p)
        down = k - 2
        if parity == 1:
            # cos((k-2)eta) folds to cos(|k-2|eta) with unit sign.
            fold = abs(down)
            if fold in index:
                M[index[fold], j] -= 0.5 * eps * (k + p)
        else:
            # sin(-eta) = -sin(eta); sin(0) vanishes.
            if down in index:
                M[index[down], j] -= 0.5 * eps * (k + p)
            elif -down in index:
                M[index[-down], j] += 0.5 * eps * (k + p)
    # L[Theta] = -a Theta: ascending a <=> ascending m.
    eigvals, eigvecs = np.linalg.eig(-M)
    order = np.argsort(eigvals.real)
    idx = int(np.searchsorted(ks, m))
    coeffs = eigvecs[:, order[idx]].real

    # Unit L2(eta) norm over one period (cos(0) integrates to 2*pi).
    l2 = np.pi * np.sum(np.square(coeffs) * np.where(ks == 0, 2.0, 1.0))
    coeffs = coeffs / np.sqrt(l2)
    sign = np.sum(coeffs) if parity == 1 else np.sum(coeffs * ks)
    if sign == 0:
        sign = coeffs[np.argmax(np.abs(coeffs))]
    return ks, coeffs * np.sign(sign)


def ince_gaussian(grid, p, m, parity=1, ellipticity=1, w=None):
    r"""
    Phase farfield of an Ince-Gaussian beam
    (doi:10.1364/OL.29.000144). Even/odd modes are real, so the mask is
    the :math:`\{0, \pi\}` sign pattern of

    .. math:: \mathrm{IG}^{e}_{p,m} \propto
        C_p^m(i\xi)\,C_p^m(\eta)\,e^{-r^2/w^2}

    (:math:`S_p^m` for odd parity); a helical mode (``parity=0``,
    :math:`\mathrm{IG}^e + i\,\mathrm{IG}^o`) returns its continuous
    argument, which carries an :math:`m`-charged central vortex.
    Elliptic coordinates :math:`\xi + i\eta =
    \mathrm{arccosh}((x + iy)/f_0)` use the reference's convention for
    the semifocal distance :math:`f_0 = w\sqrt{\varepsilon/2}`
    (ref ``phase.py:1938-1992``, a NotImplemented stub upstream — the
    scaling is its ``factor``; implemented here beyond the reference).
    """
    x_grid, y_grid = _process_grid(grid)
    w = _determine_source_radius(grid, w)

    if parity == 1:
        if not 0 <= m <= p:
            raise ValueError(f"{(p, m)} is an invalid Ince polynomial.")
    else:
        if not 1 <= m <= p:
            raise ValueError(f"{(p, m)} is an invalid Ince polynomial.")
    if (p - m) % 2:
        raise ValueError(
            f"Ince polynomial requires p - m even; got {(p, m)}."
        )

    f0 = w * np.sqrt(ellipticity / 2)
    elliptic = np.arccosh((x_grid + 1j * y_grid) / f0 + 0j)
    xi, eta = elliptic.real, elliptic.imag

    def _even():
        ks, A = _ince_coefficients(p, m, 1, ellipticity)
        radial = sum(a * np.cosh(k * xi) for a, k in zip(A, ks))
        angular = sum(a * np.cos(k * eta) for a, k in zip(A, ks))
        return radial * angular

    def _odd():
        ks, B = _ince_coefficients(p, m, -1, ellipticity)
        # S(i xi) = i * sum B_j sinh(k_j xi); the i is a global phase.
        radial = sum(b * np.sinh(k * xi) for b, k in zip(B, ks))
        angular = sum(b * np.sin(k * eta) for b, k in zip(B, ks))
        return radial * angular

    if parity == 1:
        return np.where(_even() < 0, np.pi, 0.0)
    if parity == -1:
        return np.where(_odd() < 0, np.pi, 0.0)
    if m == 0:
        raise ValueError("Helical Ince-Gaussian requires m >= 1.")
    return np.mod(np.arctan2(_odd(), _even()), 2 * np.pi)


def matheui_gaussian(grid, r, q, w=None):
    r"""
    Phase farfield of an (even) Mathieu-Gaussian beam
    (doi:10.1364/AO.49.006903): the :math:`\{0, \pi\}` sign pattern of

    .. math:: U \propto \mathrm{Mc}^{(1)}_r(\xi, q)\,
        \mathrm{ce}_r(\eta, q)\,e^{-\rho^2/w^2},

    the product of the radial (modified, first-kind) and angular even
    Mathieu functions in elliptic coordinates
    :math:`\xi + i\eta = \mathrm{arccosh}((x + iy)/f_0)` with semifocal
    distance :math:`f_0 = w/2`. ``q`` is the Mathieu ellipticity
    parameter, passed straight to the Mathieu functions.
    (Ref ``phase.py:1995-2008`` is a NotImplemented stub; implemented
    here beyond the reference.)
    """
    x_grid, y_grid = _process_grid(grid)
    w = _determine_source_radius(grid, w)
    if q <= 0:
        raise ValueError(f"Mathieu parameter q must be positive; got {q}.")

    f0 = w / 2
    elliptic = np.arccosh((x_grid + 1j * y_grid) / f0 + 0j)
    xi, eta = elliptic.real, elliptic.imag

    radial = special.mathieu_modcem1(r, q, xi)[0]
    angular = special.mathieu_cem(r, q, np.degrees(eta))[0]
    return np.where(radial * angular < 0, np.pi, 0.0)


def airy(grid, f=(np.inf, np.inf), w=None):
    r"""
    Cubic phase farfield of a 2D Airy beam
    (doi:10.1103/PhysRevLett.99.213901):

    .. math:: \phi(x, y) = \tfrac{1}{3}\left[
        (2\pi s_x x)^3 + (2\pi s_y y)^3\right],
        \qquad s_i = \frac{w}{2 f_i},

    which produces a farfield :math:`\mathrm{Ai}(k_x/s_x)\,
    \mathrm{Ai}(k_y/s_y)` with lobe scale :math:`s` in ``"kxy"`` units.
    ``s = w/2f`` matches :meth:`axicon`'s deflection convention, and
    ``f = inf`` (the default) flattens an axis, like :meth:`lens`.
    (Ref ``phase.py:2011-2030`` is a NotImplemented stub; implemented
    here beyond the reference.)
    """
    x_grid, y_grid = _process_grid(grid)
    w = _determine_source_radius(grid, w)
    f = _parse_focal_length(f)

    canvas = np.zeros_like(x_grid)
    for axis_grid, focal in ((x_grid, f[0]), (y_grid, f[1])):
        if np.isfinite(focal) and focal != 0:
            canvas = canvas + np.power(np.pi * w / focal * axis_grid, 3) / 3
    return canvas
