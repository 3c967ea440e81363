"""
The vector, unit, grid and window helpers the port's hologram classes and SLM
need, with the semantics of :mod:`slmsuite_tpu.holography.toolbox`
(numpy and scipy only).

Camera units (``"ij"`` and the metric camera-plane units) need a
Fourier-calibrated CameraSLM as ``hardware``; without one
:meth:`convert_vector` warns and returns nan for them.
"""

import warnings

import numpy as np
from scipy.spatial import Voronoi, distance, voronoi_plot_2d

from slmsuite_torch.misc.math import INTEGER_TYPES, REAL_TYPES

#: Microns per unit of length.
LENGTH_FACTORS = {"m": 1e6, "cm": 1e4, "mm": 1e3, "um": 1.0, "nm": 1e-3}

#: Camera-plane units: pixels and (magnified) lengths.
CAMERA_UNITS = ["ij"] + [p + k for p in ("", "mag_") for k in LENGTH_FACTORS]

#: Axis label of each length unit.
LENGTH_LABELS = {k: k for k in LENGTH_FACTORS}
LENGTH_LABELS["um"] = r"$\mu$m"

#: Axis labels of each unit, for plots.
BLAZE_LABELS = {
    "rad": (r"$\theta_x$ [rad]", r"$\theta_y$ [rad]"),
    "mrad": (r"$\theta_x$ [mrad]", r"$\theta_y$ [mrad]"),
    "deg": (r"$\theta_x$ [$^\circ$]", r"$\theta_y$ [$^\circ$]"),
    "norm": (r"$k_x/k$", r"$k_y/k$"),
    "kxy": (r"$k_x/k$", r"$k_y/k$"),
    "knm": (r"$k_n$ [pix]", r"$k_m$ [pix]"),
    "freq": (r"$f_x$ [1/pix]", r"$f_y$ [1/pix]"),
    "lpmm": (r"$k_x/2\pi$ [1/mm]", r"$k_y/2\pi$ [1/mm]"),
    "zernike": (
        r"$x = Z_2 = Z_1^1$ [Zernike rad]",
        r"$y = Z_1 = Z_1^{-1}$ [Zernike rad]",
    ),
    "ij": (r"Camera $i$ [pix]", r"Camera $j$ [pix]"),
}
for _prefix, _name in zip(["", "mag_"], ["Camera", "Experiment"]):
    for _k, _u in LENGTH_LABELS.items():
        BLAZE_LABELS[_prefix + _k] = (f"{_name} $x$ [{_u}]", f"{_name} $y$ [{_u}]")

#: Every unit :meth:`convert_vector` takes.
BLAZE_UNITS = ["rad", "mrad", "deg", "norm", "kxy", "knm", "freq", "lpmm",
               "zernike"] + CAMERA_UNITS


def format_vectors(vectors, expected_dimension=2, handle_dimension="pass"):
    """
    Clean an array of M-dimensional vectors into shape ``(M, N)``: tuples,
    row vectors and singletons handled. ``handle_dimension`` is the policy
    for more than ``M`` rows: ``"error"``, ``"crop"`` or ``"pass"``.
    """
    expected_dimension = int(expected_dimension)
    if handle_dimension not in ("error", "crop", "pass"):
        raise ValueError(f"handle_dimension '{handle_dimension}' not recognized.")

    vectors = np.squeeze(np.asarray(vectors))
    if vectors.ndim == 1:
        vectors = vectors[:, np.newaxis]
    elif vectors.ndim == 2 and vectors.shape[0] == 1:
        vectors = vectors.T

    if vectors.ndim != 2:
        raise ValueError(f"Wrong dimension {vectors.shape} for vectors.")

    rows = vectors.shape[0]
    if rows < expected_dimension:
        raise ValueError(f"Expected {expected_dimension}-vectors; found {rows}-vectors.")
    if rows > expected_dimension:
        if handle_dimension == "crop":
            vectors = vectors[:expected_dimension, :]
        elif handle_dimension == "error":
            raise ValueError(
                f"Expected {expected_dimension}-vectors; found {rows}-vectors."
            )
    return vectors


def format_2vectors(vectors):
    """Clean an array of 2-vectors into shape ``(2, N)`` (extra dimensions
    cropped)."""
    return format_vectors(vectors, expected_dimension=2, handle_dimension="crop")


def format_shape(shape, expected_dimension=2):
    """Validate and normalize a shape tuple of positive integers."""
    shape = tuple(np.squeeze(shape))
    if expected_dimension is not None and len(shape) != expected_dimension:
        raise ValueError(
            f"Expected shape with {expected_dimension} dimensions, got {len(shape)}"
        )
    for dim in shape:
        if not isinstance(dim, (int, np.integer)) or dim <= 0:
            raise ValueError(f"Expected positive integer dimensions, got {shape}")
    return tuple(int(d) for d in shape)


def unpad(matrix, shape):
    """Center-crop ``matrix`` to ``shape``."""
    mshape = np.shape(matrix)
    shape = format_shape(shape)
    dh = (mshape[0] - shape[0]) / 2.0
    dw = (mshape[1] - shape[1]) / 2.0
    if dh < 0 or dw < 0:
        raise ValueError(f"Shape {tuple(mshape)} too small to unpad to {shape}")
    y0, x0 = int(np.floor(dh)), int(np.floor(dw))
    return matrix[y0:int(mshape[0] - np.ceil(dh)), x0:int(mshape[1] - np.ceil(dw))]


def convert_vector(vector, from_units="norm", to_units="norm", hardware=None, shape=None):
    r"""
    Convert blaze vectors between k-space units: ``"rad"``, ``"mrad"``,
    ``"deg"`` (blaze angle), ``"norm"``/``"kxy"`` (:math:`k_x/k`),
    ``"knm"`` (computational Fourier-grid pixels centered at ``shape/2``),
    ``"freq"`` (grating pixel frequency), ``"lpmm"`` (line pairs per mm)
    ``"zernike"`` (tilt coefficients in radians), and the camera-plane
    units: ``"ij"`` (camera pixels) and lengths (``"um"``, ``"mm"``, ...,
    or ``"mag_um"``, ... in the experiment plane). The SLM units need
    ``hardware`` (an SLM, or a CameraSLM for its SLM), the camera units a
    Fourier-calibrated CameraSLM; ``shape`` defaults to the SLM's for
    ``"knm"``.

    3D vectors carry a :math:`z` row, handled as normalized focal power
    :math:`\lambda/f`, as the focus coefficient in ``"zernike"``, or as
    true depth in the camera-plane units.
    Returns ``(2, N)`` or ``(3, N)`` vectors.
    """
    if from_units not in BLAZE_UNITS:
        raise ValueError(f"Unit '{from_units}' not in {BLAZE_UNITS}")
    if to_units not in BLAZE_UNITS:
        raise ValueError(f"Unit '{to_units}' not in {BLAZE_UNITS}")

    parsed = format_vectors(vector, expected_dimension=2, handle_dimension="pass").astype(float)
    if from_units == to_units:
        return parsed

    xy = parsed[:2, :].copy()
    z = parsed[[2], :].copy() if parsed.shape[0] > 2 else None
    if hasattr(hardware, "slm") and hasattr(hardware, "cam"):
        cameraslm, slm = hardware, hardware.slm
    else:
        cameraslm, slm = None, hardware

    cam_pitch_um = None
    if from_units in CAMERA_UNITS or to_units in CAMERA_UNITS:
        if cameraslm is None or "fourier" not in getattr(cameraslm, "calibrations", {}):
            warnings.warn(
                f"A Fourier-calibrated CameraSLM is required for '{from_units}' -> '{to_units}'"
            )
            return np.full_like(parsed, np.nan)
        cam_pitch_um = cameraslm.cam.pitch_um
        metric = from_units in CAMERA_UNITS[1:] or to_units in CAMERA_UNITS[1:]
        if cam_pitch_um is None and metric:
            warnings.warn("Camera pitch_um required for metric camera units.")
            return np.full_like(parsed, np.nan)
        if cam_pitch_um is not None:
            cam_pitch_um = format_2vectors(cam_pitch_um)

    def slm_pitch_um():
        if slm is None:
            warnings.warn("An SLM is required for this unit conversion.")
            return np.nan, np.nan
        return format_2vectors(slm.pitch_um), slm.wav_um

    if "freq" in (from_units, to_units):
        pitch_um, wav_um = slm_pitch_um()
    if "lpmm" in (from_units, to_units):
        _, wav_um = slm_pitch_um()

    if "knm" in (from_units, to_units):
        pitch = format_2vectors(slm.pitch) if slm is not None else np.nan
        if shape is None:
            if slm is None:
                warnings.warn("shape or slm required for unit 'knm'")
                shape_arr = np.array((np.nan, np.nan))
            else:
                shape_arr = np.array(slm.shape, dtype=float)
        else:
            shape_arr = np.array(format_shape(shape), dtype=float)
        shape_xy = format_2vectors(np.flip(np.squeeze(shape_arr)))
        knm_conv = pitch * shape_xy

    if "zernike" in (from_units, to_units):
        zernike_scale = (
            np.nan if slm is None else 2 * np.pi / slm.get_source_zernike_scaling()
        )

    # xy: input -> normalized kxy.
    if from_units in ("norm", "kxy", "rad"):
        rad = xy
    elif from_units == "mrad":
        rad = xy / 1e3
    elif from_units == "deg":
        rad = xy * (np.pi / 180)
    elif from_units == "knm":
        rad = (xy - shape_xy / 2.0) / knm_conv
    elif from_units == "freq":
        rad = xy * wav_um / pitch_um
    elif from_units == "lpmm":
        rad = xy * wav_um / 1e3
    elif from_units == "zernike":
        rad = xy / zernike_scale
    elif from_units == "ij":
        rad = cameraslm.ijcam_to_kxyslm(xy)
    else:  # metric camera units
        unit = from_units.split("_")[-1]
        if from_units.startswith("mag_"):
            xy = xy * cameraslm.mag
        rad = cameraslm.ijcam_to_kxyslm(xy * LENGTH_FACTORS[unit] / cam_pitch_um)

    # xy: normalized kxy -> output.
    if to_units in ("norm", "kxy", "rad"):
        out_xy = rad
    elif to_units == "mrad":
        out_xy = rad * 1e3
    elif to_units == "deg":
        out_xy = rad * (180 / np.pi)
    elif to_units == "knm":
        out_xy = rad * knm_conv + shape_xy / 2.0
    elif to_units == "freq":
        out_xy = rad * pitch_um / wav_um
    elif to_units == "lpmm":
        out_xy = rad * 1e3 / wav_um
    elif to_units == "zernike":
        out_xy = rad * zernike_scale
    elif to_units == "ij":
        out_xy = cameraslm.kxyslm_to_ijcam(rad)
    else:  # metric camera units
        unit = to_units.split("_")[-1]
        out_xy = cameraslm.kxyslm_to_ijcam(rad) * cam_pitch_um / LENGTH_FACTORS[unit]
        if to_units.startswith("mag_"):
            out_xy = out_xy / cameraslm.mag

    if z is None:
        return out_xy

    # z: input -> normalized focal power.
    if from_units in CAMERA_UNITS:
        if from_units != "ij":
            unit = from_units.split("_")[-1]
            z = z * (LENGTH_FACTORS[unit] / np.mean(cam_pitch_um))
            if from_units.startswith("mag_"):
                z = z / cameraslm.mag
        focal_power = cameraslm._ijcam_to_kxyslm_depth(z)
    elif from_units == "zernike":
        focal_power = z * ((8 * np.pi) / (zernike_scale * zernike_scale))
    else:
        focal_power = z

    # z: normalized focal power -> output.
    if to_units in CAMERA_UNITS:
        out_z = cameraslm._kxyslm_to_ijcam_depth(focal_power)
        if to_units != "ij":
            unit = to_units.split("_")[-1]
            out_z = out_z * (np.mean(cam_pitch_um) / LENGTH_FACTORS[unit])
            if to_units.startswith("mag_"):
                out_z = out_z * cameraslm.mag
    elif to_units == "zernike":
        out_z = focal_power * ((zernike_scale * zernike_scale) / (8 * np.pi))
    else:
        out_z = focal_power
    return np.vstack((out_xy, out_z))


def convert_radius(radius, from_units="norm", to_units="norm", hardware=None, shape=None):
    """A scalar radius between unit systems: the mean of the conversions
    along x and along y (they differ under an anisotropic transform)."""
    origin = convert_vector((0, 0), from_units, to_units, hardware, shape)
    vx = convert_vector((radius, 0), from_units, to_units, hardware, shape)
    vy = convert_vector((0, radius), from_units, to_units, hardware, shape)
    return np.mean([np.linalg.norm(vx - origin), np.linalg.norm(vy - origin)])


def fit_3pt(y0, y1, y2, N=None, x0=(0, 0), x1=(1, 0), x2=(0, 1), orientation_check=False):
    r"""
    The affine :math:`\vec{y} = M\vec{x} + \vec{b}` through three point
    pairs: ``y0``, ``y1``, ``y2`` observed at the indices ``x0``, ``x1``,
    ``x2`` (with ``x1`` or ``x2`` None, ``y1`` or ``y2`` are basis vectors,
    differences from ``y0``). ``N`` None or not positive returns ``{"M",
    "b"}``; a count or a pair evaluates the affine on that index grid, an
    array on those indices, as ``(2, n)`` vectors. ``orientation_check``
    drops the grid's last two points (the Fourier calibration's parity
    check).
    """
    y0 = format_2vectors(y0)
    y1 = format_2vectors(y1)
    y2 = format_2vectors(y2)

    x0 = format_2vectors((0, 0) if x0 is None else x0)
    if x1 is None:
        x1 = x0 + format_2vectors((1, 0))
    else:
        x1 = format_2vectors(x1)
        y1 = y1 - y0
    if x2 is None:
        x2 = x0 + format_2vectors((0, 1))
    else:
        x2 = format_2vectors(x2)
        y2 = y2 - y0

    dx1 = x1 - x0
    dx2 = x2 - x0
    if np.abs(np.sum(dx1 * dx2)) == np.sqrt(np.sum(dx1 * dx1) * np.sum(dx2 * dx2)):
        raise ValueError("Indices must not be colinear.")

    J = np.linalg.inv(np.array([[dx1[0, 0], dx2[0, 0]], [dx1[1, 0], dx2[1, 0]]]))
    M = np.array([[y1[0, 0], y2[0, 0]], [y1[1, 0], y2[1, 0]]]) @ J
    b = y0 - M @ x0

    indices = None
    affine_return = False
    if N is None:
        affine_return = True
    elif isinstance(N, INTEGER_TYPES):
        if N <= 0:
            affine_return = True
        else:
            N = (N, N)
    elif isinstance(N, np.ndarray) and N.size > 2:
        indices = format_2vectors(N)
    elif (
        not np.isscalar(N)
        and len(N) == 2
        and isinstance(N[0], INTEGER_TYPES)
        and isinstance(N[1], INTEGER_TYPES)
    ):
        if N[0] <= 0 or N[1] <= 0:
            affine_return = True
    else:
        raise ValueError(f"N={N} not recognized.")

    if affine_return:
        return {"M": M, "b": b}

    if indices is None:
        x_grid, y_grid = np.meshgrid(np.arange(N[0]), np.arange(N[1]))
        indices = np.vstack((x_grid.ravel(), y_grid.ravel()))
    if orientation_check:
        indices = indices[:, :-2]

    return np.asarray(M @ indices + b)


def smallest_distance(vectors, metric="chebyshev"):
    r"""
    Smallest pairwise distance among ``vectors`` under ``metric``
    (:math:`\mathcal{O}(N\log N)` divide and conquer for scipy string
    metrics, brute force for callables); ``inf`` for fewer than 2 points.
    """
    vectors = format_2vectors(vectors)
    N = vectors.shape[1]
    if N <= 1:
        return np.inf

    if callable(metric):
        best = np.inf
        for a in range(N - 1):
            for b in range(a + 1, N):
                best = min(best, metric(vectors[:, a], vectors[:, b]))
        return best

    points = vectors.T.astype(float)
    min_div = 200

    def recurse(v):
        n = v.shape[0]
        if n <= min_div:
            return distance.pdist(v, metric=metric).min()
        mid = n // 2
        d = min(recurse(v[:mid]), recurse(v[mid:]))
        x0 = (v[mid - 1, 0] + v[mid, 0]) / 2
        strip = v[np.abs(v[:, 0] - x0) < d]
        if strip.shape[0] > 1:
            d = min(d, distance.pdist(strip, metric=metric).min())
        return d

    if N < 2 * min_div:
        return distance.pdist(points, metric=metric).min()
    order = np.argsort(points[:, 0])
    return recurse(points[order])


def _process_grid(grid):
    """
    Interpret a grid argument: ``(x_grid, y_grid)`` meshgrids, or an object
    with a ``.grid`` attribute (an SLM), or one with a ``.slm``.
    """
    if hasattr(grid, "slm"):
        grid = grid.slm
    if hasattr(grid, "grid"):
        grid = grid.grid
    elif hasattr(grid, "x_grid") and hasattr(grid, "y_grid"):
        return (grid.x_grid, grid.y_grid)

    if len(grid) != 2:
        raise ValueError("Expected a 2-tuple with x and y meshgrids.")
    if np.any(np.shape(grid[0]) != np.shape(grid[1])):
        raise ValueError("x and y meshgrids must share a shape.")
    return grid


def transform_grid(grid, transform=None, shift=None, direction="fwd"):
    r"""
    A copy of ``grid`` under an affine transform: ``"fwd"`` applies
    :math:`M\vec{x} + \vec{b}`, ``"rev"`` applies :math:`M^{-1}(\vec{x} -
    \vec{b})`. A scalar ``transform`` is a rotation angle; ``shift=True``
    centers the grid on itself.
    """
    x_grid, y_grid = _process_grid(grid)

    if transform is None:
        transform = 0
    if not np.isscalar(transform):
        transform = np.squeeze(transform)
        if transform.shape != (2, 2):
            raise ValueError("transform must be None, scalar, or 2x2.")

    if shift is None:
        shift = (0, 0)
    if shift is True:
        shift = (-np.mean(x_grid), -np.mean(y_grid))
    shift = np.squeeze(shift)

    if np.isscalar(transform) and transform == 0:
        sx, sy = (shift[0], shift[1]) if direction == "fwd" else (-shift[0], -shift[1])
        return (
            x_grid.copy() if sx == 0 else x_grid + sx,
            y_grid.copy() if sy == 0 else y_grid + sy,
        )

    if np.isscalar(transform):
        c, s = np.cos(transform), np.sin(transform)
        transform = np.array([[c, -s], [s, c]])

    if direction == "fwd":
        return (
            transform[0, 0] * x_grid + transform[0, 1] * y_grid + shift[0],
            transform[1, 0] * x_grid + transform[1, 1] * y_grid + shift[1],
        )
    inv = np.linalg.inv(transform)
    return (
        inv[0, 0] * (x_grid - shift[0]) + inv[0, 1] * (y_grid - shift[1]),
        inv[1, 0] * (x_grid - shift[0]) + inv[1, 1] * (y_grid - shift[1]),
    )


def window_slice(window, shape=None, centered=False, circular=False):
    """
    Indices into a larger array from a window: an ``(x, w, y, h)``
    rectangle (upper-left corner ``(x, y)``, or the center when
    ``centered``; ``circular`` takes the inscribed ellipse as index
    arrays), ``(y_indices, x_indices)`` index arrays, or a 2D boolean mask.
    ``shape`` clips the indices into a ``(height, width)`` array.
    """
    if shape is not None:
        shape = format_shape(shape)

    if len(window) == 4:
        x0 = int(window[0] - ((window[1] - 2) / 2 if centered else 0))
        x1 = x0 + int(window[1])
        y0 = int(window[2] - ((window[3] - 2) / 2 if centered else 0))
        y1 = y0 + int(window[3])

        if shape is not None:
            x0, x1 = np.clip([x0, x1], 0, shape[1] - 1)
            y0, y1 = np.clip([y0, y1], 0, shape[0] - 1)

        if circular:
            x_grid, y_grid = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
            xc = x0 + int((window[1] - 1) / 2)
            yc = y0 + int((window[3] - 1) / 2)
            # The ellipse inscribed in the w x h rectangle.
            rr = (window[3] ** 2) * np.square(x_grid.astype(float) - xc) + (
                window[1] ** 2
            ) * np.square(y_grid.astype(float) - yc)
            mask = rr <= (window[1] ** 2) * (window[3] ** 2) / 4.0
            return window_slice((y_grid[mask], x_grid[mask]), shape=shape)
        return (slice(y0, y1), slice(x0, x1))

    if len(window) == 2:
        y_ind = np.ravel(window[0])
        x_ind = np.ravel(window[1])
        if shape is not None:
            y_ind = np.clip(y_ind, 0, shape[0] - 1)
            x_ind = np.clip(x_ind, 0, shape[1] - 1)
        return (y_ind, x_ind)

    if np.ndim(window) == 2:
        return window

    raise ValueError("Unrecognized format for `window`.")


def imprint(matrix, window, function, grid=None, imprint_operation="replace",
            centered=False, circular=False, clip=True, transform=0, shift=(0, 0),
            **kwargs):
    """
    Write ``function`` (a constant, or ``f(grid, **kwargs)`` on the
    window's part of ``grid``) into the :meth:`window_slice` of ``matrix``
    in place, replacing (``imprint_operation="replace"``) or adding
    (``"add"``). ``clip`` clips the window to the matrix; ``transform`` and
    ``shift`` go to :meth:`transform_grid`. Returns ``matrix``.
    """
    if grid is not None:
        x_grid, y_grid = _process_grid(grid)

    slice_ = window_slice(
        window, shape=(matrix.shape if clip else None), centered=centered, circular=circular
    )

    if isinstance(function, REAL_TYPES):
        value = function
    elif grid is None:
        raise ValueError("grid is required when function is not a constant.")
    else:
        value = function(
            transform_grid((x_grid[slice_], y_grid[slice_]), transform, shift), **kwargs
        )

    if imprint_operation == "replace":
        matrix[slice_] = value
    elif imprint_operation == "add":
        matrix[slice_] += value
    else:
        raise ValueError(f"Unrecognized imprint operation '{imprint_operation}'.")
    return matrix


def convert_blaze_vector(*args, **kwargs):
    """Backwards-compatible alias of :meth:`convert_vector`."""
    warnings.warn("convert_blaze_vector is deprecated; use convert_vector.")
    if "slm" in kwargs:
        kwargs["hardware"] = kwargs.pop("slm")
    return convert_vector(*args, **kwargs)



def convert_blaze_radius(*args, **kwargs):
    """Backwards-compatible alias of :meth:`convert_radius`."""
    warnings.warn("convert_blaze_radius is deprecated; use convert_radius.")
    if "slm" in kwargs:
        kwargs["hardware"] = kwargs.pop("slm")
    return convert_radius(*args, **kwargs)



def print_blaze_conversions(vector, from_units="norm", **kwargs):
    """Print the given vector converted into every supported unit."""
    for unit in BLAZE_UNITS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            result = convert_vector(vector, from_units=from_units, to_units=unit, **kwargs)
        print(f"{unit} : {tuple(np.ravel(result))}")



def window_extent(window, padding_frac=0, padding_pix=0):
    """
    Bounding rectangle ``(x, w, y, h)`` of the active region of a window
    (boolean mask or ``(y_ind, x_ind)`` index arrays), optionally padded.
    """
    limits = []
    for axis in (0, 1):
        if len(window) == 2 and np.ndim(window) != 2:
            lo, hi = np.amin(window[axis]), np.amax(window[axis]) + 1
        elif np.ndim(window) == 2:
            hit = np.where(np.any(window, axis=axis))[0]
            lo, hi = np.amin(hit), np.amax(hit) + 1
        else:
            raise ValueError("Unrecognized format for `window`.")

        padding = int(np.floor((hi - lo) * padding_frac) + padding_pix)
        lo, hi = lo - padding, hi + padding
        if np.ndim(window) == 2:
            lo = np.clip(lo, 0, window.shape[1 - axis])
            hi = np.clip(hi, 0, window.shape[1 - axis])
        limits.append((int(lo), int(hi)))

    (xl, xh), (yl, yh) = limits
    return (xl, xh - xl, yl, yh - yl)



def voronoi_windows(grid, vectors, radius=None, plot=False):
    r"""
    Boolean window masks for the Voronoi cells of a set of vectors
    (cells are clipped against previously-assigned windows so pixels are
    uniquely owned, and optionally bounded to a ``radius`` around each seed).

    Parameters
    ----------
    grid : (array_like, array_like) OR SLM OR (int, int)
        Normalized coordinate meshgrids, an SLM, or a plain (height, width)
        shape (in which case ``vectors`` are in pixel units).
    vectors : array_like
        Seed points, cleaned with :meth:`format_2vectors`.
    radius : float OR None
        Optional bound on each cell's extent (pixels).
    plot : bool
        Plot the Voronoi diagram.

    Returns
    -------
    list of numpy.ndarray
        Boolean masks, one per seed.
    """
    import matplotlib.path as mpath

    vectors = format_2vectors(vectors)

    if (
        isinstance(grid, (list, tuple))
        and isinstance(grid[0], INTEGER_TYPES)
        and isinstance(grid[1], INTEGER_TYPES)
    ):
        shape = tuple(grid)
    else:
        x_grid, y_grid = _process_grid(grid)
        shape = x_grid.shape
        # Interpolate normalized coordinates into pixel indices.
        vectors = np.vstack(
            (
                np.interp(vectors[0, :], x_grid[0, :], np.arange(shape[1])),
                np.interp(vectors[1, :], y_grid[:, 0], np.arange(shape[0])),
            )
        )

    hsx, hsy = shape[1] / 2, shape[0] / 2
    # Distant helper sites guarantee all central cells are bounded.
    sites = np.concatenate(
        (
            vectors.T,
            np.array(
                [[hsx, -3 * hsy], [hsx, 5 * hsy], [-3 * hsx, hsy], [5 * hsx, hsy]]
            ),
        )
    )
    vor = Voronoi(sites)

    if plot:
        import matplotlib.pyplot as plt

        voronoi_plot_2d(vor)
        sx, sy = shape[1], shape[0]
        plt.plot([0, sx, sx, 0, 0], [0, 0, sy, sy, 0], "r")
        plt.xlim(-0.05 * sx, 1.05 * sx)
        plt.ylim(1.05 * sy, -0.05 * sy)
        plt.gca().set_aspect("equal")
        plt.title("Voronoi Cells")
        plt.show()

    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    pixel_points = np.column_stack((xx.ravel() + 0.5, yy.ravel() + 0.5))

    windows = []
    already = np.zeros(shape, dtype=bool)
    count = vectors.shape[1]
    for i in range(count):
        region = vor.regions[vor.point_region[i]]
        poly = vor.vertices[region]
        mask = (
            mpath.Path(poly).contains_points(pixel_points).reshape(shape)
            if len(poly) >= 3
            else np.zeros(shape, dtype=bool)
        )
        if radius is not None and radius > 0:
            center = vor.points[i]
            rr = np.square(xx - center[0]) + np.square(yy - center[1])
            mask &= rr <= radius * radius
        mask &= ~already
        windows.append(mask)
        already |= mask

    return windows



def lloyds_algorithm(grid, vectors, iterations=10, plot=False):
    r"""
    Lloyd's algorithm: iteratively move each vector to the centroid of its
    (box-clipped) Voronoi cell to promote even spacing. Vectors are in pixel
    units of the grid shape.
    """
    result = np.array(format_2vectors(vectors), dtype=float, copy=True)

    if isinstance(grid, (tuple, list)) and all(isinstance(g, INTEGER_TYPES) for g in grid):
        shape = tuple(grid)
    else:
        x_grid, _ = _process_grid(grid)
        shape = x_grid.shape
    H, W = shape

    def centroid(poly):
        x, y = poly[:, 0], poly[:, 1]
        xs, ys = np.roll(x, -1), np.roll(y, -1)
        cross = x * ys - xs * y
        area = 0.5 * np.sum(cross)
        if np.isclose(area, 0):
            return np.mean(poly, axis=0)
        return np.array(
            [
                np.sum((x + xs) * cross) / (6 * area),
                np.sum((y + ys) * cross) / (6 * area),
            ]
        )

    def clip_box(poly):
        # Sutherland–Hodgman against the [0,W]x[0,H] box.
        def clip_edge(poly, inside, intersect):
            out = []
            prev = poly[-1]
            for curr in poly:
                if inside(curr):
                    if not inside(prev):
                        out.append(intersect(prev, curr))
                    out.append(list(curr))
                elif inside(prev):
                    out.append(intersect(prev, curr))
                prev = curr
            return out

        def cut(p1, p2, axis, value):
            t = (value - p1[axis]) / (p2[axis] - p1[axis])
            point = [0.0, 0.0]
            point[axis] = value
            point[1 - axis] = p1[1 - axis] + t * (p2[1 - axis] - p1[1 - axis])
            return point

        edges = [
            (lambda p: p[0] >= 0, lambda a, b: cut(a, b, 0, 0.0)),
            (lambda p: p[0] <= W, lambda a, b: cut(a, b, 0, float(W))),
            (lambda p: p[1] >= 0, lambda a, b: cut(a, b, 1, 0.0)),
            (lambda p: p[1] <= H, lambda a, b: cut(a, b, 1, float(H))),
        ]
        poly = [list(p) for p in poly]
        for inside, intersect in edges:
            poly = clip_edge(poly, inside, intersect)
            if not poly:
                break
        return np.array(poly)

    for _ in range(iterations):
        hsx, hsy = W / 2, H / 2
        sites = np.concatenate(
            (
                result.T,
                np.array(
                    [[hsx, -3 * hsy], [hsx, 5 * hsy], [-3 * hsx, hsy], [5 * hsx, hsy]]
                ),
            )
        )
        vor = Voronoi(sites)

        if plot:
            import matplotlib.pyplot as plt

            voronoi_plot_2d(vor)
            plt.gca().set_aspect("equal")
            plt.show()

        for i in range(result.shape[1]):
            region = vor.regions[vor.point_region[i]]
            if -1 in region or len(region) == 0:
                continue
            poly = clip_box(vor.vertices[region])
            if len(poly) < 3:
                continue
            result[:, i] = centroid(poly)

    return result



def lloyds_points(grid, n_points, iterations=10, plot=False):
    """
    Lloyd's algorithm with random non-overlapping seeds;
    see :meth:`lloyds_algorithm`.
    """
    if (
        isinstance(grid, (list, tuple))
        and isinstance(grid[0], INTEGER_TYPES)
        and isinstance(grid[1], INTEGER_TYPES)
    ):
        shape = tuple(grid)
        grids = None
    else:
        x_grid, y_grid = _process_grid(grid)
        shape = x_grid.shape
        grids = (x_grid, y_grid)

    def draw():
        return np.vstack(
            (
                np.random.randint(0, shape[1], n_points),
                np.random.randint(0, shape[0], n_points),
            )
        )

    vectors = draw()
    while smallest_distance(vectors) < 1:
        vectors = draw()

    pixel_grid = np.meshgrid(np.arange(shape[1]), np.arange(shape[0]))
    result = lloyds_algorithm(pixel_grid, vectors, iterations, plot)

    if grids is None:
        return result
    idx = np.rint(result).astype(int)
    return np.vstack(
        (grids[0][idx[1], idx[0]], grids[1][idx[1], idx[0]])
    )



def assign_vectors(vectors, assignment_options):
    """
    For each vector, index of the nearest point in ``assignment_options``
    (Euclidean metric). Shapes ``(M, N)`` and ``(M, K)`` -> ``(N,)``.
    """
    vectors = format_vectors(vectors)[:, np.newaxis, :]
    options = format_vectors(assignment_options)[:, :, np.newaxis]
    dist2 = np.sum(np.square(vectors - options), axis=0)
    return np.argmin(dist2, axis=0)



def pad(matrix, shape):
    """
    Center-pad ``matrix`` with zeros to ``shape`` (numpy ``(h, w)``).
    ``shape=None`` is a no-op.
    """
    if shape is None:
        return matrix
    shape = format_shape(shape)

    dh = (shape[0] - matrix.shape[0]) / 2.0
    dw = (shape[1] - matrix.shape[1]) / 2.0
    if dh < 0 or dw < 0:
        raise ValueError(f"Shape {tuple(matrix.shape)} too large to pad to {shape}")

    return np.pad(
        matrix,
        [
            (int(np.floor(dh)), int(np.ceil(dh))),
            (int(np.floor(dw)), int(np.ceil(dw))),
        ],
        mode="constant",
    )

