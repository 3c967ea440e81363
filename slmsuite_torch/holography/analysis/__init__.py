r"""
Image analysis on the host (the port's copy of what the simulated rig
needs from :mod:`slmsuite_tpu.holography.analysis`; numpy and scipy):
region extraction (:meth:`take`), background removal, first and second
moments (the second for the quadratic initial phase of the holograms),
image fits (:meth:`image_fit`), the phase-image operations of the
superpixel wavefront calibration (vortices, blaze removal, wrap
reduction), affine fitting, and the spot-lattice detection behind the
Fourier calibration (:meth:`blob_array_detect`), and the rest of the
module: image statistics (:meth:`image_std`, the ellipticity,
:meth:`image_relative_strehl`), :meth:`image_zernike_fit`, and the plots
(:meth:`take_plot`, the ``plot`` of :meth:`image_fit` and
:meth:`image_remove_blaze`, matplotlib imported inside each).

``cv2`` is imported inside :meth:`blob_detect` and the helpers of
:meth:`blob_array_detect` only: everything else here, and every path that
runs on a machine without OpenCV, needs numpy and scipy alone (the
calibrations' OpenCV image operations are in torch, in :mod:`._cv`).
:meth:`take` also gathers on a device, with ``xp=torch``.
"""

import warnings
from functools import reduce

import numpy as np
from scipy.ndimage import binary_erosion
from scipy.optimize import curve_fit, minimize

from slmsuite_torch.holography.analysis.fitfunctions import gaussian2d
from slmsuite_torch.holography.toolbox import _process_grid, format_2vectors
from slmsuite_torch.misc.host import as_numpy

__all__ = [
    "take",
    "take_tile",
    "take_plot",
    "image_remove_field",
    "image_relative_strehl",
    "image_moment",
    "image_normalization",
    "image_normalize",
    "image_positions",
    "image_centroids",
    "image_variances",
    "image_areas",
    "image_std",
    "image_ellipticity",
    "image_ellipticity_angle",
    "image_fit",
    "image_zernike_fit",
    "image_vortices",
    "image_vortices_coordinates",
    "image_remove_vortices",
    "image_remove_blaze",
    "image_blaze_remove",
    "image_reduce_wraps",
    "fit_affine",
    "blob_detect",
    "blob_array_detect",
    "get_orientation_transformation",
]


def _center(width, integer=False):
    """Center of an index range of length ``width``."""
    if integer:
        return int((width - 1) / 2 if width % 2 else width / 2)
    return float(width - 1) / 2


def _coordinates(width, centered=False):
    """Float indices ``0..width-1``, optionally centered."""
    xs = np.arange(width).astype(np.float64)
    if centered:
        xs -= _center(width)
    return xs


def _generate_grid(w_x, w_y, centered=False, integer=False):
    """Meshgrid of pixel indices of shape ``(w_y, w_x)``."""
    xs = np.arange(w_x, dtype=float)
    ys = np.arange(w_y, dtype=float)
    if centered:
        xs -= _center(w_x, integer=integer)
        ys -= _center(w_y, integer=integer)
    return np.meshgrid(xs, ys)


def _ensure_stack(images):
    """View ``images`` as ``(image_count, h, w)``; note if a single image was passed."""
    images = np.asarray(images)
    single = images.ndim == 2
    if single:
        images = images.reshape((1,) + images.shape)
    return images, single


def take(
    images,
    vectors,
    size,
    centered=True,
    integrate=False,
    clip=False,
    return_mask=False,
    plot=False,
    xp=None,
):
    """
    Crop same-sized integration regions around ``vectors``, vectorized over
    regions (and optionally over a stack of images).

    Parameters
    ----------
    images : array_like
        2D image or ``(image_count, h, w)`` stack.
    vectors : array_like
        ``(2, N)`` pixel anchors (region centers if ``centered``).
    size : int OR (int, int)
        Region size ``(w, h)``; scalar means square.
    centered : bool
        Center regions on the vectors (else the vectors are upper-left corners).
    integrate : bool
        Sum each region (as float) to return shape ``(N,)``.
    clip : bool
        Allow out-of-range regions, filling with ``nan`` (or 0 for int dtypes).
    return_mask : bool
        Return a boolean mask of taken pixels instead of data.
    plot : bool
        Visualize with :meth:`take_plot` (the mask, with ``return_mask``).
    xp : module OR None
        Array module of the data path: numpy (the default) or ``torch``,
        which gathers on the images' device and returns tensors there
        (``integrate`` sums in float64).

    Returns
    -------
    numpy.ndarray OR torch.Tensor
        ``(N, h, w)`` regions or ``(N,)`` sums.
    """
    if xp is None:
        xp = np
    if xp is not np and getattr(xp, "__name__", None) != "torch":
        raise ValueError(f"take(xp=...) takes numpy or torch, not {getattr(xp, '__name__', xp)}.")
    if np.isscalar(size):
        size = (int(size), int(size))
    else:
        s = np.asarray(size).ravel()
        size = (int(s[0]), int(s[1]))

    vectors = np.floor(format_2vectors(vectors)).astype(int)

    edge_x = np.floor(_coordinates(size[0], centered)).astype(int)
    edge_y = np.floor(_coordinates(size[1], centered)).astype(int)
    region_x, region_y = np.meshgrid(edge_x, edge_y)

    # (N, w*h) index arrays.
    integration_x = region_x.ravel()[np.newaxis, :] + vectors[0][:, np.newaxis]
    integration_y = region_y.ravel()[np.newaxis, :] + vectors[1][:, np.newaxis]

    images = np.asarray(images) if xp is np else xp.as_tensor(images)
    shape = images.shape

    if clip:
        oob = (
            (integration_x < 0)
            | (integration_x >= shape[-1])
            | (integration_y < 0)
            | (integration_y >= shape[-2])
        )
        if np.any(oob):
            integration_x = np.clip(integration_x, 0, shape[-1] - 1)
            integration_y = np.clip(integration_y, 0, shape[-2] - 1)
        else:
            clip = False

    if return_mask:
        canvas = np.zeros(shape[-2:], dtype=bool)
        canvas[integration_y, integration_x] = True
        if plot:
            import matplotlib.pyplot as plt

            plt.imshow(canvas)
            plt.show()
        return canvas

    if xp is not np:
        integration_x = xp.as_tensor(integration_x, device=images.device)
        integration_y = xp.as_tensor(integration_y, device=images.device)
    if len(shape) == 2:
        result = images[None, integration_y, integration_x]
    elif len(shape) == 3:
        result = images[:, integration_y, integration_x]
    else:
        raise RuntimeError(f"Unexpected shape for images: {shape}")

    if clip:
        if xp is np:
            if np.issubdtype(result.dtype, np.floating):
                result[:, oob] = np.nan
            else:
                result[:, oob] = 0
        else:
            fill = float("nan") if result.is_floating_point() else 0
            result = xp.where(xp.as_tensor(oob, device=result.device)[None], fill, result)

    if plot:
        take_plot(as_numpy(result).reshape((-1, vectors.shape[1], size[1], size[0]))[0])

    if integrate:
        if xp is np:
            return np.squeeze(np.sum(result.astype(float), axis=-1))
        return xp.squeeze(xp.sum(result.to(xp.float64), dim=-1))
    return result.reshape((vectors.shape[1], size[1], size[0]))


def image_remove_field(images, deviations=1, out=None):
    r"""
    Background-subtract each image in a stack: zero pixels below
    ``mean + deviations * std`` (or below the median if ``deviations`` is
    ``None``), so that moment calculations measure the feature, not the field.
    """
    images = np.asarray(images, dtype=float)

    if out is None:
        out = np.copy(images)
    elif out is not images:
        np.copyto(out, images)

    stack, single = _ensure_stack(images)

    if deviations is None:
        threshold = np.nanmedian(stack, axis=(1, 2))
    else:
        threshold = np.nanmean(stack, axis=(1, 2)) + deviations * np.nanstd(
            stack, axis=(1, 2)
        )
    if not single:
        threshold = threshold.reshape((stack.shape[0], 1, 1))

    out_max = np.amax(out, axis=(-2, -1), keepdims=True)
    out -= threshold.astype(out.dtype)
    out[out < 0] = 0
    out[out > out_max - threshold] = 0
    return out


def image_moment(images, moment=(1, 0), centers=(0, 0), grid=None, normalize=True, nansum=False):
    r"""
    Discrete image moment :math:`M_{m_xm_y}` (normalized by :math:`M_{00}`
    when ``normalize``), vectorized over a stack of images.

    ``grid`` sets the units: ``None`` for image-centered pixels, a scalar or
    pair for pixel pitch, 1D lists of length w/h, or full 2D meshgrids.
    ``centers`` shifts the trial-function origin (``(2, N)`` for per-image).
    """
    images, _ = _ensure_stack(images)
    img_count, w_y, w_x = images.shape
    moment = (int(moment[0]), int(moment[1]))
    np_sum = np.nansum if nansum else np.sum

    if normalize:
        normalization = np_sum(images, axis=(1, 2)).reshape((img_count, 1, 1))
        reciprocal = np.reciprocal(
            normalization, where=normalization != 0, out=np.zeros((img_count, 1, 1))
        )
    else:
        reciprocal = 1

    if moment == (0, 0):
        if normalize:
            return np.ones((img_count,))
        return np_sum(images, axis=(1, 2))

    if len(np.shape(centers)) == 2:
        c_x = np.reshape(centers[0], (img_count, 1, 1))
        c_y = np.reshape(centers[1], (img_count, 1, 1))
    else:
        c_x, c_y = centers[0], centers[1]

    if grid is None or np.isscalar(grid) or (np.isscalar(grid[0]) and np.isscalar(grid[1])):
        # Pixel grid (optionally scaled by a pitch).
        x_grid = y_grid = 0
        if moment[0] != 0:
            x_grid = np.reshape(np.arange(w_x) - _center(w_x), (1, 1, w_x)) - c_x
            if moment[0] != 1:
                x_grid = np.power(x_grid, moment[0])
        if moment[1] != 0:
            y_grid = np.reshape(np.arange(w_y) - _center(w_y), (1, w_y, 1)) - c_y
            if moment[1] != 1:
                y_grid = np.power(y_grid, moment[1])
        if grid is not None:
            if np.isscalar(grid):
                x_grid = x_grid * grid
                y_grid = y_grid * grid
            else:
                x_grid = x_grid * grid[0]
                y_grid = y_grid * grid[1]
    else:
        x_grid, y_grid = grid
        if np.ndim(x_grid) == 2:
            x_grid = np.reshape(x_grid, (1, w_y, w_x)) - c_x
            y_grid = np.reshape(y_grid, (1, w_y, w_x)) - c_y
        elif np.ndim(x_grid) == 1:
            x_grid = np.reshape(x_grid, (1, 1, w_x)) - c_x
            y_grid = np.reshape(y_grid, (1, w_y, 1)) - c_y
        elif np.ndim(x_grid) == 3:
            pass
        else:
            raise ValueError(f"Could not parse grid of shape {np.shape(x_grid)}")
        if moment[0] > 1:
            x_grid = np.power(x_grid, moment[0])
        if moment[1] > 1:
            y_grid = np.power(y_grid, moment[1])

    if moment[1] == 0:
        return np_sum(images * x_grid * reciprocal, axis=(1, 2))
    if moment[0] == 0:
        return np_sum(images * y_grid * reciprocal, axis=(1, 2))
    return np_sum(images * x_grid * y_grid * reciprocal, axis=(1, 2))


def image_normalization(images, nansum=False):
    """Zeroth-order moments (mass) per image; shape ``(N,)``."""
    return image_moment(images, (0, 0), normalize=False, nansum=nansum)


def image_normalize(images, nansum=False, remove_field=False):
    """Normalize each image to unit mass (zero images stay zero)."""
    if remove_field:
        images = image_remove_field(images)
    else:
        images = np.asarray(images, dtype=float)

    single = images.ndim == 2
    normalization = image_normalization(images, nansum=nansum)

    if single:
        norm = float(normalization.item())
        return np.zeros_like(images) if norm == 0 else images / norm

    reciprocal = np.reciprocal(
        normalization, where=normalization != 0, out=np.zeros(len(normalization))
    )
    return images * reciprocal.reshape((len(normalization), 1, 1))


def image_positions(images, grid=None, normalize=True, nansum=False):
    r"""First moments (centroid relative to image center); shape ``(2, N)``."""
    if normalize:
        images = image_normalize(images, nansum=nansum)
    return np.vstack(
        (
            image_moment(images, (1, 0), grid=grid, normalize=False, nansum=nansum),
            image_moment(images, (0, 1), grid=grid, normalize=False, nansum=nansum),
        )
    )


def image_centroids(images, grid=None, normalize=True, nansum=False):
    """Alias for :meth:`image_positions`."""
    return image_positions(images, grid, normalize, nansum)


def image_variances(images, centers=None, grid=None, normalize=True, nansum=False,
                    exclude_shear=False):
    r"""
    Second central moments :math:`(M_{20}, M_{02}, M_{11})` per image;
    shape ``(3, N)`` (or ``(2, N)`` with ``exclude_shear``).
    """
    if normalize:
        images = image_normalize(images, nansum=nansum)
    if centers is None:
        centers = image_positions(images, normalize=False, nansum=nansum)

    m20 = image_moment(images, (2, 0), centers=centers, grid=grid, normalize=False, nansum=nansum)
    m02 = image_moment(images, (0, 2), centers=centers, grid=grid, normalize=False, nansum=nansum)
    if exclude_shear:
        return np.vstack((m20, m02))
    m11 = image_moment(images, (1, 1), centers=centers, grid=grid, normalize=False, nansum=nansum)
    return np.vstack((m20, m02, m11))


def image_areas(variances):
    """The determinant of each image's moment matrix, ``M20 M02 - M11^2``
    (a spot-area proxy), from :meth:`image_variances`' ``(3, N)``."""
    m20, m02, m11 = variances[0, :], variances[1, :], variances[2, :]
    return m20 * m02 - m11 * m11


def image_fit(images, grid=None, function=gaussian2d, guess=None, plot=False):
    """
    Fit each image in a stack to a 2D ``function`` with
    :meth:`scipy.optimize.curve_fit`, auto-guessing from moments for
    :meth:`~slmsuite_torch.holography.analysis.fitfunctions.gaussian2d`.

    Returns
    -------
    numpy.ndarray of shape ``(image_count, 1 + 2 * param_count)``
        Rows are ``[rsquared, *params, *param_errors]``; failed fits have
        ``nan`` rsquared.
    """
    images, _ = _ensure_stack(images)
    image_count, w_y, w_x = images.shape
    img_shape = (w_y, w_x)

    if grid is None:
        grid = _generate_grid(w_x, w_y, centered=True)
    grid_ravel = (np.ravel(grid[0]), np.ravel(grid[1]))

    param_count = function.__code__.co_argcount - 1
    result_count = 2 * param_count + 1
    result = np.full((image_count, result_count), np.nan)

    if guess is None or guess is True:
        if function is gaussian2d:
            normalized = image_normalize(images, remove_field=True)
            centers = image_positions(normalized, grid=grid, normalize=False)
            variances = image_variances(normalized, centers=centers, grid=grid, normalize=False)
            maxs = np.amax(images, axis=(1, 2))
            mins = np.amin(images, axis=(1, 2))
            guess = np.vstack(
                (centers, maxs - mins, mins, np.sqrt(variances[:2, :]), variances[2, :])
            ).T
        else:
            message = f"Default guess for function {function} not implemented."
            if guess is True:
                raise NotImplementedError(message)
            warnings.warn(message)
            guess = None

    for idx in range(image_count):
        img = images[idx].ravel()
        grid_ = grid_ravel

        undefined = np.isnan(img)
        if np.any(undefined):
            defined = ~undefined
            img = img[defined]
            grid_ = (grid_ravel[0][defined], grid_ravel[1][defined])

        p0 = None if guess is None else guess[idx]

        popt, perr, ok = None, np.nan, True
        try:
            popt, pcov = curve_fit(function, grid_, img, ftol=1e-5, p0=p0)
            perr = np.sqrt(np.diag(pcov))
        except RuntimeError:
            ok = False
        else:
            if np.any(~np.isfinite(popt)):
                ok = False

        if ok:
            ss_res = np.sum(np.square(img - function(grid_, *popt)))
            ss_tot = np.sum(np.square(img - np.mean(img)))
            r2 = 1 - (ss_res / ss_tot)
        else:
            popt = p0 if p0 is not None else np.full(param_count, np.nan)
            r2 = np.nan
            perr = np.nan

        result[idx, 0] = r2
        result[idx, 1 : param_count + 1] = popt
        result[idx, param_count + 1 :] = perr

        if plot:
            import matplotlib.pyplot as plt

            fig, axs = plt.subplots(1, 2, figsize=(12, 5))
            axs[0].imshow(images[idx])
            axs[0].set_title("Data")
            axs[1].imshow(np.reshape(function(grid_ravel, *popt), img_shape))
            axs[1].set_title("Fit")
            plt.show()

    return result


def image_vortices(phase_image):
    """
    The integer winding number at each pixel of a wrapped phase image,
    from the discrete curl of the wrapped derivatives.
    """
    dd = [
        np.mod(np.diff(phase_image, axis=a, prepend=np.nan) - np.pi, 2 * np.pi)
        for a in range(2)
    ]
    winding = -(
        dd[0] - dd[1] - np.roll(dd[0], shift=1, axis=1) + np.roll(dd[1], shift=1, axis=0)
    ) / (2 * np.pi)
    winding[np.isnan(winding)] = 0
    return np.rint(winding)


def image_vortices_coordinates(phase_image, mask=None):
    """The coordinates ``(ys, xs)`` and the winding weights of the vortices
    of a phase image (inside ``mask``)."""
    winding = image_vortices(phase_image)
    if mask is not None:
        winding[~np.asarray(mask, dtype=bool)] = 0
    coordinates = np.where(winding)
    weights = winding[coordinates[0], coordinates[1]]
    return coordinates, weights


def image_remove_vortices(phase_image, mask=None, return_vortices_negative=False):
    """
    Subtract a ``w * arctan2`` screw at each vortex found (inside the
    eroded ``mask``), removing the phase singularities in place.
    """
    mask_eroded = binary_erosion(mask, np.ones((5, 5))) if mask is not None else None
    coordinates, weights = image_vortices_coordinates(phase_image, mask=mask_eroded)
    grid = _generate_grid(phase_image.shape[1], phase_image.shape[0])

    canvas = np.zeros_like(phase_image) if return_vortices_negative else phase_image
    for x, y, w in zip(coordinates[1], coordinates[0], weights):
        canvas -= w * np.arctan2(grid[0] - x, grid[1] - y)
    return canvas


def image_remove_blaze(phase_image, mask=None, plot=False):
    """
    Remove the mean phase gradient (global blaze) from a wrapped phase image,
    optionally weighted by ``mask`` (e.g. the amplitude image).
    """
    phase = np.mod(phase_image, 2 * np.pi)

    dx = np.mod(np.gradient(phase, axis=1) + np.pi / 2, np.pi) - np.pi / 2
    dy = np.mod(np.gradient(phase, axis=0) + np.pi / 2, np.pi) - np.pi / 2

    if mask is None:
        dx_mean, dy_mean = np.nanmean(dx), np.nanmean(dy)
    else:
        dx_mean = np.nansum(dx * mask) / np.nansum(mask)
        dy_mean = np.nansum(dy * mask) / np.nansum(mask)

    X, Y = np.meshgrid(np.arange(phase.shape[1]), np.arange(phase.shape[0]))
    result = np.mod(phase - dx_mean * X - dy_mean * Y, 2 * np.pi)

    if plot:
        import matplotlib.pyplot as plt

        fig, axs = plt.subplots(1, 4, figsize=(20, 5))
        for ax, (img, title) in zip(
            axs, [(phase, "phase"), (dx, "dx"), (dy, "dy"), (result, "removed")]
        ):
            ax.imshow(img)
            ax.set_title(title)
        plt.show()

    return result


def image_blaze_remove(**kwargs):
    """The deprecated alias of :meth:`image_remove_blaze` (it warns)."""
    warnings.warn(
        "image_blaze_remove is deprecated; use image_remove_blaze instead.",
        DeprecationWarning,
    )
    return image_remove_blaze(**kwargs)


def image_reduce_wraps(phase_image, mask=None, steps=10, plot=False):
    """
    The global phase offset of ``steps`` that minimizes the (``mask``
    weighted) length of the wrap lines, re-wrapped into ``[0, 2pi)``.
    ``plot`` is accepted and draws nothing, as in the JAX package.
    """
    fom_min = np.inf
    result = None

    for step in range(steps):
        shift = step * 2 * np.pi / steps
        shifted = np.mod(phase_image + shift, 2 * np.pi)

        wrapping = (
            np.abs(np.gradient(shifted, axis=1)) + np.abs(np.gradient(shifted, axis=0))
        ) > np.pi
        if mask is not None:
            wrapping = wrapping * mask
        fom = np.sum(wrapping)

        if fom < fom_min:
            fom_min = fom
            result = shifted
            lo, mean, hi = np.nanmin(result), np.nanmean(result), np.nanmax(result)
            if mean - lo < hi - mean:
                result = result - lo
            else:
                result = result - (hi - 2 * np.pi)
            result = np.mod(result, 2 * np.pi)

    return result


def fit_affine(x, y, guess_affine=None, plot=False):
    r"""
    Least-squares affine transform :math:`\vec{y} = M\vec{x} + \vec{b}` from
    ordered point correspondences ``(2, N)`` (nan-tolerant). Returns
    ``{"M", "b"}``.
    """
    x = format_2vectors(x)
    y = format_2vectors(y)
    assert x.shape == y.shape

    if guess_affine is None:
        xc = np.nanmean(x, axis=1)[:, np.newaxis]
        yc = np.nanmean(y, axis=1)[:, np.newaxis]
        if np.any(np.isnan(xc)) or np.any(np.isnan(yc)):
            raise ValueError("Vectors cannot contain a row of all-nan values")

        x_ = x - xc
        y_ = y - yc

        # Ignore points too close to the centroid (disproportionate influence).
        threshold = np.median(np.sqrt(np.sum(np.square(x_), axis=0))) / 2
        nan_row = np.full_like(y_[0, :], np.nan)

        def ratio(num, den):
            return np.nanmean(np.divide(num, den, where=den > threshold, out=nan_row.copy()))

        M_guess = np.array(
            [
                [ratio(y_[0, :], x_[0, :]), ratio(y_[0, :], x_[1, :])],
                [ratio(y_[1, :], x_[0, :]), ratio(y_[1, :], x_[1, :])],
            ]
        )
        M_guess[np.isnan(M_guess)] = 0
        b_guess = yc - M_guess @ xc
    else:
        if not (isinstance(guess_affine, dict) and "M" in guess_affine and "b" in guess_affine):
            raise ValueError("guess_affine must be a dictionary with 'M' and 'b' fields.")
        M_guess = guess_affine["M"]
        b_guess = guess_affine["b"]

    def err(p):
        M = np.array([[p[0], p[1]], [p[2], p[3]]])
        b = format_2vectors([p[4], p[5]])
        return np.nansum(np.square(M @ x + b - y))

    guess = (
        M_guess[0, 0], M_guess[0, 1], M_guess[1, 0], M_guess[1, 1],
        b_guess[0, 0], b_guess[1, 0],
    )

    try:
        m = minimize(err, x0=guess)
        p = [float(v) for v in m.x]
        M = np.array([[p[0], p[1]], [p[2], p[3]]])
        b = format_2vectors([p[4], p[5]])
    except Exception:
        M, b = M_guess, b_guess

    if plot:
        import matplotlib.pyplot as plt

        plt.scatter(y[0, :], y[1, :], s=20, fc="b", ec="b")
        result = M @ x + b
        plt.scatter(result[0, :], result[1, :], s=60, fc="none", ec="g")
        plt.gca().set_aspect("equal")
        plt.show()

    return {"M": M, "b": b}


def _make_8bit(img):
    """Scale any image to the full uint8 range (for cv2)."""
    img = img.astype(float)
    img -= np.amin(img)
    peak = np.amax(img)
    if peak > 0:
        img = img / peak * 255
    return img.astype(np.uint8)


def blob_detect(img, filter=None, plot=False, **kwargs):
    """
    Detect bright blobs with :class:`cv2.SimpleBlobDetector` (defaults tuned
    for bright spots on a dark background; customize via ``**kwargs``).

    ``filter``: ``"dist_to_center"`` keeps the blob closest to the image
    center; ``"max_amp"`` keeps the brightest (integrated) one.

    Returns ``(blobs, detector)``.
    """
    import cv2

    img_8bit = _make_8bit(np.copy(img))
    params = cv2.SimpleBlobDetector_Params()

    params.blobColor = 255
    params.minThreshold = 10
    params.maxThreshold = 255
    params.thresholdStep = 10
    params.filterByArea = False
    params.filterByCircularity = False
    params.filterByConvexity = False
    params.filterByInertia = False

    for key, val in kwargs.items():
        setattr(params, key, val)

    detector = cv2.SimpleBlobDetector_create(params)
    blobs = detector.detect(img_8bit)

    if len(blobs) == 0:
        return [], detector

    if filter == "dist_to_center":
        dist = [
            np.linalg.norm(np.array(blob.pt) - np.array(img.shape[::-1]) / 2)
            for blob in blobs
        ]
        blobs = [blobs[int(np.argmin(dist))]]
    elif filter == "max_amp":
        bin_size = int(np.mean([blob.size for blob in blobs]))
        responses = []
        for blob in blobs:
            try:
                region = img_8bit[
                    np.ix_(
                        int(blob.pt[1]) + np.arange(-bin_size, bin_size),
                        int(blob.pt[0]) + np.arange(-bin_size, bin_size),
                    )
                ]
                responses.append(float(region.sum()))
            except Exception:
                responses.append(0.0)
        blobs = [blobs[int(np.argmax(responses))]]

    if plot:
        import matplotlib.pyplot as plt
        import matplotlib.patches

        plt.imshow(img_8bit)
        ax = plt.gca()
        for blob in blobs:
            ax.add_patch(
                matplotlib.patches.Circle(
                    (float(blob.pt[0]), float(blob.pt[1])),
                    radius=float(blob.size / 2),
                    color="red", linewidth=1, fill=None,
                )
            )
        plt.show()

    return blobs, detector


def _dft_peak_points(img, dft_threshold, dft_padding):
    """
    Find reciprocal-lattice peaks of a spot-array image: padded |FFT| with
    suppressed 0th order, blob-detected at progressively coarser blur.
    Returns (points (N, 2) in full-res DFT pixels, fft_size).
    """
    import cv2

    fft_size = int(2 ** (np.floor(np.log2(np.max(np.shape(img)))) + dft_padding))
    dft = np.abs(np.fft.fftshift(np.fft.fft2(img, s=[fft_size, fft_size])))

    fft_blur_size = int(np.clip(fft_size / 200, 1, 5)) * 2 + 1
    zo_size = 8 * fft_blur_size
    if fft_size <= zo_size * 4:
        raise ValueError(
            f"Image of shape {img.shape} is too small to use with blob_array_detect."
        )

    # Inverted-Gaussian window to suppress the 0th order.
    zo_x, zo_y = np.meshgrid(
        np.linspace(-zo_size / 2, zo_size / 2, zo_size),
        np.linspace(-zo_size / 2, zo_size / 2, zo_size),
    )
    zo_filter = gaussian2d([zo_x, zo_y], 0, 0, -1, 1, fft_blur_size / 2, fft_blur_size / 2)

    points = []
    downscaling = 1
    i = 0
    while fft_size / downscaling > zo_size * 4:
        dft_amp = cv2.GaussianBlur(dft, (fft_blur_size, fft_blur_size), fft_blur_size / 4)

        zo_i = int(fft_size / 2 / downscaling - zo_size / 2)
        dft_amp[zo_i : zo_i + zo_size, zo_i : zo_i + zo_size] *= zo_filter

        blobs, _ = blob_detect(dft_amp, minThreshold=dft_threshold, thresholdStep=10)
        points += [np.array(blob.pt) * downscaling for blob in blobs]

        if len(points) > 4 * (i + 1):
            break

        if fft_size / (2 * downscaling) > zo_size * 4:
            # 2x2 binning, then retry with effectively stronger blur.
            dft = dft[0::2, 0::2] + dft[0::2, 1::2] + dft[1::2, 0::2] + dft[1::2, 1::2]
            downscaling *= 2
            i += 1
        else:
            break

    if len(points) < 4:
        raise RuntimeError(
            "Array fitting looks for prominent periodicity, but failed to find such "
            "in the given image. Try: verifying the camera image (settle time, stale "
            "frames), increasing exposure, or increasing the array pitch."
        )

    return np.array(points), fft_size


def _fit_lattice_vectors(points, fft_size, k, tol):
    """
    Cluster k-nearest-neighbor displacements of DFT peaks into reciprocal
    primitive lattice vectors; return the real-space pitch matrix M (2, 2).
    """
    # Discard noise points near the 0th order; anchor with the exact center.
    lengths = np.sqrt(
        np.square(points[:, 0] - fft_size / 2) + np.square(points[:, 1] - fft_size / 2)
    )
    points = points[lengths > 0.5 * np.mean(lengths), :]
    points = np.concatenate((points, [[fft_size / 2, fft_size / 2]]))

    k = min(k, len(points) - 1)

    # Displacements to the k nearest neighbors (and inverses, to merge branches).
    dx = points[:, 0][:, np.newaxis] - points[:, 0][np.newaxis, :]
    dy = points[:, 1][:, np.newaxis] - points[:, 1][np.newaxis, :]
    d = np.sqrt(dx * dx + dy * dy)
    order = np.argsort(d, axis=0)
    kNN = (points[order[1 : k + 1, :]] - points).reshape((-1, 2))
    kNN = np.vstack((kNN, -kNN))

    # Group displacements whose difference (or sum) is within tol.
    vdx = kNN[:, 0][:, np.newaxis]
    vdy = kNN[:, 1][:, np.newaxis]
    norms = np.linalg.norm(kNN, axis=1)
    dnorm = np.sqrt(np.square(vdx - vdx.T) + np.square(vdy - vdy.T)) / norms
    inorm = np.sqrt(np.square(vdx + vdx.T) + np.square(vdy + vdy.T)) / norms

    tags = np.zeros(kNN.shape[0])
    group = 1
    for i in range(kNN.shape[0]):
        new = ((dnorm[i, :] < tol) | (inorm[i, :] < tol)) & (tags == 0)
        tags[new] = group
        if np.any(new):
            group += 1

    def mean_group(members):
        members = members.copy()
        len0 = np.sum(np.square(members[0, :]))
        diff = np.sum(np.square(members - members[[0], :]), axis=1)
        members[diff > len0] = -members[diff > len0]
        final = np.mean(members, axis=0)
        return -final if final[0] < 0 else final

    tag, count = np.unique(tags, return_counts=True)
    top = np.argsort(-count)[: min(k, len(count))]
    centers = np.array([mean_group(kNN[tags == tag[g]]) for g in top])

    # Order by distance to center; prefer short vectors, then orthogonality.
    distance_to_center = np.linalg.norm(centers, axis=1)
    distance_to_center = distance_to_center / np.max(distance_to_center)
    by_distance = np.argsort(distance_to_center)
    centers = centers[by_distance, :]
    distance_to_center = distance_to_center[by_distance]

    normed = centers / np.linalg.norm(centers, axis=1, keepdims=True)
    cross = normed[:, 0] * normed[0, 1] - normed[:, 1] * normed[0, 0]
    cross[0] = 2  # The base vector always wins slot one.
    fom = 1e4 * np.abs(cross) - distance_to_center
    best = np.argsort(-fom)
    centers = centers[best, :]

    lv = centers[:2].T  # Reciprocal primitive vectors as columns.
    return fft_size * lv / (np.linalg.norm(lv, axis=0) ** 2)


def _array_center_kernel_match(img_8bit, M_trial, size):
    """
    Build a +1/-border array kernel under M_trial and cross-correlate with the
    image to locate the array center. Returns (max_val, b (2, 1), mask_shape,
    rotated_centers, max_loc, max_pitch).
    """
    import cv2

    x_list = np.arange(-(size[0] - 1) / 2.0, (size[0] + 1) / 2.0)
    y_list = np.arange(-(size[1] - 1) / 2.0, (size[1] + 1) / 2.0)
    xg, yg = np.meshgrid(x_list, y_list)
    centers = np.vstack((xg.ravel(), yg.ravel()))

    p = 2  # Border padding to penalize off-by-one shifts.
    xg_l, yg_l = np.meshgrid(
        np.arange(-(size[0] + p - 1) / 2.0, (size[0] + p + 1) / 2.0),
        np.arange(-(size[1] + p - 1) / 2.0, (size[1] + p + 1) / 2.0),
    )
    centers_larger = np.vstack((xg_l.ravel(), yg_l.ravel()))

    rotated_centers = M_trial @ centers
    rotated_larger = M_trial @ centers_larger

    max_pitch = int(np.amax([np.linalg.norm(M_trial[:, 0]), np.linalg.norm(M_trial[:, 1])]))
    mask_shape = (
        int(np.ptp(rotated_larger[1, :]) + max_pitch),
        int(np.ptp(rotated_larger[0, :]) + max_pitch),
    )
    mask = np.zeros(mask_shape)

    rotated_centers = rotated_centers + np.flip(mask_shape)[:, np.newaxis] / 2
    rotated_larger = rotated_larger + np.flip(mask_shape)[:, np.newaxis] / 2

    area = size[0] * size[1]
    perimeter = 2 * (size[0] + size[1]) + 4
    mask[
        np.rint(rotated_larger[1, :]).astype(int),
        np.rint(rotated_larger[0, :]).astype(int),
    ] = -area / perimeter
    mask[
        np.rint(rotated_centers[1, :]).astype(int),
        np.rint(rotated_centers[0, :]).astype(int),
    ] = 1
    mask = _make_8bit(mask)

    try:
        res = cv2.matchTemplate(img_8bit, mask, cv2.TM_CCOEFF)
        _, max_val, _, max_loc = cv2.minMaxLoc(res)
    except Exception:
        max_val, max_loc = 0, [0, 0]

    b = np.array(max_loc)[:, np.newaxis] + np.flip(mask.shape)[:, np.newaxis] / 2
    return max_val, b, mask.shape, rotated_centers, max_loc, max_pitch


def _parity_check(img_8bit, M_trial, size, rotated_centers, max_loc, mask_shape, max_pitch):
    """
    Use the two intentionally-missing corner spots to resolve the 4-fold
    rotation and flip ambiguity. Returns (M_fixed, success).
    """
    try:
        window = img_8bit[
            np.ix_(
                max_loc[1] + np.arange(mask_shape[0]),
                max_loc[0] + np.arange(mask_shape[1]),
            )
        ]

        w = max(1, int(0.2 * max_pitch))
        edge = np.arange(-w, w + 1)
        ex, ey = np.meshgrid(edge, edge)
        ix = np.rint(ex.ravel()[np.newaxis, :] + rotated_centers[0][:, np.newaxis]).astype(int)
        iy = np.rint(ey.ravel()[np.newaxis, :] + rotated_centers[1][:, np.newaxis]).astype(int)

        spotpowers = np.reshape(np.sum(window[iy, ix], 1), np.flip(size))
        spotbooleans = spotpowers <= np.sort(spotpowers.ravel())[1]
        assert np.sum(spotbooleans) == 2

        corners = spotbooleans[[-1, -1, 0, 0], [-1, 0, 0, -1]]
        assert np.sum(corners) == 1

        rotation_parity = int(np.where(corners)[0][0])
        rotated = np.rot90(spotbooleans, rotation_parity)

        theta = rotation_parity * np.pi / 2
        c, s = np.cos(theta), np.sin(theta)
        rotation = np.array([[c, -s], [s, c]])

        flip_parity = int(rotated[-1, -2]) - int(rotated[-2, -1])
        assert abs(flip_parity) == 1
        flip = np.eye(2) if flip_parity == 1 else np.array([[0, 1], [1, 0]])

        return M_trial @ rotation @ flip, True
    except Exception:
        return M_trial, False


def blob_array_detect(
    img,
    size,
    orientation=None,
    orientation_check=True,
    dft_threshold=100,
    dft_padding=0,
    k=8,
    tol=0.1,
    plot=False,
):
    r"""
    Detect a rectangular array of spots and return the affine transform
    :math:`\vec{y} = M\vec{x} + \vec{b}` from spot indices to camera pixels.

    Pipeline: padded |FFT| -> 0th-order suppression -> multiscale peak
    detection -> kNN clustering of reciprocal lattice vectors -> primitive
    lattice fit -> kernel cross-correlation for the center -> missing-corner
    parity check -> iterative centroid refinement with outlier rejection.

    Parameters
    ----------
    img : numpy.ndarray
        Camera image of the array.
    size : (int, int) OR int
        Array size ``(Nx, Ny)``.
    orientation : dict OR None
        Optional previous ``{"M", "b"}`` guess (skips the DFT stage).
    orientation_check : bool
        Whether the two-missing-spot parity check applies (see
        :meth:`~slmsuite_torch.holography.algorithms.SpotHologram.make_rectangular_array`).
    dft_threshold, dft_padding, k, tol, plot :
        Pipeline tuning.

    Returns
    -------
    dict with keys ``"M"`` (2, 2) and ``"b"`` (2, 1).
    """
    if len(np.shape(img)) != 2:
        raise RuntimeError(f"Cannot interpret image with shape {np.shape(img)}")
    if np.isscalar(size):
        size = (int(size), int(size))

    img_8bit = _make_8bit(img)
    if np.amax(img_8bit) == 0:
        raise RuntimeError(
            "Cannot fit an image of all zeros. "
            "Check your camera to make sure it is snapping correctly."
        )

    if orientation is not None:
        M = orientation["M"]
    else:
        points, fft_size = _dft_peak_points(img, dft_threshold, dft_padding)
        M = _fit_lattice_vectors(points, fft_size, k, tol)

    # Consider the transposed alternative for non-square arrays.
    if size[0] != size[1] and orientation is None:
        M_options = [M, np.array([[M[0, 1], M[0, 0]], [M[1, 1], M[1, 0]]])]
    else:
        M_options = [M]

    results = []
    for M_trial in M_options:
        max_val, b, mask_shape, rotated_centers, max_loc, max_pitch = (
            _array_center_kernel_match(img_8bit, M_trial, size)
        )
        if orientation is None and orientation_check:
            M_fixed, parity_success = _parity_check(
                img_8bit, M_trial, size, rotated_centers, max_loc, mask_shape, max_pitch
            )
        else:
            M_fixed, parity_success = M_trial, True
        results.append((max_val, b, M_fixed, parity_success))

    if len(results) == 1:
        index = 0
    elif results[0][3] == results[1][3]:
        index = int(results[1][0] > results[0][0])
    else:
        index = int(results[1][3])

    orientation = {"M": results[index][2], "b": results[index][1]}

    # Refine the fit by averaging spot centroid deviations (3 passes,
    # rejecting > mean + std outliers each pass).
    x_list = np.arange(-(size[0] - 1) / 2.0, (size[0] + 1) / 2.0)
    y_list = np.arange(-(size[1] - 1) / 2.0, (size[1] + 1) / 2.0)
    xg, yg = np.meshgrid(x_list, y_list)
    centers = np.vstack((xg.ravel(), yg.ravel()))

    region_fraction = 1.0
    true_positions = None
    for _ in range(3):
        guess_positions = orientation["M"] @ centers + orientation["b"]

        psf = 2 * int(np.floor(np.amin(np.amax(np.abs(orientation["M"]), axis=0))) / 2) + 1
        psf = max(3, psf)

        regions = take(img, guess_positions, psf, centered=True, integrate=False, clip=True)
        region_fraction = np.sum(np.nan_to_num(regions)) / np.sum(img)

        shift = image_positions(regions) - (guess_positions - np.rint(guess_positions))

        shift_error = np.sqrt(np.square(shift[0, :]) + np.square(shift[1, :]))
        thresh = np.mean(shift_error) + np.std(shift_error)
        shift[:, shift_error > thresh] = np.nan

        true_positions = guess_positions + shift
        orientation = fit_affine(centers, true_positions, orientation)

    mask_shape_arr = np.array(mask_shape)
    if np.any(mask_shape_arr > 0.95 * np.array(img_8bit.shape)):
        warnings.warn(
            "The computed Fourier grid size exceeds or approaches the camera size; "
            "calibration results may be improperly centered as a result."
        )
    elif np.any(np.nanmax(true_positions, axis=1) > 0.95 * np.flip(img_8bit.shape)) or np.any(
        np.nanmin(true_positions, axis=1) < 0.05 * np.flip(img_8bit.shape)
    ):
        warnings.warn(
            "The fitted spot array approaches or exceeds the camera FOV; "
            "calibration results may be improperly centered as a result."
        )
    if region_fraction < 0.5:
        warnings.warn(
            f"{(1 - region_fraction) * 100:.1f}% of the image's power is outside the "
            "spot array. This might have caused the array fit to be poor."
        )

    if plot:
        import matplotlib.pyplot as plt

        true_centers = orientation["M"] @ centers + orientation["b"]
        plt.imshow(img)
        plt.scatter(
            true_centers[0, :], true_centers[1, :],
            facecolors="none", edgecolors="r", marker="o", s=80, linewidths=0.5,
        )
        plt.scatter(orientation["b"][0], orientation["b"][1], c="r", marker="x", s=10)
        plt.title("blob_array_detect result")
        plt.show()

    return orientation


def get_orientation_transformation(rot="0", fliplr=False, flipud=False):
    """
    Compile an image transformation lambda from rotations ("90"/"180"/"270"
    or 1/2/3) and flips. Used by the Camera transform pipeline.
    """
    transforms = []
    if fliplr:
        transforms.append(np.fliplr)
    if flipud:
        transforms.append(np.flipud)

    if rot in ("90", 1):
        transforms.append(lambda img: np.rot90(img, 1))
    elif rot in ("180", 2):
        transforms.append(lambda img: np.rot90(img, 2))
    elif rot in ("270", 3):
        transforms.append(lambda img: np.rot90(img, 3))

    return reduce(lambda f, g: lambda x: f(g(x)), transforms, lambda x: x)


def _take_parse_shape(images, shape=None):
    """Resolve the tiling grid shape for a stack of images."""
    img_count = np.shape(images)[0]
    if shape is None:
        M = N = int(np.ceil(np.sqrt(img_count)))
    else:
        M, N = shape
    if M * N < img_count:
        warnings.warn("Not enough space to fit all images. Truncating the image count.")
        img_count = M * N
    return img_count, (M, N)



def take_tile(images, shape=None):
    """Tile a stack of images into one mosaic image of grid ``shape``."""
    img_count, sy, sx = np.shape(images)
    img_count, (M, N) = _take_parse_shape(images, shape)

    result = np.zeros((M * N, sy, sx), np.asarray(images).dtype)
    result[:img_count] = images[:img_count]
    return result.reshape(M, N, sy, sx).transpose(0, 2, 1, 3).reshape(M * sy, N * sx)



def take_plot(images, shape=None, separate_axes=False, cbar=True):
    """Plot a stack of :meth:`take` regions (tiled or as subplots)."""
    import matplotlib.pyplot as plt
    from mpl_toolkits.axes_grid1 import make_axes_locatable

    img_count, sy, sx = np.shape(images)
    img_count, (M, N) = _take_parse_shape(images, shape)

    if separate_axes:
        vmin, vmax = np.nanmin(images), np.nanmax(images)
        plt.figure(figsize=(12, 12))
        for i in range(img_count):
            ax = plt.subplot(M, M, i + 1)
            ax.imshow(images[i], vmin=vmin, vmax=vmax, interpolation="none")
            ax.axis("off")
    else:
        im = plt.imshow(take_tile(images, shape), interpolation="none")
        ax = plt.gca()
        ax.axis("off")
        for x in range(1, N):
            ax.axvline(x=sx * x, color="r", linewidth=0.5)
        for y in range(1, M):
            ax.axhline(y=sy * y, color="r", linewidth=0.5)
        if cbar:
            cax = make_axes_locatable(ax).append_axes("right", size="2%", pad=0.05)
            plt.gcf().colorbar(im, cax=cax, orientation="vertical")
            plt.sca(ax)



def image_relative_strehl(images):
    r"""Relative Strehl metric :math:`S = \max I / \sum I` per image; shape ``(N,)``."""
    images, _ = _ensure_stack(images)
    return np.amax(images, axis=(1, 2)) / np.sum(images, axis=(1, 2))



def image_std(images, centers=None, grid=None, normalize=True, nansum=False):
    """Standard deviations (sqrt of variances, shear excluded); shape ``(2, N)``."""
    return np.sqrt(
        image_variances(images, centers, grid, normalize, nansum, exclude_shear=True)
    )



def _variance_eigenvalues(variances):
    """Eigenvalues of the 2x2 moment matrices; returns (eig_plus, eig_minus)."""
    m20, m02, m11 = variances[0, :], variances[1, :], variances[2, :]
    half_trace = (m20 + m02) / 2
    determinant = m20 * m02 - m11 * m11
    eig_half_difference = np.sqrt(np.square(half_trace) - determinant)
    return half_trace + eig_half_difference, half_trace - eig_half_difference



def image_ellipticity(variances):
    r"""
    Ellipticity metric :math:`1 - \lambda_-/\lambda_+` from the output of
    :meth:`image_variances`; 0 for circular, 1 for a line.
    """
    eig_plus, eig_minus = _variance_eigenvalues(variances)
    return 1 - (eig_minus / eig_plus)



def image_ellipticity_angle(variances):
    r"""Angle between the x axis and the major (large-eigenvalue) axis."""
    m02, m11 = variances[1, :], variances[2, :]
    eig_plus, _ = _variance_eigenvalues(variances)
    return np.arctan2(eig_plus - m02, m11, where=m11 != 0, out=np.zeros_like(m11))



def image_zernike_fit(phase_images, grid, order=10, iterations=2, leastsquares=True, unwrap=False, **kwargs):
    """
    Fit Zernike coefficients (up to radial ``order``, piston omitted) to a
    stack of phase images: iterative overlap subtraction, then optional
    least-squares refinement.

    Note: phase unwrapping (``unwrap=True``) requires scikit-image, which is
    optional; the reference behaves identically (``analysis/__init__.py:1127``).
    """
    from slmsuite_torch.holography.toolbox.phase import zernike_sum

    phase_images = np.asarray(phase_images)
    if phase_images.ndim == 2:
        phase_images = phase_images.reshape((1, *phase_images.shape))
    image_count = phase_images.shape[0]

    if unwrap:
        try:
            from skimage.restoration import unwrap_phase
        except ImportError:
            raise ImportError("Phase unwrapping requires scikit-image.")
        phase_images = np.stack([unwrap_phase(im) for im in phase_images])

    order = int(order + 1)
    indices_ansi = np.arange((order * (order + 1)) // 2)
    D = len(indices_ansi)
    phases = zernike_sum(grid, indices_ansi, np.eye(D), use_mask=True, **kwargs)
    norm = np.reciprocal(np.nansum(np.square(phases), (1, 2)))

    vectors_zernike = np.zeros((D, image_count))
    remainders = np.copy(phase_images).astype(float)

    for _ in range(int(iterations)):
        for i in range(D):
            overlap = np.nansum(remainders * phases[[i]] * norm[i], axis=(1, 2))
            vectors_zernike[i, :] += overlap
            remainders -= overlap[:, np.newaxis, np.newaxis] * phases[[i]]

    if leastsquares:
        grid_xy = _process_grid(grid)
        grid_ravel = (np.ravel(grid_xy[0]), np.ravel(grid_xy[1]))

        for j in range(image_count):

            def zsum(g, *p):
                return zernike_sum(
                    grid, indices_ansi, np.reshape(p, (D, 1)), use_mask=True, **kwargs
                ).ravel()

            try:
                popt, _ = curve_fit(
                    zsum, grid_ravel, phase_images[j].ravel(), ftol=1e-5,
                    p0=vectors_zernike[:, j],
                )
                vectors_zernike[:, j] = popt
            except RuntimeError:
                pass

    return vectors_zernike[1:, :]

