"""
The rest of the user's toolbox on the port against ``slmsuite_tpu`` on the
CPU: the phase patterns (gratings, masks, axicon, the Zernike index API,
polynomials, the structured-light modes), the toolbox's unit labels,
windows, Lloyd's points, assignment and padding, the analysis statistics
and Zernike fit, the fit functions, the file helpers and the math helpers.

Every function here is a numpy copy of its namesake, so each is held to
``np.array_equal`` on the same inputs, except where a test says otherwise.
Anything that draws from numpy's global generator is seeded alike in both
packages, and the generator is restored after each test.
"""

import warnings

import numpy as np
import pytest

from slmsuite_torch.hardware.slms.simulated import SimulatedSLM as TSLM
from slmsuite_torch.holography import analysis as tanalysis
from slmsuite_torch.holography import toolbox as ttoolbox
from slmsuite_torch.holography.analysis import fitfunctions as tfit
from slmsuite_torch.holography.toolbox import phase as tphase
from slmsuite_torch.misc import files as tfiles
from slmsuite_torch.misc import math as tmath
from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM as JSLM
from slmsuite_tpu.holography import analysis as janalysis
from slmsuite_tpu.holography import toolbox as jtoolbox
from slmsuite_tpu.holography.analysis import fitfunctions as jfit
from slmsuite_tpu.holography.toolbox import phase as jphase
from slmsuite_tpu.misc import files as jfiles
from slmsuite_tpu.misc import math as jmath


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _grid(shape=(48, 64)):
    """A normalized meshgrid ``(x, y)`` (8 um pixels at 0.78 um)."""
    h, w = shape
    x = (np.arange(w) - w / 2) * 8 / 0.78
    y = (np.arange(h) - h / 2) * 8 / 0.78
    return tuple(np.meshgrid(x, y))


def _slms(resolution=(64, 48)):
    """The same simulated SLM with a Gaussian source in both packages."""
    out = []
    for cls in (TSLM, JSLM):
        slm = cls(resolution, pitch_um=(8, 8), wav_um=0.78)
        slm.set_source_analytic("gaussian2d", sim=True, x0=0, y0=0, a=1, c=0,
                                wx=0.3 * resolution[0] * 8, wy=0.3 * resolution[1] * 8)
        out.append(slm)
    return out


def _equal(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.array_equal(got, ref, equal_nan=True)


# ----------------------------------------------------------------------
# Phase patterns.
# ----------------------------------------------------------------------

PATTERNS = {
    "sinusoid": lambda m, g: m.sinusoid(g, (0.01, -0.02), shift=0.3, a=2.0, b=0.5),
    "sinusoid_flat": lambda m, g: m.sinusoid(g, (0, 0), shift=0.3),
    "bahtinov": lambda m, g: m.bahtinov(g, radius=0.02),
    "quadrants": lambda m, g: m.quadrants(g, radius=0.02, center=(0.001, 0)),
    "axicon": lambda m, g: m.axicon(g, (2e4, 3e4), w=100.0),
    "axicon_x": lambda m, g: m.axicon(g, (2e4, np.inf), w=100.0),
    "laguerre_gaussian": lambda m, g: m.laguerre_gaussian(g, 3, p=2, w=120.0),
    "hermite_gaussian": lambda m, g: m.hermite_gaussian(g, 2, 3, w=120.0),
    "ince_gaussian_even": lambda m, g: m.ince_gaussian(g, 4, 2, parity=1, w=120.0),
    "ince_gaussian_helical": lambda m, g: m.ince_gaussian(g, 4, 2, parity=0, w=120.0),
    "matheui_gaussian": lambda m, g: m.matheui_gaussian(g, 2, 4.0, w=120.0),
    "airy": lambda m, g: m.airy(g, f=(2e4, 2e4), w=120.0),
    "zernike_sum_derivative": lambda m, g: m.zernike_sum(g, (3, 4, 7), (0.5, -1.0, 0.2),
                                                         derivative=(1, 0)),
    "zernike_sum_stack": lambda m, g: m.zernike_sum(g, (2, 1, 4), np.eye(3)),
    "zernike_nan_mask": lambda m, g: m.zernike(g, 5, weight=2.0, use_mask=np.nan),
    "polynomial": lambda m, g: m.polynomial(g, np.array([1.0, -2.0, 0.5]),
                                            terms=np.array([[1, 0], [0, 2], [2, 1]])),
}


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_phase_pattern_matches_jax(name):
    """Each pattern on the same meshgrid: equal."""
    grid = _grid()
    _equal(PATTERNS[name](tphase, grid), PATTERNS[name](jphase, grid))


@pytest.mark.parametrize("name", ["laguerre_gaussian", "hermite_gaussian", "airy", "axicon"])
def test_structured_light_on_an_slm_matches_jax(name):
    """The modes' default radius is the SLM's fitted source radius
    (:meth:`SLM.get_source_radius`): equal on the same SLM."""
    tslm, jslm = _slms()
    calls = {
        "laguerre_gaussian": lambda m, s: m.laguerre_gaussian(s, 2, p=1),
        "hermite_gaussian": lambda m, s: m.hermite_gaussian(s, 1, 2),
        "airy": lambda m, s: m.airy(s, f=(3e4, 3e4)),
        "axicon": lambda m, s: m.axicon(s, (3e4, 3e4)),
    }
    _equal(calls[name](tphase, tslm), calls[name](jphase, jslm))
    assert tslm.get_source_radius() == jslm.get_source_radius()


def test_zernike_sum_out_matches_jax():
    """``out=`` is filled and returned, as in the JAX package."""
    grid = _grid()
    outs = [np.zeros((2,) + grid[0].shape) for _ in range(2)]
    got = tphase.zernike_sum(grid, (3, 5), np.array([[1.0, 0.0], [0.5, 2.0]]), out=outs[0])
    ref = jphase.zernike_sum(grid, (3, 5), np.array([[1.0, 0.0], [0.5, 2.0]]), out=outs[1])
    _equal(got, ref)
    _equal(outs[0], outs[1])


@pytest.mark.parametrize("to_index", ["ansi", "noll", "fringe", "wyant", "radial"])
def test_zernike_convert_index_matches_jax(to_index):
    indices = np.arange(28)
    _equal(tphase.zernike_convert_index(indices, "ansi", to_index),
           jphase.zernike_convert_index(indices, "ansi", to_index))
    radial = jphase.zernike_convert_index(indices, "ansi", "radial")
    _equal(tphase.zernike_convert_index(radial, "radial", to_index),
           jphase.zernike_convert_index(radial, "radial", to_index))
    with pytest.raises(NotImplementedError):
        tphase.zernike_convert_index(indices + 1, "noll", "ansi")


def test_zernike_names_and_strings_match_jax():
    assert tphase.ZERNIKE_NAMES == jphase.ZERNIKE_NAMES
    assert list(tphase.ZERNIKE_INDEXING) == list(jphase.ZERNIKE_INDEXING)
    assert [tphase.zernike_order_number(n) for n in range(8)] == \
        [jphase.zernike_order_number(n) for n in range(8)]
    for index in range(21):
        for derivative in ((0, 0), (1, 0), (0, 2)):
            assert tphase.zernike_get_string(index, derivative) == \
                jphase.zernike_get_string(index, derivative)


def test_ince_coefficients_match_jax():
    for p, m, parity in ((4, 2, 1), (5, 3, -1), (6, 0, 1), (3, 1, 1)):
        got = tphase._ince_coefficients(p, m, parity, 2.0)
        ref = jphase._ince_coefficients(p, m, parity, 2.0)
        for a, b in zip(np.atleast_1d(got), np.atleast_1d(ref)):
            _equal(a, b)


# ----------------------------------------------------------------------
# The toolbox.
# ----------------------------------------------------------------------


def test_unit_labels_match_jax():
    assert ttoolbox.LENGTH_LABELS == jtoolbox.LENGTH_LABELS
    assert ttoolbox.BLAZE_LABELS == jtoolbox.BLAZE_LABELS
    assert ttoolbox.BLAZE_UNITS == jtoolbox.BLAZE_UNITS
    assert ttoolbox.CAMERA_UNITS == jtoolbox.CAMERA_UNITS


def test_blaze_conversion_aliases_match_jax(capsys):
    """The deprecated aliases warn and convert as :meth:`convert_vector`;
    :meth:`print_blaze_conversions` prints the same lines."""
    tslm, jslm = _slms()
    for module, slm in ((ttoolbox, tslm), (jtoolbox, jslm)):
        with pytest.warns(UserWarning, match="deprecated"):
            module.convert_blaze_vector((0.01, 0.02), "kxy", "knm", slm=slm, shape=(64, 64))
        with pytest.warns(UserWarning, match="deprecated"):
            module.convert_blaze_radius(0.01, "kxy", "knm", slm=slm, shape=(64, 64))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _equal(ttoolbox.convert_blaze_vector((0.01, 0.02), "kxy", "knm", slm=tslm, shape=(64, 64)),
               jtoolbox.convert_blaze_vector((0.01, 0.02), "kxy", "knm", slm=jslm, shape=(64, 64)))
        _equal(ttoolbox.convert_blaze_radius(0.01, "kxy", "rad", slm=tslm),
               jtoolbox.convert_blaze_radius(0.01, "kxy", "rad", slm=jslm))
    capsys.readouterr()
    ttoolbox.print_blaze_conversions((0.01, 0.02), "kxy", hardware=tslm, shape=(64, 64))
    got = capsys.readouterr().out
    jtoolbox.print_blaze_conversions((0.01, 0.02), "kxy", hardware=jslm, shape=(64, 64))
    assert got == capsys.readouterr().out and got


def test_windows_pad_and_assignment_match_jax():
    mask = np.zeros((40, 50), bool)
    mask[5:17, 20:33] = True
    for kw in (dict(), dict(padding_frac=0.2), dict(padding_pix=3)):
        assert ttoolbox.window_extent(mask, **kw) == jtoolbox.window_extent(mask, **kw)
    _equal(ttoolbox.pad(np.ones((5, 7)), (12, 10)), jtoolbox.pad(np.ones((5, 7)), (12, 10)))
    rng = np.random.default_rng(4)
    vectors, options = rng.uniform(0, 10, (2, 9)), rng.uniform(0, 10, (2, 4))
    _equal(ttoolbox.assign_vectors(vectors, options), jtoolbox.assign_vectors(vectors, options))
    _equal(ttoolbox.fit_3pt((3, 4), (5, 4), (3, 7), N=(3, 2)),
           jtoolbox.fit_3pt((3, 4), (5, 4), (3, 7), N=(3, 2)))


def test_voronoi_windows_match_jax():
    vectors = np.array([[10.0, 40.0, 25.0, 50.0], [10.0, 12.0, 30.0, 35.0]])
    for radius in (None, 9):
        got = ttoolbox.voronoi_windows((48, 64), vectors, radius=radius)
        ref = jtoolbox.voronoi_windows((48, 64), vectors, radius=radius)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _equal(a, b)


def test_lloyds_points_match_jax():
    """Seeded alike, Lloyd's algorithm moves the same points the same way."""
    vectors = np.array([[10.0, 11.0, 30.0, 50.0], [10.0, 30.0, 31.0, 40.0]])
    _equal(ttoolbox.lloyds_algorithm((48, 64), vectors, iterations=4),
           jtoolbox.lloyds_algorithm((48, 64), vectors, iterations=4))
    np.random.seed(11)
    got = ttoolbox.lloyds_points((48, 64), 6, iterations=3)
    np.random.seed(11)
    ref = jtoolbox.lloyds_points((48, 64), 6, iterations=3)
    _equal(got, ref)


# ----------------------------------------------------------------------
# Analysis.
# ----------------------------------------------------------------------


def _spots(n=4, side=21):
    """A stack of seeded, elliptical Gaussian spots."""
    rng = np.random.default_rng(8)
    yy, xx = np.meshgrid(np.arange(side) - side // 2, np.arange(side) - side // 2,
                         indexing="ij")
    images = []
    for _ in range(n):
        x0, y0 = rng.uniform(-2, 2, 2)
        wx, wy = rng.uniform(2, 5, 2)
        images.append(np.exp(-((xx - x0) / wx) ** 2 - ((yy - y0) / wy) ** 2 - 0.3 * xx * yy / 9))
    return np.stack(images)


def test_image_statistics_match_jax():
    images = _spots()
    _equal(tanalysis.image_relative_strehl(images), janalysis.image_relative_strehl(images))
    _equal(tanalysis.image_std(images), janalysis.image_std(images))
    variances = janalysis.image_variances(images)
    _equal(tanalysis.image_ellipticity(variances), janalysis.image_ellipticity(variances))
    _equal(tanalysis.image_ellipticity_angle(variances),
           janalysis.image_ellipticity_angle(variances))
    _equal(tanalysis.take_tile(images), janalysis.take_tile(images))
    _equal(tanalysis.take_tile(images, shape=(1, 3)), janalysis.take_tile(images, shape=(1, 3)))


def test_image_zernike_fit_matches_jax():
    """A sum of Zernike terms fit back (the overlap iterations, then the
    least-squares polish)."""
    grid = _grid((32, 32))
    phase = jphase.zernike_sum(grid, (3, 4, 5), (0.4, -0.7, 0.2), aperture="circular")
    for leastsquares in (False, True):
        got = tanalysis.image_zernike_fit(phase, grid, order=3, leastsquares=leastsquares,
                                          aperture="circular")
        ref = janalysis.image_zernike_fit(phase, grid, order=3, leastsquares=leastsquares,
                                          aperture="circular")
        _equal(got, ref)


def test_fit_functions_match_jax():
    x = np.linspace(-3, 3, 41)
    xy = np.meshgrid(x, x)
    _equal(tfit.linear(x, 2.0, -1.0), jfit.linear(x, 2.0, -1.0))
    _equal(tfit.parabola(x, 0.5, 1.0, -2.0), jfit.parabola(x, 0.5, 1.0, -2.0))
    _equal(tfit.hyperbola(x, 1.5, 0.2, 2.0), jfit.hyperbola(x, 1.5, 0.2, 2.0))
    _equal(tfit.gaussian(x, 0.3, 2.0, 0.1, 1.2), jfit.gaussian(x, 0.3, 2.0, 0.1, 1.2))
    assert tfit.__all__ == jfit.__all__
    args = (0.1, -0.2, 1.5, 1.0, 0.5, 0.1, 0.02, 0.3, 0.4)
    _equal(tfit._sinc2d_centered_taylor(xy, *args[2:]), jfit._sinc2d_centered_taylor(xy, *args[2:]))
    _equal(tfit._sinc2d_centered_jacobian(xy, *args[2:]),
           jfit._sinc2d_centered_jacobian(xy, *args[2:]))


# ----------------------------------------------------------------------
# Files and math.
# ----------------------------------------------------------------------


def test_h5_aliases_round_trip_like_jax(tmp_path):
    data = {"a": np.arange(6.0).reshape(2, 3), "s": "text", "n": {"b": np.int32(3)}}
    tfiles.write_h5(str(tmp_path / "t.h5"), data)
    jfiles.write_h5(str(tmp_path / "j.h5"), data)
    got, ref = tfiles.read_h5(str(tmp_path / "t.h5")), jfiles.read_h5(str(tmp_path / "j.h5"))
    _equal(got["a"], ref["a"])
    assert got["s"] == ref["s"] == "text" and got["n"]["b"] == ref["n"]["b"] == 3
    _equal(tfiles.read_h5(str(tmp_path / "j.h5"))["a"], data["a"])


@pytest.mark.parametrize("kw", [dict(), dict(cmap=True), dict(cmap="viridis", lut=16),
                                dict(normalize=False, border=255)])
def test_gray2rgb_and_save_image_match_jax(kw, tmp_path):
    images = np.random.default_rng(5).uniform(0, 1, (2, 12, 16))
    images[0, 3, 4] = np.nan
    _equal(tfiles._gray2rgb(images, **kw), jfiles._gray2rgb(images, **kw))
    tfiles.save_image(str(tmp_path / "t.png"), images[1], **kw)
    jfiles.save_image(str(tmp_path / "j.png"), images[1], **kw)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def test_load_image_matches_jax(tmp_path):
    import cv2

    img = (np.random.default_rng(6).uniform(0, 255, (30, 40))).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "i.png"), img)
    kw = dict(target_shape=(20, 20), angle=10, shift=(3, -2))
    _equal(tfiles._load_image(str(tmp_path / "i.png"), (48, 64), **kw),
           jfiles._load_image(str(tmp_path / "i.png"), (48, 64), **kw))


def test_math_helpers_match_jax():
    assert tmath.SCALAR_TYPES == jmath.SCALAR_TYPES
    for x in (0, 3, -4, np.int64(8)):
        assert tmath.iseven(x) == jmath.iseven(x)
