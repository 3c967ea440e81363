"""
The superpixel wavefront calibration of the port against the JAX package,
on the CPU at a small size (a 256^2 SLM and camera, 32-pixel superpixels):
the OpenCV operations in torch (against ``cv2``), the copied fit
functions, image fits and phase-image operations, the measurement
schedule and the processing helpers, ``wavefront_calibrate_superpixel``
(``phase_steps`` 8, 1 and None, and its options), the processing (the
JAX tests' synthetic raw data, the r001 migration) and the correction it
makes.

Rigs are built in the JAX package and cross with
:meth:`slmsuite_torch.convert.rig_from_jax`; their Fourier calibration is
set analytically from the camera's own affine (the measured one detects
spots with OpenCV and draws a hologram's phase from numpy's global
generator). Numpy's global generator is seeded before every calibration in
both packages and restored after each test.

The camera quantizes the display and the counts, so one ulp can flip a
gray level: the raw data and the corrections are held on what users read,
each with its tolerance below.
"""

import contextlib
import warnings

import numpy as np
import pytest
import torch

import slmsuite_torch
from slmsuite_torch import convert
from slmsuite_torch.hardware import cameraslms as tcs
from slmsuite_torch.holography import analysis as tanalysis
from slmsuite_torch.holography.analysis import _cv
from slmsuite_torch.holography.analysis import fitfunctions as tfit
from slmsuite_torch.holography.toolbox import phase as tphase
from slmsuite_tpu.hardware import cameraslms as jcs
from slmsuite_tpu.hardware.cameras.simulated import SimulatedCamera as JCamera
from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM as JSLM
from slmsuite_tpu.holography import analysis as janalysis
from slmsuite_tpu.holography.analysis import fitfunctions as jfit
from slmsuite_tpu.holography.toolbox import phase as jphase

torch.set_num_threads(1)

SIDE = 256
RIG_M = np.array([[4.0e3, 100.0], [-100.0, 4.0e3]])
RIG_B = np.array([[128.0], [128.0]])
#: The rig's simulated aberration: focus and oblique astigmatism (rad).
ABERRATION = ((4, 3), (1.5, -1.0))
#: The calibration point of the JAX package's smoke test.
POINT = np.array([[160.0], [110.0]])
SUPERPIXEL = 32

#: The torch copies of OpenCV's operations against cv2, in float64.
CV_ATOL = 1e-12
#: Exact copies (fit functions, helpers, phase-image operations).
EXACT_ATOL = 1e-12
#: Raw camera data (power, normalization): relative to the largest.
POWER_RTOL = 1e-3
#: Fitted blaze gradients (kx, ky): relative to the largest.
K_RTOL = 1e-3
#: Fitted fringe phase (rad, circular) where both fits have r2 > 0.9.
FRINGE_ATOL = 2e-2
#: Fit r2.
R2_ATOL = 1e-3
#: Processed correction: RMS of the phase difference (rad) weighted by the
#: measured amplitude, modulo a global constant; the amplitude over its max.
CORRECTION_RMS = 1e-3
AMPLITUDE_ATOL = 1e-6
#: The corrected spot's peak over the uncorrected one (the JAX smoke test's bar).
PEAK_GAIN = 1.1


@pytest.fixture(autouse=True)
def _cpu_default():
    previous = slmsuite_torch.resolve_device(None)
    slmsuite_torch.set_default_device("cpu")
    yield
    slmsuite_torch.set_default_device(previous)


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _jax_rig(aberration=ABERRATION):
    """The JAX smoke test's 256^2 rig, calibrated analytically."""
    slm = JSLM(resolution=(SIDE, SIDE), pitch_um=(8, 8), wav_um=0.78)
    slm.set_source_analytic(
        "gaussian2d", sim=True, x0=0, y0=0, a=1, c=0,
        wx=0.35 * SIDE * slm.pitch[0], wy=0.35 * SIDE * slm.pitch[1],
    )
    cam = JCamera(slm, resolution=(SIDE, SIDE), pitch_um=(5.5, 5.5), M=RIG_M.copy(),
                  b=RIG_B.copy())
    cam.set_exposure(1.0)
    fs = jcs.FourierSLM(cam, slm)
    fs.fourier_calibrate_analytic(RIG_M.copy(), RIG_B.copy())
    if aberration is not None:
        slm.source["phase_sim"] = np.asarray(
            jphase.zernike_sum(slm, *aberration)).astype(np.float32)
    return fs


def _rigs(**kwargs):
    jfs = _jax_rig(**kwargs)
    return convert.rig_from_jax(jfs, device="cpu"), jfs


def _calibrate(fs, **kwargs):
    """``wavefront_calibrate_superpixel`` at the tests' defaults, the
    global generator seeded first and warnings silenced."""
    kwargs = {"calibration_points": POINT, "superpixel_size": SUPERPIXEL, "plot": -1,
              **kwargs}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.random.seed(0)
        return fs.wavefront_calibrate_superpixel(**kwargs)


def _process(fs, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fs.wavefront_calibration_superpixel_process(**kwargs)


def _max_rel(got, ref):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    scale = np.nanmax(np.abs(ref)) or 1.0
    return np.nanmax(np.abs(got - ref)) / scale


def _assert_raw(got, ref, phase_steps):
    """Two raw calibrations hold what users read (tolerances above)."""
    for key in ("calibration_points", "reference_superpixels", "scheduling",
                "interference_size", "interference_window", "slm_supershape"):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(ref[key]), err_msg=key)
    assert got["superpixel_size"] == ref["superpixel_size"]
    assert got["phase_steps"] == ref["phase_steps"]
    for key in ("power", "normalization"):
        np.testing.assert_array_equal(np.isnan(got[key]), np.isnan(ref[key]), err_msg=key)
        assert _max_rel(got[key], ref[key]) <= POWER_RTOL, key
    for key in ("kx", "ky", "phase", "r2_fit"):
        np.testing.assert_array_equal(np.isnan(got[key]), np.isnan(ref[key]), err_msg=key)
    if phase_steps is None:
        return
    for key in ("kx", "ky"):
        assert _max_rel(got[key], ref[key]) <= K_RTOL, key
    assert np.nanmax(np.abs(got["r2_fit"] - ref["r2_fit"])) <= R2_ATOL
    good = np.minimum(got["r2_fit"], ref["r2_fit"]) > 0.9
    assert good.any()
    dphi = np.abs(np.angle(np.exp(1j * (got["phase"] - ref["phase"]))))
    assert np.nanmax(np.where(good, dphi, 0)) <= FRINGE_ATOL


def _correction_rms(got, ref, weight):
    """The RMS of the circular difference of two phases, weighted by
    ``weight``, after removing their mean difference (a global constant)."""
    d = np.angle(np.exp(1j * (np.asarray(got) - np.asarray(ref))))
    piston = np.angle(np.sum(weight * np.exp(1j * d)))
    residual = np.angle(np.exp(1j * (d - piston)))
    return float(np.sqrt(np.sum(weight * residual**2) / np.sum(weight)))


def _assert_processed(got, ref):
    assert _correction_rms(got["phase"], ref["phase"], ref["amplitude"]) <= CORRECTION_RMS
    np.testing.assert_allclose(got["amplitude"], ref["amplitude"], rtol=0,
                               atol=AMPLITUDE_ATOL)
    np.testing.assert_array_equal(got["r2"], ref["r2"])
    assert got["r2_threshold"] == ref["r2_threshold"]


# ----------------------------------------------------------------------
# OpenCV's operations in torch.
# ----------------------------------------------------------------------


@pytest.mark.parametrize("k", [3, 9, 17, 129])
def test_gaussian_blur_matches_cv2(k):
    cv2 = pytest.importorskip("cv2")
    image = np.random.default_rng(k).uniform(0, 1, (150, 112))
    got = _cv.gaussian_blur(torch.tensor(image), k).numpy()
    np.testing.assert_allclose(got, cv2.GaussianBlur(image, (k, k), 0), rtol=0, atol=CV_ATOL)


@pytest.mark.parametrize("interpolation", ["nearest", "cubic"])
@pytest.mark.parametrize("factor", [32, 64])
def test_resize_matches_cv2(interpolation, factor):
    cv2 = pytest.importorskip("cv2")
    flag = {"nearest": cv2.INTER_NEAREST, "cubic": cv2.INTER_CUBIC}[interpolation]
    small = np.random.default_rng(factor).uniform(-1, 2, (5, 7))
    size = (7 * factor, 5 * factor)
    got = _cv.resize(torch.tensor(small), size, interpolation).numpy()
    np.testing.assert_allclose(got, cv2.resize(small, size, interpolation=flag), rtol=0,
                               atol=CV_ATOL)


def test_cv_operations_refuse_what_opencv_refuses():
    with pytest.raises(ValueError, match="odd"):
        _cv.gaussian_taps(4)
    with pytest.raises(ValueError, match="interpolation"):
        _cv.resize(torch.zeros(2, 2, dtype=torch.float64), (4, 4), "linear")


# ----------------------------------------------------------------------
# Copies of the JAX package's helpers.
# ----------------------------------------------------------------------


_XY = np.meshgrid(np.linspace(-9, 9, 23), np.linspace(-7, 8, 19))
_X = np.linspace(-3, 4, 41)
FIT_CASES = {
    "cos": (_X, (0.7, 2.0, 0.3), {"k": 1.5}),
    "lorentzian": (_X, (0.4, 3.0, 0.2, 0.8), {}),
    "sinc2d": (_XY, (0.5, -1.0, 6.0, 2.0, 0.3, 0.4, 0.1, 0.2, -0.3), {}),
    "_sinc2d_nomod": (_XY, (0.5, -1.0, 6.0, 2.0, 0.1), {}),
    "_sinc2d_centered": (_XY, (6.0, 2.0, 0.3, 0.4, 0.1, 0.2, -0.3), {}),
    "exponential_jump": (_X, (0.5, 2.0, 0.7, 0.1), {}),
}


@pytest.mark.parametrize("name", sorted(FIT_CASES))
def test_fit_functions_match_jax(name):
    x, args, kwargs = FIT_CASES[name]
    np.testing.assert_allclose(getattr(tfit, name)(x, *args, **kwargs),
                               getattr(jfit, name)(x, *args, **kwargs), rtol=0,
                               atol=EXACT_ATOL)


@pytest.mark.parametrize("function", ["gaussian2d", "_sinc2d_nomod"])
def test_image_fit_matches_jax(function):
    """A stack of noisy spots fitted by both packages (the sinc fit from
    the guess the calibration's ``find_centers`` forms)."""
    rng = np.random.default_rng(2)
    grid = np.meshgrid(np.arange(31) - 15.0, np.arange(31) - 15.0)
    images = np.stack([
        jfit.gaussian2d(grid, 1.5, -2.0, 50.0, 3.0, 4.0, 3.0)
        + jfit._sinc2d_nomod(grid, -1.0, 2.0, 8.0, 40.0)
        + rng.normal(0, 0.5, (31, 31))
        for _ in range(2)
    ])
    if function == "gaussian2d":
        got, ref = tanalysis.image_fit(images), janalysis.image_fit(images)
    else:
        centers = janalysis.image_positions(images)
        a = np.nanmax(images, axis=(1, 2))
        guess = np.vstack((centers, np.full_like(a, 31 / 4), a, np.zeros_like(a))).T
        got = tanalysis.image_fit(images, function=tfit._sinc2d_nomod, guess=guess)
        ref = janalysis.image_fit(images, function=jfit._sinc2d_nomod, guess=guess)
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=EXACT_ATOL)


def _vortex_phase():
    grid = np.meshgrid(np.arange(40.0), np.arange(36.0))
    screw = np.arctan2(grid[1] - 17.3, grid[0] - 21.6) - np.arctan2(grid[1] - 8.2, grid[0] - 9.1)
    return np.mod(screw + 0.05 * grid[0] + 0.02 * grid[1], 2 * np.pi)


@pytest.mark.parametrize("masked", [False, True])
def test_phase_image_operations_match_jax(masked):
    """``image_vortices``, ``_coordinates``, ``image_remove_vortices``,
    ``image_remove_blaze`` and ``image_reduce_wraps`` on a phase with two
    vortices and a blaze."""
    phase = _vortex_phase()
    mask = None
    if masked:
        grid = np.meshgrid(np.arange(40.0), np.arange(36.0))
        mask = np.exp(-((grid[0] - 20) ** 2 + (grid[1] - 18) ** 2) / 200)
    np.testing.assert_array_equal(tanalysis.image_vortices(phase),
                                  janalysis.image_vortices(phase))
    for t, j in zip(tanalysis.image_vortices_coordinates(phase, mask=mask),
                    janalysis.image_vortices_coordinates(phase, mask=mask)):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    for kwargs in ({"mask": mask}, {"mask": mask, "return_vortices_negative": True}):
        np.testing.assert_allclose(
            tanalysis.image_remove_vortices(phase.copy(), **kwargs),
            janalysis.image_remove_vortices(phase.copy(), **kwargs), rtol=0, atol=EXACT_ATOL)
    for name in ("image_remove_blaze", "image_reduce_wraps"):
        np.testing.assert_allclose(getattr(tanalysis, name)(phase, mask=mask),
                                   getattr(janalysis, name)(phase, mask=mask), rtol=0,
                                   atol=EXACT_ATOL)
    with pytest.warns(DeprecationWarning):
        got = tanalysis.image_blaze_remove(phase_image=phase, mask=mask)
    np.testing.assert_allclose(got, janalysis.image_remove_blaze(phase, mask=mask), rtol=0,
                               atol=EXACT_ATOL)


@pytest.mark.parametrize("vector", [(0.01, 0.0), (0.003, -0.007), (4, 0), (0, 0)])
def test_binary_grating_matches_jax(vector):
    tslm, jslm = _slms()
    for kwargs in ({}, {"a": 7, "b": 2, "duty_cycle": 0.3}, {"shift": 4.0}):
        np.testing.assert_array_equal(tphase.binary(tslm, vector=vector, **kwargs),
                                      jphase.binary(jslm, vector=vector, **kwargs))


def _slms():
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM as TSLM

    return (TSLM((48, 40), pitch_um=(8, 8), wav_um=0.78),
            JSLM((48, 40), pitch_um=(8, 8), wav_um=0.78))


# ----------------------------------------------------------------------
# The schedule and the processing helpers.
# ----------------------------------------------------------------------


def _schedule_inputs(supershape, margin, n_refs):
    exclude = np.zeros(supershape, dtype=bool)
    if margin:
        exclude[:, :margin] = exclude[:, -margin:] = True
        exclude[:margin, :] = exclude[-margin:, :] = True
    index_image = np.arange(np.prod(supershape)).reshape(supershape)
    center = np.array(supershape) // 2
    refs = np.array([index_image[center[0], center[1]],
                     index_image[center[0], center[1] + 1]][:n_refs])
    return exclude, refs, index_image[~exclude].ravel()


@pytest.mark.parametrize("margin", [0, 2])
@pytest.mark.parametrize("phase_steps", [None, 1, 4])
@pytest.mark.parametrize("n_refs", [1, 2])
def test_superpixel_schedule_matches_jax(margin, phase_steps, n_refs):
    """The schedule equals the JAX package's (its offset of the rotation by
    the reference's place in the active list kept), covers every active
    superpixel but a row's reference once, and idles a row wherever its
    reference is measured."""
    supershape = (8, 8)
    exclude, refs, active = _schedule_inputs(supershape, margin, n_refs)
    got = tcs._build_superpixel_schedule(supershape, exclude, refs, phase_steps)
    ref = jcs._build_superpixel_schedule(supershape, exclude, refs, phase_steps)
    np.testing.assert_array_equal(got, ref)
    for i, r in enumerate(refs):
        row = got[i][got[i] >= 0]
        assert len(np.unique(row)) == len(row)
        assert set(row.tolist()) == set(active.tolist()) - {int(r)}
        if phase_steps is not None:
            cols = np.where(np.any(got == r, axis=0))[0]
            assert np.all(got[i, cols] == -1)


def test_processing_helpers_match_jax():
    rng = np.random.default_rng(7)
    for yx in ((0, 0), (3, 4), (5, 6)):
        matrix = rng.uniform(0, 1, (6, 7))
        matrix[2, 3] = np.nan
        got, ref = matrix.copy(), matrix.copy()
        tcs._patch_from_neighbors(got, yx)
        jcs._patch_from_neighbors(ref, yx)
        np.testing.assert_array_equal(got, ref)

    power = rng.uniform(100, 200, (6, 6))
    untrusted = np.zeros((6, 6), bool)
    untrusted[:2] = True
    power[untrusted] = 3.0 + rng.uniform(0, 0.01, 12)
    for normalization in (np.full((6, 6), 150.0), np.full((6, 6), 1.0)):
        for mask in (untrusted, np.zeros_like(untrusted)):
            assert (tcs._detect_noise_floor(power, normalization, mask)
                    == jcs._detect_noise_floor(power, normalization, mask))

    trusted = rng.uniform(0, 1, (7, 8)) > 0.3
    trusted[3, 4] = True
    trusted[0, :] = False
    trusted[6, 7] = False
    args = (rng.uniform(-1e-3, 1e-3, (7, 8)), rng.uniform(-1e-3, 1e-3, (7, 8)),
            rng.uniform(0, 2 * np.pi, (7, 8)), trusted, (3, 4), np.array([650.0, 700.0]))
    for t, j in zip(tcs._propagate_affine_phase(*args), jcs._propagate_affine_phase(*args)):
        np.testing.assert_allclose(t, j, rtol=0, atol=EXACT_ATOL)


def test_superpixel_window_matches_jax():
    tfs, jfs = _rigs()
    for size in (16, 32, 50, 64):
        np.testing.assert_array_equal(tfs.wavefront_calibration_superpixel_window(size),
                                      jfs.wavefront_calibration_superpixel_window(size))


# ----------------------------------------------------------------------
# The calibration on the rig.
# ----------------------------------------------------------------------


@contextlib.contextmanager
def _kept_global_state():
    state = np.random.get_state()
    try:
        yield
    finally:
        np.random.set_state(state)


@pytest.fixture(scope="module")
def calibrated():
    """Both packages' calibration at phase_steps 8, 1 and None, processed
    at the default smoothing and applied: ``{steps: (tfs, jfs, (raw,
    processed) of the port, of the JAX package)}``."""
    out = {}
    with _kept_global_state():
        for steps in (8, 1, None):
            tfs, jfs = _rigs()
            pair = []
            for fs in (tfs, jfs):
                raw = _calibrate(fs, phase_steps=steps)
                pair.append((raw, _process(fs, apply=True)))
            out[steps] = (tfs, jfs, *pair)
    return out


@pytest.mark.parametrize("steps", [8, 1, None])
def test_superpixel_calibration_matches_jax(calibrated, steps):
    """The raw data of the stepped cosine fit (8), the single-shot fringe
    fit (1) and the amplitude alone (None), and the correction processed
    from them, agree with the JAX package's."""
    tfs, jfs, (t_raw, t_proc), (j_raw, j_proc) = calibrated[steps]
    _assert_raw(t_raw, j_raw, steps)
    _assert_processed(t_proc, j_proc)
    for key in ("phase", "amplitude", "r2"):
        np.testing.assert_array_equal(tfs.slm.source[key], t_proc[key])
    assert set(tfs.calibrations["wavefront_superpixel"]) == set(
        jfs.calibrations["wavefront_superpixel"])


def _spot_peak(fs):
    fs.slm.set_phase(None, settle=False)
    return float(fs.cam.get_image().astype(float).max())


@pytest.mark.parametrize("steps", [8, 1])
def test_superpixel_correction_raises_the_peak(calibrated, steps):
    """The JAX smoke test's bar, on the port: with the correction on, the
    spot's peak exceeds 1.1 times the peak without it (the exposure halved
    until the corrected spot does not saturate)."""
    tfs = calibrated[steps][0]
    correction = tfs.slm.source["phase"]
    assert np.isfinite(correction).all()
    while _spot_peak(tfs) >= 0.9 * tfs.cam.bitresolution:
        tfs.cam.set_exposure(tfs.cam.get_exposure() / 2)
    after = _spot_peak(tfs)
    tfs.slm.source.pop("phase")
    before = _spot_peak(tfs)
    tfs.slm.source["phase"] = correction
    assert after > PEAK_GAIN * before


@pytest.mark.parametrize("smooth", [0, 2, True])
@pytest.mark.parametrize("flags", [
    {},
    {"remove_blaze": False},
    {"remove_vortices": True, "r2_threshold": 0.95},
    {"remove_background": False, "apply": False},
])
def test_superpixel_processing_options_match_jax(calibrated, smooth, flags):
    """The processing of the stepped calibration's raw data at each
    smoothing (0, 2, True for 16) and option."""
    tfs, jfs = calibrated[8][:2]
    got = _process(tfs, smooth=smooth, **flags)
    ref = _process(jfs, smooth=smooth, **flags)
    _assert_processed(got, ref)


@pytest.mark.parametrize("column", [5, 30, 62])
def test_single_shot_test_index_matches_jax(column):
    """``test_index``: one schedule column of the single-shot fringe fit,
    returned, the source restored."""
    tfs, jfs = _rigs()
    tfs.slm.source["phase"] = jfs.slm.source["phase"] = np.full((SIDE, SIDE), 0.25)
    got = _calibrate(tfs, phase_steps=1, test_index=column)
    ref = _calibrate(jfs, phase_steps=1, test_index=column)
    assert set(got) == set(ref)
    for key in ("power", "normalization"):
        assert _max_rel(got[key], ref[key]) <= POWER_RTOL, key
    for key in ("kx", "ky"):
        assert _max_rel(got[key], ref[key]) <= K_RTOL, key
    assert abs(np.angle(np.exp(1j * (got["phase"][0] - ref["phase"][0])))) <= FRINGE_ATOL
    np.testing.assert_array_equal(tfs.slm.source["phase"], jfs.slm.source["phase"])
    assert "wavefront_superpixel" not in tfs.calibrations


OPTION_CASES = {
    "margins": dict(exclude_superpixels=(1, 2)),
    "excluded_image": dict(exclude_superpixels=np.eye(8, dtype=int)[::-1]),
    "reference": dict(reference_superpixels=(2, 5)),
    "background_and_corrected": dict(measure_background=True, corrected_amplitude=True),
    "field_point_ij": dict(field_point=(60, 200), field_point_units="ij"),
    "kept_correction": dict(fresh_calibration=False),
    "two_points": dict(calibration_points=np.array([[170.0, 60.0], [100.0, 160.0]])),
}


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_superpixel_options_match_jax(case):
    """The calibration's options, on the amplitude-only measurement
    (``phase_steps=None``; the corrected amplitude needs the centers'
    fit), then processed for each point."""
    kwargs = dict(OPTION_CASES[case])
    tfs, jfs = _rigs()
    if case == "kept_correction":
        correction = np.asarray(jphase.zernike_sum(jfs.slm, (4,), (0.5,)))
        tfs.slm.source["phase"] = jfs.slm.source["phase"] = correction
    got = _calibrate(tfs, phase_steps=None, **kwargs)
    ref = _calibrate(jfs, phase_steps=None, **kwargs)
    _assert_raw(got, ref, None)
    np.testing.assert_array_equal(np.asarray(got["previous_phase_correction"]),
                                  np.asarray(ref["previous_phase_correction"]))
    for index in range(got["calibration_points"].shape[1]):
        _assert_processed(_process(tfs, index=index, apply=False),
                          _process(jfs, index=index, apply=False))


def test_default_calibration_points_match_jax():
    """``TestSuperpixelDifferential``'s run: a 128^2 SLM behind a 256^2
    camera, 32-pixel superpixels, the single-shot fringe fit, and the
    calibration points left to the layout of
    ``wavefront_calibration_points`` (several points, each with its own
    reference superpixel and schedule row)."""
    from slmsuite_torch.hardware.cameras.simulated import SimulatedCamera as TCamera
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM as TSLM

    raws = []
    for slm_type, cam_type, fs_type in ((TSLM, TCamera, tcs.FourierSLM),
                                        (JSLM, JCamera, jcs.FourierSLM)):
        slm = slm_type((128, 128), pitch_um=(8, 8), wav_um=0.78)
        cam = cam_type(slm, (256, 256), pitch_um=(4, 4), M=np.array([[4.0e3, 0], [0, 4.0e3]]),
                       b=np.array([[128.0], [128.0]]))
        cam.set_exposure(1.0)
        fs = fs_type(cam, slm)
        fs.calibrations["fourier"] = {"M": np.array([[4e3, 0.0], [0.0, 4e3]]),
                                      "b": np.array([[128.0], [128.0]]),
                                      "a": np.array([[0.0], [0.0]])}
        raws.append(_calibrate(fs, calibration_points=None, phase_steps=1))
    got, ref = raws
    assert got["calibration_points"].shape[1] > 1
    _assert_raw(got, ref, 1)


def test_default_method_is_the_superpixel_calibration():
    """``wavefront_calibrate()`` runs the superpixel calibration; the
    deprecated ``calibration_point`` warns and is taken."""
    tfs, jfs = _rigs()
    with pytest.warns(UserWarning, match="deprecated"):
        got = tfs.wavefront_calibrate(calibration_point=POINT, superpixel_size=64,
                                      phase_steps=None, plot=-1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jfs.wavefront_calibrate(calibration_point=POINT, superpixel_size=64,
                                      phase_steps=None, plot=-1)
    _assert_raw(got, ref, None)


ERROR_CASES = {
    "close_points": (ValueError, dict(calibration_points=np.array([[150.0, 160.0],
                                                                   [110.0, 110.0]]))),
    "excluded_reference": (ValueError, dict(exclude_superpixels=(4, 4))),
    "bad_exclusion": (ValueError, dict(exclude_superpixels=(1, 2, 3))),
    "fractional_steps": (ValueError, dict(phase_steps=1.5)),
    "no_steps": (ValueError, dict(phase_steps=0)),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_superpixel_geometry_errors_match_jax(case):
    error, kwargs = ERROR_CASES[case]
    tfs, jfs = _rigs()
    for fs in (tfs, jfs):
        with pytest.raises(error):
            _calibrate(fs, **kwargs)


def test_superpixel_geometry_warnings_match_jax():
    """Points too close warn under ``test_index``; points near the field's
    orders and near their own mirror warn; without the Fourier calibration
    the window's size cannot be found (KeyError in both packages)."""
    tfs, jfs = _rigs()
    kwargs = dict(calibration_points=np.array([[150.0, 160.0], [110.0, 110.0]]),
                  superpixel_size=64, phase_steps=None, test_index=0, plot=-1)
    near = dict(calibration_points=np.array([[131.0], [129.0]]), superpixel_size=64,
                phase_steps=None, test_index=0, plot=-1)
    for fs in (tfs, jfs):
        with pytest.warns(UserWarning, match="too close together"):
            fs.wavefront_calibrate_superpixel(**kwargs)
        with pytest.warns(UserWarning) as record:
            fs.wavefront_calibrate_superpixel(**near)
        messages = " ".join(str(w.message) for w in record)
        assert "diffractive orders" in messages and "-1st orders" in messages
        fs.calibrations.pop("fourier")
        with pytest.raises(KeyError, match="fourier"):
            _calibrate(fs)


# ----------------------------------------------------------------------
# Processing of stored raw data.
# ----------------------------------------------------------------------


def _synthetic_raw(fs, kx_val, ky_val, offset_val, superpixel_size=64, holes=()):
    """The JAX package's ``TestSuperpixelProcessing`` raw data: a globally
    affine wavefront, a Gaussian power, the reference's reading infinite."""
    H, W = fs.slm.shape
    NY, NX = H // superpixel_size, W // superpixel_size
    ref = (NY // 2, NX // 2)
    r2 = np.ones((NY, NX))
    for hole in holes:
        r2[hole] = 0.2
    r2[ref] = np.nan
    yy, xx = np.meshgrid(np.arange(NY) - ref[0], np.arange(NX) - ref[1], indexing="ij")
    power = 100.0 * np.exp(-(xx**2 + yy**2) / 8.0)
    power[ref] = np.inf
    return {
        "__version__": "0.0.1", "NX": NX, "NY": NY, "nxref": ref[1], "nyref": ref[0],
        "superpixel_size": superpixel_size, "power": power,
        "normalization": np.full((NY, NX), 120.0), "background": np.zeros((NY, NX)),
        "phase": np.full((NY, NX), offset_val), "kx": np.full((NY, NX), kx_val),
        "ky": np.full((NY, NX), ky_val), "r2_fit": r2, "previous_phase_correction": False,
    }


def _wrapped_spread(delta):
    mean = np.angle(np.mean(np.exp(1j * delta)))
    return np.abs(np.angle(np.exp(1j * (delta - mean)))).max()


PROCESSING_CASES = {
    "affine": dict(ky=-0.5, offset=1.0, superpixel_size=64, holes=(),
                   process=dict(smooth=0, remove_blaze=False, remove_background=False)),
    "holes": dict(ky=0.7, offset=0.3, superpixel_size=32,
                  holes=((1, 1), (1, 2), (2, 1), (2, 2), (7, 7)),
                  process=dict(smooth=0, remove_blaze=False, remove_background=False)),
    "noise_floor": dict(ky=0.2, offset=0.0, superpixel_size=32,
                        holes=((0, 0), (0, 1), (1, 0), (7, 6), (6, 7)),
                        process=dict(smooth=2, remove_background=True)),
    "amplitude": dict(ky=1.0, offset=0.0, superpixel_size=64, holes=(),
                      process=dict(smooth=0, remove_background=False)),
}


@pytest.mark.parametrize("case", sorted(PROCESSING_CASES))
def test_superpixel_processing_of_synthetic_data_matches_jax(case):
    """``TestSuperpixelProcessing``'s raw data through both packages: an
    affine wavefront is rebuilt exactly (holes included), the amplitude
    peaks at 1 near the center, and with a noise floor in the untrusted
    powers it is detected and removed in both."""
    spec = PROCESSING_CASES[case]
    tfs, jfs = _rigs()
    kx_val = 0.2 / (tfs.slm.grid[0].max() * 2 * np.pi)
    outs = []
    for fs in (tfs, jfs):
        raw = _synthetic_raw(fs, kx_val, spec["ky"] * kx_val, spec["offset"],
                             spec["superpixel_size"], spec["holes"])
        if case == "noise_floor":
            for hole in spec["holes"]:
                raw["power"][hole] = 2.0
        fs.calibrations["wavefront_superpixel"] = raw
        outs.append(_process(fs, apply=False, **spec["process"]))
    got, ref = outs
    _assert_processed(got, ref)
    if spec["process"].get("smooth") == 0 and not spec["process"].get("remove_blaze", True):
        x_grid, y_grid = tfs.slm.grid
        delta = got["phase"] - 2 * np.pi * (kx_val * x_grid + spec["ky"] * kx_val * y_grid)
        assert _wrapped_spread(delta) < 1e-6
    assert np.isclose(got["amplitude"].max(), 1.0) and got["r2"].shape == tfs.slm.shape


def test_superpixel_process_applies_to_the_source():
    tfs, jfs = _rigs()
    for fs in (tfs, jfs):
        fs.calibrations["wavefront_superpixel"] = _synthetic_raw(fs, 1e-4, 0.0, 0.0)
        _process(fs, smooth=2, apply=True)
    for key in ("phase", "amplitude", "r2"):
        assert tfs.slm.source[key].shape == tfs.slm.shape
    _assert_processed(tfs.slm.source, jfs.slm.source)


def _truth_raw(slm, holey, seed=3):
    """The JAX differential test's raw data (r001 form, 8 x 8 superpixels
    of 16 on a 128^2 SLM) sampled from one smooth wavefront."""
    rng = np.random.default_rng(seed)
    NY = NX = 8
    sp = 16
    xg, yg = np.asarray(slm.grid[0]), np.asarray(slm.grid[1])
    truth = 40.0 * (xg**2 + yg**2) * 1e4 / 6.5 + 3.0 * np.sin(xg * 3e2) + 2.0 * (xg * yg) * 1e4
    gy, gx = np.gradient(truth)
    dx, dy = xg[0, 1] - xg[0, 0], yg[1, 0] - yg[0, 0]
    kx, ky, offset = (np.zeros((NY, NX)) for _ in range(3))
    for ny in range(NY):
        for nx in range(NX):
            sl = np.s_[ny * sp:(ny + 1) * sp, nx * sp:(nx + 1) * sp]
            kxv = gx[sl].mean() / dx / (2 * np.pi)
            kyv = gy[sl].mean() / dy / (2 * np.pi)
            kx[ny, nx], ky[ny, nx] = kxv, kyv
            offset[ny, nx] = np.mod(
                truth[sl].mean() - 2 * np.pi * (kxv * xg[sl].mean() + kyv * yg[sl].mean()),
                2 * np.pi)
    power = (1e3 * np.exp(-(xg**2 + yg**2) * 1e4 / 40) + 30).reshape(8, 16, 8, 16).mean(
        axis=(1, 3))
    r2 = np.full((NY, NX), 0.98)
    if holey:
        holes = rng.random((NY, NX)) < 0.2
        holes[2:4, 5:7] = True
        holes[4, 4] = False
        r2[holes] = 0.2
        kx[holes] = ky[holes] = offset[holes] = np.nan
    return {
        "NX": NX, "NY": NY, "nxref": 4, "nyref": 4, "superpixel_size": sp,
        "interference_point": np.array([64.0, 64.0]),
        "interference_size": np.array([8.0, 8.0]), "power": power,
        "normalization": np.full((NY, NX), 1.1e3), "background": np.zeros((NY, NX)),
        "phase": offset, "kx": kx, "ky": ky, "amp_fit": np.ones((NY, NX)),
        "contrast_fit": np.ones((NY, NX)), "r2_fit": r2,
    }


@pytest.mark.parametrize("holey", [False, True])
@pytest.mark.parametrize("remove_blaze", [False, True])
def test_superpixel_process_of_a_smooth_wavefront_matches_jax(holey, remove_blaze):
    """``TestSuperpixelProcessDifferential``'s smooth wavefront (with and
    without failed fits) on a 128^2 rig, as a stored r001 ``"wavefront"``
    calibration: the same amplitude, r2 map and correction."""
    from slmsuite_torch.hardware.cameras.simulated import SimulatedCamera as TCamera
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM as TSLM

    outs = []
    for slm_type, cam_type, fs_type in ((TSLM, TCamera, tcs.FourierSLM),
                                        (JSLM, JCamera, jcs.FourierSLM)):
        slm = slm_type((128, 128), pitch_um=(8, 8), wav_um=0.78)
        cam = cam_type(slm, (128, 128), pitch_um=(4, 4), M=np.array([[2.0e3, 0], [0, 2.0e3]]),
                       b=np.array([[64.0], [64.0]]))
        fs = fs_type(cam, slm)
        fs.calibrations["wavefront"] = _truth_raw(slm, holey)
        outs.append(_process(fs, apply=False, remove_blaze=remove_blaze))
        assert fs.calibrations["wavefront"]["__version__"] == "0.0.1"
    _assert_processed(*outs)


def test_r001_file_processes_like_jax(tmp_path):
    """``TestSuperpixelR001Migration``: a pre-0.1 calibration file (no
    ``__version__``) loads, gets the version, and processes to the JAX
    package's correction."""
    from slmsuite_torch.misc.files import load_h5, save_h5

    rng = np.random.default_rng(5)
    r001 = {
        "NX": 4, "NY": 4, "nxref": 2, "nyref": 2, "superpixel_size": 64,
        "interference_point": np.array([160.0, 110.0]),
        "interference_size": np.array([8.0, 8.0]),
        "power": rng.uniform(500, 1000, (4, 4)), "normalization": np.full((4, 4), 1.1e3),
        "background": np.zeros((4, 4)), "phase": rng.uniform(0, 2 * np.pi, (4, 4)),
        "kx": rng.uniform(-1e-4, 1e-4, (4, 4)), "ky": rng.uniform(-1e-4, 1e-4, (4, 4)),
        "amp_fit": np.ones((4, 4)), "contrast_fit": np.ones((4, 4)),
        "r2_fit": np.full((4, 4), 0.97),
    }
    path = str(tmp_path / "wavefront_r001.h5")
    save_h5(path, r001)
    tfs, jfs = _rigs()
    outs = []
    for fs in (tfs, jfs):
        loaded = load_h5(path)
        assert "__version__" not in loaded
        fs.calibrations["wavefront"] = loaded
        outs.append(_process(fs, smooth=2, apply=True))
        assert fs.calibrations["wavefront"]["__version__"] == "0.0.1"
    _assert_processed(*outs)
    assert np.isfinite(tfs.slm.source["phase"]).all()


def test_superpixel_refusals_name_their_item():
    """The plots draw (no refusal names item 12 any more): the raw-data and
    processed plots of a measured calibration, the fit plots and the
    analysis plots; the rest of the JAX package's names run."""
    tfs, _ = _rigs()
    with pytest.raises(RuntimeError, match="Could not find"):
        tfs.wavefront_calibration_superpixel_process(plot=True)
    _draws(lambda: _calibrate(tfs, phase_steps=1, test_index=5, plot=2))
    _draws(lambda: _calibrate(tfs, phase_steps=4, test_index=5, plot=1))
    _calibrate(tfs, phase_steps=1)
    for call in (
        lambda: tfs._wavefront_calibration_superpixel_plot_raw(index=0),
        lambda: tfs._wavefront_calibration_superpixel_plot_raw(index=None),
        lambda: tfs.wavefront_calibration_superpixel_process(plot=True, apply=False),
        lambda: tanalysis.image_fit(np.ones((3, 3)), plot=True),
        lambda: tanalysis.image_remove_blaze(np.ones((3, 3)), plot=True),
    ):
        _draws(call)


def _draws(call):
    """Run ``call`` under matplotlib's Agg backend; it must draw a figure.
    Closes every figure after. Returns what ``call`` returns."""
    import matplotlib.pyplot as plt

    plt.close("all")
    out = call()
    assert plt.get_fignums(), "no figure drawn"
    plt.close("all")
    return out
