"""
The rest of the rig's calibrations on the port against the JAX package, on
the CPU at a small size: the settle and pixel calibrations (the JAX
differential tests' 128^2 SLM and 256^2 camera), ``write_calibration`` and
``read_calibration``, ``Camera.autoexposure`` and ``autofocus`` (also with
the SLM as the focus actuator), ``SLM.fit_source_amplitude`` of a measured
source and its re-centred grid, the state the superpixel calibration
writes (a hologram optimized before it measures through the new
correction, on the device measurement and on the host image path), a
stored JAX calibration carried across by ``convert.rig_from_jax``, and the
stubs that stay (``NearfieldSLM``, ``CameraSLM.plot``).

Numpy's global generator is seeded before every call that draws from it
(a hologram's random initial phase), in both packages, and restored after
each test. The camera quantizes the display and the counts: measurements
are held on what users read, each with its tolerance below.
"""

import warnings

import numpy as np
import pytest
import torch
from scipy import optimize

import slmsuite_torch
from slmsuite_torch import convert
from slmsuite_torch.hardware.cameras.camera import Camera as TCamera
from slmsuite_torch.hardware.cameras.simulated import SimulatedCamera as TSimCamera
from slmsuite_torch.hardware.cameraslms import CameraSLM as TCameraSLM
from slmsuite_torch.hardware.cameraslms import FourierSLM as TFourierSLM
from slmsuite_torch.hardware.cameraslms import NearfieldSLM as TNearfieldSLM
from slmsuite_torch.hardware.slms.simulated import SimulatedSLM as TSLM
from slmsuite_torch.holography import algorithms as T
from slmsuite_torch.holography import analysis as tanalysis
from slmsuite_torch.holography.toolbox import phase as tphase
from slmsuite_tpu.hardware.cameras.camera import Camera as JCamera
from slmsuite_tpu.hardware.cameras.simulated import SimulatedCamera as JSimCamera
from slmsuite_tpu.hardware.cameraslms import CameraSLM as JCameraSLM
from slmsuite_tpu.hardware.cameraslms import FourierSLM as JFourierSLM
from slmsuite_tpu.hardware.cameraslms import NearfieldSLM as JNearfieldSLM
from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM as JSLM
from slmsuite_tpu.holography import algorithms as J
from slmsuite_tpu.holography import toolbox as jtoolbox
from slmsuite_tpu.holography.toolbox import phase as jphase

torch.set_num_threads(1)

#: Exact copies (pure numpy on the same inputs).
EXACT_ATOL = 1e-12
#: Fitted settle times and the fitted pixel phase response, relative.
FIT_RTOL = 1e-6
#: Autofocus: the optimal z of the two packages.
FOCUS_ATOL = 1e-4
#: Spot powers of one measurement: one count per window pixel (inline).
#: Measured stats of camera loops (uniformity, efficiency).
LOOP_STAT_ATOL = 2e-3
#: The processed correction (rad, RMS weighted by the amplitude, modulo a
#: global constant) and the amplitude over its maximum.
CORRECTION_RMS = 1e-3
AMPLITUDE_ATOL = 1e-6
#: A fitted source centre (SLM pixels) and radius (relative).
CENTER_ATOL = 1e-6
RADIUS_RTOL = 1e-6


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


def _jax_settle_rig():
    """The JAX differential tests' rig: a 128^2 SLM, a 256^2 camera, the
    calibration set from the camera's affine."""
    slm = JSLM((128, 128), pitch_um=(8, 8), wav_um=0.78)
    cam = JSimCamera(slm, (256, 256), pitch_um=(4, 4), M=np.array([[4.0e3, 0.0], [0.0, 4.0e3]]),
                     b=np.array([[128.0], [128.0]]))
    cam.set_exposure(1.0)
    fs = JFourierSLM(cam, slm)
    fs.calibrations["fourier"] = {
        "M": np.array([[4e3, 0.0], [0.0, 4e3]]),
        "b": np.array([[128.0], [128.0]]),
        "a": np.array([[0.0], [0.0]]),
    }
    return fs


def _jax_rig(side=128, M=((2.0e3, 50.0), (-50.0, 2.0e3)), aberration=None):
    """A Gaussian-source rig of ``side``^2, calibrated analytically."""
    M = np.array(M, float)
    b = np.array([[side / 2.0], [side / 2.0]])
    slm = JSLM(resolution=(side, side), pitch_um=(8, 8), wav_um=0.78)
    slm.set_source_analytic(
        "gaussian2d", sim=True, x0=0, y0=0, a=1, c=0,
        wx=0.35 * side * slm.pitch[0], wy=0.35 * side * slm.pitch[1],
    )
    cam = JSimCamera(slm, resolution=(side, side), pitch_um=(5.5, 5.5), M=M.copy(), b=b.copy())
    cam.set_exposure(1.0)
    fs = JFourierSLM(cam, slm)
    fs.fourier_calibrate_analytic(M.copy(), b.copy())
    if aberration is not None:
        slm.source["phase_sim"] = np.asarray(jphase.zernike_sum(slm, *aberration)).astype(
            np.float32)
    return fs


def _pair(jfs):
    return convert.rig_from_jax(jfs, device="cpu"), jfs


def _quiet(call, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return call(*args, **kwargs)


def _correction_rms(got, ref, weight):
    d = np.angle(np.exp(1j * (np.asarray(got) - np.asarray(ref))))
    piston = np.angle(np.sum(weight * np.exp(1j * d)))
    residual = np.angle(np.exp(1j * (d - piston)))
    return float(np.sqrt(np.sum(weight * residual**2) / np.sum(weight)))


# ----------------------------------------------------------------------
# Settle and pixel calibrations.
# ----------------------------------------------------------------------


@pytest.mark.parametrize("times", [np.linspace(0.001, 0.02, 6), 4])
def test_settle_calibration_matches_jax(times, monkeypatch):
    """``TestSettlePixelDifferential``'s settle calibration: the data
    (integrated counts) within one count per window pixel, and the port's
    fit of the same stored data (the JAX package's) held on what is
    well-posed. The simulated SLM settles at once, so the data are flat and
    the step-and-exponential fit (four parameters on four or six points) is
    ill-posed: a change of 1e-15 of the data, or a last bit of ``np.exp``,
    moves the fitted times by orders of magnitude, so they are not compared
    (their comparison failed or passed with the tests run before it in the
    process). Each fitted model at the sweep's points reproduces the data
    it was fitted to within one count per window pixel, as does the JAX
    package's, and the times are stored as returned."""
    fits = []
    curve_fit = optimize.curve_fit

    def spy(f, xdata, ydata, *args, **kwargs):
        params, cov = curve_fit(f, xdata, ydata, *args, **kwargs)
        fits.append((f(np.asarray(xdata), *params), np.asarray(ydata)))
        return params, cov

    monkeypatch.setattr(optimize, "curve_fit", spy)
    tfs, jfs = _pair(_jax_settle_rig())
    kwargs = dict(vector=(0.005, 0.005), times=times, settle_time_s=0.01)
    if np.isscalar(times):
        kwargs["size"] = 24
    got = _quiet(tfs.settle_calibrate, **kwargs)
    ref = _quiet(jfs.settle_calibrate, **kwargs)
    size = kwargs.get("size") or 16 * _quiet(
        jtoolbox.convert_radius, jfs.slm.get_spot_radius_kxy(), to_units="ij", hardware=jfs)
    count = int(size) ** 2
    np.testing.assert_array_equal(got["times"], ref["times"])
    np.testing.assert_allclose(got["data"], ref["data"], rtol=0, atol=count)
    tfs.calibrations["settle"]["data"] = np.array(ref["data"])
    fitted = _quiet(tfs.settle_calibration_process, plot=False)
    assert len(fits) == 3   # the port's, the JAX package's, the port's of the JAX data
    for model, data in fits:
        np.testing.assert_allclose(model, data, rtol=0, atol=count)
    np.testing.assert_array_equal(fits[2][1], np.squeeze(ref["data"]))
    for key in ("communication_time", "relax_time", "settle_time"):
        assert np.isfinite(fitted[key]) and tfs.calibrations["settle"][key] == fitted[key]
    assert _draws(lambda: _quiet(tfs.settle_calibration_process)) == fitted


@pytest.mark.parametrize("window", [None, (32, 64, 32, 64)])
def test_pixel_calibration_matches_jax(window):
    """``TestSettlePixelDifferential``'s 4-level sweep (direction, period,
    level a, level b): the integrated orders within one count per window
    pixel; the fitted phase response within FIT_RTOL."""
    tfs, jfs = _pair(_jax_settle_rig())
    kwargs = dict(levels=4, periods=[16, 32], orders=1, window=window)
    got = _quiet(tfs.pixel_calibrate, **kwargs)
    ref = _quiet(jfs.pixel_calibrate, **kwargs)
    for key in ("levels", "orders", "periods"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert got["levels"].dtype == ref["levels"].dtype
    size = 8  # min(order and field spacing) of this rig.
    np.testing.assert_allclose(got["data"], ref["data"], rtol=0, atol=size * size)
    assert np.abs(got["data"]).max() > 100
    fit_t = tfs.pixel_calibration_process()["phase_fit"]
    fit_j = jfs.pixel_calibration_process()["phase_fit"]
    np.testing.assert_array_equal(fit_t["levels"], fit_j["levels"])
    for key in ("phase", "amplitude", "rmse"):
        np.testing.assert_allclose(fit_t[key], fit_j[key], rtol=FIT_RTOL, atol=1e-9, err_msg=key)
    _draws(lambda: tfs.pixel_calibration_process(fit=False, plot=True))


@pytest.mark.parametrize("kwargs", [
    {}, {"a1_pix": 0.3, "a2_pix": 0.1, "n1": 2, "n2": 1}, {"a1_pix": 1.0, "n1": 0.5},
])
def test_pixel_kernel_matches_jax(kwargs):
    x = np.linspace(-2, 2, 9)
    np.testing.assert_allclose(TFourierSLM.pixel_kernel(x, **kwargs),
                               JFourierSLM.pixel_kernel(x, **kwargs), rtol=0, atol=EXACT_ATOL)


@pytest.mark.parametrize("kwargs,error", [
    (dict(periods=2), NotImplementedError),
    (dict(periods=[16, 17]), RuntimeError),
    (dict(periods=[16], orders=[0, 2]), ValueError),
])
def test_pixel_calibration_refusals_match_jax(kwargs, error):
    tfs, jfs = _pair(_jax_settle_rig())
    for fs in (tfs, jfs):
        with pytest.raises(error):
            _quiet(fs.pixel_calibrate, **kwargs)


def test_write_and_read_calibration_are_deprecated_aliases(tmp_path, monkeypatch):
    """``write_calibration`` saves and ``read_calibration`` loads, each
    with the JAX package's warning."""
    monkeypatch.chdir(tmp_path)
    tfs, _ = _pair(_jax_settle_rig())
    _quiet(tfs.settle_calibrate, times=np.linspace(0.001, 0.01, 4), settle_time_s=0.0)
    with pytest.warns(UserWarning, match="write_calibration is deprecated"):
        tfs.write_calibration("settle", str(tmp_path), None)
    stored = dict(tfs.calibrations["settle"])
    tfs.calibrations.pop("settle")
    with pytest.warns(UserWarning, match="read_calibration is deprecated"):
        tfs.read_calibration("settle")
    for key in ("times", "data", "settle_time"):
        np.testing.assert_array_equal(tfs.calibrations["settle"][key], stored[key])


# ----------------------------------------------------------------------
# Autoexposure and autofocus.
# ----------------------------------------------------------------------


def _bare_rig(which):
    """``TestCameraRoutinesDifferential``'s rig: a 128^2 SLM and camera."""
    slm_type, cam_type = (TSLM, TSimCamera) if which == "port" else (JSLM, JSimCamera)
    slm = slm_type((128, 128), pitch_um=(8, 8), wav_um=0.78)
    kwargs = {"device": "cpu"} if which == "port" else {}
    cam = cam_type(slm, (128, 128), pitch_um=(4, 4), M=np.array([[2.0e3, 0.0], [0.0, 2.0e3]]),
                   b=np.array([[64.0], [64.0]]), **kwargs)
    return slm, cam


@pytest.mark.parametrize("kwargs", [
    dict(set_fraction=0.4, tol=0.03),
    dict(set_fraction=0.5, tol=0.05, window=(64, 20, 64, 20)),
    dict(set_fraction=0.25, tol=0.02, exposure_bounds_s=(1e-3, 1e3)),
])
def test_autoexposure_matches_jax(kwargs):
    """The proportional search reaches the same exposure in both packages
    (the same frames give the same clipped steps)."""
    exposures = []
    for which in ("port", "jax"):
        slm, cam = _bare_rig(which)
        cam.set_exposure(0.37)
        slm.set_phase(None)
        exposures.append(_quiet(cam.autoexposure, verbose=False, **kwargs))
        assert cam.get_exposure() == exposures[-1]
    assert exposures[0] == exposures[1]


def test_autoexposure_rails_like_jax():
    for which in ("port", "jax"):
        slm, cam = _bare_rig(which)
        cam.set_exposure(0.37)
        slm.set_phase(None)
        with pytest.raises(RuntimeError, match="railed"):
            _quiet(cam.autoexposure, exposure_bounds_s=(0.36, 0.38), verbose=False)


def test_autofocus_metric_matches_jax():
    img = np.random.default_rng(3).integers(0, 255, (64, 48))
    np.testing.assert_allclose(TCamera._autofocus_metric(img), JCamera._autofocus_metric(img),
                               rtol=1e-12)
    assert _draws(lambda: TCamera._autofocus_metric(img, plot=True)) == \
        TCamera._autofocus_metric(img)


@pytest.mark.parametrize("range_z", [2, np.linspace(-1.5, 1.0, 9)])
def test_autofocus_with_the_slm_matches_jax(range_z):
    """``TestCameraRoutinesDifferential``'s autofocus: the SLM's defocus
    against a 0.4-rad focus injected in the simulated source; the same
    optimum in both packages, which compensates the injection, and the
    optimum kept in the SLM's correction."""
    z = []
    for which, phase in (("port", tphase), ("jax", jphase)):
        slm, cam = _bare_rig(which)
        aberration = 0.4 * np.asarray(phase.zernike(slm, index=4, weight=1.0, use_mask=False))
        slm.source["phase_sim"] = aberration.astype(np.float32)
        cam.set_exposure(1.0)
        slm.set_phase(None)
        z.append(_quiet(cam.autofocus, slm, get_z=0, range_z=range_z))
        np.testing.assert_allclose(
            slm.source["phase"], np.asarray(phase.zernike(slm, index=4, weight=z[-1],
                                                          use_mask=False)), atol=EXACT_ATOL)
    assert abs(z[0] - z[1]) < FOCUS_ATOL
    if np.isscalar(range_z):
        assert abs(z[0] + 0.434) < 0.01


def test_autofocus_with_a_stage_matches_jax():
    """A focus actuator that is a function (a stage), ``get_z`` a function:
    the Lorentzian's peak, in both packages."""
    z = []
    for which in ("port", "jax"):
        slm, cam = _bare_rig(which)
        cam.set_exposure(1.0)
        position = {"z": 0.3}

        def set_z(value, slm=slm, which=which):
            position["z"] = value
            lens = (tphase if which == "port" else jphase).zernike(
                slm, index=4, weight=float(value) - 0.5, use_mask=False)
            slm.set_phase(np.asarray(lens), settle=True)

        z.append(_quiet(cam.autofocus, set_z, get_z=lambda: position["z"], range_z=1.5))
        assert position["z"] == z[-1]
    assert abs(z[0] - z[1]) < FOCUS_ATOL


def test_autofocus_refusals_match_jax():
    for which in ("port", "jax"):
        _, cam = _bare_rig(which)

        def broken(value):
            raise OSError("stage offline")

        with pytest.raises(RuntimeError, match="no valid images"):
            cam.autofocus(broken)
        with pytest.raises(ValueError, match="function or SLM"):
            cam.autofocus(3.0)
    _draws(lambda: _quiet(_bare_rig("port")[1].autofocus, lambda z: None, plot=True))


# ----------------------------------------------------------------------
# The measured source and its grid.
# ----------------------------------------------------------------------


def _measured_slms(shape=(96, 80), center=(7.0, -5.0)):
    """Both packages' SLMs with the same measured, off-centre Gaussian
    source amplitude."""
    slms = (TSLM(shape[::-1], pitch_um=(8, 8), wav_um=0.78),
            JSLM(shape[::-1], pitch_um=(8, 8), wav_um=0.78))
    grid = np.meshgrid(np.arange(shape[1]) - shape[1] / 2 - center[0],
                       np.arange(shape[0]) - shape[0] / 2 - center[1])
    amp = np.exp(-(grid[0] ** 2 / 400 + grid[1] ** 2 / 250)) + 0.01
    for slm in slms:
        slm.source["amplitude"] = amp.copy()
    return slms


@pytest.mark.parametrize("method", ["moments", "fit"])
@pytest.mark.parametrize("extent_threshold", [0.1, 0.5])
def test_fit_source_amplitude_matches_jax(method, extent_threshold):
    """The centre, radius and extent of a measured source, and the grid
    re-centred on it, in both packages."""
    tslm, jslm = _measured_slms()
    for slm in (tslm, jslm):
        _quiet(slm.fit_source_amplitude, method=method, extent_threshold=extent_threshold)
    np.testing.assert_allclose(tslm.source["amplitude_center_pix"],
                               jslm.source["amplitude_center_pix"], rtol=0, atol=CENTER_ATOL)
    np.testing.assert_allclose(tslm.source["amplitude_radius"], jslm.source["amplitude_radius"],
                               rtol=RADIUS_RTOL)
    for key in ("amplitude_extent", "amplitude_extent_radius"):
        np.testing.assert_allclose(tslm.source[key], jslm.source[key], rtol=RADIUS_RTOL,
                                   err_msg=key)
    for t, j in zip(tslm.grid, jslm.grid):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    assert abs(tslm.source["amplitude_center_pix"][0] - (40 + 7.0)) <= 1
    # force=False keeps the fit.
    before = np.array(tslm.grid[0])
    tslm.source["amplitude"] = np.roll(tslm.source["amplitude"], 9, axis=1)
    tslm.fit_source_amplitude(force=False)
    np.testing.assert_array_equal(tslm.grid[0], before)


def test_fit_source_amplitude_refuses_an_extent_above_one():
    tslm, jslm = _measured_slms()
    for slm in (tslm, jslm):
        with pytest.raises(RuntimeError, match="extent_threshold"):
            slm.fit_source_amplitude(extent_threshold=2)


def test_regridded_slm_leaves_no_stale_device_copy():
    """``fit_source_amplitude`` re-centres ``slm.grid`` in place. The port
    keeps one device copy built from the grid, a compressed hologram's
    Zernike basis, built at construction as the JAX package builds it: a
    hologram made after the fit carries the new grid, one made before keeps
    its basis, in both packages. The simulated camera and the device
    measurement do not read the grid: a spot hologram on the rig measures
    the same spots before and after the fit, on the device and on the host
    image path."""
    jfs = _jax_rig(aberration=((4,), (0.5,)))
    tfs, _ = _pair(jfs)
    vectors = np.array([[-2e-3, 3e-3, 1e-3], [1e-3, 0.0, -2e-3]])
    np.random.seed(1)
    t_before = T.CompressedSpotHologram(vectors, basis="kxy", cameraslm=tfs.slm)
    np.random.seed(1)
    j_before = J.CompressedSpotHologram(vectors, basis="kxy", cameraslm=jfs.slm)

    spots = np.array([[40.0, 80.0], [60.0, 70.0]])
    np.random.seed(2)
    spot_holo = T.SpotHologram((256, 256), spots, basis="ij", cameraslm=tfs)
    tfs.cam.set_exposure(20.0)
    measured_before = spot_holo._sim_spot_powers()[0].copy()

    amp = np.roll(np.asarray(tfs.slm.source["amplitude_sim"]), (5, -3), axis=(0, 1))
    for slm in (tfs.slm, jfs.slm):
        slm.source["amplitude"] = amp.copy()
        slm.fit_source_amplitude()
    np.testing.assert_allclose(tfs.slm.grid[0], jfs.slm.grid[0], atol=1e-9)
    np.random.seed(1)
    t_after = T.CompressedSpotHologram(vectors, basis="kxy", cameraslm=tfs.slm)
    np.random.seed(1)
    j_after = J.CompressedSpotHologram(vectors, basis="kxy", cameraslm=jfs.slm)
    for t, j in ((t_before, j_before), (t_after, j_after)):
        np.testing.assert_allclose(t._basis, np.asarray(j._basis), rtol=0, atol=1e-5)
    assert np.abs(t_after._basis - t_before._basis).max() > 1e-3

    spot_holo._midloop_cleaning()
    measured_after = spot_holo._sim_spot_powers()[0]
    np.testing.assert_array_equal(measured_after, measured_before)
    spot_holo.measure("ij")
    host = tanalysis.take(np.square(np.asarray(spot_holo.img_ij, np.float64)), spot_holo.spot_ij,
                          spot_holo.spot_integration_width_ij, centered=True, integrate=True)
    assert np.abs(measured_after - host).max() <= spot_holo.spot_integration_width_ij ** 2


# ----------------------------------------------------------------------
# The state the superpixel calibration writes.
# ----------------------------------------------------------------------


SPOTS = np.array([[150.0, 110.0, 130.0], [150.0, 150.0, 100.0]])


def _spot_holograms(tfs, jfs):
    pair = []
    for pkg, fs in ((T, tfs), (J, jfs)):
        np.random.seed(4)
        pair.append(pkg.SpotHologram((512, 512), SPOTS, basis="ij", cameraslm=fs))
    return pair


def _camera_loop(holo, n=3):
    holo.optimize("WGS-Kim", feedback="experimental_spot", maxiter=n, verbose=False,
                  stat_groups=["experimental_spot"])
    return {key: float(holo.stats["stats"]["experimental_spot"][key][-1])
            for key in ("uniformity", "efficiency")}


def _host_spot_powers(holo):
    holo.measure("ij")
    return tanalysis.take(np.square(np.asarray(holo.img_ij, np.float64)), holo.spot_ij,
                          holo.spot_integration_width_ij, centered=True, integrate=True)


def test_hologram_measures_through_the_new_correction():
    """A hologram on the rig, optimized with camera feedback before the
    superpixel calibration, is optimized again after it: the device
    measurement runs through the new ``slm.source["phase"]`` (its cached
    constants are keyed on the correction's identity and content), so it
    agrees with the host image path (``set_phase`` adds the correction)
    within one count per window pixel, and the loop's measured stats agree
    with the JAX package's.

    ``source["amplitude"]``, which the processing also writes, is not in
    the cache key, and need not be: the measurement reads the simulated
    source (``amplitude_sim``, ``phase_sim``), the correction phase and the
    display; the measured amplitude enters only a hologram's nearfield
    model, which both packages read once, at construction.
    """
    jfs = _jax_rig(side=256, M=((4.0e3, 100.0), (-100.0, 4.0e3)), aberration=((4, 3),
                                                                             (1.5, -1.0)))
    tfs, _ = _pair(jfs)
    for fs in (tfs, jfs):
        fs.cam.set_exposure(30.0)
    tholo, jholo = _spot_holograms(tfs, jfs)
    before = [_camera_loop(h) for h in (tholo, jholo)]
    consts_before = tholo._sim_engine_inputs()[0]
    device_before = tholo._sim_spot_powers()[0]
    np.testing.assert_allclose(device_before, _host_spot_powers(tholo), rtol=0,
                               atol=tholo.spot_integration_width_ij ** 2)

    for fs in (tfs, jfs):
        exposure = fs.cam.get_exposure()
        fs.cam.set_exposure(1.0)
        np.random.seed(0)
        _quiet(fs.wavefront_calibrate_superpixel, calibration_points=np.array([[160.0],
                                                                              [110.0]]),
               superpixel_size=64, phase_steps=8, plot=-1)
        _quiet(fs.wavefront_calibration_superpixel_process, smooth=2, apply=True)
        fs.cam.set_exposure(exposure)
    assert _correction_rms(tfs.slm.source["phase"], jfs.slm.source["phase"],
                           jfs.slm.source["amplitude"]) <= CORRECTION_RMS

    after = [_camera_loop(h) for h in (tholo, jholo)]
    consts_after = tholo._sim_engine_inputs()[0]
    assert consts_after is not consts_before
    assert float((consts_after["sim_pre"] - consts_before["sim_pre"]).abs().max()) > 0.1
    device_after = tholo._sim_spot_powers()[0]
    np.testing.assert_allclose(device_after, _host_spot_powers(tholo), rtol=0,
                               atol=tholo.spot_integration_width_ij ** 2)
    for got, ref in zip((before[0], after[0]), (before[1], after[1])):
        for key in got:
            assert abs(got[key] - ref[key]) <= LOOP_STAT_ATOL, key


def test_stored_jax_calibrations_cross_and_process_alike():
    """``convert.rig_from_jax`` carries the superpixel, settle and pixel
    calibrations and the SLM's measured source (``amplitude``, ``phase``,
    ``r2``) across; the stored superpixel data processes to the JAX
    package's correction in the port."""
    jfs = _jax_rig(side=256, M=((4.0e3, 100.0), (-100.0, 4.0e3)), aberration=((4, 3),
                                                                             (1.5, -1.0)))
    np.random.seed(0)
    _quiet(jfs.wavefront_calibrate_superpixel, calibration_points=np.array([[160.0], [110.0]]),
           superpixel_size=64, phase_steps=8, plot=-1)
    _quiet(jfs.wavefront_calibration_superpixel_process, smooth=2, apply=True)
    jfs.calibrations["settle"] = {"times": np.linspace(0, 1, 5), "data": np.arange(5.0)}
    jfs.calibrations["pixel"] = {"levels": np.arange(4, dtype=np.uint8), "data": np.ones(3)}
    tfs = convert.rig_from_jax(jfs, device="cpu")
    for key in ("wavefront_superpixel", "settle", "pixel", "fourier"):
        assert set(tfs.calibrations[key]) == set(jfs.calibrations[key]), key
        for field, value in jfs.calibrations[key].items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(tfs.calibrations[key][field], value)
    for key in ("amplitude", "phase", "r2"):
        np.testing.assert_array_equal(tfs.slm.source[key], jfs.slm.source[key])
    got = _quiet(tfs.wavefront_calibration_superpixel_process, smooth=2, apply=False)
    ref = _quiet(jfs.wavefront_calibration_superpixel_process, smooth=2, apply=False)
    assert _correction_rms(got["phase"], ref["phase"], ref["amplitude"]) <= CORRECTION_RMS
    np.testing.assert_allclose(got["amplitude"], ref["amplitude"], rtol=0, atol=AMPLITUDE_ATOL)
    # The correction in force on the port's rig is the JAX package's.
    tfs.slm.set_phase(None)
    jfs.slm.set_phase(None)
    np.testing.assert_array_equal(tfs.slm.display, jfs.slm.display)


def test_stubs_stay_as_in_jax():
    """``NearfieldSLM`` raises in both packages; ``CameraSLM.plot`` draws the
    SLM's phase beside a camera frame, as the JAX package's does."""
    tfs, jfs = _pair(_jax_rig())
    with pytest.raises(NotImplementedError):
        JNearfieldSLM(jfs.cam, jfs.slm)
    with pytest.raises(NotImplementedError):
        TNearfieldSLM(tfs.cam, tfs.slm)
    taxs = _draws(lambda: TCameraSLM(tfs.cam, tfs.slm).plot(title="pair"))
    jaxs = _draws(lambda: JCameraSLM(jfs.cam, jfs.slm).plot(title="pair"))
    np.testing.assert_array_equal(taxs[0].images[0].get_array(), jaxs[0].images[0].get_array())
    # The camera frames of the same state: within a count.
    np.testing.assert_allclose(taxs[1].images[0].get_array(), jaxs[1].images[0].get_array(),
                               rtol=0, atol=1)


def _draws(call):
    """Run ``call`` under matplotlib's Agg backend; it must draw a figure.
    Closes every figure after. Returns what ``call`` returns."""
    import matplotlib.pyplot as plt

    plt.close("all")
    out = call()
    assert plt.get_fignums(), "no figure drawn"
    plt.close("all")
    return out
