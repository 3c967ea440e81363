"""
The simulated rig and the camera-in-the-loop WGS of the port against the
JAX package, on the CPU at a small size (128^2 SLM, 128^2 camera, 256^2
hologram): the analysis and toolbox copies, ``SimulatedCamera``,
``FourierSLM``, ``sim_measure_spots`` and the closed loop.

Inputs come from ``numpy.random.default_rng(seed)`` and are carried into
both packages; rigs cross with :mod:`slmsuite_torch.convert`. The display
quantization makes the closed loop discontinuous in psi (one ulp can flip
a gray level, and ``floor`` a camera count), so:

- one measurement of the SAME psi is held tightly: spot powers within
  1e-5 relative plus one count per window pixel;
- whole loops are held on what users read: the measured uniformity and
  efficiency within 2e-3 after 30 iterations, weights within 1e-2 of
  their maximum.
"""

import types

import numpy as np
import pytest
import torch

import slmsuite_torch
from slmsuite_torch import convert
from slmsuite_torch.hardware.cameras.simulated import SimulatedCamera as TCamera
from slmsuite_torch.hardware.cameraslms import FourierSLM as TFourierSLM
from slmsuite_torch.hardware.slms.simulated import SimulatedSLM as TSLM
from slmsuite_torch.holography import algorithms as T
from slmsuite_torch.holography import analysis as tanalysis
from slmsuite_torch.holography import toolbox as ttoolbox
from slmsuite_torch.models import engine_models as tmodels
from slmsuite_torch.ops import engine as TE
from slmsuite_tpu.hardware.cameras.simulated import SimulatedCamera as JCamera
from slmsuite_tpu.hardware.cameraslms import FourierSLM as JFourierSLM
from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM as JSLM
from slmsuite_tpu.holography import algorithms as J
from slmsuite_tpu.holography import analysis as janalysis
from slmsuite_tpu.holography import toolbox as jtoolbox
from slmsuite_tpu.ops import engine as JE


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


torch.set_num_threads(1)

SIDE, SHAPE = 128, (256, 256)
RIG_M = np.array([[2.0e3, 50.0], [-50.0, 2.0e3]])
RIG_B = np.array([[64.0], [64.0]])
SPOTS_4 = np.array([[40.0, 64, 88, 64], [64.0, 40, 64, 88]])
#: A 4 x 4 grid at 16-pixel pitch centered on the camera's center.
SPOTS_GRID = np.array([
    (x, y) for y in 64 + 16 * (np.arange(4) - 1.5) for x in 64 + 16 * (np.arange(4) - 1.5)
]).T

#: One measurement of the same psi: relative, plus one count per window pixel.
POWER_RTOL = 1e-5
#: Whole loops: measured uniformity and efficiency, and weights over their max.
LOOP_STAT_ATOL = 2e-3
LOOP_WEIGHT_ATOL = 1e-2


@pytest.fixture(autouse=True)
def _cpu_default():
    previous = slmsuite_torch.resolve_device(None)
    slmsuite_torch.set_default_device("cpu")
    yield
    slmsuite_torch.set_default_device(previous)


def _jax_rig(calibrated=True, M=RIG_M, b=RIG_B, pitch_um=(8, 8), side=SIDE, **cam_kwargs):
    slm = JSLM(resolution=(side, side), pitch_um=pitch_um, wav_um=0.78)
    slm.set_source_analytic(
        "gaussian2d", sim=True, x0=0, y0=0, a=1, c=0,
        wx=0.35 * side * slm.pitch[0], wy=0.35 * side * slm.pitch[1],
    )
    cam = JCamera(slm, resolution=(side, side), pitch_um=(5.5, 5.5),
                  M=None if M is None else M.copy(), b=None if b is None else b.copy(),
                  **cam_kwargs)
    cam.set_exposure(1.0)
    fs = JFourierSLM(cam, slm)
    if calibrated:
        fs.fourier_calibrate_analytic(RIG_M.copy(), RIG_B.copy())
    return fs


def _rigs(**kwargs):
    """The same rig in both packages (the port's through convert)."""
    jfs = _jax_rig(**kwargs)
    return convert.rig_from_jax(jfs, device="cpu"), jfs


def _phase(seed, shape=(SIDE, SIDE)):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, shape).astype(np.float32)


def _holograms(tfs, jfs, spots=SPOTS_4, seed=3, shape=SHAPE):
    phase = _phase(seed)
    jholo = J.SpotHologram(shape, spots.copy(), basis="ij", cameraslm=jfs)
    jholo.reset_phase(custom_phase=phase)
    tholo = T.SpotHologram(shape, spots.copy(), basis="ij", cameraslm=tfs, phase=phase)
    return tholo, jholo


# ----------------------------------------------------------------------
# analysis and toolbox copies.
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    dict(centered=True, integrate=True),
    dict(centered=True, integrate=False),
    dict(centered=False, integrate=True),
    dict(centered=True, integrate=False, clip=True),
    dict(centered=True, integrate=True, return_mask=True),
])
def test_take_matches_jax(kwargs):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (64, 96))
    vectors = rng.uniform(8, 56, (2, 7))
    if kwargs.get("clip"):
        vectors[:, 0] = (1.2, 62.5)  # A window that leaves the frame.
    got = tanalysis.take(img, vectors, 7, **kwargs)
    ref = janalysis.take(img, vectors, 7, **kwargs)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("integrate", [True, False])
def test_take_takes_numpy_xp_like_jax(integrate):
    """``take(..., xp=numpy)``, the JAX package's signature, gives what the
    default gives; ``xp=torch`` gathers the same values into a tensor on
    the image's device (sums in float64); another module raises."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (64, 96))
    vectors = rng.uniform(8, 56, (2, 5))
    got = tanalysis.take(img, vectors, 7, integrate=integrate, xp=np)
    np.testing.assert_array_equal(got, janalysis.take(img, vectors, 7, integrate=integrate,
                                                      xp=np))
    np.testing.assert_array_equal(got, tanalysis.take(img, vectors, 7, integrate=integrate))
    on_device = tanalysis.take(torch.as_tensor(img), vectors, 7, integrate=integrate, xp=torch)
    assert torch.is_tensor(on_device) and on_device.device == torch.device("cpu")
    # The float64 sums run in torch's order (same values, summed otherwise).
    np.testing.assert_allclose(on_device.numpy(), got, rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="numpy or torch"):
        tanalysis.take(img, vectors, 7, integrate=integrate, xp=types)


def test_take_off_frame_raises_like_jax():
    img = np.zeros((32, 32))
    for module in (tanalysis, janalysis):
        with pytest.raises(IndexError):
            module.take(img, [[30], [30]], 9, centered=True, integrate=True)


def test_image_helpers_match_jax():
    rng = np.random.default_rng(1)
    stack = rng.uniform(0, 10, (5, 9, 9))
    np.testing.assert_allclose(tanalysis.image_positions(stack),
                               janalysis.image_positions(stack), rtol=1e-12)
    np.testing.assert_allclose(tanalysis.image_moment(stack, (2, 0)),
                               janalysis.image_moment(stack, (2, 0)), rtol=1e-12)
    np.testing.assert_allclose(tanalysis.image_remove_field(stack.copy(), deviations=None),
                               janalysis.image_remove_field(stack.copy(), deviations=None),
                               rtol=1e-12)
    np.testing.assert_allclose(tanalysis.image_normalize(stack),
                               janalysis.image_normalize(stack), rtol=1e-12)


def test_fit_affine_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 12))
    y = RIG_M @ x + RIG_B + rng.normal(0, 1e-3, (2, 12))
    got, ref = tanalysis.fit_affine(x, y), janalysis.fit_affine(x, y)
    np.testing.assert_allclose(got["M"], ref["M"], rtol=1e-10)
    np.testing.assert_allclose(got["b"], ref["b"], rtol=1e-10)
    np.testing.assert_allclose(got["M"], RIG_M, rtol=1e-3)


@pytest.mark.parametrize("rot, fliplr, flipud", [("0", False, False), ("90", True, False),
                                                  ("180", False, True), (3, True, True)])
def test_orientation_transformation_matches_jax(rot, fliplr, flipud):
    probe = np.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(
        tanalysis.get_orientation_transformation(rot, fliplr, flipud)(probe),
        janalysis.get_orientation_transformation(rot, fliplr, flipud)(probe),
    )


@pytest.mark.parametrize("transform, shift, direction", [
    (None, None, "fwd"), (0.3, (1.0, -2.0), "fwd"), (RIG_M, RIG_B, "fwd"),
    (RIG_M, RIG_B, "rev"), (0, (3.0, 4.0), "rev"), (0.3, True, "fwd"),
])
def test_transform_grid_matches_jax(transform, shift, direction):
    grid = np.meshgrid(np.linspace(-1, 1, 9), np.linspace(-2, 2, 7))
    got = ttoolbox.transform_grid(grid, transform, shift, direction)
    ref = jtoolbox.transform_grid(grid, transform, shift, direction)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(3, 4), [5, 6], np.array([[7, 8]])])
def test_format_shape_matches_jax(shape):
    assert ttoolbox.format_shape(shape) == jtoolbox.format_shape(shape)


@pytest.mark.parametrize("from_units, to_units", [
    ("ij", "kxy"), ("kxy", "ij"), ("ij", "knm"), ("knm", "ij"), ("um", "kxy"),
    ("kxy", "mm"), ("mag_um", "ij"), ("ij", "mag_mm"), ("ij", "zernike"), ("freq", "ij"),
])
@pytest.mark.parametrize("dims", [2, 3])
def test_convert_vector_camera_units_match_jax(from_units, to_units, dims):
    tfs, jfs = _rigs()
    tfs.mag = jfs.mag = 2.5
    rng = np.random.default_rng(4)
    vectors = rng.uniform(20, 100, (dims, 6))
    if from_units in ("kxy", "freq"):
        vectors[:2] = rng.uniform(-0.01, 0.01, (2, 6))
    if dims == 3:
        vectors[2] = rng.uniform(-1e-6, 1e-6, 6) if from_units in ("kxy", "freq") \
            else rng.uniform(-50, 50, 6)
    got = ttoolbox.convert_vector(vectors, from_units, to_units, hardware=tfs, shape=SHAPE)
    ref = jtoolbox.convert_vector(vectors, from_units, to_units, hardware=jfs, shape=SHAPE)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-14)


def test_convert_vector_camera_units_need_a_calibration():
    tfs, jfs = _rigs(calibrated=False)
    for toolbox, fs in ((ttoolbox, tfs), (jtoolbox, jfs)):
        with pytest.warns(UserWarning, match="Fourier-calibrated"):
            out = toolbox.convert_vector([[1.0], [2.0]], "ij", "kxy", hardware=fs)
        assert np.isnan(out).all()
        with pytest.warns(UserWarning, match="Fourier-calibrated"):
            out = toolbox.convert_vector([[1.0], [2.0]], "ij", "kxy", hardware=fs.slm)
        assert np.isnan(out).all()


@pytest.mark.parametrize("from_units, to_units", [("kxy", "ij"), ("ij", "knm"), ("kxy", "knm")])
def test_convert_radius_matches_jax(from_units, to_units):
    tfs, jfs = _rigs()
    radius = 0.002 if from_units == "kxy" else 5.0
    got = ttoolbox.convert_radius(radius, from_units, to_units, hardware=tfs, shape=SHAPE)
    ref = jtoolbox.convert_radius(radius, from_units, to_units, hardware=jfs, shape=SHAPE)
    np.testing.assert_allclose(got, ref, rtol=1e-10)


# ----------------------------------------------------------------------
# SimulatedCamera.
# ----------------------------------------------------------------------


@pytest.mark.parametrize("pitch_um", [(8, 8), (8, 12)])
def test_camera_geometry_matches_jax(pitch_um):
    """``shape_padded``, ``knm_cam`` (rows take pitch[1], columns pitch[0])
    and the gather maps (``floor(x + 0.5)``) equal the JAX camera's."""
    tfs, jfs = _rigs(pitch_um=pitch_um)
    tcam, jcam = tfs.cam, jfs.cam
    assert tuple(tcam.shape_padded) == tuple(jcam.shape_padded) == (256, 256)
    np.testing.assert_allclose(tcam.knm_cam, jcam.knm_cam, rtol=1e-12)
    for g, r in zip(tcam.grid, jcam.grid):
        np.testing.assert_allclose(g, r, rtol=1e-12)
    flat, valid = tcam._sample_maps()
    jflat, jvalid = jcam._sample_maps()
    assert flat.dtype == np.int64
    np.testing.assert_array_equal(flat, np.asarray(jflat))
    np.testing.assert_array_equal(valid, np.asarray(jvalid))


def test_camera_off_kspace_warns_and_masks():
    """A camera reaching past the SLM's k-space warns in both packages and
    its outside pixels read 0."""
    M = RIG_M / 8
    with pytest.warns(UserWarning, match="beyond the accessible"):
        jfs = _jax_rig(M=M)
    with pytest.warns(UserWarning, match="beyond the accessible"):
        tfs = convert.rig_from_jax(jfs, device="cpu")
    flat, valid = tfs.cam._sample_maps()
    jflat, jvalid = jfs.cam._sample_maps()
    np.testing.assert_array_equal(flat, np.asarray(jflat))
    np.testing.assert_array_equal(valid, np.asarray(jvalid))
    assert valid.min() == 0
    assert (tfs.cam.get_image()[valid == 0] == 0).all()


def _display(fs_pair, seed):
    phase = _phase(seed)
    for fs in fs_pair:
        fs.slm.set_phase(phase.copy())
    np.testing.assert_array_equal(fs_pair[0].slm.display, fs_pair[1].slm.display)


def test_camera_image_matches_jax():
    """The same display gives the same frame, to one count (the farfield
    power differs by float32 rounding before the cast)."""
    tfs, jfs = _rigs()
    _display((tfs, jfs), 5)
    for exposure in (1.0, 400.0):
        tfs.cam.set_exposure(exposure)
        jfs.cam.set_exposure(exposure)
        got, ref = tfs.cam.get_image(), jfs.cam.get_image()
        assert got.dtype == ref.dtype and got.shape == ref.shape == (SIDE, SIDE)
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert got.max() == 255  # Saturated at exposure 400.


def test_camera_image_with_seeded_noise_matches_jax():
    def noise():
        return {
            "dark": lambda x: np.random.default_rng(7).poisson(0.02 * x),
            "read": lambda x: np.random.default_rng(8).normal(0.01 * x, 0.002 * x),
        }

    tfs, jfs = _rigs(noise=noise())
    assert tfs.cam.noise is jfs.cam.noise
    _display((tfs, jfs), 6)
    got, ref = tfs.cam.get_image(), jfs.cam.get_image()
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    quiet = convert.rig_from_jax(_jax_rig(), device="cpu")
    quiet.slm.set_phase(_phase(6))
    assert (got.astype(int) - quiet.cam.get_image().astype(int)).mean() > 1
    tfs.cam.noise = {"shot": lambda x: x}
    with pytest.raises(RuntimeError, match="Unknown noise"):
        tfs.cam.get_image()


def test_camera_without_affine_matches_jax():
    """No affine: pixels map one-to-one onto the SLM's farfield."""
    tfs, jfs = _rigs(calibrated=False, M=None, b=None)
    assert not tfs.cam._interpolate and tuple(tfs.cam.shape_padded) == (SIDE, SIDE)
    _display((tfs, jfs), 9)
    tfs.cam.set_exposure(200.0)
    jfs.cam.set_exposure(200.0)
    got, ref = tfs.cam.get_image(), jfs.cam.get_image()
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1 and got.max() > 10


def test_camera_averaging_hdr_and_stack_match_jax():
    tfs, jfs = _rigs()
    _display((tfs, jfs), 10)
    for kwargs in (dict(averaging=4), dict(hdr=3)):
        got, ref = tfs.cam.get_image(**kwargs), jfs.cam.get_image(**kwargs)
        assert got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, atol=4)
    got, ref = tfs.cam.get_images(2), jfs.cam.get_images(2)
    assert got.shape == ref.shape == (2, SIDE, SIDE)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("kwargs", [
    dict(f_eff=2.0e3, units="ij"),
    dict(f_eff=(1.0e4, 1.1e4), units="norm", theta=0.1, shear_angle=0.02),
    dict(f_eff=80.0, units="mm", theta=-0.2, offset=(10, 20)),
])
def test_build_affine_matches_jax(kwargs):
    tfs, jfs = _rigs()
    got, ref = tfs.cam.build_affine(**kwargs), jfs.cam.build_affine(**kwargs)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-12)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-12)
    built, jbuilt = tfs.fourier_calibration_build(**kwargs), jfs.fourier_calibration_build(**kwargs)
    np.testing.assert_allclose(built[0], jbuilt[0], rtol=1e-12)
    np.testing.assert_allclose(built[1], jbuilt[1], rtol=1e-12)


def test_camera_hologram_draws_no_random_phase():
    """Building a camera (and its internal hologram) leaves numpy's
    global generator where it was."""
    np.random.seed(123)
    expected = np.random.uniform()
    np.random.seed(123)
    tmodels.camera_loop_rig(slm_side=SIDE, cam_side=SIDE, M=RIG_M, device="cpu")
    assert np.random.uniform() == expected


# ----------------------------------------------------------------------
# FourierSLM.
# ----------------------------------------------------------------------


def test_rig_conversion_copies_the_rig():
    tfs, jfs = _rigs()
    assert isinstance(tfs, TFourierSLM) and isinstance(tfs.cam, TCamera)
    assert isinstance(tfs.slm, TSLM) and tfs.name == jfs.name
    assert tfs.slm.shape == jfs.slm.shape and tfs.cam.shape == jfs.cam.shape
    assert tfs.slm.bitdepth == jfs.slm.bitdepth and tfs.cam.bitdepth == jfs.cam.bitdepth
    np.testing.assert_array_equal(tfs.slm.source["amplitude_sim"], jfs.slm.source["amplitude_sim"])
    assert tfs.slm.source["amplitude_sim"] is not jfs.slm.source["amplitude_sim"]
    for key in ("M", "b", "a"):
        np.testing.assert_array_equal(tfs.calibrations["fourier"][key],
                                      jfs.calibrations["fourier"][key])
    assert tfs.cam.exposure_s == jfs.cam.exposure_s and tfs.cam.gain == jfs.cam.gain


def test_fourier_transforms_match_jax():
    tfs, jfs = _rigs()
    rng = np.random.default_rng(11)
    kxy = rng.uniform(-0.01, 0.01, (2, 5))
    ij = rng.uniform(0, SIDE, (2, 5))
    np.testing.assert_allclose(tfs.kxyslm_to_ijcam(kxy), jfs.kxyslm_to_ijcam(kxy), rtol=1e-12)
    np.testing.assert_allclose(tfs.ijcam_to_kxyslm(ij), jfs.ijcam_to_kxyslm(ij), rtol=1e-12)
    np.testing.assert_allclose(tfs.ijcam_to_kxyslm(tfs.kxyslm_to_ijcam(kxy)), kxy, rtol=1e-9)
    kxyz = np.vstack((kxy, rng.uniform(-1e-6, 1e-6, (1, 5))))
    np.testing.assert_allclose(tfs.kxyslm_to_ijcam(kxyz), jfs.kxyslm_to_ijcam(kxyz), rtol=1e-12)
    ijz = np.vstack((ij, rng.uniform(-20, 20, (1, 5))))
    np.testing.assert_allclose(tfs.ijcam_to_kxyslm(ijz), jfs.ijcam_to_kxyslm(ijz), rtol=1e-12)
    for units in ("ij", "norm", "mm"):
        np.testing.assert_allclose(tfs.get_effective_focal_length(units),
                                   jfs.get_effective_focal_length(units), rtol=1e-12)
    for basis in ("kxy", "ij"):
        np.testing.assert_allclose(tfs.get_farfield_spot_size(basis=basis),
                                   jfs.get_farfield_spot_size(basis=basis), rtol=1e-10)
        np.testing.assert_allclose(tfs.get_farfield_spot_size(50.0, basis=basis),
                                   jfs.get_farfield_spot_size(50.0, basis=basis), rtol=1e-10)


def test_fourier_transforms_need_a_calibration():
    tfs, _ = _rigs(calibrated=False)
    for call in (lambda: tfs.kxyslm_to_ijcam([0, 0]), lambda: tfs.ijcam_to_kxyslm([0, 0]),
                 lambda: tfs.get_effective_focal_length()):
        with pytest.raises(RuntimeError, match="Fourier calibration"):
            call()
    with pytest.raises(ValueError, match="2x2"):
        tfs.fourier_calibrate_analytic(np.eye(3), (0, 0))


def test_analytic_calibration_sets_a_bare_camera_affine():
    """``fourier_calibrate_analytic`` on a camera without an affine places
    it, as in the JAX package."""
    tfs, jfs = _rigs(calibrated=False, M=None, b=None)
    for fs in (tfs, jfs):
        fs.fourier_calibrate_analytic(RIG_M.copy(), RIG_B.copy())
    assert tfs.cam._interpolate and jfs.cam._interpolate
    np.testing.assert_allclose(tfs.cam.knm_cam, jfs.cam.knm_cam, rtol=1e-12)


def test_calibration_save_load_roundtrip(tmp_path, monkeypatch):
    tfs, _ = _rigs()
    path = tfs.save_calibration("fourier", path=str(tmp_path))
    assert path.endswith("camera-SLM-fourier-calibration_00000.h5")
    other, _ = _rigs(calibrated=False)
    assert other.load_calibration("fourier", file_path=path) == path
    for key in ("M", "b", "a"):
        np.testing.assert_array_equal(other.calibrations["fourier"][key],
                                      tfs.calibrations["fourier"][key])
    monkeypatch.chdir(tmp_path)
    latest, _ = _rigs(calibrated=False)
    assert latest.load_calibration("fourier") == path
    with pytest.raises(ValueError, match="Could not find"):
        tfs.save_calibration("wavefront")
    with pytest.raises(FileNotFoundError):
        latest.load_calibration("pixel")


def test_padded_shape_matches_jax():
    tfs, jfs = _rigs()
    cases = [
        dict(), dict(padding_order=2), dict(padding_order=0, square_padding=False),
        dict(precision=1e-4), dict(precision=0.25, precision_basis="ij"),
    ]
    for kwargs in cases:
        assert T.Hologram.get_padded_shape(tfs, **kwargs) == tuple(
            int(v) for v in J.Hologram.get_padded_shape(jfs, **kwargs))
        if kwargs.get("precision_basis") != "ij":
            assert T.Hologram.get_padded_shape(tfs.slm, **kwargs) == tuple(
                int(v) for v in J.Hologram.get_padded_shape(jfs.slm, **kwargs))
    assert T.Hologram.get_padded_shape((100, 60)) == (128, 128)
    with pytest.raises(ValueError, match="CameraSLM"):
        T.Hologram.get_padded_shape(tfs.slm, precision=0.5, precision_basis="ij")
    with pytest.raises(ValueError, match="precision"):
        T.Hologram.get_padded_shape((64, 64), precision=0.5)


def test_fourier_grid_project_matches_jax():
    """The projected calibration grid: same spots, and a camera frame with
    its peaks in the same places."""
    tfs, jfs = _rigs(calibrated=False)
    np.random.seed(21)
    jholo = jfs.fourier_grid_project(array_shape=4, array_pitch=16, verbose=False)
    np.random.seed(21)
    tholo = tfs.fourier_grid_project(array_shape=4, array_pitch=16, verbose=False)
    np.testing.assert_array_equal(tholo.spot_knm, jholo.spot_knm)
    np.testing.assert_allclose(tholo.spot_kxy_rounded, jholo.spot_kxy_rounded, rtol=1e-12)
    assert tholo.shape == tuple(jholo.shape) and len(tholo) == 14
    got, ref = tfs.cam.get_image().astype(float), jfs.cam.get_image().astype(float)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.99


def test_fourier_calibrate_matches_jax():
    """The measured calibration (OpenCV blob detection) recovers the
    camera's affine in both packages, from the same initial phase (on a
    256^2 rig: at 128^2 the spots are too wide for the blob detector)."""
    pytest.importorskip("cv2")
    M, b = 2 * RIG_M, 2 * RIG_B
    tfs, jfs = _rigs(calibrated=False, M=M, b=b, side=256)
    np.random.seed(22)
    ref = jfs.fourier_calibrate(array_shape=5, array_pitch=16, verbose=False)
    np.random.seed(22)
    got = tfs.fourier_calibrate(array_shape=5, array_pitch=16, verbose=False)
    np.testing.assert_allclose(got["M"], ref["M"], rtol=2e-3, atol=4.0)
    np.testing.assert_allclose(got["M"], M, rtol=2e-2, atol=40.0)
    probe = np.array([[0.0, 0.005, -0.005], [0.0, 0.005, 0.005]])
    truth = M @ probe + b
    assert np.abs(tfs.kxyslm_to_ijcam(probe) - truth).max() < 1.0
    assert np.abs(tfs.kxyslm_to_ijcam(probe) - jfs.kxyslm_to_ijcam(probe)).max() < 0.1
    assert {"__version__", "__time__", "__timestamp__", "__meta__"} <= set(got)


# ----------------------------------------------------------------------
# SpotHologram on a rig.
# ----------------------------------------------------------------------


@pytest.mark.parametrize("basis", ["ij", "kxy", "knm"])
def test_spot_bases_match_jax(basis):
    tfs, jfs = _rigs()
    vectors = {"ij": SPOTS_4, "knm": np.array([[100.0, 140.5, 150.2], [120.0, 99.7, 160.0]]),
               "kxy": np.array([[-0.008, 0.004, 0.0], [0.002, -0.006, 0.009]])}[basis]
    t = T.SpotHologram(SHAPE, vectors, basis=basis, cameraslm=tfs, phase=_phase(0))
    j = J.SpotHologram(SHAPE, vectors, basis=basis, cameraslm=jfs)
    for attr in ("spot_knm", "spot_kxy", "spot_ij", "spot_knm_rounded", "spot_kxy_rounded",
                 "spot_ij_rounded", "spot_amp"):
        np.testing.assert_allclose(getattr(t, attr), getattr(j, attr), rtol=1e-10, err_msg=attr)
    assert t.spot_integration_width_knm == j.spot_integration_width_knm
    assert t.spot_integration_width_ij == j.spot_integration_width_ij
    np.testing.assert_allclose(t.target, np.asarray(j.target), atol=1e-7)
    np.testing.assert_allclose(t.amp, np.asarray(j.amp), rtol=1e-6)
    assert t.cameraslm is tfs


def test_spot_bases_without_calibration_match_jax():
    tfs, jfs = _rigs(calibrated=False)
    t = T.SpotHologram(SHAPE, [[0.004], [0.002]], basis="kxy", cameraslm=tfs, phase=_phase(0))
    j = J.SpotHologram(SHAPE, [[0.004], [0.002]], basis="kxy", cameraslm=jfs)
    assert t.spot_ij is None and j.spot_ij is None and t.spot_integration_width_ij is None
    np.testing.assert_allclose(t.spot_knm, j.spot_knm, rtol=1e-12)
    bare = T.SpotHologram(SHAPE, [[0.004], [0.002]], basis="kxy", cameraslm=tfs.slm,
                          phase=_phase(0))
    np.testing.assert_allclose(bare.spot_knm, j.spot_knm, rtol=1e-12)
    assert bare.cameraslm is None
    with pytest.raises(ValueError, match="Fourier-calibrated"):
        T.SpotHologram(SHAPE, SPOTS_4, basis="ij", cameraslm=tfs)
    with pytest.raises(ValueError, match="Unrecognized basis"):
        T.SpotHologram(SHAPE, SPOTS_4, basis="uv", cameraslm=tfs)


def test_spot_bounds_match_jax():
    tfs, jfs = _rigs()
    for module, fs in ((T, tfs), (J, jfs)):
        with pytest.raises(ValueError, match="camera bounds"):
            module.SpotHologram(SHAPE, [[2.0], [64.0]], basis="ij", cameraslm=fs)
        with pytest.raises(ValueError, match="computational space"):
            module.SpotHologram(SHAPE, [[0.2], [0.0]], basis="kxy", cameraslm=fs)


@pytest.mark.parametrize("basis", ["ij", "kxy", "knm"])
def test_rectangular_array_bases_match_jax(basis):
    tfs, jfs = _rigs()
    pitch = {"ij": 12, "kxy": 0.004, "knm": 10}[basis]
    t = T.SpotHologram.make_rectangular_array(
        SHAPE, (3, 4), pitch, basis=basis, orientation_check=True, cameraslm=tfs,
        phase=_phase(0))
    j = J.SpotHologram.make_rectangular_array(
        SHAPE, (3, 4), pitch, basis=basis, orientation_check=True, cameraslm=jfs)
    assert len(t) == len(j) == 10
    np.testing.assert_allclose(t.spot_knm, j.spot_knm, rtol=1e-10)
    np.testing.assert_allclose(t.spot_ij, j.spot_ij, rtol=1e-10)


def test_measure_matches_jax():
    """``measure`` writes the phase to the SLM and caches the frame's
    amplitude; a new phase clears the cache; ``measure("knm")`` resamples
    the cached frame into the computational basis."""
    tfs, jfs = _rigs()
    tholo, jholo = _holograms(tfs, jfs)
    for holo in (tholo, jholo):
        holo.measure(basis="ij")
    np.testing.assert_array_equal(tfs.slm.display, jfs.slm.display)
    np.testing.assert_allclose(np.square(tholo.img_ij), np.square(jholo.img_ij), atol=1.0)
    cached = tholo.img_ij
    tholo.measure("ij")
    assert tholo.img_ij is cached
    tholo.optimize("GS", maxiter=1, verbose=False)
    assert tholo.img_ij is None
    tholo, jholo = _holograms(tfs, jfs)
    for holo in (tholo, jholo):
        holo.cameraslm.cam.set_exposure(30.0)  # Counts to resample.
        holo.measure("knm")
    scale = np.nanmax(jholo.img_knm)
    np.testing.assert_allclose(tholo.img_knm / scale, jholo.img_knm / scale, atol=1e-2,
                               equal_nan=True)
    shifts = tholo.refine_offset(basis=None)
    assert shifts.shape == (2, 4) and np.all(np.isfinite(shifts))


# ----------------------------------------------------------------------
# sim_measure_spots and its inputs.
# ----------------------------------------------------------------------


def _sim_pair(spots=SPOTS_4, kernel=False, correction=False, aberration=False):
    tfs, jfs = _rigs()
    rng = np.random.default_rng(13)
    for fs in (tfs, jfs):
        if correction:
            fs.slm.source["phase"] = np.random.default_rng(14).uniform(-1, 1, (SIDE, SIDE))
        if aberration:
            fs.slm.source["phase_sim"] = np.random.default_rng(15).uniform(-1, 1, (SIDE, SIDE))
    tholo, jholo = _holograms(tfs, jfs, spots=spots)
    if kernel:
        k = rng.uniform(-1, 1, (SIDE, SIDE)).astype(np.float32)
        tholo.propagation_kernel, jholo.propagation_kernel = k, k.copy()
    return tholo, jholo


def _window_pixels(holo):
    return holo.spot_integration_width_ij ** 2


@pytest.mark.parametrize("options", [
    dict(), dict(spots=SPOTS_GRID), dict(kernel=True), dict(correction=True),
    dict(aberration=True), dict(kernel=True, correction=True, aberration=True),
])
@pytest.mark.parametrize("exposure", [1.0, 30.0])
def test_sim_measure_spots_matches_jax(options, exposure):
    """The device measurement on the SAME psi: constants equal, spot powers
    within 1e-5 relative plus one count per window pixel."""
    tholo, jholo = _sim_pair(**options)
    for holo in (tholo, jholo):
        holo.cameraslm.cam.set_exposure(exposure)
    tconsts, tstatics = tholo._sim_engine_inputs()
    jconsts, jstatics = jholo._sim_engine_inputs()
    assert tstatics == jstatics
    for key in jconsts:
        np.testing.assert_allclose(tconsts[key].numpy().reshape(-1),
                                   np.asarray(jconsts[key]).reshape(-1), atol=1e-6, err_msg=key)
    assert tconsts["sim_flat_cam"].dtype == tconsts["sim_spot_flat"].dtype == torch.int64

    psi = _phase(16) * 3  # Any range: the quantization wraps.
    got_spots, got_total = TE.sim_measure_spots(
        torch.as_tensor(psi), {**tconsts, "sim_scale": tholo._sim_scale()}, **tstatics)
    import jax.numpy as jnp
    ref_spots, ref_total = JE.sim_measure_spots(
        jnp.asarray(psi), {**jconsts, "sim_scale": jholo._sim_scale()}, **jstatics)
    ref_spots = np.asarray(ref_spots)
    slack = POWER_RTOL * ref_spots + _window_pixels(tholo)
    assert (np.abs(got_spots.numpy() - ref_spots) <= slack).all()
    assert abs(float(got_total) - float(ref_total)) <= POWER_RTOL * float(ref_total) + SIDE * SIDE
    assert ref_spots.min() > 100 or exposure == 1.0  # The comparison has signal.


def test_sim_measure_agrees_with_the_host_image_path():
    """Two routes to the same spot powers in the port: the device
    measurement of psi, and ``set_phase`` -> ``get_image`` -> ``take``;
    equal to one count per window pixel."""
    tholo, jholo = _sim_pair(aberration=True)
    tholo.cameraslm.cam.set_exposure(20.0)
    tholo.optimize("WGS-Leonardo", maxiter=3, verbose=False)
    fast_spots, fast_total = tholo._sim_spot_powers()
    assert tholo._sim_spot_powers()[0] is fast_spots  # Cached for this phase.
    tholo.measure("ij")
    pwr_img = np.square(np.asarray(tholo.img_ij, np.float64))
    host = tanalysis.take(pwr_img, tholo.spot_ij, tholo.spot_integration_width_ij,
                          centered=True, integrate=True)
    assert np.abs(fast_spots - host).max() <= _window_pixels(tholo)
    assert abs(fast_total - pwr_img.sum()) <= SIDE * SIDE
    assert host.min() > 100


def _disqualify(fs, how):
    if how == "noise":
        fs.cam.noise = {"dark": lambda x: 0 * x}
    elif how == "averaging":
        fs.cam.averaging = 2
    elif how == "hdr":
        fs.cam.hdr = (2, 2)
    elif how == "transform":
        fs.cam.transform = np.fliplr
    elif how == "phase_scaling":
        fs.slm.phase_scaling = 0.9
    elif how == "no_affine":
        fs.cam._interpolate = False


@pytest.mark.parametrize("how", ["noise", "averaging", "hdr", "transform", "phase_scaling",
                                 "no_affine", "window_off_frame", "no_cameraslm"])
def test_sim_engine_inputs_disqualifications(how):
    """A rig the device measurement does not model gives None in both
    packages; camera feedback and camera stats then take the host loop,
    whose measured stats agree with the JAX package's, or, with no frame
    to integrate (a window off the frame, no camera), raise in both."""
    tfs, jfs = _rigs()
    tholo, jholo = _holograms(tfs, jfs)
    assert tholo._sim_engine_inputs() is not None
    if how == "window_off_frame":
        for holo in (tholo, jholo):
            holo.spot_ij = holo.spot_ij + np.array([[80.0], [0.0]])
    elif how == "no_cameraslm":
        tholo.cameraslm = jholo.cameraslm = None
    else:
        _disqualify(tfs, how)
        _disqualify(jfs, how)
    assert tholo._sim_engine_inputs() is None and jholo._sim_engine_inputs() is None
    assert tholo._sim_spot_powers() is None
    assert "experimental_spot" in tholo._stats_pending_groups() or not tholo.flags

    def run(holo):
        holo.optimize("WGS-Kim", maxiter=2, verbose=False, feedback="experimental_spot",
                      stat_groups=["experimental_spot"])
        holo.optimize("WGS-Kim", maxiter=2, verbose=False, stat_groups=["experimental_spot"])
        return holo.stats["stats"]["experimental_spot"]

    if how in ("window_off_frame", "no_cameraslm"):
        for holo in (tholo, jholo):
            with pytest.raises((IndexError, RuntimeError, AttributeError)):
                run(holo)
        return
    for holo in (tholo, jholo):
        holo.cameraslm.cam.set_exposure(20.0)
    tstats, jstats = run(tholo), run(jholo)
    assert tholo._engine_feedback() == jholo._engine_feedback() == "external_spot"
    assert tholo.iter == jholo.iter == 4
    for key in ("uniformity", "efficiency"):
        np.testing.assert_allclose(tstats[key], jstats[key], atol=LOOP_STAT_ATOL, err_msg=key)


def test_sim_engine_inputs_cache_follows_content():
    """The consts are cached while their inputs are unchanged, and rebuilt
    after an in-place edit of the SLM's correction phase."""
    tfs, jfs = _rigs()
    tfs.slm.source["phase"] = np.zeros((SIDE, SIDE))
    tholo, _ = _holograms(tfs, jfs)
    first = tholo._sim_engine_inputs()
    assert tholo._sim_engine_inputs()[0] is first[0]
    tfs.slm.source["phase"][:] = 0.5  # In place: the array's identity stays.
    second = tholo._sim_engine_inputs()
    assert second[0] is not first[0]
    assert float((second[0]["sim_pre"] - first[0]["sim_pre"]).mean()) == pytest.approx(0.5)
    tholo.cameraslm.cam.set_exposure(3.0)
    assert float(tholo._sim_scale()) == 3.0 and tholo._sim_engine_inputs()[0] is second[0]


def test_fused_gates_refuse_camera_feedback():
    base = dict(method="WGS-Kim", shape=(64, 64), slm_shape=(64, 64))
    for change in (dict(feedback="experimental_spot_sim"),
                   dict(stat_groups=("experimental_spot",)),
                   dict(stat_groups=("computational", "experimental_spot"))):
        config = TE.GSConfig(**base, **change)
        assert not TE._fused_active(config) and not TE._mraf_fused_active(config)
        assert not TE._carry_active(TE.GSConfig(**base, mraf=True, **change))


# ----------------------------------------------------------------------
# The closed loop.
# ----------------------------------------------------------------------


def _closed_loop(holo, method="WGS-Kim", warm=5, iters=30, **flags):
    holo.optimize(method, maxiter=warm, verbose=False, **flags)
    holo.optimize(method, maxiter=iters, verbose=False, feedback="experimental_spot",
                  stat_groups=["experimental_spot"], **flags)
    return holo.stats["stats"]["experimental_spot"]


def test_engine_step_with_camera_matches_jax():
    """One engine run from the same state and constants (through
    convert): the measured stats rows of the first iterations agree."""
    tfs, jfs = _rigs()
    tholo, jholo = _holograms(tfs, jfs)
    for holo in (tholo, jholo):
        holo.cameraslm.cam.set_exposure(20.0)
        holo._update_flags("WGS-Kim", False, "experimental_spot", ["experimental_spot"])
    tconfig, jconfig = tholo._build_config(), jholo._build_config()
    assert tconfig.feedback == jconfig.feedback == "experimental_spot_sim"
    for field in ("sim_bitres", "sim_cam_sat", "sim_truncates", "sim_shape_padded"):
        assert getattr(tconfig, field) == getattr(jconfig, field)
    jstate, jstats = JE.run_gs(jconfig, jholo._build_state(jconfig),
                               jholo._build_consts(jconfig), 3)
    tstate, tstats = TE.run_gs(tconfig, tholo._build_state(tconfig),
                               tholo._build_consts(tconfig), 3)
    np.testing.assert_allclose(tstats.numpy()[:, 0, :2], np.asarray(jstats)[:, 0, :2],
                               atol=LOOP_STAT_ATOL)
    wt, wj = tstate.weights.numpy(), np.asarray(jstate.weights)
    np.testing.assert_allclose(wt / wt.max(), wj / wj.max(), atol=LOOP_WEIGHT_ATOL)


@pytest.mark.parametrize("spots, method, exposure", [
    (SPOTS_4, "WGS-Kim", 20.0),
    (SPOTS_GRID, "WGS-Kim", 60.0),
    (SPOTS_4, "WGS-Leonardo", 20.0),
    (SPOTS_GRID, "WGS-Nogrette", 60.0),
    (SPOTS_4, "WGS-Kim", 1.0),
], ids=["four-kim", "grid-kim", "four-leonardo", "grid-nogrette", "four-kim-dim"])
def test_closed_loop_matches_jax(spots, method, exposure):
    """The whole camera-in-the-loop run, 5 computational iterations and
    30 with the camera: what users read agrees within the loop limits,
    and the loop went through the device feedback mode."""
    tfs, jfs = _rigs()
    tholo, jholo = _holograms(tfs, jfs, spots=spots)
    for holo in (tholo, jholo):
        holo.cameraslm.cam.set_exposure(exposure)
    tstats, jstats = _closed_loop(tholo, method), _closed_loop(jholo, method)
    assert tholo._engine_feedback() == jholo._engine_feedback() == "experimental_spot_sim"
    assert tholo.iter == jholo.iter == 35
    for key in ("uniformity", "efficiency"):
        assert len(tstats[key]) == 35 and np.isnan(tstats[key][:5]).all()
        assert abs(tstats[key][-1] - jstats[key][-1]) <= LOOP_STAT_ATOL, key
        np.testing.assert_allclose(tstats[key][5:8], jstats[key][5:8], atol=LOOP_STAT_ATOL)
    wt, wj = np.asarray(tholo.weights), np.asarray(jholo.weights)
    centers = (tholo.spot_knm_rounded[1], tholo.spot_knm_rounded[0])
    np.testing.assert_allclose(wt[centers] / wt.max(), wj[centers] / wj.max(),
                               atol=LOOP_WEIGHT_ATOL)
    assert np.count_nonzero(wt) == spots.shape[1]
    if exposure > 1:
        assert tstats["uniformity"][-1] > 0.9


def test_closed_loop_improves_on_the_warm_up():
    """The camera's feedback ends no worse than it started, and the final
    hologram, displayed and imaged on the host, shows the same
    uniformity the loop reported."""
    tfs, _ = _rigs()
    tfs.slm.source["phase_sim"] = 0.5 * np.random.default_rng(17).uniform(-1, 1, (SIDE, SIDE))
    tfs.cam.set_affine(tfs.cam.M, tfs.cam.b)
    tfs.cam.set_exposure(60.0)
    tholo = T.SpotHologram(SHAPE, SPOTS_GRID, basis="ij", cameraslm=tfs, phase=_phase(18))
    stats = _closed_loop(tholo)
    assert stats["uniformity"][-1] >= stats["uniformity"][5]
    assert stats["uniformity"][-1] > 0.9
    host = {}
    tholo._populate_stats(host, ["experimental_spot"])
    tholo.measure("ij")
    powers = tanalysis.take(np.square(tholo.img_ij.astype(np.float64)), tholo.spot_ij,
                            tholo.spot_integration_width_ij, centered=True, integrate=True)
    amps = np.sqrt(powers)
    imaged = 1 - (amps.max() - amps.min()) / (amps.max() + amps.min())
    assert abs(imaged - host["experimental_spot"]["uniformity"]) < 5e-3


def test_closed_loop_resumes_from_jax_state():
    """A JAX hologram after its warm-up crosses through convert; both then
    run the camera loop from the same planes."""
    tfs, jfs = _rigs()
    _, jholo = _holograms(tfs, jfs, spots=SPOTS_GRID)
    for fs in (tfs, jfs):
        fs.cam.set_exposure(60.0)
    jholo.optimize("WGS-Kim", maxiter=5, verbose=False)
    tholo = convert.spot_hologram_from_jax(jholo, tfs, device="cpu")
    assert tholo.iter == 5
    np.testing.assert_array_equal(tholo.spot_ij, jholo.spot_ij)
    np.testing.assert_allclose(tholo.weights, np.asarray(jholo.weights), atol=1e-7)
    for holo in (tholo, jholo):
        holo.optimize("WGS-Kim", maxiter=10, verbose=False, feedback="experimental_spot",
                      stat_groups=["experimental_spot"])
    for key in ("uniformity", "efficiency"):
        t = tholo.stats["stats"]["experimental_spot"][key]
        j = jholo.stats["stats"]["experimental_spot"][key]
        np.testing.assert_allclose(t[5:], j[5:], atol=LOOP_STAT_ATOL)


def test_camera_stats_beside_computational_feedback():
    """``stat_groups=["experimental_spot"]`` with computational feedback:
    the camera only watches."""
    tfs, jfs = _rigs()
    tholo, jholo = _holograms(tfs, jfs)
    for holo in (tholo, jholo):
        holo.cameraslm.cam.set_exposure(20.0)
        holo.optimize("WGS-Kim", maxiter=6, verbose=False,
                      stat_groups=["computational", "experimental_spot"])
    assert tholo._build_config().feedback == "computational"
    for group in ("computational", "experimental_spot"):
        for key in ("uniformity", "efficiency"):
            np.testing.assert_allclose(tholo.stats["stats"][group][key],
                                       jholo.stats["stats"][group][key], atol=LOOP_STAT_ATOL)


def test_camera_loop_model_builds_config_4():
    """``camera_loop_wgs`` packages the rig and hologram of BASELINE
    config 4 (here at a small size), analytic and measured calibration."""
    fs, holo = tmodels.camera_loop_wgs(
        spot_ij=SPOTS_4, shape=SHAPE, slm_side=SIDE, cam_side=SIDE, M=RIG_M, device="cpu")
    assert holo.shape == SHAPE and holo.slm_shape == (SIDE, SIDE) and len(holo) == 4
    np.testing.assert_array_equal(fs.calibrations["fourier"]["M"], RIG_M)
    np.testing.assert_array_equal(fs.calibrations["fourier"]["b"], RIG_B)
    assert fs.cam.exposure_s == 1.0 and fs.slm.wav_um == 0.78
    again = tmodels.camera_loop_wgs(
        spot_ij=SPOTS_4, shape=SHAPE, slm_side=SIDE, cam_side=SIDE, M=RIG_M, device="cpu")[1]
    np.testing.assert_array_equal(holo.phase, again.phase)
    assert holo._sim_engine_inputs() is not None
    np.testing.assert_array_equal(tmodels.CAMERA_LOOP_SPOTS_IJ.shape, (2, 4))
    with pytest.raises(ValueError, match="calibration"):
        tmodels.camera_loop_wgs(calibration="guessed", slm_side=SIDE, cam_side=SIDE,
                                M=RIG_M, device="cpu")
