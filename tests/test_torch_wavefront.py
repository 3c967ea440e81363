"""
The Zernike wavefront calibration and the rig steps under it, on the port
against the JAX package, on the CPU at a small size (128^2 SLM and camera):
``FourierSLM.simulate`` and ``load``, ``wavefront_calibration_points``, a
``CompressedSpotHologram`` on a ``FourierSLM`` (camera positions and
integration width), ``experimental_spot`` WGS-Kim, ``refine_offset``,
``wavefront_calibrate_zernike`` (also resumed from a stored calibration) and
``wavefront_calibrate_zernike_smooth``.

Rigs are built in the JAX package and cross with
:meth:`slmsuite_torch.convert.rig_from_jax`. Numpy's global generator is
seeded before every call that draws from it, in both packages (a
hologram's random initial phase), so that neither run depends on the
order of the tests.

The JAX package's compressed host loop measures the phase its hologram
held when ``optimize()`` began, in every iteration; the port measures the
iteration's phase (as the stepwise loop of every other hologram does).
The tests that compare camera feedback make the JAX loop adopt the
iteration's phase first (:func:`_current_phase_loop`).

The camera quantizes the display and the counts, so one ulp can flip a
gray level: the tests hold what users read, each with its tolerance.
"""

import numpy as np
import pytest
import torch

import slmsuite_torch
from slmsuite_torch import convert
from slmsuite_torch.hardware.cameraslms import FourierSLM as TFourierSLM
from slmsuite_torch.holography import algorithms as T
from slmsuite_torch.holography import analysis as tanalysis
from slmsuite_torch.holography import toolbox as ttoolbox
from slmsuite_torch.holography.toolbox import phase as tphase
from slmsuite_torch.models import engine_models as tmodels
from slmsuite_tpu.hardware.cameras.simulated import SimulatedCamera as JCamera
from slmsuite_tpu.hardware.cameraslms import FourierSLM as JFourierSLM
from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM as JSLM
from slmsuite_tpu.holography import algorithms as J
from slmsuite_tpu.holography import analysis as janalysis
from slmsuite_tpu.holography import toolbox as jtoolbox
from slmsuite_tpu.holography.toolbox import phase as jphase

torch.set_num_threads(1)

SIDE = 128
RIG_M = np.array([[2.0e3, 50.0], [-50.0, 2.0e3]])
RIG_B = np.array([[64.0], [64.0]])
#: The aberration of the rig: focus, oblique astigmatism, primary spherical.
ABERRATION = ((4, 3, 12), (1.0, -0.6, 0.4))
#: A 3 x 3 grid of camera points at 24-pixel pitch around the 0th order.
POINTS_3X3 = np.array([(64 + dx, 64 + dy) for dy in (-24, 0, 24) for dx in (-24, 0, 24)],
                      float).T

#: Exact copies (the toolbox and the calibration's geometry): float64 round-off.
EXACT_ATOL = 1e-9
#: Camera positions after a fit of measured centroids (pixels).
SHIFT_ATOL = 0.05
#: Measured stats (uniformity, efficiency) of loops through the camera.
STAT_ATOL = 2e-3
#: Weights, over their largest.
WEIGHT_ATOL = 1e-2
#: Fitted Zernike corrections (rad): a fiftieth of the sweeps' 0.5 rad step.
CORRECTION_ATOL = 1e-2
#: The calibration's metric (mean spot area), relative.
METRIC_RTOL = 1e-2


@pytest.fixture(autouse=True)
def _cpu_default():
    previous = slmsuite_torch.resolve_device(None)
    slmsuite_torch.set_default_device("cpu")
    yield
    slmsuite_torch.set_default_device(previous)


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it: these tests seed
    it, and tests of other files draw from it unseeded."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


@pytest.fixture
def _current_phase_loop(monkeypatch):
    """The JAX package's compressed host loop, measuring each iteration's
    phase (see the module's note)."""
    loop = J.CompressedSpotHologram._stepwise_compressed

    def adopting(self, state, *args, **kwargs):
        self._set_psi_device(state.psi)
        return loop(self, state, *args, **kwargs)

    monkeypatch.setattr(J.CompressedSpotHologram, "_stepwise_compressed", adopting)


def _jax_rig(cam_b=RIG_B, aberration=ABERRATION):
    """The JAX package's calibrated 128^2 rig; the camera's affine offset
    ``cam_b`` may differ from the calibration's (a misplaced camera)."""
    slm = JSLM(resolution=(SIDE, SIDE), pitch_um=(8, 8), wav_um=0.78)
    slm.set_source_analytic(
        "gaussian2d", sim=True, x0=0, y0=0, a=1, c=0,
        wx=0.35 * SIDE * slm.pitch[0], wy=0.35 * SIDE * slm.pitch[1],
    )
    cam = JCamera(slm, resolution=(SIDE, SIDE), pitch_um=(5.5, 5.5), M=RIG_M.copy(),
                  b=np.array(cam_b, float))
    cam.set_exposure(1.0)
    fs = JFourierSLM(cam, slm)
    fs.fourier_calibrate_analytic(RIG_M.copy(), RIG_B.copy())
    if aberration is not None:
        slm.source["phase_sim"] = np.asarray(jphase.zernike_sum(slm, *aberration))
    return fs


def _rigs(**kwargs):
    jfs = _jax_rig(**kwargs)
    return convert.rig_from_jax(jfs, device="cpu"), jfs


def _phase(seed, shape=(SIDE, SIDE)):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, shape).astype(np.float32)


def _compressed(tfs, jfs, vectors=POINTS_3X3, basis="ij", seed=5):
    """The same compressed hologram on both rigs, from the same phase."""
    pair = []
    for pkg, fs in ((T, tfs), (J, jfs)):
        np.random.seed(seed)
        holo = pkg.CompressedSpotHologram(np.array(vectors), basis=basis, cameraslm=fs)
        holo.reset_phase(_phase(seed))
        pair.append(holo)
    return pair


def _stat(holo, group, key):
    return np.asarray(holo.stats["stats"][group][key], float)


# ----------------------------------------------------------------------
# Toolbox and analysis copies.
# ----------------------------------------------------------------------


@pytest.mark.parametrize("N", [None, 0, 3, (4, 2), np.array([[0, 1, 2], [2, 1, 0]])])
@pytest.mark.parametrize("basis_vectors", [False, True])
def test_fit_3pt_matches_jax(N, basis_vectors):
    y0, y1, y2 = (3.0, 4.0), (10.0, 5.5), (2.5, 12.0)
    kwargs = dict(x1=None, x2=None) if basis_vectors else {}
    got = ttoolbox.fit_3pt(y0, y1, y2, N, **kwargs)
    ref = jtoolbox.fit_3pt(y0, y1, y2, N, **kwargs)
    if isinstance(ref, dict):
        for key in ("M", "b"):
            np.testing.assert_allclose(got[key], ref[key], atol=EXACT_ATOL)
    else:
        np.testing.assert_allclose(got, ref, atol=EXACT_ATOL)
    with pytest.raises(ValueError, match="colinear"):
        ttoolbox.fit_3pt(y0, y1, y2, x1=(1, 1), x2=(2, 2))


def test_zernike_and_image_areas_match_jax():
    tfs, jfs = _rigs()
    for index in (3, 4, 12, 20):
        np.testing.assert_allclose(tphase.zernike(tfs.slm, index, 0.7, use_mask=False),
                                   jphase.zernike(jfs.slm, index, 0.7, use_mask=False),
                                   atol=EXACT_ATOL)
    images = np.random.default_rng(1).uniform(0, 1, (4, 9, 9))
    variances = tanalysis.image_variances(images)
    np.testing.assert_allclose(tanalysis.image_areas(variances),
                               janalysis.image_areas(janalysis.image_variances(images)),
                               atol=EXACT_ATOL)
    np.testing.assert_allclose(
        TFourierSLM._wavefront_calibrate_zernike_default_metric(images),
        JFourierSLM._wavefront_calibrate_zernike_default_metric(images), atol=EXACT_ATOL)


# ----------------------------------------------------------------------
# simulate() and load().
# ----------------------------------------------------------------------


@pytest.mark.parametrize("a", [(0.0, 0.0), (0.004, -0.003)])
def test_simulate_matches_jax(a):
    """The clone's camera takes the calibration's affine with the array
    center folded in (``b - M a``); its calibrations, source and geometry
    are the rig's, and it images a phase as the JAX package's clone does
    (within one count: the cast of the counts)."""
    tfs, jfs = _rigs()
    for fs in (tfs, jfs):
        fs.calibrations["fourier"]["a"] = np.array(a, float).reshape(2, 1)
    tsim, jsim = tfs.simulate(), jfs.simulate()
    assert isinstance(tsim, TFourierSLM) and tsim.cam.device == tfs.cam.device
    np.testing.assert_allclose(tsim.cam.M, jsim.cam.M, atol=EXACT_ATOL)
    np.testing.assert_allclose(np.reshape(tsim.cam.b, (2, 1)), np.reshape(jsim.cam.b, (2, 1)),
                               atol=EXACT_ATOL)
    kxy = np.array([[0.01, -0.02], [0.005, 0.0]])
    np.testing.assert_allclose(tsim.kxyslm_to_ijcam(kxy), jsim.kxyslm_to_ijcam(kxy),
                               atol=EXACT_ATOL)
    np.testing.assert_allclose(tsim.kxyslm_to_ijcam(kxy), tfs.kxyslm_to_ijcam(kxy),
                               atol=EXACT_ATOL)
    assert tsim.slm.name == jsim.slm.name and tsim.cam.name == jsim.cam.name
    np.testing.assert_array_equal(tsim.slm.source["phase_sim"], jsim.slm.source["phase_sim"])
    phase = _phase(2)
    for sim in (tsim, jsim):
        sim.slm.set_phase(phase, settle=True)
    np.testing.assert_allclose(tsim.cam.get_image().astype(float),
                               jsim.cam.get_image().astype(float), atol=1.0)
    tfs.calibrations.pop("fourier")
    with pytest.raises(ValueError, match="Fourier calibration"):
        tfs.simulate()


def test_load_matches_jax(tmp_path):
    """``load`` of a saved rig (``save``) restores the geometry, the
    wavelength, the calibrations and the camera's affine, as the JAX
    package's does on the same file; a calibration file has no
    calibrations to restore; a clone saved and loaded gives the same
    ``kxyslm_to_ijcam`` within 1e-9 px, and so does the dictionary that
    ``save`` writes read by ``load``'s reader (``_from_pickle``, which a
    machine without h5py uses)."""
    tfs, _ = _rigs()
    tfs.calibrations["fourier"]["a"] = np.array([[0.002], [0.001]])
    sim = tfs.simulate()
    path = sim.save(str(tmp_path))
    tload, jload = TFourierSLM.load(path, device="cpu"), JFourierSLM.load(path)
    assert tload.slm.shape == jload.slm.shape and tload.cam.shape == jload.cam.shape
    assert tload.slm.wav_um == jload.slm.wav_um == sim.slm.wav_um
    assert tload.name == jload.name and tload.cam.device == torch.device("cpu")
    np.testing.assert_allclose(np.reshape(tload.cam.b, (2, 1)), np.reshape(jload.cam.b, (2, 1)),
                               atol=EXACT_ATOL)
    kxy = np.array([[0.01, -0.02, 0.0], [0.005, 0.0, -0.01]])
    np.testing.assert_allclose(tload.kxyslm_to_ijcam(kxy), sim.kxyslm_to_ijcam(kxy),
                               atol=EXACT_ATOL)
    np.testing.assert_allclose(tload.kxyslm_to_ijcam(kxy), jload.kxyslm_to_ijcam(kxy),
                               atol=EXACT_ATOL)
    from_dict = TFourierSLM._from_pickle(sim.pickle(), device="cpu")
    np.testing.assert_allclose(from_dict.kxyslm_to_ijcam(kxy), tload.kxyslm_to_ijcam(kxy),
                               atol=EXACT_ATOL)
    cal_path = sim.save_calibration("fourier", path=str(tmp_path))
    bare = TFourierSLM.load(cal_path, device="cpu")
    assert bare.calibrations == {} and bare.slm.shape == sim.slm.shape
    bare.load_calibration("fourier", cal_path)
    np.testing.assert_allclose(bare.kxyslm_to_ijcam(kxy), sim.kxyslm_to_ijcam(kxy),
                               atol=EXACT_ATOL)
    with pytest.raises(ValueError, match="__meta__"):
        from slmsuite_torch.misc.files import save_h5

        save_h5(str(tmp_path / "empty.h5"), {"x": np.zeros(2)})
        TFourierSLM.load(str(tmp_path / "empty.h5"))


# ----------------------------------------------------------------------
# The calibration points and the compressed hologram on a FourierSLM.
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    dict(pitch=np.sqrt(SIDE * SIDE / 9)),
    dict(pitch=20),
    dict(pitch=20, avoid_mirrors=False),
    dict(pitch=16, field_point=(0.01, 0.005), field_exclusion=10),
    dict(pitch=20, avoid_points=(30, 90), avoid_nyquist=False),
])
def test_wavefront_calibration_points_match_jax(kwargs):
    tfs, jfs = _rigs()
    got = tfs.wavefront_calibration_points(**kwargs)
    np.testing.assert_array_equal(got, jfs.wavefront_calibration_points(**kwargs))
    assert got.shape[0] == 2 and got.shape[1] > 0
    with pytest.raises(ValueError, match="No calibration points"):
        tfs.wavefront_calibration_points(200)


@pytest.mark.parametrize("basis", ["ij", "kxy", "zernike"])
def test_compressed_on_fourier_slm_matches_jax(basis):
    """The vector triple, the camera positions from the Fourier calibration
    and the integration width from the PSF, as in the JAX package, for
    spots given in camera pixels, in k-space and as Zernike coefficients
    (D = 5, through focus); spots off the camera raise in both."""
    tfs, jfs = _rigs()
    vectors = POINTS_3X3
    if basis != "ij":
        vectors = ttoolbox.convert_vector(POINTS_3X3, "ij", basis, hardware=tfs)
    if basis == "zernike":
        vectors = np.vstack([np.zeros((1, 9)), vectors[[1, 0]], np.zeros((1, 9)),
                             np.linspace(-1, 1, 9)[None]])
        basis = [0, 1, 2, 3, 4]
    t, j = _compressed(tfs, jfs, vectors, basis)
    for key in ("spot_ij", "spot_kxy", "spot_zernike", "zernike_basis_cartesian"):
        np.testing.assert_allclose(np.asarray(getattr(t, key), float),
                                   np.asarray(getattr(j, key), float), atol=EXACT_ATOL)
    assert t.spot_integration_width_ij == j.spot_integration_width_ij
    edge = POINTS_3X3.copy()
    edge[:, 0] = (1.0, 64.0)
    for pkg, fs in ((T, tfs), (J, jfs)):
        with pytest.raises(ValueError, match="camera bounds"):
            pkg.CompressedSpotHologram(edge, basis="ij", cameraslm=fs)


# ----------------------------------------------------------------------
# Camera feedback and refine_offset.
# ----------------------------------------------------------------------


@pytest.mark.usefixtures("_current_phase_loop")
def test_experimental_spot_wgs_kim_matches_jax():
    """WGS-Kim with ``experimental_spot`` feedback for 3 host iterations
    (one camera frame an iteration) with both spot stat groups: the
    weights, the measured and computed stats and the phase agree."""
    tfs, jfs = _rigs()
    t, j = _compressed(tfs, jfs)
    for holo in (t, j):
        holo.optimize("WGS-Kim", feedback="experimental_spot", maxiter=3, verbose=False,
                      stat_groups=["computational_spot", "experimental_spot"])
    assert t.iter == j.iter == 3
    for group in ("computational_spot", "experimental_spot"):
        for key in ("efficiency", "uniformity"):
            np.testing.assert_allclose(_stat(t, group, key), _stat(j, group, key),
                                       atol=STAT_ATOL)
    w_t, w_j = np.asarray(t.weights, float), np.asarray(j.weights, float)
    np.testing.assert_allclose(w_t / w_j.max(), w_j / w_j.max(), atol=WEIGHT_ATOL)
    dp = np.abs(np.mod(np.asarray(t.phase, float) - np.asarray(j.phase, float) + np.pi,
                       2 * np.pi) - np.pi)
    assert np.quantile(dp, 0.99) < 1e-2


def test_compressed_camera_loop_measures_each_iteration():
    """The port's compressed host loop hands the callback and the camera
    each iteration's phase: the callback sees a new phase each iteration,
    and the SLM displays the last one it saw (written by the last weight
    update's measurement)."""
    tfs, jfs = _rigs()
    t, _ = _compressed(tfs, jfs)
    seen = []
    t.optimize("WGS-Kim", feedback="experimental_spot", maxiter=3, verbose=False,
               callback=lambda h: seen.append(np.array(h.phase)) and False)
    assert len(seen) == 3 and not np.array_equal(seen[0], seen[1])
    slm = tfs.slm
    expect = slm._phase2gray(np.asarray(seen[-1], float) + np.pi,
                             out=np.empty_like(slm.display))
    np.testing.assert_array_equal(slm.display, expect)


@pytest.mark.parametrize("kind", ["compressed", "spot"])
@pytest.mark.parametrize("basis, force_affine", [("kxy", False), ("ij", False),
                                                 ("kxy", True), ("knm", True)])
def test_refine_offset_matches_jax(kind, basis, force_affine):
    """A camera misplaced by (1.5, -1) px against the calibration: the
    centroid shifts (and their affine fit) agree within 0.05 px, and so do
    the targets they move: the k-space spots (and the tilt coefficients of
    the compressed hologram, the ``knm`` spots of the spot hologram) or the
    camera windows."""
    tfs, jfs = _rigs(cam_b=RIG_B + np.array([[1.5], [-1.0]]))
    if kind == "compressed":
        t, j = _compressed(tfs, jfs)
    else:
        t = T.SpotHologram((256, 256), POINTS_3X3.copy(), basis="ij", cameraslm=tfs,
                           phase=_phase(5))
        j = J.SpotHologram((256, 256), POINTS_3X3.copy(), basis="ij", cameraslm=jfs)
        j.reset_phase(custom_phase=_phase(5))
    for holo in (t, j):
        holo.optimize("GS", maxiter=5, verbose=False)
    shift_t = t.refine_offset(basis=basis, force_affine=force_affine)
    shift_j = j.refine_offset(basis=basis, force_affine=force_affine)
    np.testing.assert_allclose(shift_t, shift_j, atol=SHIFT_ATOL)
    assert np.all(np.abs(np.mean(shift_t, axis=1) - (1.5, -1.0)) < 0.5)
    np.testing.assert_allclose(t.spot_ij, j.spot_ij, atol=SHIFT_ATOL)
    scale = np.abs(RIG_M).max()
    np.testing.assert_allclose(t.spot_kxy[:2], j.spot_kxy[:2], atol=SHIFT_ATOL / scale)
    if kind == "compressed":
        np.testing.assert_allclose(t.spot_zernike, j.spot_zernike, atol=1e-2)
    else:
        np.testing.assert_allclose(t.spot_knm, j.spot_knm, atol=SHIFT_ATOL)
    with pytest.raises(ValueError, match="basis"):
        t.refine_offset(basis="rad")
    shifts = t.refine_offset(basis=None)
    np.testing.assert_array_equal(_draws(lambda: t.refine_offset(basis=None, plot=True)),
                                  shifts)


# ----------------------------------------------------------------------
# The Zernike wavefront calibration.
# ----------------------------------------------------------------------


def _calibrate(fs, **kwargs):
    np.random.seed(0)
    return fs.wavefront_calibrate(method="zernike", plot=-1, **kwargs)


def _assert_calibrations(got, ref):
    assert got["spot_integration_width_ij"] == ref["spot_integration_width_ij"]
    np.testing.assert_array_equal(got["zernike_indices"], ref["zernike_indices"])
    for key in ("initial_points", "calibration_points_ij"):
        np.testing.assert_allclose(got[key], ref[key], atol=EXACT_ATOL)
    np.testing.assert_allclose(got["corrected_spots"], ref["corrected_spots"],
                               atol=CORRECTION_ATOL)
    np.testing.assert_allclose(np.mean(got["metric_stats"], axis=1),
                               np.mean(ref["metric_stats"], axis=1), rtol=METRIC_RTOL)
    w_t, w_j = np.asarray(got["weights"], float), np.asarray(ref["weights"], float)
    np.testing.assert_allclose(w_t / w_j.max(), w_j / w_j.max(), atol=WEIGHT_ATOL)


@pytest.mark.usefixtures("_current_phase_loop")
@pytest.mark.parametrize("case", ["d5", "d20_global"])
def test_wavefront_calibrate_zernike_matches_jax(case):
    """The calibration end to end, 9 points asked on the 128^2 camera (the
    exclusions keep 5): D = 5 with 7 perturbations, position refinement and
    2 iterations of weight equalization; and D = 20 (past the earlier
    kernels' 16 terms) with one global correction a term, no focus term,
    3 perturbations. The corrections, the metric before each term and
    after the last, the weights and the stored geometry agree; at D = 5,
    which corrects focus spot by spot, the metric falls."""
    tfs, jfs = _rigs()
    kwargs = dict(calibration_points=9, optimize_weights=2)
    if case == "d5":
        kwargs.update(zernike_indices=5, perturbation=np.linspace(-1.5, 1.5, 7))
    else:
        kwargs.update(zernike_indices=20, perturbation=np.linspace(-1, 1, 3),
                      global_correction=True, optimize_focus=False)
    got, ref = _calibrate(tfs, **kwargs), _calibrate(jfs, **kwargs)
    assert got is tfs.calibrations["wavefront_zernike"]
    _assert_calibrations(got, ref)
    if case == "d5":
        assert np.mean(got["metric_stats"][-1]) < np.mean(got["metric_stats"][0])
    assert got["last_result"].shape == ref["last_result"].shape


@pytest.mark.usefixtures("_current_phase_loop")
def test_wavefront_calibrate_zernike_resumes_like_jax():
    """A calibration resumed from the stored one (carried across by
    ``rig_from_jax``, which copies every calibration dict): the stored
    points, camera positions, window width, weights and metric history are
    taken up, and the resumed runs agree; incompatible indices raise."""
    jfs = _jax_rig()
    _calibrate(jfs, calibration_points=9, zernike_indices=5, optimize_weights=1,
               perturbation=np.linspace(-1.5, 1.5, 5))
    tfs = convert.rig_from_jax(jfs, device="cpu")
    _assert_calibrations(tfs.calibrations["wavefront_zernike"],
                         jfs.calibrations["wavefront_zernike"])
    kwargs = dict(calibration_points=None, zernike_indices=6, optimize_weights=1,
                  perturbation=np.linspace(-0.5, 0.5, 5))
    got, ref = _calibrate(tfs, **kwargs), _calibrate(jfs, **kwargs)
    _assert_calibrations(got, ref)
    assert len(got["metric_stats"]) == len(ref["metric_stats"]) > 4
    with pytest.raises(ValueError, match="not compatible"):
        _calibrate(tfs, calibration_points=None, zernike_indices=[0, 2, 1, 3, 4, 5, 6])


@pytest.mark.usefixtures("_current_phase_loop")
def test_wavefront_calibrate_zernike_without_perturbation_projects_like_jax():
    """``perturbation=0`` projects the weighted hologram and returns it,
    storing no calibration, in both packages."""
    tfs, jfs = _rigs()
    got = _calibrate(tfs, calibration_points=POINTS_3X3, zernike_indices=4,
                     perturbation=0, optimize_weights=1)
    ref = _calibrate(jfs, calibration_points=POINTS_3X3, zernike_indices=4,
                     perturbation=0, optimize_weights=1)
    assert isinstance(got, T.CompressedSpotHologram)
    assert "wavefront_zernike" not in tfs.calibrations
    np.testing.assert_allclose(got.spot_zernike, ref.spot_zernike, atol=EXACT_ATOL)
    w_t, w_j = np.asarray(got.weights, float), np.asarray(ref.weights, float)
    np.testing.assert_allclose(w_t / w_j.max(), w_j / w_j.max(), atol=WEIGHT_ATOL)


@pytest.mark.usefixtures("_current_phase_loop")
@pytest.mark.parametrize("kwargs", [dict(), dict(smoothing=0.6, smoothing_xy=0.1)])
def test_wavefront_calibrate_zernike_smooth_matches_jax(kwargs):
    """Smoothing of the stored calibration's coefficients over the points'
    Delaunay neighbors, on the JAX package's calibration: exact."""
    jfs = _jax_rig()
    _calibrate(jfs, calibration_points=20, zernike_indices=5, optimize_weights=False,
               optimize_position=False, perturbation=np.linspace(-1, 1, 3))
    tfs = convert.rig_from_jax(jfs, device="cpu")
    np.testing.assert_allclose(tfs.wavefront_calibrate_zernike_smooth(**kwargs),
                               jfs.wavefront_calibrate_zernike_smooth(**kwargs),
                               atol=EXACT_ATOL)
    with pytest.raises(ValueError, match="between 0 and 1"):
        tfs.wavefront_calibrate_zernike_smooth(smoothing=2)
    with pytest.raises(RuntimeError, match="z-smoothing"):
        tfs.wavefront_calibrate_zernike_smooth(smoothing_z=0.1)


def test_calibration_refusals_name_their_item():
    """Nothing names item 12 any more: the Zernike calibration's plots draw
    (each term's sweep and fit, the points, the status image and tiles of
    a projection, the refined offsets, the raw data, the smoothing graph);
    an unknown method raises ValueError, as in the JAX package (the
    superpixel method's plots: ``tests/test_torch_superpixel.py``)."""
    tfs, jfs = _rigs()
    small = dict(calibration_points=POINTS_3X3, zernike_indices=4, optimize_weights=False)
    for call in (
        lambda: tfs.wavefront_calibrate(method="zernike", plot=2, perturbation=0, **small),
        lambda: tfs.wavefront_calibrate(method="zernike", plot=2,
                                        perturbation=np.linspace(-1, 1, 3), **small),
        lambda: tfs._wavefront_calibrate_zernike_plot_raw(),
        lambda: tfs.wavefront_calibrate_zernike_smooth(plot=True),
        lambda: tfs.wavefront_calibration_points(20, plot=True),
    ):
        _draws(call)
    for fs in (tfs, jfs):
        with pytest.raises(ValueError, match="not recognized"):
            fs.wavefront_calibrate(method="bogus")


# ----------------------------------------------------------------------
# Carrying state across, and the rig of the chip run.
# ----------------------------------------------------------------------


@pytest.mark.usefixtures("_current_phase_loop")
def test_compressed_hologram_from_jax_carries_the_state():
    """A JAX-package compressed hologram on its FourierSLM after camera
    feedback crosses with its vectors, basis, camera positions, window,
    weights and phase; both continue alike."""
    tfs, jfs = _rigs()
    np.random.seed(3)
    j = J.CompressedSpotHologram(POINTS_3X3.copy(), basis="ij", cameraslm=jfs)
    j.optimize("WGS-Kim", feedback="experimental_spot", maxiter=2, verbose=False)
    t = convert.compressed_hologram_from_jax(j, tfs, device="cpu")
    np.testing.assert_array_equal(t.zernike_basis, j.zernike_basis)
    np.testing.assert_allclose(t.spot_zernike, j.spot_zernike, atol=EXACT_ATOL)
    np.testing.assert_allclose(t.spot_ij, j.spot_ij, atol=EXACT_ATOL)
    assert t.spot_integration_width_ij == j.spot_integration_width_ij and t.iter == 2
    np.testing.assert_array_equal(t.weights, np.asarray(j.weights))
    np.testing.assert_array_equal(t.phase, np.asarray(j.phase))
    for holo in (t, j):
        holo.optimize("WGS-Kim", feedback="experimental_spot", maxiter=2, verbose=False,
                      stat_groups=["experimental_spot"])
    for key in ("efficiency", "uniformity"):
        np.testing.assert_allclose(_stat(t, "experimental_spot", key),
                                   _stat(j, "experimental_spot", key), atol=STAT_ATOL)


def test_zernike_calibration_rig_model():
    """The chip run's rig at a small size: the analytic calibration, the
    injected aberration (as the JAX package's ``zernike_sum``), and a
    calibration that recovers the focus term's sign."""
    fs = tmodels.zernike_calibration_rig(slm_side=SIDE, cam_side=SIDE, M=RIG_M, b=RIG_B,
                                         device="cpu")
    np.testing.assert_array_equal(fs.calibrations["fourier"]["M"], RIG_M)
    jfs = _jax_rig()
    np.testing.assert_allclose(fs.slm.source["phase_sim"], jfs.slm.source["phase_sim"],
                               atol=EXACT_ATOL)
    cal = _calibrate(fs, calibration_points=9, zernike_indices=5,
                     perturbation=np.linspace(-1.5, 1.5, 7), optimize_weights=2)
    focus = list(cal["zernike_indices"]).index(4)
    assert np.mean(cal["corrected_spots"][focus] - cal["initial_points"][focus]) < -0.3


def _draws(call):
    """Run ``call`` under matplotlib's Agg backend; it must draw a figure.
    Closes every figure after. Returns what ``call`` returns."""
    import matplotlib.pyplot as plt

    plt.close("all")
    out = call()
    assert plt.get_fignums(), "no figure drawn"
    plt.close("all")
    return out
