"""
The stepwise host loop of the port against ``slmsuite_tpu`` on the CPU:
callbacks, ``stepwise_backward``, host stats, ``external_spot`` and camera
(``experimental_spot``, ``"experimental"``) feedback, camera-basis image
targets (``target_ij``, ``update_target``, ``ijcam_to_knmslm``), spot null
regions, and the compressed hologram's host loop with ``zero_factor``
MRAF. Inputs come from ``numpy.random.default_rng(seed)`` and go to both
packages; the JAX side runs as its own tests run it on the CPU.

Tolerances: stats 1e-4 abs / 1e-3 rel (the goldens'), the unfolded phase
5e-3 rad (modulo 2 pi, global offset removed), weights 1e-5 of their
maximum. Camera loops are discontinuous in psi (the display's gray levels,
the camera's integer counts and, here, its noise), so they are held on what
users read, as ``tests/test_torch_camera.py`` holds them: the measured
uniformity and efficiency within 2e-3, the spot weights within 1e-2 of
their maximum. The camera noise is drawn from one ``default_rng(seed)`` per
package, made just before that package's calls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slmsuite_torch
from slmsuite_torch import convert
from slmsuite_torch.holography import algorithms as T
from slmsuite_torch.holography import toolbox as TT
from slmsuite_torch.ops import engine as TE
from slmsuite_torch.ops import propagation as TP
from slmsuite_tpu.hardware.cameras.simulated import SimulatedCamera as JCamera
from slmsuite_tpu.hardware.cameraslms import FourierSLM as JFourierSLM
from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM as JSLM
from slmsuite_tpu.holography import algorithms as J
from slmsuite_tpu.holography import toolbox as JT
from slmsuite_tpu.holography.algorithms._hologram import _stepwise_backward
from slmsuite_tpu.ops import engine as JE


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


STATS_ATOL, STATS_RTOL = 1e-4, 1e-3
PHASE_ATOL = 5e-3
WEIGHT_RTOL = 1e-5
LOOP_STAT_ATOL, LOOP_WEIGHT_ATOL = 2e-3, 1e-2

#: The 128^2 rig of tests/test_torch_camera.py.
SIDE, SHAPE = 128, (256, 256)
RIG_M = np.array([[2.0e3, 50.0], [-50.0, 2.0e3]])
RIG_B = np.array([[64.0], [64.0]])
SPOTS_GRID = np.array([
    (x, y) for y in 64 + 16 * (np.arange(4) - 1.5) for x in 64 + 16 * (np.arange(4) - 1.5)
]).T


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    slmsuite_torch.set_default_device("cpu")
    yield
    slmsuite_torch.set_default_device("cuda")
    torch.set_num_threads(threads)


def _phase(seed, shape=(SIDE, SIDE)):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, shape).astype(np.float32)


def _phase_err(a, b):
    dp = np.asarray(a, float) - np.asarray(b, float)
    dp = np.mod(dp - dp.flat[0] + np.pi, 2 * np.pi) - np.pi
    return np.abs(dp).max()


def _assert_weights(got, ref, atol=WEIGHT_RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got / np.abs(ref).max(), ref / np.abs(ref).max(), atol=atol)


def _assert_stats(t, j, groups):
    for group in groups:
        for key, series in j.stats["stats"][group].items():
            np.testing.assert_allclose(t.stats["stats"][group][key], series, atol=STATS_ATOL,
                                       rtol=STATS_RTOL, err_msg=f"{group}/{key}")
    assert t.stats["flags"]["fixed_phase"] == j.stats["flags"]["fixed_phase"]


def _jax_rig(**cam_kwargs):
    slm = JSLM(resolution=(SIDE, SIDE), pitch_um=(8, 8), wav_um=0.78)
    slm.set_source_analytic(
        "gaussian2d", sim=True, x0=0, y0=0, a=1, c=0,
        wx=0.35 * SIDE * slm.pitch[0], wy=0.35 * SIDE * slm.pitch[1],
    )
    cam = JCamera(slm, resolution=(SIDE, SIDE), pitch_um=(5.5, 5.5), M=RIG_M.copy(),
                  b=RIG_B.copy(), **cam_kwargs)
    cam.set_exposure(1.0)
    fs = JFourierSLM(cam, slm)
    fs.fourier_calibrate_analytic(RIG_M.copy(), RIG_B.copy())
    return fs


def _rigs(**cam_kwargs):
    """The same rig in both packages (the port's through convert)."""
    jfs = _jax_rig(**cam_kwargs)
    return convert.rig_from_jax(jfs, device="cpu"), jfs


def _noise(seed):
    """Dark and read noise from one generator (one per package)."""
    rng = np.random.default_rng(seed)
    return {
        "dark": lambda x: rng.poisson(0.02 * x),
        "read": lambda x: rng.normal(0.01 * x, 0.002 * x),
    }


# ----------------------------------------------------------------------
# stepwise_backward.
# ----------------------------------------------------------------------


BACKWARD_CASES = {
    "unpadded": dict(shape=(64, 64)),
    "padded": dict(shape=(128, 128)),
    "padded_kernel": dict(shape=(128, 128), kernel=True),
    "mraf": dict(shape=(64, 64), mraf=True),
    "mraf_factor_kernel": dict(shape=(64, 64), mraf=True, factor=True, kernel=True),
    "mraf_padded_kernel": dict(shape=(128, 64), mraf=True, factor=True, kernel=True),
}


@pytest.mark.parametrize("case", sorted(BACKWARD_CASES))
def test_stepwise_backward_matches_jax(case):
    """The host loop's constraint and backward transform, on the same
    farfield, weights and phase store, against ``_stepwise_backward``."""
    spec = BACKWARD_CASES[case]
    shape, slm_shape = spec["shape"], (64, 32) if case == "mraf_padded_kernel" else (64, 64)
    rng = np.random.default_rng(21)
    farfield = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    weights = rng.uniform(0, 1, shape).astype(np.float32)
    phase_ff = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
    consts = {}
    if spec.get("kernel"):
        consts["kernel"] = rng.uniform(-1, 1, slm_shape).astype(np.float32)
    if spec.get("mraf"):
        code = rng.integers(0, 3, shape)
        consts.update(signal_mask=code == 1, noise_mask=code == 2, zero_mask=code == 0,
                      mraf_factor=np.float32(0.5))
    config = dict(method="WGS-Kim", shape=shape, slm_shape=slm_shape,
                  mraf=bool(spec.get("mraf")), mraf_factor=bool(spec.get("factor")),
                  has_kernel=bool(spec.get("kernel")))
    got = TP.stepwise_backward(TE.GSConfig(**config))(
        torch.from_numpy(farfield), torch.from_numpy(weights), torch.from_numpy(phase_ff),
        {k: torch.as_tensor(v) for k, v in consts.items()},
    ).numpy()
    ref = np.asarray(_stepwise_backward(JE.GSConfig(**config))(
        jnp.asarray(farfield), jnp.asarray(weights), jnp.asarray(phase_ff),
        {k: jnp.asarray(v) for k, v in consts.items()},
    ))
    assert got.shape == ref.shape == slm_shape
    dp = np.abs(np.mod(got - ref + np.pi, 2 * np.pi) - np.pi)
    assert dp.max() < PHASE_ATOL, dp.max()


# ----------------------------------------------------------------------
# Callbacks.
# ----------------------------------------------------------------------


def _image_target(shape, nan_rows=False):
    target = np.zeros(shape)
    H, W = shape
    target[H // 4:3 * H // 4:6, W // 4:3 * W // 4:6] = 1.0
    if nan_rows:
        target[:H // 8] = np.nan
    return target


GEOMETRIES = {
    "unpadded": dict(shape=(64, 64)),
    "padded": dict(shape=(128, 128)),
    "unpadded_kernel": dict(shape=(64, 64), kernel=True),
    "padded_kernel": dict(shape=(128, 128), kernel=True),
    "mraf_factor": dict(shape=(64, 64), mraf=True),
    "mraf_factor_padded_kernel": dict(shape=(128, 128), mraf=True, kernel=True),
}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("method", ["GS", "WGS-Kim", "WGS-Leonardo"])
def test_callback_stops_at_k_matches_jax(method, geometry):
    """A callback that returns True at iteration 7 of 12 stops the loop
    before the weights and ``iter`` move; what it saw, the stats, the
    phase and the weights agree with ``slmsuite_tpu``."""
    spec = GEOMETRIES[geometry]
    slm_shape = (64, 64)
    target = _image_target(spec["shape"], nan_rows=spec.get("mraf", False))
    phase = _phase(1, slm_shape)
    kernel = _phase(2, slm_shape) / np.pi if spec.get("kernel") else None
    flags = dict(fix_phase_iteration=3)
    if spec.get("mraf"):
        flags["mraf_factor"] = 0.5
    seen = {}
    for pkg in (T, J):
        holo = pkg.Hologram(target, slm_shape=slm_shape, phase=phase, propagation_kernel=kernel)
        record = seen[pkg] = []

        def callback(h, record=record):
            record.append((h.iter, float(np.sum(np.square(np.asarray(h.amp_ff))))))
            return h.iter == 7

        holo.optimize(method, maxiter=12, callback=callback, verbose=False,
                      stat_groups=["computational"], **flags)
        seen[pkg, "holo"] = holo
    t, j = seen[T, "holo"], seen[J, "holo"]
    assert t.iter == j.iter == 7
    assert [k for k, _ in seen[T]] == [k for k, _ in seen[J]] == list(range(8))
    np.testing.assert_allclose([p for _, p in seen[T]], [p for _, p in seen[J]], rtol=1e-5)
    assert len(t.stats["stats"]["computational"]["efficiency"]) == 7
    _assert_stats(t, j, ["computational"])
    assert _phase_err(t.get_phase(), j.get_phase()) < PHASE_ATOL
    _assert_weights(t.weights, j.weights)
    assert t.flags["fixed_phase"] == j.flags["fixed_phase"]
    np.testing.assert_allclose(t.amp_ff, np.asarray(j.amp_ff), atol=1e-5)


@pytest.mark.parametrize("basis", ["knm", "padded"])
def test_spot_callback_matches_jax(basis):
    """A SpotHologram with ``computational_spot`` feedback and both stat
    groups in the host loop (a callback that never stops), then the engine
    resumes from the host loop's planes."""
    shape = (64, 64) if basis == "knm" else (128, 128)
    holos = [pkg.SpotHologram.make_rectangular_array(
        shape, (4, 3), (8, 10), basis="knm", slm_shape=(64, 64), phase=_phase(4, (64, 64)))
        for pkg in (T, J)]
    for holo in holos:
        holo.optimize("WGS-Kim", maxiter=8, verbose=False, callback=lambda h: False,
                      feedback="computational_spot", fix_phase_iteration=4,
                      stat_groups=["computational", "computational_spot"])
        holo.optimize("WGS-Kim", maxiter=4, verbose=False, feedback="computational_spot",
                      stat_groups=["computational", "computational_spot"])
    t, j = holos
    assert t.iter == j.iter == 12
    _assert_stats(t, j, ["computational", "computational_spot"])
    assert _phase_err(t.get_phase(), j.get_phase()) < PHASE_ATOL
    _assert_weights(t.weights, j.weights)


def test_host_loop_follows_a_moved_target():
    """Spots moved between two host-loop runs (``set_target`` edits the
    target in place): the second run's weight update and stats use the
    new target, as in the JAX package."""
    spots = np.random.default_rng(13).uniform(60, 196, (2, 9))
    holos = [pkg.SpotHologram((256, 256), spots.copy(), basis="knm",
                              phase=_phase(13, (256, 256))) for pkg in (T, J)]
    for holo in holos:
        holo.optimize("WGS-Leonardo", maxiter=3, verbose=False, callback=lambda h: False,
                      stat_groups=["computational"])
        holo.spot_knm = holo.spot_knm + np.array([[1.0], [3.0]])
        holo.set_target(reset_weights=True)
        holo.optimize("WGS-Leonardo", maxiter=3, verbose=False, callback=lambda h: False,
                      stat_groups=["computational"])
    t, j = holos
    np.testing.assert_array_equal(t.target, j.target)
    _assert_stats(t, j, ["computational"])
    _assert_weights(t.weights, j.weights)
    assert t.stats["stats"]["computational"]["efficiency"][-1] > 0.5


# ----------------------------------------------------------------------
# external_spot.
# ----------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 64), (128, 128)], ids=["unpadded", "padded"])
@pytest.mark.parametrize("method", ["WGS-Kim", "WGS-Leonardo", "WGS-Nogrette"])
def test_external_spot_matches_jax(method, shape):
    """Spot amplitudes that the test gives (as a user measuring them
    elsewhere would) drive the weights, with ``external_spot`` stats."""
    rng = np.random.default_rng(5)
    holos = [pkg.SpotHologram.make_rectangular_array(
        shape, (3, 3), (9, 7), basis="knm", slm_shape=(64, 64), phase=_phase(6, (64, 64)))
        for pkg in (T, J)]
    for it in range(3):
        amps = rng.uniform(0.5, 1.5, 9)
        for holo in holos:
            holo.external_spot_amp = amps.copy()
            holo.optimize(method, maxiter=3, verbose=False, feedback="external_spot",
                          stat_groups=["computational_spot", "external_spot"])
    t, j = holos
    assert t.iter == j.iter == 9
    assert t._engine_feedback() == j._engine_feedback() == "external_spot"
    _assert_stats(t, j, ["computational_spot", "external_spot"])
    assert _phase_err(t.get_phase(), j.get_phase()) < PHASE_ATOL
    _assert_weights(t.weights, j.weights)


# ----------------------------------------------------------------------
# The camera: experimental_spot on a rig the device measurement does not
# model.
# ----------------------------------------------------------------------


CAMERA_CASES = {
    "noise_averaging_kim": dict(method="WGS-Kim", averaging=2),
    "noise_averaging_leonardo": dict(method="WGS-Leonardo", averaging=2),
    "noise_transform_kim": dict(method="WGS-Kim", transform=True),
}


@pytest.mark.parametrize("case", sorted(CAMERA_CASES))
def test_experimental_spot_with_noise_matches_jax(case):
    """The 128^2 rig with seeded dark and read noise (and averaging or an
    orientation transform): 5 computational iterations, then 10 with the
    camera's spot feedback and both spot stat groups in the host loop."""
    spec = CAMERA_CASES[case]
    tfs, jfs = _rigs()
    holos = {}
    for pkg, fs in ((J, jfs), (T, tfs)):
        fs.cam.set_exposure(60.0)
        fs.cam.averaging = spec.get("averaging")
        if spec.get("transform"):
            fs.cam.transform = np.fliplr
        holo = pkg.SpotHologram(SHAPE, SPOTS_GRID.copy(), basis="ij", cameraslm=fs)
        holo.reset_phase(custom_phase=_phase(3))
        assert holo._sim_engine_inputs() is None
        holo.optimize(spec["method"], maxiter=5, verbose=False)
        fs.cam.noise = _noise(31)  # Made just before this package's camera calls.
        holo.optimize(spec["method"], maxiter=10, verbose=False, feedback="experimental_spot",
                      stat_groups=["computational_spot", "experimental_spot"])
        holos[pkg] = holo
    t, j = holos[T], holos[J]
    assert t._engine_feedback() == j._engine_feedback() == "external_spot"
    assert t.iter == j.iter == 15
    for key in ("uniformity", "efficiency"):
        got = t.stats["stats"]["experimental_spot"][key]
        ref = j.stats["stats"]["experimental_spot"][key]
        assert len(got) == 15 and np.isnan(got[:5]).all()
        assert abs(got[-1] - ref[-1]) <= LOOP_STAT_ATOL, (key, got[-1], ref[-1])
        np.testing.assert_allclose(got[5:8], ref[5:8], atol=LOOP_STAT_ATOL)
    centers = (t.spot_knm_rounded[1], t.spot_knm_rounded[0])
    wt, wj = np.asarray(t.weights), np.asarray(j.weights)
    np.testing.assert_allclose(wt[centers] / wt.max(), wj[centers] / wj.max(),
                               atol=LOOP_WEIGHT_ATOL)


def test_experimental_spot_warns_for_experimental():
    """``feedback="experimental"`` on a SpotHologram is read as
    ``experimental_spot``, with the JAX package's warning."""
    tfs, jfs = _rigs(averaging=2)
    for pkg, fs in ((T, tfs), (J, jfs)):
        fs.cam.set_exposure(60.0)
        holo = pkg.SpotHologram(SHAPE, SPOTS_GRID.copy(), basis="ij", cameraslm=fs,
                                phase=_phase(3))
        with pytest.warns(UserWarning, match="experimental_spot"):
            holo.optimize("WGS-Kim", maxiter=2, verbose=False, feedback="experimental")
        assert holo.flags["feedback"] == "experimental_spot" and holo.iter == 2


# ----------------------------------------------------------------------
# FeedbackHologram: camera-basis image targets.
# ----------------------------------------------------------------------


def _target_ij():
    """A camera-basis image: two bright rectangles inside the frame."""
    img = np.zeros((SIDE, SIDE))
    img[40:56, 36:60] = 1.0
    img[70:90, 72:84] = 0.6
    return img


@pytest.mark.parametrize("blur", [0, 2])
@pytest.mark.parametrize("order", [0, 3])
def test_ijcam_to_knmslm_matches_jax(blur, order):
    tfs, jfs = _rigs()
    t = T.FeedbackHologram(SHAPE, cameraslm=tfs)
    j = J.FeedbackHologram(SHAPE, cameraslm=jfs)
    got = t.ijcam_to_knmslm(_target_ij(), blur_ij=blur, order=order)
    ref = j.ijcam_to_knmslm(_target_ij(), blur_ij=blur, order=order)
    assert got.dtype == ref.dtype and got.shape == SHAPE
    np.testing.assert_allclose(got, ref, atol=1e-7, equal_nan=True)
    assert np.isnan(got).any() and np.nansum(got**2) == pytest.approx(1.0, rel=1e-5)
    np.testing.assert_allclose(t._cam_points, j._cam_points, rtol=1e-10)


NULL_FRACS = {"none": None, "frac": 0.9, "frac_region": 0.9, "whole": 1.0}


@pytest.mark.parametrize("frac", sorted(NULL_FRACS))
def test_target_ij_and_update_target_match_jax(frac):
    """``target_ij`` at construction and a new one through
    ``update_target``, with a null region and radius fraction: the target
    (nan where it is free) and the weights agree."""
    tfs, jfs = _rigs()

    def region():
        if frac != "frac_region":
            return None
        mask = np.zeros(SHAPE, dtype=bool)
        mask[:, :SHAPE[1] // 3] = True
        return mask

    kwargs = dict(null_region_radius_frac=NULL_FRACS[frac])
    t = T.FeedbackHologram(SHAPE, target_ij=_target_ij(), cameraslm=tfs,
                           null_region=region(), **kwargs)
    j = J.FeedbackHologram(SHAPE, target_ij=_target_ij(), cameraslm=jfs,
                           null_region=region(), **kwargs)
    for _ in range(2):
        np.testing.assert_array_equal(t.target_ij, j.target_ij)
        np.testing.assert_allclose(t.target, j.target, atol=1e-7, equal_nan=True)
        np.testing.assert_allclose(t.weights, np.asarray(j.weights), atol=1e-7)
        # Free (nan) only inside the fraction's ellipse and off the camera.
        assert np.isnan(t.target).any() == (frac in ("frac", "frac_region"))
        moved = np.roll(_target_ij(), 6, axis=1)
        t.update_target(moved, region(), NULL_FRACS[frac], reset_weights=True)
        j.update_target(moved, region(), NULL_FRACS[frac], reset_weights=True)


def test_measure_knm_matches_jax():
    """``measure("knm")`` images the phase and resamples the frame into
    the computational basis; a cached frame is resampled without a new
    capture."""
    tfs, jfs = _rigs()
    t = T.FeedbackHologram(SHAPE, target_ij=_target_ij(), cameraslm=tfs, phase=_phase(8))
    j = J.FeedbackHologram(SHAPE, target_ij=_target_ij(), cameraslm=jfs)
    j.reset_phase(custom_phase=_phase(8))
    for holo in (t, j):
        holo.cameraslm.cam.set_exposure(200.0)
        holo.measure("ij")
        holo.measure("knm")
    np.testing.assert_allclose(np.square(t.img_ij), np.square(j.img_ij), atol=1.0)
    scale = np.nanmax(j.img_knm)
    np.testing.assert_allclose(t.img_knm / scale, j.img_knm / scale, atol=1e-2,
                               equal_nan=True)
    cached = t.img_ij
    t.measure("knm")
    assert t.img_ij is cached


def test_experimental_weight_update_matches_jax():
    """One ``"experimental"`` weight update from the same weights and the
    same camera frame (cached in both packages) agrees to 1e-5 of the
    weights' maximum."""
    tfs, jfs = _rigs()
    frame = np.random.default_rng(10).integers(0, 200, (SIDE, SIDE)).astype(np.float32)
    holos = []
    for pkg, fs in ((T, tfs), (J, jfs)):
        holo = pkg.FeedbackHologram(SHAPE, target_ij=_target_ij(), cameraslm=fs)
        holo._update_flags("WGS-Kim", False, "experimental", [])
        holo.img_ij = np.sqrt(frame)
        holo._update_weights()
        holos.append(holo)
    t, j = holos
    np.testing.assert_allclose(t.img_knm, j.img_knm, atol=1e-6, equal_nan=True)
    _assert_weights(t.weights, j.weights)


@pytest.mark.parametrize("method", ["WGS-Kim", "WGS-Leonardo"])
def test_experimental_image_feedback_matches_jax(method):
    """``"experimental"`` feedback on a ``target_ij`` image: the weights
    follow the camera's image resampled into the computational basis; the
    computational and camera-basis stats agree on what users read. Every
    pixel of the image feeds its own weight, so a count that differs by one
    between the packages moves that weight far and the weight plane is not
    held here; one update from the same frame is
    (:meth:`test_experimental_weight_update_matches_jax`)."""
    tfs, jfs = _rigs()
    holos = {}
    for pkg, fs in ((T, tfs), (J, jfs)):
        fs.cam.set_exposure(150.0)
        holo = pkg.FeedbackHologram(SHAPE, target_ij=_target_ij(), cameraslm=fs)
        holo.reset_phase(custom_phase=_phase(9))
        holo.optimize(method, maxiter=4, verbose=False, stat_groups=["computational"])
        holo.optimize(method, maxiter=5, verbose=False, feedback="experimental",
                      stat_groups=["computational", "experimental"])
        holos[pkg] = holo
    t, j = holos[T], holos[J]
    assert t._engine_feedback() == j._engine_feedback() == "external"
    assert t.iter == j.iter == 9
    assert np.isnan(t.stats["stats"]["experimental_ij"]["efficiency"][:4]).all()
    for group in ("computational", "experimental_ij"):
        for key in ("uniformity", "efficiency"):
            got = t.stats["stats"][group][key]
            ref = j.stats["stats"][group][key]
            np.testing.assert_allclose(got, ref, atol=LOOP_STAT_ATOL, err_msg=f"{group}/{key}")


# ----------------------------------------------------------------------
# SpotHologram null regions.
# ----------------------------------------------------------------------


def _null_pair(case):
    spots = np.array([[20.0, 40, 30], [24.0, 24, 44]])
    if case in ("knm_vectors", "knm_vectors_radius", "knm_region", "knm_frac"):
        kwargs = dict(basis="knm")
        if case.startswith("knm_vectors"):
            kwargs["null_vectors"] = np.array([[10.0, 50], [50.0, 10]])
            if case == "knm_vectors_radius":
                kwargs["null_radius"] = 3.0
        elif case == "knm_region":
            region = np.zeros((64, 64), dtype=bool)
            region[:10] = True
            kwargs.update(null_vectors=np.array([[50.0], [50.0]]), null_region=region)
        else:
            kwargs["null_region_radius_frac"] = 0.7
        return [pkg.SpotHologram((64, 64), spots.copy(), phase=_phase(11, (64, 64)),
                                 **{k: (v.copy() if isinstance(v, np.ndarray) else v)
                                    for k, v in kwargs.items()})
                for pkg in (T, J)]
    tfs, jfs = _rigs()
    region = np.zeros((SIDE, SIDE))
    region[:, :20] = 1.0
    kwargs = dict(basis="ij", null_vectors=np.array([[52.0, 80], [80.0, 48]]),
                  null_radius=4.0)
    if case == "ij_region_frac":
        kwargs.update(null_region=region, null_region_radius_frac=0.9)
    pair = []
    for pkg, fs in ((T, tfs), (J, jfs)):
        holo = pkg.SpotHologram(SHAPE, SPOTS_GRID[:, :5].copy(), cameraslm=fs,
                                **{k: (v.copy() if isinstance(v, np.ndarray) else v)
                                   for k, v in kwargs.items()})
        holo.reset_phase(custom_phase=_phase(12))
        pair.append(holo)
    return pair


@pytest.mark.parametrize("case", ["knm_vectors", "knm_vectors_radius", "knm_region",
                                  "knm_frac", "ij_vectors", "ij_region_frac"])
def test_null_regions_match_jax(case):
    """Null vectors make the background free (nan) with zero discs around
    them and the spots; a null region and a radius fraction zero the
    target. The target, the weights and a short MRAF run agree."""
    t, j = _null_pair(case)
    assert t.null_radius_knm == j.null_radius_knm
    np.testing.assert_array_equal(t.null_region_knm, j.null_region_knm)
    np.testing.assert_array_equal(np.isnan(t.target), np.isnan(j.target))
    np.testing.assert_allclose(t.target, j.target, atol=1e-7, equal_nan=True)
    np.testing.assert_allclose(t.weights, np.asarray(j.weights), atol=1e-7)
    assert np.isnan(t.target).any() == (case != "knm_frac")
    for holo in (t, j):
        holo.optimize("WGS-Kim", maxiter=4, verbose=False, stat_groups=["computational"])
    _assert_stats(t, j, ["computational"])
    _assert_weights(t.weights, j.weights)


def test_imprint_matches_jax():
    """The toolbox copies behind the null discs: ``window_slice`` in its
    three forms and ``imprint`` (constant, circular, clipped, added)."""
    for window, kwargs in (((10, 7, 20, 5), {}), ((3, 9, 60, 9), dict(centered=True)),
                           ((30, 11, 30, 7), dict(centered=True, circular=True))):
        got, ref = TT.window_slice(window, (64, 64), **kwargs), JT.window_slice(
            window, (64, 64), **kwargs)
        for g, r in zip(got, ref):
            assert np.array_equal(np.arange(64)[g], np.arange(64)[r])
        a, b = np.zeros((64, 64)), np.zeros((64, 64))
        TT.imprint(a, window, 2.0, **kwargs)
        JT.imprint(b, window, 2.0, **kwargs)
        TT.imprint(a, window, 1.0, imprint_operation="add", **kwargs)
        JT.imprint(b, window, 1.0, imprint_operation="add", **kwargs)
        np.testing.assert_array_equal(a, b)
    grid = np.meshgrid(np.arange(64.0), np.arange(64.0))
    a, b = np.zeros((64, 64)), np.zeros((64, 64))
    TT.imprint(a, (5, 9, 5, 9), lambda g: g[0] + 2 * g[1], grid=grid, shift=True)
    JT.imprint(b, (5, 9, 5, 9), lambda g: g[0] + 2 * g[1], grid=grid, shift=True)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="grid"):
        TT.imprint(a, (5, 9, 5, 9), lambda g: g[0])


# ----------------------------------------------------------------------
# CompressedSpotHologram's host loop.
# ----------------------------------------------------------------------


def _compressed_pair(spot_amp=None):
    rng = np.random.default_rng(8)
    vectors = np.vstack([rng.uniform(-8e-3, 8e-3, (2, 9)), rng.uniform(-2e-6, 2e-6, (1, 9))])
    pair = []
    for pkg, slm_cls in ((T, None), (J, JSLM)):
        if slm_cls is None:
            from slmsuite_torch.hardware.slms.simulated import SimulatedSLM as slm_cls
        slm = slm_cls((64, 64), pitch_um=(8, 8), wav_um=0.78)
        holo = pkg.CompressedSpotHologram(vectors, basis="kxy", spot_amp=spot_amp,
                                          cameraslm=slm)
        holo.reset_phase(_phase(9, (64, 64)))
        pair.append(holo)
    return pair


COMPRESSED_CASES = ("callback", "external_spot", "zero_factor", "zero_factor_callback")


@pytest.mark.parametrize("case", COMPRESSED_CASES)
def test_compressed_host_loop_matches_jax(case):
    """The compressed host loop: a callback stopping at iteration 6,
    ``external_spot`` amplitudes the test gives, and ``zero_factor`` MRAF
    (nan noise spots and null spots, whose complex zero weights the host
    loop carries); psi, the weights, the zero weights and the stats agree,
    and the engine resumes from the host loop's state."""
    spot_amp = None
    flags = dict(fix_phase_iteration=3)
    if case.startswith("zero_factor"):
        spot_amp = np.ones(9)
        spot_amp[::4] = np.nan
        spot_amp[1] = spot_amp[6] = 0.0
        flags.update(zero_factor=0.1, mraf_factor=0.5)
    t, j = _compressed_pair(spot_amp)
    amps = np.random.default_rng(14).uniform(0.5, 1.5, 9)
    for holo in (t, j):
        kwargs = dict(flags, stat_groups=["computational_spot"])
        if case.endswith("callback"):
            kwargs["callback"] = lambda h: h.iter == 6
        if case == "external_spot":
            holo.external_spot_amp = amps.copy()
            kwargs.update(feedback="external_spot",
                          stat_groups=["computational_spot", "external_spot"])
        holo.optimize("WGS-Kim", maxiter=10, verbose=False, **kwargs)
    expect = 6 if case.endswith("callback") else 10
    assert t.iter == j.iter == expect
    groups = ["computational_spot"] + (["external_spot"] if case == "external_spot" else [])
    _assert_stats(t, j, groups)
    np.testing.assert_allclose(t.amp_ff, np.asarray(j.amp_ff), atol=STATS_ATOL)
    _assert_weights(t.weights, j.weights)
    dp = np.abs(np.mod(np.asarray(t.phase, float) - np.asarray(j.phase, float) + np.pi,
                       2 * np.pi) - np.pi)
    assert np.quantile(dp, 0.99) < PHASE_ATOL
    if case.startswith("zero_factor"):
        zt, zj = t._zero_weights_c, j._zero_weights_c
        assert zt.dtype == zj.dtype == np.complex64 and np.abs(zj).max() > 0
        np.testing.assert_allclose(zt, zj, atol=WEIGHT_RTOL * np.abs(zj).max())
    for holo in (t, j):
        holo.optimize("WGS-Kim", maxiter=3, verbose=False, stat_groups=["computational_spot"],
                      **{k: v for k, v in flags.items() if k != "zero_factor"})
    assert t.iter == j.iter == expect + 3
    _assert_weights(t.weights, j.weights, atol=STATS_ATOL)


def test_compressed_camera_feedback_names_item_9():
    """Camera feedback on a compressed hologram needs a camera: with a bare
    SLM it raises at the first measurement (item 9 ported it for
    CameraSLMs: ``tests/test_torch_wavefront.py``): the feedback at the
    first weight update (iteration 1), the stat group at once."""
    t, _ = _compressed_pair()
    for kwargs in (dict(feedback="experimental_spot"), dict(stat_groups=["experimental_spot"])):
        with pytest.raises(RuntimeError, match="cameraslm"):
            t.optimize("WGS-Kim", maxiter=2, verbose=False, **kwargs)
        assert t.iter == 1
