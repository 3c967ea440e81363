"""
The port's public classes on the CPU: the golden replay of the six
carry-loop configurations (the five fusable ones and MRAF WGS-Leonardo
with zero weights) and of the natural path's five (GS, Nogrette, a padded
hologram, spot feedback, GS-MRAF) with the port's ``Hologram``/
``SpotHologram`` (``tests/holography/golden``, the tolerances of
``test_reference_parity.py``, std_err within 1e-6 / 1e-5), a 256^2
``SpotHologram`` WGS-Kim run held
against ``slmsuite_tpu`` on the same inputs, and a resume from the JAX
package's planes through ``Hologram.load_arrays``.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import slmsuite_torch
from slmsuite_torch.holography import algorithms as T
from slmsuite_tpu.holography import algorithms as J


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "holography", "golden")

_spec = importlib.util.spec_from_file_location(
    "golden_configs", os.path.join(GOLDEN_DIR, "configs.py")
)
configs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(configs)

#: PyTorch's thread count before the module fixture sets 1.
DEFAULT_THREADS = torch.get_num_threads()

#: test_reference_parity.py's tolerances.
STATS_ATOL, STATS_RTOL = 1e-4, 1e-3
PHASE_ATOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    slmsuite_torch.set_default_device("cpu")
    yield
    slmsuite_torch.set_default_device("cuda")
    torch.set_num_threads(threads)


def _phase_err(a, b):
    dp = np.asarray(a) - np.asarray(b)
    dp = np.mod(dp - dp.flat[0] + np.pi, 2 * np.pi) - np.pi
    return np.abs(dp).max()


#: The carry loops' goldens (the fused WGS loop's and the MRAF one's), and
#: the natural path's.
FUSED_GOLDENS = ["wgs_leonardo", "wgs_kim_iter", "wgs_kim_eff", "wgs_wu", "wgs_tanh",
                 "wgs_leonardo_mraf_zero"]
NATURAL_GOLDENS = ["gs", "wgs_nogrette", "gs_padded", "spots_kim", "gs_mraf"]
#: std_err against the golden on every iteration: the port forms it from
#: float64 moments (largest difference measured 2.6e-7 on the fused
#: goldens and 1.8e-6 on spots_kim, at 1 and 8 threads; 1.9e-7 on
#: wgs_leonardo_mraf_zero and 1.2e-7 on gs_mraf at 2 threads).
STD_ERR_ATOL = {name: 1e-6 for name in FUSED_GOLDENS}
STD_ERR_ATOL.update({name: 1e-5 for name in NATURAL_GOLDENS})


def _replay(name):
    golden = np.load(os.path.join(GOLDEN_DIR, f"ref_{name}.npz"))
    stats, phase = configs.run_config(name, T.Hologram, T.SpotHologram)
    for key in configs.STAT_KEYS:
        np.testing.assert_allclose(
            stats[key], np.asarray(golden[key]), atol=STATS_ATOL, rtol=STATS_RTOL,
            err_msg=f"{name}/{key}",
        )
    np.testing.assert_allclose(stats["std_err"], np.asarray(golden["std_err"]),
                               atol=STD_ERR_ATOL[name], rtol=0, err_msg=f"{name}/std_err")
    assert _phase_err(phase, golden["phase"]) < PHASE_ATOL


@pytest.mark.parametrize("name", FUSED_GOLDENS + NATURAL_GOLDENS)
def test_golden_replay(name):
    _replay(name)


@pytest.mark.parametrize("name", FUSED_GOLDENS)
def test_golden_replay_default_threads(name):
    """The fused goldens at PyTorch's default thread count (another
    summation order than at one thread)."""
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        _replay(name)
    finally:
        torch.set_num_threads(1)


def _spot_run(module, phi0, maxiter=20, **flags):
    holo = module.SpotHologram.make_rectangular_array(
        (256, 256), array_shape=(8, 8), array_pitch=(20, 20), basis="knm"
    )
    holo.reset_phase(custom_phase=phi0)
    holo.optimize(method="WGS-Kim", maxiter=maxiter, stat_groups=["computational"],
                  verbose=False, **flags)
    return holo


def test_spot_hologram_matches_jax():
    phi0 = np.random.default_rng(11).uniform(-np.pi, np.pi, (256, 256)).astype(np.float32)
    tholo = _spot_run(T, phi0, fix_phase_iteration=5)
    jholo = _spot_run(J, phi0, fix_phase_iteration=5)

    np.testing.assert_array_equal(tholo.target, jholo.target)
    for key in configs.STAT_KEYS:
        np.testing.assert_allclose(
            tholo.stats["stats"]["computational"][key],
            jholo.stats["stats"]["computational"][key],
            atol=STATS_ATOL, rtol=STATS_RTOL, err_msg=key,
        )
    assert tholo.stats["flags"]["fixed_phase"] == jholo.stats["flags"]["fixed_phase"]
    assert tholo.iter == jholo.iter == 20
    assert _phase_err(tholo.get_phase(), jholo.get_phase()) < PHASE_ATOL
    np.testing.assert_allclose(tholo.weights, np.asarray(jholo.weights), atol=1e-5)
    np.testing.assert_allclose(tholo.get_amp_ff(), np.asarray(jholo.get_amp_ff()), atol=1e-5)
    far_t, far_j = tholo.get_farfield(), jholo.get_farfield()
    np.testing.assert_allclose(np.abs(far_t), np.abs(far_j), atol=1e-5)


def test_resume_from_jax_arrays():
    """Both packages continue from the JAX hologram's planes after 5
    iterations; the next 5 agree."""
    phi0 = np.random.default_rng(12).uniform(-np.pi, np.pi, (256, 256)).astype(np.float32)
    jholo = _spot_run(J, phi0, maxiter=5, fix_phase_iteration=3)
    tholo = T.SpotHologram.make_rectangular_array(
        (256, 256), array_shape=(8, 8), array_pitch=(20, 20), basis="knm"
    )
    tholo.load_arrays(dict(
        psi=np.asarray(jholo._psi), weights=np.asarray(jholo.weights),
        phase_ff_folded=np.asarray(jholo._phase_ff_folded), iter=jholo.iter,
        fixed_phase=jholo.flags["fixed_phase"],
    ))
    assert tholo.iter == 5
    for holo in (tholo, jholo):
        holo.optimize(method="WGS-Kim", maxiter=5, stat_groups=["computational"],
                      verbose=False, fix_phase_iteration=3)
    eff_t = tholo.stats["stats"]["computational"]["efficiency"]
    eff_j = jholo.stats["stats"]["computational"]["efficiency"]
    np.testing.assert_allclose(eff_t[5:], eff_j[5:], atol=STATS_ATOL, rtol=STATS_RTOL)
    assert _phase_err(tholo.get_phase(), jholo.get_phase()) < PHASE_ATOL


def test_unported_paths_raise():
    """The kxy basis without hardware raises as in the JAX package; MRAF
    (a nan target), callbacks, spot null regions and CG, which raised
    before they were ported, run (``tests/test_torch_hostloop.py`` and
    ``tests/test_torch_cg.py`` hold them against the JAX package)."""
    target = np.ones((64, 64))
    target[:8] = np.nan
    mraf = T.Hologram(target=target)
    mraf.optimize(method="GS", maxiter=2, verbose=False)
    assert mraf.iter == 2 and np.isfinite(mraf.get_phase()).all()
    holo = T.Hologram(target=np.ones((64, 64)))
    holo.optimize(method="WGS-Kim", maxiter=3, verbose=False, callback=lambda h: h.iter == 1)
    assert holo.iter == 1
    holo.optimize(method="CG", maxiter=2, verbose=False)
    assert holo.iter == 3 and np.isfinite(holo.flags["loss_result"])
    with pytest.raises(ValueError, match="cameraslm"):
        T.SpotHologram((64, 64), [[10, 20], [10, 20]], basis="kxy")
    with pytest.raises(ValueError, match="cameraslm"):
        J.SpotHologram((64, 64), [[10, 20], [10, 20]], basis="kxy")
    nulled = T.SpotHologram((64, 64), [[10, 20], [10, 20]], basis="knm",
                            null_vectors=[[30], [30]])
    assert np.isnan(nulled.target).any() and nulled.null_radius_knm == 3


@pytest.mark.parametrize("reset_weights", [False, True])
def test_set_target_takes_plot_like_jax(reset_weights):
    """``set_target(new_target, reset_weights, plot=False)`` (the JAX
    package's signature) rebuilds the same target and weights in both
    packages after the spots move; ``plot=True`` draws nothing and leaves
    the same target, as in the JAX package."""
    holos = [pkg.SpotHologram.make_rectangular_array(
        (64, 64), array_shape=(3, 3), array_pitch=(12, 12), basis="knm") for pkg in (T, J)]
    for holo in holos:
        holo.spot_knm = holo.spot_knm + 2
        holo.set_target(None, reset_weights, plot=False)
    tholo, jholo = holos
    np.testing.assert_array_equal(tholo.target, np.asarray(jholo.target))
    np.testing.assert_array_equal(np.asarray(tholo.weights), np.asarray(jholo.weights))
    import matplotlib.pyplot as plt

    plt.close("all")
    tholo.set_target(plot=True)
    jholo.set_target(plot=True)
    assert not plt.get_fignums()
    np.testing.assert_array_equal(tholo.target, np.asarray(jholo.target))


# ----------------------------------------------------------------------
# The quadratic initial phase: the second moments, the blaze and the lens
# copied from the JAX package's toolbox, and reset_phase(quadratic_phase=).
# ----------------------------------------------------------------------

#: Host numpy on both sides (float64 moments, the same operations): the
#: helpers agree to round-off; the phase is built in the hologram's float32.
QUADRATIC_ATOL = 1e-12
QUADRATIC_PHASE_ATOL = 1e-5


@pytest.mark.parametrize("centers", [None, "given"])
@pytest.mark.parametrize("grid", [None, 0.5, "1d", "2d"])
def test_image_moments_match_jax(centers, grid):
    """``image_centroids`` and ``image_variances`` (shear on and off, nan
    sums) on a stack of seeded images, on each kind of grid."""
    from slmsuite_torch.holography import analysis as TA
    from slmsuite_tpu.holography import analysis as JA

    rng = np.random.default_rng(21)
    images = rng.uniform(0, 1, (3, 24, 30))
    images[1, 3, 4] = np.nan
    if grid == "1d":
        grid = (np.linspace(-1, 1, 30), np.linspace(-2, 2, 24))
    elif grid == "2d":
        grid = np.meshgrid(np.linspace(-1, 1, 30), np.linspace(-2, 2, 24))
    c = rng.uniform(-1, 1, (2, 3)) if centers == "given" else None
    np.testing.assert_allclose(TA.image_centroids(images, grid=grid, nansum=True),
                               JA.image_centroids(images, grid=grid, nansum=True),
                               atol=QUADRATIC_ATOL)
    for shear in (False, True):
        got = TA.image_variances(images, centers=c, grid=grid, nansum=True,
                                 exclude_shear=shear)
        want = JA.image_variances(images, centers=c, grid=grid, nansum=True,
                                  exclude_shear=shear)
        assert got.shape == want.shape == (2 if shear else 3, 3)
        np.testing.assert_allclose(got, want, atol=QUADRATIC_ATOL)


@pytest.mark.parametrize("vector", [(0, 0), (0.01, 0), (0, -0.02), (0.01, 0.03),
                                    (0.01, 0.02, 0.5)])
def test_blaze_matches_jax(vector):
    from slmsuite_torch.holography.toolbox import phase as TP
    from slmsuite_tpu.holography.toolbox import phase as JP

    grid = np.meshgrid(np.linspace(-3, 3, 17), np.linspace(-2, 2, 11))
    np.testing.assert_allclose(TP.blaze(grid, vector), JP.blaze(grid, vector),
                               atol=QUADRATIC_ATOL)


@pytest.mark.parametrize("f", [np.inf, 2.0, (3.0, np.inf), (np.inf, -4.0), (1.5, 2.5)])
def test_lens_matches_jax(f):
    from slmsuite_torch.holography.toolbox import phase as TP
    from slmsuite_tpu.holography.toolbox import phase as JP

    grid = np.meshgrid(np.linspace(-3, 3, 17), np.linspace(-2, 2, 11))
    np.testing.assert_allclose(TP.lens(grid, f), JP.lens(grid, f), atol=QUADRATIC_ATOL)
    for mod in (TP, JP):
        with pytest.raises(ValueError, match="zero"):
            mod.lens(grid, (0.0, 1.0))


def _quadratic_pair(kind):
    """The same hologram in both packages: a SpotHologram array, one spot
    (no extent: focal power 0), an image Hologram with an amplitude
    plane, and a CompressedSpotHologram of 3D spots."""
    rng = np.random.default_rng(23)
    if kind == "spots":
        return [pkg.SpotHologram.make_rectangular_array(
            (128, 128), array_shape=(4, 3), array_pitch=(12, 16), array_center=(70, 50),
            basis="knm") for pkg in (T, J)]
    if kind == "one spot":
        return [pkg.SpotHologram((128, 128), [[80], [40]], basis="knm") for pkg in (T, J)]
    if kind == "image":
        target = np.zeros((96, 128))
        target[20:40, 60:100] = rng.uniform(0.5, 1, (20, 40))
        amp = np.exp(-np.sum(np.square(np.meshgrid(np.linspace(-1, 1, 64),
                                                   np.linspace(-1, 1, 48))), axis=0))
        return [pkg.Hologram(target, amp=amp, slm_shape=(48, 64)) for pkg in (T, J)]
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM as TSLM
    from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM as JSLM

    spots = np.vstack([rng.uniform(-8e-3, 8e-3, (2, 7)), rng.uniform(-2e-6, 2e-6, (1, 7))])
    return [pkg.CompressedSpotHologram(spots, cameraslm=slm((64, 64), pitch_um=(8, 8),
                                                              wav_um=0.78))
            for pkg, slm in ((T, TSLM), (J, JSLM))]


@pytest.mark.parametrize("kind", ["spots", "one spot", "image", "compressed"])
@pytest.mark.parametrize("scaling", [1, 2.5])
def test_quadratic_initial_phase_matches_jax(kind, scaling):
    """The target moments and ``reset_phase(quadratic_phase=scaling,
    random_phase=0)``; the single spot has no extent, so its lens is flat
    (focal power 0) and the phase is the blaze alone. The compressed
    hologram's spot moments are nan in the JAX package (its ``kxy`` ->
    ``knm`` conversion at shape (1, 1)), summed as 0: its quadratic phase
    is a no-op there, and the port copies that. This case pins parity with
    the JAX package, not a working quadratic phase for that class."""
    tholo, jholo = _quadratic_pair(kind)
    for got, want in zip(tholo._get_target_moments_knm_norm(),
                         jholo._get_target_moments_knm_norm()):
        np.testing.assert_allclose(got, want, atol=QUADRATIC_ATOL)
    for holo in (tholo, jholo):
        holo.reset_phase(quadratic_phase=scaling, random_phase=0)
    got, want = np.asarray(tholo.get_phase()), np.asarray(jholo.get_phase())
    assert got.shape == want.shape == tuple(tholo.slm_shape)
    assert np.isfinite(got).all() and (np.ptp(got) > 0) == (kind != "compressed")
    np.testing.assert_allclose(got, want, atol=QUADRATIC_PHASE_ATOL)
    if kind == "one spot":
        _, std = tholo._get_target_moments_knm_norm()
        assert np.all(std == 0)
        np.testing.assert_allclose(tholo._get_quadratic_initial_phase(scaling),
                                   T.Hologram._get_quadratic_initial_phase.__get__(tholo)(1),
                                   atol=0)


def test_quadratic_phase_flag_and_random_phase():
    """The ``quadratic_phase`` flag is read where the argument is None, and
    the random phase is added on top (numpy's global generator, as in the
    JAX package)."""
    tholo, jholo = _quadratic_pair("spots")
    for holo in (tholo, jholo):
        holo.flags["quadratic_phase"] = 1
        np.random.seed(5)
        holo.reset_phase(random_phase=0.5)
    np.testing.assert_allclose(np.asarray(tholo.get_phase()), np.asarray(jholo.get_phase()),
                               atol=QUADRATIC_PHASE_ATOL)
