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
    """Callbacks, CG and the kxy basis raise, naming their ROADMAP item;
    MRAF (a nan target), which raised before it was ported, runs."""
    target = np.ones((64, 64))
    target[:8] = np.nan
    mraf = T.Hologram(target=target)
    mraf.optimize(method="GS", maxiter=2, verbose=False)
    assert mraf.iter == 2 and np.isfinite(mraf.get_phase()).all()
    holo = T.Hologram(target=np.ones((64, 64)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        holo.optimize(method="WGS-Kim", maxiter=2, verbose=False, callback=lambda h: False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        holo.optimize(method="CG", maxiter=2, verbose=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.SpotHologram((64, 64), [[10, 20], [10, 20]], basis="kxy")
