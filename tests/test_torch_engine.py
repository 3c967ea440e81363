"""
The port's fused carry-mode engine (``slmsuite_torch.ops.engine.run_gs``)
against the JAX package's engine on the CPU, where JAX runs its natural
(non-fused) loop with ``jnp.fft``. The two agree to f32 round-off: the
fused loop's deferred-by-one weight norm and Parseval feedback norm are
exact substitutions (``TestScrambledEngine`` shows the same inside JAX).

128^2, a ``spot_array_wgs``-style target, 20 iterations. Tolerances:
unfolded phase (modulo 2 pi, global offset removed) 5e-4 rad, weights
atol 1e-5, stats rows atol 1e-4 / rtol 1e-3, round-off grown over 20
iterations.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slmsuite_torch
from slmsuite_torch import convert
from slmsuite_torch.models import engine_models as tmodels
from slmsuite_torch.ops import engine as TE
from slmsuite_torch.ops import propagation as tprop
from slmsuite_tpu.models import engine_models as jmodels
from slmsuite_tpu.ops import engine as JE

N = 128
ITERS = 20
PHASE_ATOL = 5e-4
WEIGHT_ATOL = 1e-5
STATS_ATOL, STATS_RTOL = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    slmsuite_torch.set_default_device("cpu")
    yield
    slmsuite_torch.set_default_device("cuda")
    torch.set_num_threads(threads)


CASES = {
    "leonardo": dict(method="WGS-Leonardo"),
    "kim_iter": dict(method="WGS-Kim", fix_phase_iteration=5),
    "kim_eff": dict(method="WGS-Kim", fix_phase_efficiency=0.5, fix_phase_iteration=1),
    "wu": dict(method="WGS-Wu", feedback_exponent=0.5),
    "tanh": dict(method="WGS-tanh", feedback_exponent=0.5, feedback_factor=0.2),
    "kim_nostats": dict(method="WGS-Kim", stats=False, fix_phase_iteration=5),
}


def _numpy_inputs(case):
    target = tmodels.spot_array_target(N, 4, 8)
    rng = np.random.default_rng(7)
    psi0 = tprop.fold_phase(rng.uniform(-np.pi, np.pi, (N, N)).astype(np.float32), (N, N))
    stats = case.get("stats", True)
    consts = dict(
        amp=np.float32(1.0 / N),
        target=target,
        stat_mask=target != 0,
        feedback_exponent=np.float32(case.get("feedback_exponent", 0.8)),
        feedback_factor=np.float32(case.get("feedback_factor", 0.1)),
        fix_phase_iteration=np.int32(case.get("fix_phase_iteration", 10)),
        fix_phase_efficiency=np.float32(case.get("fix_phase_efficiency", np.nan)),
    )
    config = dict(
        method=case["method"], shape=(N, N), slm_shape=(N, N),
        stat_groups=("computational",) if stats else (),
        kim_efficiency_trigger="fix_phase_efficiency" in case,
    )
    return psi0, target, consts, config


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_gs_matches_jax(name):
    psi0, target, consts, config = _numpy_inputs(CASES[name])

    jconfig = JE.GSConfig(**config)
    jconsts = {k: jnp.asarray(v) for k, v in consts.items()}
    jstate, jstats = JE.run_gs(jconfig, JE.init_gs_state(jconfig, psi0, target.copy()),
                               jconsts, ITERS)

    tconfig = TE.GSConfig(**config)
    tstate = convert.gs_state_from_numpy(dict(
        psi=psi0, weights=target, phase_ff=np.zeros((N, N)),
        fixed_phase=False, unfixed_streak=np.int32(0), iteration=np.int32(0),
    ))
    tstate, tstats = TE.run_gs(tconfig, tstate, convert.consts_from_numpy(consts), ITERS)

    phase_t = tprop.unfold_phase(tstate.psi.numpy(), (N, N))
    phase_j = tprop.unfold_phase(np.asarray(jstate.psi), (N, N))
    dp = phase_t - phase_j
    dp = np.mod(dp - dp.flat[0] + np.pi, 2 * np.pi) - np.pi
    assert np.abs(dp).max() < PHASE_ATOL, np.abs(dp).max()
    np.testing.assert_allclose(tstate.weights.numpy(), np.asarray(jstate.weights),
                               atol=WEIGHT_ATOL)
    np.testing.assert_allclose(tstats.numpy(), np.asarray(jstats),
                               atol=STATS_ATOL, rtol=STATS_RTOL, equal_nan=True)
    assert bool(tstate.fixed_phase) == bool(jstate.fixed_phase)
    assert int(tstate.iteration) == int(jstate.iteration) == ITERS
    if "Kim" in config["method"]:
        on = target != 0  # the stored farfield phase matters where light goes
        dphi = np.angle(np.exp(1j * (tstate.phase_ff.numpy() - np.asarray(jstate.phase_ff))))
        assert np.abs(dphi[on]).max() < PHASE_ATOL


def test_chunked_run_matches_single_run():
    """Chunks enter and exit the carry each time; the trajectory is the
    same to round-off."""
    psi0, target, consts, config = _numpy_inputs(CASES["kim_iter"])
    tconfig = TE.GSConfig(**config)

    def state():
        return convert.gs_state_from_numpy(dict(
            psi=psi0, weights=target, phase_ff=np.zeros((N, N)),
            fixed_phase=False, unfixed_streak=np.int32(0), iteration=np.int32(0),
        ))

    tconsts = convert.consts_from_numpy(consts)
    one, stats_one = TE.run_gs(tconfig, state(), tconsts, ITERS)
    seen = []
    many, stats_many = TE.run_gs_chunked(tconfig, state(), tconsts, ITERS, chunk=7,
                                         on_chunk=seen.append)
    assert seen == [7, 7, 6]
    np.testing.assert_allclose(torch.cat(stats_many).numpy(), stats_one.numpy(),
                               atol=STATS_ATOL, rtol=STATS_RTOL)
    np.testing.assert_allclose(many.weights.numpy(), one.weights.numpy(), atol=WEIGHT_ATOL)


def test_spot_array_wgs_model_matches_jax():
    """The headline model, cut to 128^2: the same target, phase and
    config as ``slmsuite_tpu``'s ``spot_array_wgs``; one short run agrees."""
    tm = tmodels.spot_array_wgs(N=N, n_side=8, spacing_div=16, device="cpu")
    jm = jmodels.spot_array_wgs(N=N, n_side=8, spacing_div=16)
    np.testing.assert_array_equal(tm.target, jm.target)
    np.testing.assert_array_equal(tm.phase0.numpy(), jm.phase0)
    assert dataclasses.asdict(tm.config) == {
        k: v for k, v in dataclasses.asdict(jm.config).items()
        if k in dataclasses.asdict(tm.config)
    }
    tstate, tstats = tm.run(5)
    jstate, jstats = jm.run(5)
    np.testing.assert_allclose(tstats.numpy(), np.asarray(jstats),
                               atol=STATS_ATOL, rtol=STATS_RTOL)


@pytest.mark.parametrize("change", [
    dict(feedback="experimental_spot_sim"),
    dict(stat_groups=("experimental_spot",)),
    dict(feedback="external_spot"),
    dict(stat_groups=("experimental",)),
])
def test_unported_configs_raise(change):
    """The simulated camera and host-side feedback or stats raise, naming
    their ROADMAP item (GS, Nogrette, padded shapes, kernels,
    computational_spot and MRAF run)."""
    config = TE.GSConfig(**dict(
        dict(method="WGS-Kim", shape=(64, 64), slm_shape=(64, 64)), **change
    ))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TE.make_gs_step(config)
    state = TE.init_gs_state(config, np.zeros((64, 64)), np.zeros(config.shape))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TE.run_gs(config, state, {}, 1)


@pytest.mark.parametrize("change", [dict(mraf=True), dict(method="GS", mraf=True)])
def test_mraf_configs_run(change):
    """The two MRAF configurations that raised before MRAF was ported now
    build a step and run: WGS-Kim on the carry-mode MRAF step, GS on the
    natural step."""
    config = TE.GSConfig(**dict(
        dict(method="WGS-Kim", shape=(64, 64), slm_shape=(64, 64),
             stat_groups=("computational",)), **change
    ))
    assert TE._mraf_fused_active(config) is (config.method == "WGS-Kim")
    assert callable(TE.make_gs_step(config))
    target = np.full((64, 64), np.nan, np.float32)
    target[24:40, 24:40] = 0.0
    target[28:36:2, 28:36:2] = 0.25
    noise = np.isnan(target)
    consts = convert.consts_from_numpy(dict(
        amp=np.float32(1 / 64), target=target, stat_mask=target > 0,
        feedback_exponent=np.float32(0.8), feedback_factor=np.float32(0.1),
        fix_phase_iteration=np.int32(10), fix_phase_efficiency=np.float32(np.nan),
        signal_mask=target > 0, noise_mask=noise, zero_mask=target == 0,
        mraf_factor=np.float32(1.0),
    ), device="cpu")
    psi0 = np.random.default_rng(3).uniform(-np.pi, np.pi, (64, 64))
    state = TE.init_gs_state(config, psi0, np.nan_to_num(target), device="cpu")
    state, stats = TE.run_gs(config, state, consts, 3)
    assert int(state.iteration) == 3 and stats.shape == (3, 2, 4)
    assert bool(torch.isfinite(state.psi).all()) and 0 < float(stats[-1, 0, 0]) <= 1


@pytest.mark.parametrize("entry", ["run_gs_scheduled", "run_gs_batch", "set_scrambled_mode"])
def test_tpu_only_entry_points_raise(entry):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(TE, entry)(None)
