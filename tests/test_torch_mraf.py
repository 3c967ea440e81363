"""
The port's MRAF (``slmsuite_torch``) against the JAX package on the CPU:
the plain carry-mode MRAF step and its two column passes, the
natural-order ``ifft2_phase``, the psi -> psi steps ``wgs_fused_step`` and
``mraf_fused_step``, the kernel compositions of ``cuda_fft`` run on the
kernels' plain versions, the engine for every MRAF configuration, the
``image_mraf`` model and ``Hologram`` with an MRAF target.

The JAX package runs its ``*_scrambled*`` twins on the CPU, whose
farfield planes are in the four-step scrambled order (the carry along its
last axis only), so the JAX inputs are permuted with
``scramble_permutation_2d`` and its outputs un-permuted. On the CPU the
JAX engine runs MRAF on its natural step (its carry step needs the
scrambled layout); the port takes the carry step for Leonardo and Kim
everywhere, whose deferred-then-exact weight norm agrees to f32
round-off, and its natural step is held against JAX's too.

Tolerances: as ``test_torch_carry.py`` for the step functions (carry
planes 3e-5 relative to their peak; weights, phasors, zero weights,
farfield planes and stats sums atol 3e-5 / rtol 1e-4; psi 99th-percentile
wrapped difference below 2e-3); transformed planes of the compositions
1e-5 relative; engine runs of 10 iterations as ``test_torch_natural.py``
(unfolded phase 5e-4 rad modulo 2 pi with the global offset removed,
weights and zero weights atol 1e-5, stats atol 1e-4 / rtol 1e-3 with
the JAX package's f32 std_err uncertainty added).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slmsuite_torch
from slmsuite_torch import convert
from slmsuite_torch.holography import algorithms as T
from slmsuite_torch.models import engine_models as tmodels
from slmsuite_torch.ops import cuda_fft
from slmsuite_torch.ops import engine as TE
from slmsuite_torch.ops import fft as TF
from slmsuite_torch.ops import propagation as tprop
from slmsuite_tpu.holography import algorithms as J
from slmsuite_tpu.models import engine_models as jmodels
from slmsuite_tpu.ops import engine as JE
from slmsuite_tpu.ops import fft as JF

SHAPE = (64, 128)
CARRY_RTOL = 3e-5
ATOL, RTOL = 3e-5, 1e-4
PSI_P99 = 2e-3
PLANE_RTOL = 1e-5
ITERS = 10
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


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


_PH, _PW = JF.scramble_permutation_2d(SHAPE)


def _scramble2(x):
    return np.asarray(x)[..., _PH, :][..., _PW]


def _unscramble_w(x):
    out = np.empty_like(np.asarray(x))
    out[..., _PW] = np.asarray(x)
    return out


def _unscramble2(x):
    out = np.empty_like(np.asarray(x))
    out[..., _PH[:, None], _PW[None, :]] = np.asarray(x)
    return out


def _assert_carry(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=CARRY_RTOL)


def _assert_close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=ATOL, rtol=RTOL)


def _assert_psi(got, ref):
    diff = np.angle(np.exp(1j * (np.asarray(got) - np.asarray(ref))))
    assert np.percentile(np.abs(diff), 99) < PSI_P99


def _step_inputs(seed=1):
    """psi, the cleaned target, the region code (1 signal at the spots, 2
    noise on a seeded half of the rest, 0 zero), a Kim angle store, an
    amplitude plane and zero weights, all natural order."""
    H, W = SHAPE
    rng = np.random.default_rng(seed)
    psi = rng.uniform(-2 * np.pi, 2 * np.pi, SHAPE).astype(np.float32)
    target = np.zeros(SHAPE, np.float32)
    target[rng.integers(0, H, 12), rng.integers(0, W, 12)] = 1.0
    target /= np.sqrt((target**2).sum())
    mcode = np.where(target > 0, 1.0, np.where(rng.uniform(size=SHAPE) < 0.5, 2.0, 0.0))
    pff = rng.uniform(-np.pi, np.pi, SHAPE).astype(np.float32)
    amp_plane = (0.5 + rng.uniform(0, 1, SHAPE)).astype(np.float32)
    zw = (1e-3 * rng.standard_normal((2, *SHAPE))).astype(np.float32)
    return psi, target, mcode.astype(np.float32), pff, amp_plane, zw


def _amps(kind, amp_plane):
    """(jax amp, port amp, post scale) for a scalar or array amplitude."""
    H, W = SHAPE
    if kind == "scalar":
        a = 1.0 / np.sqrt(H * W)
        return jnp.float32(a), float(a), a / np.sqrt(H * W)
    return jnp.asarray(amp_plane), _t(amp_plane), 1.0 / np.sqrt(H * W)


def _scalars(target, stats_on):
    return dict(
        inv_prev_norm=0.7, apply_update=1.0, use_theta=float(not stats_on),
        feedback_exponent=0.8, feedback_factor=0.2, inv_fnorm=1.3,
        inv_tsum=1.0 / float((target**2).sum()), inv_fsum=0.9,
        mraf_factor=0.4, zero_factor=0.3,
    )


# ----------------------------------------------------------------------
# The carry-mode MRAF step.
# ----------------------------------------------------------------------


@pytest.mark.parametrize("zero", [True, False])
@pytest.mark.parametrize("stats_on", [True, False])
@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
@pytest.mark.parametrize("rule", ["leonardo", "kim"])
def test_mraf_carry_step_matches_jax(rule, amp_kind, stats_on, zero):
    psi, target, mcode, pff, amp_plane, zw = _step_inputs()
    jamp, tamp, post = _amps(amp_kind, amp_plane)
    kim = rule == "kim"
    mask = (target != 0).astype(np.float32)
    scalars = _scalars(target, stats_on)

    gr, gi = JF._wgs_carry_entry_jnp(jnp.asarray(psi), jamp)
    ref = JF._mraf_carry_step_jnp(
        gr, gi, jamp,
        jnp.asarray(_scramble2(target)),
        (jnp.asarray(_scramble2(np.cos(pff))), jnp.asarray(_scramble2(np.sin(pff))))
        if kim else None,
        jnp.asarray(_scramble2(target)),
        jnp.asarray(_scramble2(mask)) if stats_on else None,
        jnp.asarray(_scramble2(mcode)),
        jnp.asarray(_scramble2(zw)) if zero else None,
        {k: jnp.float32(v) for k, v in scalars.items()},
        rule=rule, kim=kim, stats_on=stats_on, zero=zero,
    )
    got = TF.mraf_carry_step(
        _t(_unscramble_w(gr)), _t(_unscramble_w(gi)), tamp, _t(target),
        (_t(np.cos(pff)), _t(np.sin(pff))) if kim else None,
        _t(target), _t(mask) if stats_on else None, _t(mcode),
        _t(zw) if zero else None, TF.pack_scalars(dict(scalars, post=post)),
        rule=rule, kim=kim, stats_on=stats_on, zero=zero,
    )

    _assert_carry(got[0], _unscramble_w(ref[0]))
    _assert_carry(got[1], _unscramble_w(ref[1]))
    _assert_close(got[2], _unscramble2(ref[2]))
    if kim:
        for g, r in zip(got[3], ref[3]):
            _assert_close(g, _unscramble2(r))
    else:
        assert got[3] is None
    if zero:
        assert got[4].shape == (2, *SHAPE)
        _assert_close(got[4], _unscramble2(ref[4]))
    else:
        assert got[4] is None
    _assert_close(got[5], ref[5])
    _assert_close(got[6], ref[6])
    _assert_psi(TF.wgs_carry_exit(got[0], got[1]),
                JF._wgs_carry_exit_jnp(ref[0], ref[1]))


def test_mraf_mix_regions():
    """The mix writes ``uw / ||uw||`` times the phasor in the signal
    region, ``k F`` in the noise region and the updated zero weights in
    the zero region, before the inverse column FFT."""
    _, target, mcode, _, _, zw = _step_inputs()
    rng = np.random.default_rng(2)
    fr, fi, uw = (_t(rng.standard_normal(SHAPE)) for _ in range(3))
    sums = torch.tensor([0.0, 0.0, 0.0, float((uw**2).sum())], dtype=torch.float64)
    scal = TF.pack_scalars(dict(_scalars(target, True), post=1.0))
    hr, hi, _, zw_out = TF._cols_mraf_mix_inv(fr, fi, uw, _t(mcode), None, _t(zw), sums,
                                              scal, kim=False, zero=True)
    mixed = torch.fft.fft(torch.complex(hr, hi), dim=0) / SHAPE[0]
    f = torch.sqrt(fr**2 + fi**2)
    sig, noi, zer = (_t(mcode) == c for c in (1.0, 2.0, 0.0))
    wn = uw / uw.norm()
    expect_r = torch.where(sig, wn * fr / f, torch.where(noi, 0.4 * fr, zw_out[0]))
    expect_i = torch.where(sig, wn * fi / f, torch.where(noi, 0.4 * fi, zw_out[1]))
    np.testing.assert_allclose(mixed.real.numpy(), expect_r.numpy(), atol=1e-5)
    np.testing.assert_allclose(mixed.imag.numpy(), expect_i.numpy(), atol=1e-5)
    torch.testing.assert_close(zw_out[0][zer], _t(zw)[0][zer] - 0.3 * (f * fr)[zer])
    torch.testing.assert_close(zw_out[:, ~zer], _t(zw)[:, ~zer])


# ----------------------------------------------------------------------
# ifft2_phase and the psi -> psi steps.
# ----------------------------------------------------------------------


def test_ifft2_phase_matches_jax():
    rng = np.random.default_rng(3)
    xr, xi = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    ref = JF.ifft2_scrambled_phase(jnp.asarray(_scramble2(xr)), jnp.asarray(_scramble2(xi)))
    _assert_psi(TF.ifft2_phase(_t(xr), _t(xi)), ref)


def _psi_step_inputs(rule, amp_kind, stats_on, seed=4):
    psi, target, mcode, pff, amp_plane, _ = _step_inputs(seed)
    jamp, tamp, post = _amps(amp_kind, amp_plane)
    kim = rule == "kim"
    mask = (target != 0).astype(np.float32)
    scalars = _scalars(target, stats_on)
    weights = target * 1.3
    jargs = (jnp.asarray(psi), jamp, jnp.asarray(_scramble2(weights)),
             jnp.asarray(_scramble2(pff)) if kim else None, jnp.asarray(_scramble2(target)),
             jnp.asarray(_scramble2(mask)) if stats_on else None)
    targs = (_t(psi), tamp, _t(weights), _t(pff) if kim else None, _t(target),
             _t(mask) if stats_on else None)
    jscal = {k: jnp.float32(v) for k, v in scalars.items()}
    # The psi -> psi steps derive the post lane from amp.
    tscal = TF.pack_scalars(dict(scalars, post=0.0))
    return jargs, targs, jscal, tscal, mcode, kim


def _assert_psi_step(got, ref, kim):
    _assert_psi(got[0], ref[0])
    _assert_close(got[1], _unscramble2(ref[1]))
    if kim:
        dphi = np.angle(np.exp(1j * (got[2].numpy() - _unscramble2(ref[2]))))
        assert np.abs(dphi).max() < ATOL
    else:
        assert got[2] is None
    _assert_close(got[3], ref[3])
    _assert_close(got[4], ref[4])


@pytest.mark.parametrize("stats_on", [True, False])
@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
@pytest.mark.parametrize("rule", ["leonardo", "kim", "wu", "tanh"])
def test_wgs_fused_step_matches_jax(rule, amp_kind, stats_on):
    jargs, targs, jscal, tscal, _, kim = _psi_step_inputs(rule, amp_kind, stats_on)
    kw = dict(rule=rule, kim=kim, stats_on=stats_on)
    ref = JF.wgs_fused_step(*jargs, jscal, **kw)
    got = TF.wgs_fused_step(*targs, tscal, **kw)
    _assert_psi_step(got, ref, kim)


@pytest.mark.parametrize("stats_on", [True, False])
@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
@pytest.mark.parametrize("rule", ["leonardo", "kim"])
def test_mraf_fused_step_matches_jax(rule, amp_kind, stats_on):
    jargs, targs, jscal, tscal, mcode, kim = _psi_step_inputs(rule, amp_kind, stats_on)
    kw = dict(rule=rule, kim=kim, stats_on=stats_on)
    ref = JF._mraf_fused_step_jnp(*jargs, jnp.asarray(_scramble2(mcode)), jscal, **kw)
    got = TF.mraf_fused_step(*targs, _t(mcode), tscal, **kw)
    _assert_psi_step(got, ref, kim)


@pytest.fixture
def plain_kernels(monkeypatch):
    """``cuda_fft``'s compositions with each kernel wrapper replaced by its
    plain version, so they run on CPU tensors."""
    for name, plain in [
        ("carry_entry", TF._wgs_carry_entry), ("carry_exit", TF._wgs_carry_exit),
        ("cols_fft", TF._cols_fft), ("cols_wgs_roundtrip", TF._cols_wgs_roundtrip),
        ("rows_normfwd", TF._rows_normfwd), ("cols_mraf_fwd", TF._cols_mraf_fwd),
        ("cols_mraf_mix_inv", TF._cols_mraf_mix_inv),
    ]:
        monkeypatch.setattr(cuda_fft, name, plain)


@pytest.mark.parametrize("fn", ["ifft2_phase", "wgs_fused_step", "mraf_fused_step",
                                "mraf_carry_step"])
@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
def test_kernel_composition_matches_plain(plain_kernels, fn, amp_kind):
    """The kernel sequence of each new dispatcher (directions, the post
    lane, Kim's angle <-> phasor conversions), run on the kernels' plain
    versions, equals the dispatcher's plain version."""
    if fn == "ifft2_phase":
        rng = np.random.default_rng(5)
        xr, xi = (_t(rng.standard_normal(SHAPE)) for _ in range(2))
        _assert_psi(cuda_fft.ifft2_phase(xr, xi), TF._ifft2_phase(xr, xi))
        return
    _, targs, _, tscal, mcode, kim = _psi_step_inputs("kim", amp_kind, True)
    kw = dict(rule="kim", kim=True, stats_on=True)
    if fn == "wgs_fused_step":
        got, ref = cuda_fft.wgs_fused_step(*targs, tscal, **kw), TF._wgs_fused_step(*targs, tscal, **kw)
    elif fn == "mraf_fused_step":
        got = cuda_fft.mraf_fused_step(*targs, _t(mcode), tscal, **kw)
        ref = TF._mraf_fused_step(*targs, _t(mcode), tscal, **kw)
    else:
        psi, amp, weights, pff, target, mask = targs
        _, _, _, _, _, zw = _step_inputs()
        scal = TF.pack_scalars(dict(_scalars(target.numpy(), True),
                                    post=TF.post_scale(amp, SHAPE)))
        gr, gi = TF._wgs_carry_entry(psi, amp)
        args = (gr, gi, amp, weights, TF.wgs_phasor_entry(pff), target, mask, _t(mcode),
                _t(zw), scal)
        got = cuda_fft.mraf_carry_step(*args, **kw, zero=True)
        ref = TF._mraf_carry_step(*args, **kw, zero=True)
        for g, r in zip(got[:3] + got[4:], ref[:3] + ref[4:]):
            _assert_carry(g, r)
        return
    _assert_psi(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        _assert_carry(g, r)


# ----------------------------------------------------------------------
# The engine.
# ----------------------------------------------------------------------


def _assert_stats(got, ref):
    """Stats rows at STATS_ATOL / STATS_RTOL, with the JAX package's f32
    std_err uncertainty, ``sqrt(eps32) * (1 - efficiency)``, added to
    std_err's tolerance (see ``test_torch_natural.py``)."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got[..., :3], ref[..., :3],
                               atol=STATS_ATOL, rtol=STATS_RTOL, equal_nan=True)
    cancel = np.sqrt(np.finfo(np.float32).eps) * np.abs(1 - ref[..., 0])
    bad = np.abs(got[..., 3] - ref[..., 3]) > STATS_ATOL + STATS_RTOL * np.abs(ref[..., 3]) + cancel
    assert not bad.any(), (got[..., 3][bad], ref[..., 3][bad])


def _mraf_target(shape, seed=9):
    """A unit-power spot target inside a window, nan (noise) outside it;
    the window's other pixels are the zero region."""
    rng = np.random.default_rng(seed)
    H, W = shape
    target = np.zeros(shape, np.float32)
    target[rng.integers(H // 4 + 2, 3 * H // 4 - 2, 10),
           rng.integers(W // 4 + 2, 3 * W // 4 - 2, 10)] = 1.0
    target /= np.sqrt((target**2).sum())
    noise = np.ones(shape, bool)
    noise[H // 4:3 * H // 4, W // 4:3 * W // 4] = False
    target[noise] = np.nan
    return target


ENGINE_CASES = {
    "leonardo": dict(method="WGS-Leonardo"),
    "leonardo_zero": dict(method="WGS-Leonardo", zero_factor=0.1),
    "kim": dict(method="WGS-Kim", fix_phase_iteration=4),
    "kim_zero": dict(method="WGS-Kim", fix_phase_iteration=4, zero_factor=0.1),
    "kim_eff_nofactor": dict(method="WGS-Kim", fix_phase_efficiency=0.3,
                             fix_phase_iteration=1, mraf_factor=None),
    "gs": dict(method="GS"),
    "gs_zero": dict(method="GS", zero_factor=0.1),
    "wu": dict(method="WGS-Wu", feedback_exponent=0.5),
    "tanh": dict(method="WGS-tanh", feedback_exponent=0.5, feedback_factor=0.2),
    "nogrette": dict(method="WGS-Nogrette", feedback_factor=0.2),
    "gs_padded": dict(method="GS", shape=(128, 128), slm_shape=(64, 64)),
    "leonardo_padded_zero": dict(method="WGS-Leonardo", shape=(128, 128),
                                 slm_shape=(64, 64), zero_factor=0.1),
    "leonardo_nostats": dict(method="WGS-Leonardo", stats=False),
}


def _engine_inputs(case):
    shape = case.get("shape", (64, 64))
    slm_shape = case.get("slm_shape", shape)
    target = _mraf_target(shape)
    rng = np.random.default_rng(10)
    psi0 = tprop.fold_phase(rng.uniform(-np.pi, np.pi, slm_shape).astype(np.float32), shape)
    noise = np.isnan(target)
    zero = ~noise & (target == 0)
    mraf_factor = case.get("mraf_factor", 0.5)
    consts = dict(
        amp=np.float32(1.0 / np.sqrt(np.prod(slm_shape))),
        target=target,
        stat_mask=(target != 0) & ~noise,
        feedback_exponent=np.float32(case.get("feedback_exponent", 0.8)),
        feedback_factor=np.float32(case.get("feedback_factor", 0.1)),
        fix_phase_iteration=np.int32(case.get("fix_phase_iteration", 10)),
        fix_phase_efficiency=np.float32(case.get("fix_phase_efficiency", np.nan)),
        signal_mask=~(noise | zero), noise_mask=noise, zero_mask=zero,
        mraf_factor=np.float32(1.0 if mraf_factor is None else mraf_factor),
        zero_factor=np.float32(case.get("zero_factor", 0.0)),
    )
    config = dict(
        method=case["method"], shape=shape, slm_shape=slm_shape,
        stat_groups=("computational",) if case.get("stats", True) else (),
        mraf=True, mraf_factor=mraf_factor is not None,
        zero_factor="zero_factor" in case,
        kim_efficiency_trigger="fix_phase_efficiency" in case,
    )
    return psi0, np.nan_to_num(target), consts, config


def _jax_run(psi0, weights, consts, config):
    jconfig = JE.GSConfig(**config)
    jconsts = {k: jnp.asarray(v) for k, v in consts.items()}
    return JE.run_gs(jconfig, JE.init_gs_state(jconfig, psi0, weights.copy()), jconsts, ITERS)


def _assert_engine(config, tstate, tstats, jstate, jstats, weights):
    shape = config["shape"]
    dp = (tprop.unfold_phase(tstate.psi.numpy(), shape)
          - tprop.unfold_phase(np.asarray(jstate.psi), shape))
    dp = np.mod(dp - dp.flat[0] + np.pi, 2 * np.pi) - np.pi
    assert np.abs(dp).max() < PHASE_ATOL, np.abs(dp).max()
    np.testing.assert_allclose(tstate.weights.numpy(), np.asarray(jstate.weights),
                               atol=WEIGHT_ATOL)
    np.testing.assert_allclose(tstate.zero_weights.numpy(), np.asarray(jstate.zero_weights),
                               atol=WEIGHT_ATOL)
    if config["stat_groups"]:
        _assert_stats(tstats.numpy(), jstats)
    assert bool(tstate.fixed_phase) == bool(jstate.fixed_phase)
    assert int(tstate.iteration) == int(jstate.iteration) == ITERS
    if "Kim" in config["method"]:
        on = weights != 0
        dphi = np.angle(np.exp(1j * (tstate.phase_ff.numpy() - np.asarray(jstate.phase_ff))))
        assert np.abs(dphi[on]).max() < PHASE_ATOL


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_run_gs_mraf_matches_jax(name):
    """Leonardo and Kim take the port's carry-mode MRAF step, every other
    case its natural step; the JAX package runs its natural step."""
    psi0, weights, consts, config = _engine_inputs(ENGINE_CASES[name])
    jstate, jstats = _jax_run(psi0, weights, consts, config)
    tconfig = TE.GSConfig(**config)
    carry = config["method"] in ("WGS-Leonardo", "WGS-Kim") and config["shape"] == config["slm_shape"]
    assert TE._mraf_fused_active(tconfig) is carry
    tstate = TE.init_gs_state(tconfig, psi0, weights, device="cpu")
    tstate, tstats = TE.run_gs(tconfig, tstate, convert.consts_from_numpy(consts), ITERS)
    _assert_engine(config, tstate, tstats, jstate, jstats, weights)


@pytest.mark.parametrize("name", ["leonardo", "leonardo_zero", "kim", "kim_zero"])
def test_natural_mraf_step_matches_jax(name):
    """The port's natural MRAF step on the configurations its carry step
    runs, against the JAX package's natural step."""
    psi0, weights, consts, config = _engine_inputs(ENGINE_CASES[name])
    jstate, jstats = _jax_run(psi0, weights, consts, config)
    tconfig = TE.GSConfig(**config)
    tstate = TE.init_gs_state(tconfig, psi0, weights, device="cpu")
    tstate, tstats = TE._run_natural(tconfig, tstate, convert.consts_from_numpy(consts), ITERS)
    _assert_engine(config, tstate, tstats, jstate, jstats, weights)


def test_chunked_mraf_run_matches_one_run():
    """Chunks leave and re-enter the carry; the zero weights and the
    deferred norm carry across."""
    psi0, weights, consts, config = _engine_inputs(ENGINE_CASES["kim_zero"])
    tconfig = TE.GSConfig(**config)
    tconsts = convert.consts_from_numpy(consts)
    one, stats_one = TE.run_gs(tconfig, TE.init_gs_state(tconfig, psi0, weights), tconsts, ITERS)
    many, stats_many = TE.run_gs_chunked(tconfig, TE.init_gs_state(tconfig, psi0, weights),
                                         tconsts, ITERS, chunk=4)
    np.testing.assert_allclose(torch.cat(stats_many).numpy(), stats_one.numpy(),
                               atol=STATS_ATOL, rtol=STATS_RTOL)
    np.testing.assert_allclose(many.zero_weights.numpy(), one.zero_weights.numpy(),
                               atol=WEIGHT_ATOL)
    np.testing.assert_allclose(many.weights.numpy(), one.weights.numpy(), atol=WEIGHT_ATOL)


def test_gs_state_from_numpy_carries_zero_weights():
    zw = np.random.default_rng(6).standard_normal((2, 8, 8)).astype(np.float32)
    arrays = dict(psi=np.zeros((8, 8)), weights=np.ones((8, 8)), phase_ff=np.zeros((8, 8)),
                  fixed_phase=False, unfixed_streak=np.int32(0), iteration=np.int32(0))
    state = convert.gs_state_from_numpy(dict(arrays, zero_weights=zw), device="cpu")
    np.testing.assert_array_equal(state.zero_weights.numpy(), zw)
    empty = convert.gs_state_from_numpy(arrays, device="cpu")
    assert empty.zero_weights.shape == (2, 0, 0)


# ----------------------------------------------------------------------
# The model and the public class.
# ----------------------------------------------------------------------


@pytest.mark.parametrize("method", ["WGS-Leonardo", "WGS-Kim", "GS"])
def test_image_mraf_model_matches_jax(method):
    """BASELINE config 3, cut to 128^2: the same target, phase and config
    as ``slmsuite_tpu``'s ``image_mraf``; ``run(5)`` agrees."""
    tm = tmodels.image_mraf(N=128, method=method, device="cpu")
    jm = jmodels.image_mraf(N=128, method=method)
    np.testing.assert_array_equal(tm.target, jm.target)
    np.testing.assert_array_equal(tm.phase0.numpy(), jm.phase0)
    tconfig, jconfig = dataclasses.asdict(tm.config), dataclasses.asdict(jm.config)
    assert tconfig == {k: v for k, v in jconfig.items() if k in tconfig}
    for key in ("signal_mask", "noise_mask", "zero_mask", "mraf_factor", "target"):
        np.testing.assert_array_equal(tm.consts[key].numpy(), np.asarray(jm.consts[key]))
    assert TE._mraf_fused_active(tm.config) is (method != "GS")
    tstate, tstats = tm.run(5)
    jstate, jstats = jm.run(5)
    _assert_stats(tstats.numpy(), jstats)
    np.testing.assert_allclose(tstate.weights.numpy(), np.asarray(jstate.weights),
                               atol=WEIGHT_ATOL)


def _holo_stats(holo):
    record = holo.stats["stats"]["computational"]
    return np.stack([record[k] for k in ("efficiency", "uniformity", "pkpk_err",
                                         "std_err")], axis=-1)


@pytest.mark.parametrize("method", ["WGS-Leonardo", "WGS-Kim", "GS"])
def test_hologram_mraf_resumes_zero_weights(method):
    """``Hologram`` with a nan target and ``zero_factor``: two successive
    ``optimize()`` calls, the second resuming from the first's zero
    weights, agree with ``slmsuite_tpu``'s hologram."""
    target = _mraf_target((64, 64), seed=11)
    phi0 = np.random.default_rng(12).uniform(-np.pi, np.pi, (64, 64)).astype(np.float32)
    holos = []
    for module in (T, J):
        holo = module.Hologram(target=target)
        holo.reset_phase(custom_phase=phi0)
        for _ in range(2):
            holo.optimize(method=method, maxiter=5, verbose=False,
                          stat_groups=["computational"], mraf_factor=0.5,
                          zero_factor=0.1, fix_phase_iteration=3)
        holos.append(holo)
    tholo, jholo = holos
    assert tholo.iter == jholo.iter == 10
    assert tholo.zero_weights.shape == (2, 64, 64)
    assert np.abs(tholo.zero_weights).max() > 0
    np.testing.assert_allclose(tholo.zero_weights, np.asarray(jholo.zero_weights),
                               atol=WEIGHT_ATOL)
    _assert_stats(_holo_stats(tholo), _holo_stats(jholo))
    dp = tholo.get_phase() - np.asarray(jholo.get_phase())
    dp = np.mod(dp - dp.flat[0] + np.pi, 2 * np.pi) - np.pi
    assert np.abs(dp).max() < PHASE_ATOL
    np.testing.assert_allclose(tholo.weights, np.asarray(jholo.weights), atol=WEIGHT_ATOL)
