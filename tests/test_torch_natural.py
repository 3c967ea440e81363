"""
The port's natural (non-fused) engine path against the JAX package on
the CPU: the natural-order transforms and their kernel twins, the padded
canvas, the weight rules without nan checks, the natural step of
``slmsuite_torch.ops.engine`` for every method and mode, and the public
classes on padded holograms, propagation kernels and spot feedback.

The JAX package runs its natural loop on the CPU (``jnp.fft``); its
``*_scrambled*`` transforms run their einsum tier, whose farfield is in
the four-step scrambled order, so the port's natural-order output is
permuted with ``scramble_permutation_2d`` before the comparison.
Inputs are made from a seed with numpy and handed to both packages.

Tolerances: transformed planes 1e-5 relative to their peak (f32 FFT
round-off); ``arg F`` 1e-3 rad where ``|F| > 1e-3 max |F|`` (elsewhere
the angle of a round-off-sized value is arbitrary); psi 99th-percentile
wrapped difference below 2e-3 for single transforms. Engine runs of 10
iterations: unfolded phase 5e-4 rad (modulo 2 pi, global offset
removed), weights atol 1e-5, stats atol 1e-4 / rtol 1e-3, as the fused
engine tests. The Nogrette nanmean sums in another order than JAX's,
which the weights tolerance covers.
"""

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
from slmsuite_torch.ops import weights as tweights
from slmsuite_tpu.holography import algorithms as J
from slmsuite_tpu.models import engine_models as jmodels
from slmsuite_tpu.ops import engine as JE
from slmsuite_tpu.ops import fft as JF
from slmsuite_tpu.ops import propagation as jprop
from slmsuite_tpu.ops import weights as jweights


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


PLANE_RTOL = 1e-5
THETA_ATOL = 1e-3
PSI_P99 = 2e-3
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


def _assert_plane(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=PLANE_RTOL)


def _assert_theta(got, ref, amp):
    on = np.asarray(amp) > 1e-3 * np.asarray(amp).max()
    dphi = np.angle(np.exp(1j * (np.asarray(got) - np.asarray(ref))))
    assert np.abs(dphi[on]).max() < THETA_ATOL


def _assert_psi(got, ref):
    diff = np.angle(np.exp(1j * (np.asarray(got) - np.asarray(ref))))
    assert np.percentile(np.abs(diff), 99) < PSI_P99


def _assert_stats(got, ref):
    """Stats rows at STATS_ATOL / STATS_RTOL. The JAX package forms
    std_err as ``count * sqrt(E[e^2] - E[e]^2)`` in f32, with ``count *
    E[e]`` about ``1 - efficiency``: its value is uncertain by about
    ``sqrt(eps32) * (1 - efficiency)``, the whole of it near convergence
    or at a padded start. The port forms it in float64, so that bound is
    added to std_err's tolerance (calculate_stats' float64 std_err is held
    to numpy in test_torch_ops.py)."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got[..., :3], ref[..., :3],
                               atol=STATS_ATOL, rtol=STATS_RTOL, equal_nan=True)
    cancel = np.sqrt(np.finfo(np.float32).eps) * np.abs(1 - ref[..., 0])
    bad = np.abs(got[..., 3] - ref[..., 3]) > STATS_ATOL + STATS_RTOL * np.abs(ref[..., 3]) + cancel
    assert not bad.any(), (got[..., 3][bad], ref[..., 3][bad])


def _scrambler(shape):
    ph, pw = JF.scramble_permutation_2d(shape)
    return lambda x: np.asarray(x)[ph][:, pw]


# ----------------------------------------------------------------------
# Transforms.
# ----------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 64), (128, 96)])
@pytest.mark.parametrize(
    "fn", ["fft2", "ifft2", "fft2_polar", "polar_from_phase_scalar",
           "polar_from_phase_array", "wexp_ifft2", "wexp_ifft2_phase"]
)
def test_transform_matches_jax(fn, shape):
    """Each natural-order dispatcher (plain on the CPU) against the JAX
    package's scrambled counterpart."""
    rng = np.random.default_rng(4)
    scr = _scrambler(shape)
    xr, xi = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    psi = rng.uniform(-3 * np.pi, 3 * np.pi, shape).astype(np.float32)
    amp_plane = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if fn == "fft2":
        got = TF.fft2(_t(xr), _t(xi))
        ref = JF.fft2_scrambled_pair(jnp.asarray(xr), jnp.asarray(xi))
        for g, r in zip(got, ref):
            _assert_plane(scr(g), r)
    elif fn == "ifft2":
        got = TF.ifft2(_t(xr), _t(xi))
        ref = JF.ifft2_scrambled_pair(jnp.asarray(scr(xr)), jnp.asarray(scr(xi)))
        for g, r in zip(got, ref):
            _assert_plane(g, r)
    elif fn == "fft2_polar":
        got = TF.fft2_polar(_t(xr), _t(xi))
        ref = JF.fft2_scrambled_polar(jnp.asarray(xr), jnp.asarray(xi))
        _assert_plane(scr(got[0]), ref[0])
        _assert_theta(scr(got[1]), ref[1], ref[0])
    elif fn.startswith("polar_from_phase"):
        scalar = fn.endswith("scalar")
        amp = 1.0 / np.sqrt(np.prod(shape)) if scalar else amp_plane
        got = TF.fft2_polar_from_phase(_t(psi), amp if scalar else _t(amp))
        ref = JF.fft2_scrambled_polar_from_phase(
            jnp.asarray(psi), jnp.float32(amp) if scalar else jnp.asarray(amp)
        )
        _assert_plane(scr(got[0]), ref[0])
        _assert_theta(scr(got[1]), ref[1], ref[0])
    elif fn == "wexp_ifft2":
        phase = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
        got = TF.wexp_ifft2(_t(amp_plane), _t(phase))
        ref = JF.wexp_ifft2_scrambled(jnp.asarray(scr(amp_plane)), jnp.asarray(scr(phase)))
        for g, r in zip(got, ref):
            _assert_plane(g, r)
    else:
        weights = amp_plane
        phase = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
        got = TF.wexp_ifft2_phase(_t(weights), _t(phase))
        ref = JF.wexp_ifft2_scrambled_phase(
            jnp.asarray(scr(weights)), jnp.asarray(scr(phase))
        )
        _assert_psi(got, ref)


@pytest.fixture
def plain_kernels(monkeypatch):
    """``cuda_fft``'s compositions with each kernel wrapper replaced by its
    plain version, so they run on CPU tensors."""
    for name, plain in [
        ("carry_entry", TF._wgs_carry_entry), ("carry_exit", TF._wgs_carry_exit),
        ("rows_fft", TF._rows_fft), ("cols_fft", TF._cols_fft),
        ("cols_fwd_polar", TF._cols_fwd_polar), ("cols_wexp_inv", TF._cols_wexp_inv),
    ]:
        monkeypatch.setattr(cuda_fft, name, plain)


@pytest.mark.parametrize(
    "fn", ["fft2", "ifft2", "fft2_polar", "polar_from_phase_scalar",
           "polar_from_phase_array", "wexp_ifft2", "wexp_ifft2_phase"]
)
def test_kernel_composition_matches_plain(plain_kernels, fn):
    """The kernel sequence of each dispatcher (directions, ortho scales,
    the scalar amplitude's post scale), run on the kernels' plain
    versions, equals the dispatcher's plain version on ``torch.fft``."""
    shape = (64, 128)
    rng = np.random.default_rng(5)
    a, b = (_t(rng.standard_normal(shape)) for _ in range(2))
    psi = _t(rng.uniform(-3 * np.pi, 3 * np.pi, shape))
    if fn in ("fft2", "ifft2"):
        for g, r in zip(getattr(cuda_fft, fn)(a, b), getattr(TF, "_" + fn)(a, b)):
            _assert_plane(g.numpy(), r.numpy())
    elif fn == "fft2_polar":
        got, ref = cuda_fft.fft2_polar(a, b), TF._fft2_polar(a, b)
        _assert_plane(got[0].numpy(), ref[0].numpy())
        _assert_theta(got[1].numpy(), ref[1].numpy(), ref[0].numpy())
    elif fn.startswith("polar_from_phase"):
        amp = 0.02 if fn.endswith("scalar") else a.abs() + 0.5
        got = cuda_fft.fft2_polar_from_phase(psi, amp)
        ref = TF._fft2_polar_from_phase(psi, amp)
        _assert_plane(got[0].numpy(), ref[0].numpy())
        _assert_theta(got[1].numpy(), ref[1].numpy(), ref[0].numpy())
    elif fn == "wexp_ifft2":
        got, ref = cuda_fft.wexp_ifft2(a.abs(), psi), TF._wexp_ifft2(a.abs(), psi)
        for g, r in zip(got, ref):
            _assert_plane(g.numpy(), r.numpy())
    else:
        _assert_psi(cuda_fft.wexp_ifft2_phase(a.abs(), psi).numpy(),
                    TF._wexp_ifft2_phase(a.abs(), psi).numpy())


def test_negative_scalar_amp_is_refused():
    with pytest.raises(ValueError, match=">= 0"):
        TF.post_scale(-0.5, (64, 64))


@pytest.mark.parametrize("window", [(64, 96), (64, 94)])
def test_padded_canvas_matches_jax(window):
    """A 128^2 canvas holding a window (at offsets (32, 16), and the odd
    x offset 17): the folded nearfield with a kernel and an amplitude
    plane, the forward polar transform, and the backward transform with
    the phase extraction, against the JAX package's propagation."""
    shape = (128, 128)
    rng = np.random.default_rng(6)
    phase = rng.uniform(-np.pi, np.pi, window).astype(np.float32)
    amp = rng.uniform(0.5, 1.0, window).astype(np.float32)
    kernel = rng.uniform(-1, 1, window).astype(np.float32)
    psi = tprop.fold_phase(phase, shape)
    np.testing.assert_array_equal(psi, jprop.fold_phase(phase, shape))
    np.testing.assert_array_equal(tprop.unfold_phase(psi, shape),
                                  jprop.unfold_phase(psi, shape))

    nr, ni = tprop.build_folded_nearfield(_t(psi), _t(amp), shape, _t(kernel))
    jnear = jprop.build_folded_nearfield(
        jnp.asarray(psi), jnp.asarray(amp), shape, jnp.asarray(kernel)
    )
    np.testing.assert_allclose(nr.numpy(), np.asarray(jnear.real), atol=1e-6)
    np.testing.assert_allclose(ni.numpy(), np.asarray(jnear.imag), atol=1e-6)

    amp_ff, theta = TF.fft2_polar(nr, ni)
    jfar = np.asarray(jprop.nearfield_to_farfield(jnear))
    _assert_plane(amp_ff.numpy(), np.abs(jfar))
    _assert_theta(theta.numpy(), np.angle(jfar), np.abs(jfar))

    weights = rng.uniform(0, 1, shape).astype(np.float32)
    got = tprop.extract_folded_phase(
        *tprop.farfield_to_nearfield(_t(weights * np.cos(theta.numpy())),
                                     _t(weights * np.sin(theta.numpy()))),
        window, _t(kernel),
    )
    ref = jprop.extract_folded_phase(
        jprop.farfield_to_nearfield(jnp.asarray(weights * np.exp(1j * theta.numpy()))),
        window, jnp.asarray(kernel),
    )
    assert got.shape == window
    _assert_psi(tprop.unfold_phase(got.numpy(), shape),
                jprop.unfold_phase(np.asarray(ref), shape))


@pytest.mark.parametrize(
    "method", ["GS", "WGS-Leonardo", "WGS-Kim", "WGS-Nogrette", "WGS-Wu", "WGS-tanh"]
)
def test_update_weights_without_nan_checks(method):
    """The six methods with ``nan_checks=False`` (the default is in
    test_torch_ops.py); GS has no weight rule in either package."""
    rng = np.random.default_rng(8)
    target = rng.uniform(0.1, 1, (32, 32)).astype(np.float32)
    feedback = rng.uniform(0.1, 1, (32, 32)).astype(np.float32)
    weights = rng.uniform(0.5, 1.5, (32, 32)).astype(np.float32)

    def jax_call():
        return np.asarray(jweights.update_weights_generic(
            jnp.asarray(weights), jnp.asarray(feedback), jnp.asarray(target),
            method, 0.7, 0.15, nan_checks=False,
        ))

    def torch_call():
        return tweights.update_weights_generic(
            _t(weights), _t(feedback), _t(target), method, 0.7, 0.15,
            nan_checks=False,
        ).numpy()

    if method == "GS":
        for call in (jax_call, torch_call):
            with pytest.raises(ValueError, match="WGS"):
                call()
        return
    np.testing.assert_allclose(torch_call(), jax_call(), atol=1e-6, rtol=1e-5)


# ----------------------------------------------------------------------
# The natural step of the engine.
# ----------------------------------------------------------------------


def _spot_layout(shape, n_side=4, pitch=12, offset=0.0):
    """(2, N) float spot positions (x; y) of a centred grid, each moved by
    a seeded jitter of up to 2 pixels, and the target plane with
    unit-power spots at the rounded positions. The jitter breaks the
    grid's symmetry, whose exact nearfield nulls leave psi undefined."""
    edge = (np.arange(n_side) - (n_side - 1) / 2) * pitch
    xs, ys = np.meshgrid(edge + shape[1] / 2 + offset, edge + shape[0] / 2 + offset)
    jitter = np.random.default_rng(13).integers(-2, 3, (2, n_side * n_side))
    spots = np.vstack([xs.ravel(), ys.ravel()]) + jitter
    rounded = np.rint(spots).astype(int)
    target = np.zeros(shape, np.float32)
    target[rounded[1], rounded[0]] = 1.0
    return spots, target / np.sqrt((target**2).sum())


ENGINE_CASES = {
    "gs": dict(method="GS"),
    "leonardo": dict(method="WGS-Leonardo"),
    "kim": dict(method="WGS-Kim", fix_phase_iteration=4),
    "nogrette": dict(method="WGS-Nogrette", feedback_factor=0.2),
    "wu": dict(method="WGS-Wu", feedback_exponent=0.5),
    "tanh": dict(method="WGS-tanh", feedback_exponent=0.5, feedback_factor=0.2),
    "kim_padded": dict(method="WGS-Kim", fix_phase_iteration=4,
                       shape=(128, 128), slm_shape=(64, 96)),
    "kim_eff_padded": dict(method="WGS-Kim", fix_phase_efficiency=0.3,
                           fix_phase_iteration=1, shape=(128, 128),
                           slm_shape=(64, 96)),
    "spot_single_px": dict(method="WGS-Kim", fix_phase_iteration=4,
                           feedback="computational_spot",
                           stat_groups=("computational", "computational_spot")),
    "spot_windowed": dict(method="WGS-Leonardo", feedback="computational_spot",
                          stat_groups=("computational_spot", "computational"),
                          shape=(128, 128), slm_shape=(64, 64), spot_offset=0.4),
    "kernel": dict(method="WGS-Leonardo", kernel=True),
    "nogrette_kernel_padded": dict(method="WGS-Nogrette", kernel=True,
                                   shape=(128, 128), slm_shape=(64, 64)),
}


def _engine_inputs(case):
    shape = case.get("shape", (64, 64))
    slm_shape = case.get("slm_shape", shape)
    rng = np.random.default_rng(9)
    spots, target = _spot_layout(shape, offset=case.get("spot_offset", 0.0))
    psi0 = tprop.fold_phase(rng.uniform(-np.pi, np.pi, slm_shape).astype(np.float32), shape)
    consts = dict(
        amp=np.float32(1.0 / np.sqrt(np.prod(slm_shape))),
        target=target,
        stat_mask=target != 0,
        feedback_exponent=np.float32(case.get("feedback_exponent", 0.8)),
        feedback_factor=np.float32(case.get("feedback_factor", 0.1)),
        fix_phase_iteration=np.int32(case.get("fix_phase_iteration", 10)),
        fix_phase_efficiency=np.float32(case.get("fix_phase_efficiency", np.nan)),
    )
    if case.get("kernel"):
        consts["kernel"] = rng.uniform(-2, 2, slm_shape).astype(np.float32)
    stat_groups = case.get("stat_groups", ("computational",))
    feedback = case.get("feedback", "computational")
    if "computational_spot" in stat_groups or feedback == "computational_spot":
        flat, _ = JE.spot_gather_indices(np.floor(spots).astype(int), 3, shape)
        wflat, center = JE.spot_gather_indices(np.rint(spots).astype(int), 3, shape)
        consts.update(spot_flat_idx=flat, spot_weight_flat_idx=wflat,
                      spot_center_idx=center,
                      spot_amp=np.full(spots.shape[1], 1 / np.sqrt(spots.shape[1]),
                                       np.float32))
    config = dict(
        method=case["method"], shape=shape, slm_shape=slm_shape,
        feedback=feedback, stat_groups=stat_groups,
        has_kernel="kernel" in consts,
        kim_efficiency_trigger="fix_phase_efficiency" in case,
        spot_single_px=tuple(shape) == tuple(slm_shape),
    )
    return psi0, target, consts, config


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_natural_step_matches_jax(name):
    psi0, target, consts, config = _engine_inputs(ENGINE_CASES[name])
    shape = config["shape"]

    jconfig = JE.GSConfig(**config)
    jconsts = {k: jnp.asarray(v) for k, v in consts.items()}
    jstate, jstats = JE.run_gs(jconfig, JE.init_gs_state(jconfig, psi0, target.copy()),
                               jconsts, ITERS)

    tconfig = TE.GSConfig(**config)
    tstate = TE.init_gs_state(tconfig, psi0, target, device="cpu")
    tconsts = convert.consts_from_numpy(consts)
    # The fusable rules at this geometry would take the fused loop: run
    # the natural step itself.
    if TE._fused_active(tconfig):
        tstate, tstats = TE._run_natural(tconfig, tstate, tconsts, ITERS)
    else:
        tstate, tstats = TE.run_gs(tconfig, tstate, tconsts, ITERS)

    dp = (tprop.unfold_phase(tstate.psi.numpy(), shape)
          - tprop.unfold_phase(np.asarray(jstate.psi), shape))
    dp = np.mod(dp - dp.flat[0] + np.pi, 2 * np.pi) - np.pi
    assert np.abs(dp).max() < PHASE_ATOL, np.abs(dp).max()
    np.testing.assert_allclose(tstate.weights.numpy(), np.asarray(jstate.weights),
                               atol=WEIGHT_ATOL)
    _assert_stats(tstats.numpy(), jstats)
    assert bool(tstate.fixed_phase) == bool(jstate.fixed_phase)
    assert int(tstate.iteration) == int(jstate.iteration) == ITERS
    if tconfig.is_kim:
        on = target != 0
        dphi = np.angle(np.exp(1j * (tstate.phase_ff.numpy() - np.asarray(jstate.phase_ff))))
        assert np.abs(dphi[on]).max() < PHASE_ATOL


def test_natural_chunks_match_one_run():
    psi0, target, consts, config = _engine_inputs(ENGINE_CASES["kim_padded"])
    tconfig = TE.GSConfig(**config)
    tconsts = convert.consts_from_numpy(consts)
    one, stats_one = TE.run_gs(tconfig, TE.init_gs_state(tconfig, psi0, target), tconsts,
                               ITERS)
    seen = []
    many, stats_many = TE.run_gs_chunked(tconfig, TE.init_gs_state(tconfig, psi0, target),
                                         tconsts, ITERS, chunk=4, on_chunk=seen.append)
    assert seen == [4, 4, 2]
    torch.testing.assert_close(torch.cat(stats_many), stats_one)
    torch.testing.assert_close(many.psi, one.psi)


@pytest.mark.parametrize("method", ["GS", "WGS-Nogrette"])
def test_spot_array_wgs_any_method_matches_jax(method):
    """``spot_array_wgs(method=...)`` takes the natural path for GS and
    Nogrette, cut to 128^2."""
    tm = tmodels.spot_array_wgs(N=128, n_side=8, spacing_div=16, method=method,
                                device="cpu")
    jm = jmodels.spot_array_wgs(N=128, n_side=8, spacing_div=16, method=method)
    assert not TE._fused_active(tm.config)
    tstate, tstats = tm.run(5)
    jstate, jstats = jm.run(5)
    _assert_stats(tstats.numpy(), jstats)
    np.testing.assert_allclose(tstate.weights.numpy(), np.asarray(jstate.weights),
                               atol=WEIGHT_ATOL)


# ----------------------------------------------------------------------
# The public classes.
# ----------------------------------------------------------------------


def _holo_stats(holo, group):
    """(n_iterations, 4) stats of one group, in STAT_KEYS order."""
    record = holo.stats["stats"][group]
    return np.stack([record[k] for k in ("efficiency", "uniformity", "pkpk_err",
                                         "std_err")], axis=-1)


def _phase_err(a, b):
    dp = np.asarray(a) - np.asarray(b)
    dp = np.mod(dp - dp.flat[0] + np.pi, 2 * np.pi) - np.pi
    return np.abs(dp).max()


def test_hologram_default_method_runs_gs():
    """``Hologram(target).optimize()`` runs with its default method, GS."""
    rng = np.random.default_rng(10)
    target = np.zeros((64, 64), np.float32)
    target[rng.integers(0, 64, 10), rng.integers(0, 64, 10)] = 1.0
    phi0 = rng.uniform(-np.pi, np.pi, (64, 64)).astype(np.float32)
    holos = []
    for module in (T, J):
        holo = module.Hologram(target=target)
        holo.reset_phase(custom_phase=phi0)
        holo.optimize(maxiter=ITERS, verbose=False)
        holos.append(holo)
    tholo, jholo = holos
    assert tholo.flags["method"] == "GS" and tholo.iter == ITERS
    assert _phase_err(tholo.get_phase(), jholo.get_phase()) < PHASE_ATOL
    np.testing.assert_allclose(tholo.get_amp_ff(), np.asarray(jholo.get_amp_ff()),
                               atol=1e-5)


def test_padded_hologram_with_kernel_matches_jax():
    """A padded Hologram (128^2 farfield, 64x96 SLM) with a propagation
    kernel and an amplitude plane, WGS-Kim with stats."""
    rng = np.random.default_rng(11)
    _, target = _spot_layout((128, 128))
    amp = rng.uniform(0.5, 1.0, (64, 96)).astype(np.float32)
    kernel = rng.uniform(-1, 1, (64, 96)).astype(np.float32)
    phi0 = rng.uniform(-np.pi, np.pi, (64, 96)).astype(np.float32)
    holos = []
    for module in (T, J):
        holo = module.Hologram(target=target, amp=amp, slm_shape=(64, 96),
                               propagation_kernel=kernel)
        holo.reset_phase(custom_phase=phi0)
        holo.optimize(method="WGS-Kim", maxiter=ITERS, verbose=False,
                      stat_groups=["computational"], fix_phase_iteration=4)
        holos.append(holo)
    tholo, jholo = holos
    _assert_stats(_holo_stats(tholo, "computational"), _holo_stats(jholo, "computational"))
    assert tholo.get_phase().shape == (64, 96)
    assert _phase_err(tholo.get_phase(), jholo.get_phase()) < PHASE_ATOL
    np.testing.assert_allclose(tholo.weights, np.asarray(jholo.weights), atol=WEIGHT_ATOL)
    np.testing.assert_allclose(np.abs(tholo.get_farfield()), np.abs(jholo.get_farfield()),
                               atol=1e-5)


def test_padded_spot_hologram_spot_feedback_matches_jax():
    """``SpotHologram.make_rectangular_array(..., slm_shape=...)`` with
    computational_spot feedback and both stat groups."""
    phi0 = np.random.default_rng(12).uniform(-np.pi, np.pi, (64, 64)).astype(np.float32)
    holos = []
    for module in (T, J):
        holo = module.SpotHologram.make_rectangular_array(
            (128, 128), array_shape=(4, 4), array_pitch=(10, 10), basis="knm",
            slm_shape=(64, 64),
        )
        holo.reset_phase(custom_phase=phi0)
        holo.optimize(method="WGS-Nogrette", maxiter=ITERS, verbose=False,
                      feedback="computational_spot",
                      stat_groups=["computational", "computational_spot"])
        holos.append(holo)
    tholo, jholo = holos
    for group in ("computational", "computational_spot"):
        _assert_stats(_holo_stats(tholo, group), _holo_stats(jholo, group))
    assert _phase_err(tholo.get_phase(), jholo.get_phase()) < PHASE_ATOL
    np.testing.assert_allclose(tholo.weights, np.asarray(jholo.weights), atol=WEIGHT_ATOL)
