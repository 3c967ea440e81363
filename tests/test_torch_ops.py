"""
The port's device building blocks against the JAX package on the CPU:
the five WGS weight rules, the device stats, fold/unfold and forward
propagation, the state/constant converters, and the CUDA wrappers'
refusal of CPU tensors.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances are f32 round-off: the two packages sum in different orders.
"""

import sys
import types

import jax.numpy as jnp

import numpy as np
import pytest
import torch

import slmsuite_torch
from slmsuite_torch import convert
from slmsuite_torch.ops import cuda_fft
from slmsuite_torch.ops import fft as tfft
from slmsuite_torch.ops import propagation as tprop
from slmsuite_torch.ops import stats as tstats
from slmsuite_torch.ops import weights as tweights
from slmsuite_tpu.ops import propagation as jprop
from slmsuite_tpu.ops import stats as jstats
from slmsuite_tpu.ops import weights as jweights


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


#: f32 round-off over a 64x64 plane, with margin.
ATOL, RTOL = 1e-6, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    slmsuite_torch.set_default_device("cpu")
    yield
    slmsuite_torch.set_default_device("cuda")
    torch.set_num_threads(threads)


def _planes(seed=0, shape=(64, 64)):
    rng = np.random.default_rng(seed)
    target = np.zeros(shape, np.float32)
    target[rng.integers(0, shape[0], 20), rng.integers(0, shape[1], 20)] = 1.0
    target /= np.sqrt((target**2).sum())
    feedback = rng.uniform(0, 1, shape).astype(np.float32)
    weights = (target * rng.uniform(0.5, 1.5, shape)).astype(np.float32)
    return target, feedback, weights


@pytest.mark.parametrize(
    "method", ["WGS-Leonardo", "WGS-Kim", "WGS-Nogrette", "WGS-Wu", "WGS-tanh"]
)
def test_update_weights_generic(method):
    target, feedback, weights = _planes()
    ref = jweights.update_weights_generic(
        jnp.asarray(weights), jnp.asarray(feedback), jnp.asarray(target),
        method, 0.7, 0.15,
    )
    got = tweights.update_weights_generic(
        torch.from_numpy(weights), torch.from_numpy(feedback),
        torch.from_numpy(target), method, 0.7, 0.15,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize(
    "compensation,total,mask", [(False, None, True), (True, None, False), (False, 2.5, False)]
)
def test_calculate_stats(compensation, total, mask):
    target, feedback, _ = _planes(1)
    target[0, :4] = np.nan  # nan targets are excluded
    m = (target != 0) & ~np.isnan(target)
    ref = jstats.calculate_stats(
        jnp.asarray(feedback), jnp.asarray(target),
        mask=jnp.asarray(m) if mask else None,
        efficiency_compensation=compensation, total=total,
    )
    got = tstats.calculate_stats(
        torch.from_numpy(feedback), torch.from_numpy(target),
        mask=torch.from_numpy(m) if mask else None,
        efficiency_compensation=compensation, total=total,
    )
    got, ref = got.numpy(), np.asarray(ref)
    np.testing.assert_allclose(got[:3], ref[:3], atol=1e-5, rtol=1e-4)
    # std_err is count * sqrt(E[e^2] - E[e]^2). The port forms it from
    # float64 moments, the JAX package in f32, whose cancellation leaves
    # ~1e-2 of it here, where the random feedback leaves a large mean error
    # (test_calculate_stats_std_err holds the port to numpy's float64 std).
    np.testing.assert_allclose(got[3], ref[3], rtol=3e-2)
    host = tstats.calculate_stats_numpy(feedback, np.nan_to_num(target), compensation, total)
    assert host == jstats.calculate_stats_numpy(
        feedback, np.nan_to_num(target), compensation, total
    )
    assert tstats.STAT_KEYS == jstats.STAT_KEYS


@pytest.mark.parametrize("total", [None, 3.0])
def test_calculate_stats_std_err(total):
    """std_err from float64 moments against numpy's float64 std, on a
    plane whose error has a mean far above its spread (most of the light
    off target), where an f32 E[e^2] - E[e]^2 loses its digits."""
    rng = np.random.default_rng(3)
    target = np.zeros((128, 128), np.float32)
    target[rng.integers(0, 128, 200), rng.integers(0, 128, 200)] = 1.0
    target /= np.sqrt((target**2).sum())
    feedback = rng.uniform(0.9, 1.0, (128, 128)).astype(np.float32)
    got = tstats.calculate_stats(
        torch.from_numpy(feedback), torch.from_numpy(target),
        efficiency_compensation=False, total=total,
    )
    on = target != 0
    f2, t2 = np.square(feedback.astype(np.float64)), np.square(target.astype(np.float64))
    f_norm = f2.sum()
    err = t2[on] / t2.sum() - f2[on] / f_norm
    assert abs(err.mean()) > 10 * err.std()
    np.testing.assert_allclose(float(got[3]), on.sum() * np.std(err), rtol=1e-5)


@pytest.mark.parametrize("shape", [(64, 64), (128, 96)])
def test_fold_unfold(shape):
    phase = np.random.default_rng(2).uniform(-np.pi, np.pi, (64, 64)).astype(np.float32)
    np.testing.assert_array_equal(tprop.fold_phase(phase, shape), jprop.fold_phase(phase, shape))
    psi = tprop.fold_phase(phase, shape)
    np.testing.assert_array_equal(tprop.unfold_phase(psi, shape), jprop.unfold_phase(psi, shape))
    assert tprop.pad_window_slices(shape, (64, 64)) == jprop.pad_window_slices(shape, (64, 64))
    np.testing.assert_array_equal(
        tprop.checkerboard((64, 64), (1, 2)), jprop.checkerboard((64, 64), (1, 2))
    )


@pytest.mark.parametrize("shape,amp_kind,kernel", [
    ((64, 64), "scalar", False),
    ((128, 128), "array", True),
])
def test_forward_fields(shape, amp_kind, kernel):
    rng = np.random.default_rng(3)
    psi = rng.uniform(-np.pi, np.pi, (64, 64)).astype(np.float32)
    amp = (np.float32(1 / 64) if amp_kind == "scalar"
           else rng.uniform(0.5, 1, (64, 64)).astype(np.float32))
    kern = rng.uniform(-1, 1, (64, 64)).astype(np.float32) if kernel else None
    ref = jprop.forward_fields(
        jnp.asarray(psi), jnp.asarray(amp), shape,
        None if kern is None else jnp.asarray(kern),
    )
    t_amp = float(amp) if amp_kind == "scalar" else torch.from_numpy(amp)
    got = tprop.forward_fields(
        torch.from_numpy(psi), t_amp, shape,
        None if kern is None else torch.from_numpy(kern),
    )
    far_ref = np.asarray(ref[0])
    np.testing.assert_allclose(got[0].numpy(), far_ref, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-6)
    on = np.abs(far_ref) > 1e-3 * np.abs(far_ref).max()  # phase defined
    dphi = np.angle(np.exp(1j * (got[2].numpy() - np.asarray(ref[2]))))
    assert np.abs(dphi[on]).max() < 1e-3
    np.testing.assert_allclose(
        tprop.compute_farfield(torch.from_numpy(psi), t_amp, shape).numpy(),
        np.asarray(jprop.compute_farfield(jnp.asarray(psi), jnp.asarray(amp), shape, (64, 64))),
        atol=1e-6,
    )


def test_converters_keep_dtypes():
    state = convert.gs_state_from_numpy(dict(
        psi=np.zeros((8, 8)), weights=np.ones((8, 8)), phase_ff=np.zeros((8, 8)),
        fixed_phase=np.bool_(True), unfixed_streak=np.int32(3), iteration=np.int32(4),
    ), device="cpu")
    assert state.psi.dtype == torch.float32 and state.fixed_phase.dtype == torch.bool
    assert int(state.iteration) == 4 and state.iteration.dtype == torch.int32
    assert state.w_norm is None and state.weights.dtype == torch.float32
    consts = convert.consts_from_numpy(
        dict(amp=np.float32(0.5), target=np.ones((8, 8), np.float32),
             stat_mask=np.ones((8, 8), bool), fix_phase_iteration=np.int32(5)),
        device="cpu",
    )
    assert consts["amp"] == 0.5 and consts["stat_mask"].dtype == torch.bool
    assert consts["fix_phase_iteration"].dtype == torch.int32


def test_cuda_wrappers_refuse_cpu_tensors_and_build_nothing():
    """The wrappers launch or raise: a CPU tensor raises before any build,
    and importing the module built nothing."""
    assert cuda_fft._LIB is None
    plane = torch.zeros((64, 64))
    scal = tfft.pack_scalars(dict.fromkeys(tfft.SCALAR_KEYS, 0.0))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fft.carry_entry(plane, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fft.carry_exit(plane, plane)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fft.rows_normfwd(plane, plane, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fft.carry_step(plane, plane, 1.0, plane, None, plane, plane, scal,
                            rule="kim", kim=False, stats_on=True)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fft.rows_fft(plane, plane, inverse=False)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fft.cols_fft(plane, plane, inverse=True)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fft.cols_fwd_polar(plane, plane, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fft.cols_wexp_inv(plane, plane)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fft.cols_mraf_fwd(plane, plane, plane, plane, plane, scal,
                               rule="leonardo", stats_on=True)
    sums = torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fft.cols_mraf_mix_inv(plane, plane, plane, plane, None, None, sums, scal,
                                   kim=False, zero=False)
    assert cuda_fft._LIB is None
    assert "triton" not in sys.modules
    assert not tfft.use_kernels(plane)


def test_dispatch_tier_is_plain_on_cpu_and_outside_the_gate():
    """A CPU tensor takes the plain versions; a CUDA tensor takes the
    kernels where they take its sides and the plain tier elsewhere, counted
    in PLAIN_ON_DEVICE; a tensor on any other device raises, before any
    launch, without naming a ROADMAP entry."""
    assert tfft.use_kernels(torch.zeros((96, 128))) is False
    assert tfft.use_kernels(torch.zeros((100, 128))) is False
    assert tfft.kernel_tier("cuda", (96, 128)) == "kernels"
    assert tfft.kernel_tier("cuda", (100, 128)) == "plain"
    assert tfft.kernel_tier("cpu", (96, 128)) == "plain"
    tfft.reset_plain_count()
    fake = types.SimpleNamespace(device=torch.device("cuda"), shape=(100, 128))
    assert tfft.use_kernels(fake) is False and tfft.PLAIN_ON_DEVICE == 1
    fake.shape = (96, 128)
    assert tfft.use_kernels(fake) is True and tfft.PLAIN_ON_DEVICE == 1
    tfft.reset_plain_count()
    for shape in ((96, 128), (100, 128)):
        with pytest.raises(NotImplementedError, match="CPU or on a CUDA device") as info:
            tfft.use_kernels(torch.zeros(shape, device="meta"))
        assert "ROADMAP" not in str(info.value)
    with pytest.raises(NotImplementedError, match="CPU or on a CUDA device"):
        tfft.wgs_carry_entry(torch.zeros((64, 64), device="meta"), 1.0)
    meta = torch.zeros((64, 64), device="meta")
    for call in (lambda: tfft.fft2(meta, meta), lambda: tfft.ifft2(meta, meta),
                 lambda: tfft.fft2_polar(meta, meta),
                 lambda: tfft.fft2_polar_from_phase(meta, 1.0),
                 lambda: tfft.wexp_ifft2(meta, meta),
                 lambda: tfft.wexp_ifft2_phase(meta, meta),
                 lambda: tfft.ifft2_phase(meta, meta)):
        with pytest.raises(NotImplementedError, match="CPU or on a CUDA device"):
            call()
    assert tfft.PLAIN_ON_DEVICE == 0


@pytest.mark.parametrize("n,ok", [(32, False), (64, True), (1536, True), (2048, True),
                                  (4096, True), (8192, True), (96, True), (1080, True),
                                  (1272, True), (100, False), (1021, False), (16384, False),
                                  (8200, False), (56, False)])
def test_kernel_tier_of_a_side(n, ok):
    """A side the kernels take gives a CUDA plane the kernels, any other
    side the plain tier; the CPU always takes the plain tier."""
    assert tfft.kernel_len_ok(n) is ok
    tier = "kernels" if ok else "plain"
    assert tfft.kernel_tier("cuda", (n, 128)) == tier
    assert tfft.kernel_tier("cuda", (128, n)) == tier
    assert tfft.kernel_tier("cuda", (8, n), rows=True) == tier
    assert tfft.kernel_tier("cpu", (n, n)) == "plain"
