"""
The port's plain carry-mode WGS step (``slmsuite_torch.ops.fft``) against
the JAX package's jnp twins of the TPU kernels
(``slmsuite_tpu.ops.fft._wgs_carry_{entry,step,exit}_jnp``), on the CPU.

The port runs in natural order. The JAX carry is four-step scrambled
along its last axis, and its farfield planes (weights, target, mask, Kim
phasor) along both axes, so the JAX inputs are permuted with
``scramble_permutation_2d`` and its outputs un-permuted.

The entry and exit kernels' own arithmetic (``carry_entry_kernel`` and
``carry_exit_kernel`` in ``csrc/wgs_carry.cu``: the phasor, then the
forward line FFT; the inverse line FFT, then atan2) runs here through
``cuda_fft.line_fft_model``, which follows the kernels' ``line_fft`` pass
by pass, at every line length the kernels take.

Tolerances, as in the JAX package's own Pallas-vs-twin test
(``tests/holography/test_algorithms.py``): carry planes 3e-5 relative to
their peak; weights, phasors and stats sums atol 3e-5 / rtol 1e-4; psi
99th-percentile wrapped difference below 2e-3. At |psi| up to 1e3 (a warm
start) both sides take cos and sin of the same f32 value, so the carry is
held to the same 3e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slmsuite_torch
from slmsuite_torch.ops import cuda_fft
from slmsuite_torch.ops import fft as T
from slmsuite_tpu.ops import fft as F


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


SHAPE = (64, 128)
#: The step's shapes: the kernels' line FFT has two passes at 64 and 128
#: points and three at 256, so these cover both plans along each axis.
STEP_SHAPES = [(64, 128), (128, 64), (256, 128)]
#: Every line length of the kernels' line FFT (two passes to 256, three
#: above), a few rows of each for the entry and exit kernels' model.
LINE_SIDES = (64, 128, 256, 512, 1024, 2048, 4096)
LINE_ROWS = 3
CARRY_RTOL = 3e-5
ATOL, RTOL = 3e-5, 1e-4
PSI_P99 = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    slmsuite_torch.set_default_device("cpu")
    yield
    slmsuite_torch.set_default_device("cuda")
    torch.set_num_threads(threads)


def _inputs(seed=1, shape=SHAPE):
    H, W = shape
    rng = np.random.default_rng(seed)
    psi = rng.uniform(-2 * np.pi, 2 * np.pi, shape).astype(np.float32)
    target = np.zeros(shape, np.float32)
    target[rng.integers(0, H, 12), rng.integers(0, W, 12)] = 1.0
    target /= np.sqrt((target**2).sum())
    pff = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
    amp_plane = (0.5 + rng.uniform(0, 1, shape)).astype(np.float32)
    return psi, target, pff, amp_plane


def _perm(shape):
    return F.scramble_permutation_2d(shape)


def _scramble2(x):
    ph, pw = _perm(np.shape(x))
    return np.asarray(x)[ph][:, pw]


def _unscramble_w(x):
    _, pw = _perm(np.shape(x))
    out = np.empty_like(np.asarray(x))
    out[..., pw] = np.asarray(x)
    return out


def _unscramble2(x):
    ph, pw = _perm(np.shape(x))
    out = np.empty_like(np.asarray(x))
    out[np.ix_(ph, pw)] = np.asarray(x)
    return out


def _amps(kind, amp_plane):
    """(jax amp, port amp, post scale) for a scalar or array amplitude."""
    H, W = amp_plane.shape
    if kind == "scalar":
        a = 1.0 / np.sqrt(H * W)
        return jnp.float32(a), float(a), a / np.sqrt(H * W)
    return jnp.asarray(amp_plane), torch.from_numpy(amp_plane), 1.0 / np.sqrt(H * W)


def _assert_carry(got, ref):
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=CARRY_RTOL)


@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
def test_carry_entry(amp_kind):
    psi, _, _, amp_plane = _inputs()
    jamp, tamp, _ = _amps(amp_kind, amp_plane)
    ref = F._wgs_carry_entry_jnp(jnp.asarray(psi), jamp)
    got = T._wgs_carry_entry(torch.from_numpy(psi), tamp)
    for g, r in zip(got, ref):
        _assert_carry(g.numpy(), _unscramble_w(r))


def test_carry_exit():
    psi, _, _, _ = _inputs()
    gr, gi = F._wgs_carry_entry_jnp(jnp.asarray(psi), jnp.float32(1.0))
    ref = np.asarray(F._wgs_carry_exit_jnp(gr, gi))
    got = T._wgs_carry_exit(
        torch.from_numpy(_unscramble_w(gr)), torch.from_numpy(_unscramble_w(gi))
    ).numpy()
    diff = np.angle(np.exp(1j * (got - ref)))
    assert np.percentile(np.abs(diff), 99) < PSI_P99
    # The round trip returns psi itself (mod 2 pi).
    assert np.abs(np.angle(np.exp(1j * (got - psi)))).max() < 1e-4


@pytest.mark.parametrize("kim", [True, False])
@pytest.mark.parametrize("stats_on", [True, False])
@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
@pytest.mark.parametrize("rule", ["kim", "leonardo", "wu", "tanh"])
@pytest.mark.parametrize("shape", STEP_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_carry_step(shape, rule, amp_kind, stats_on, kim):
    psi, target, pff, amp_plane = _inputs(shape=shape)
    jamp, tamp, post = _amps(amp_kind, amp_plane)
    mask = (target != 0).astype(np.float32)
    scalars = dict(
        inv_prev_norm=0.7, apply_update=1.0, use_theta=float(not stats_on),
        feedback_exponent=0.8, feedback_factor=0.2, inv_fnorm=1.3,
        inv_tsum=1.0 / float((target**2).sum()), inv_fsum=0.9,
    )

    gr, gi = F._wgs_carry_entry_jnp(jnp.asarray(psi), jamp)
    ref = F._wgs_carry_step_jnp(
        gr, gi, jamp,
        jnp.asarray(_scramble2(target)),
        (jnp.asarray(_scramble2(np.cos(pff))), jnp.asarray(_scramble2(np.sin(pff))))
        if kim else None,
        jnp.asarray(_scramble2(target)),
        jnp.asarray(_scramble2(mask)) if stats_on else None,
        {k: jnp.float32(v) for k, v in scalars.items()},
        rule=rule, kim=kim, stats_on=stats_on,
    )
    ref_psi = np.asarray(F._wgs_carry_exit_jnp(ref[0], ref[1]))

    got = T._wgs_carry_step(
        torch.from_numpy(_unscramble_w(gr)), torch.from_numpy(_unscramble_w(gi)),
        tamp,
        torch.from_numpy(target),
        (torch.from_numpy(np.cos(pff)), torch.from_numpy(np.sin(pff))) if kim else None,
        torch.from_numpy(target),
        torch.from_numpy(mask) if stats_on else None,
        T.pack_scalars(dict(scalars, post=post)),
        rule=rule, kim=kim, stats_on=stats_on,
    )
    got_psi = T._wgs_carry_exit(got[0], got[1]).numpy()

    _assert_carry(got[0].numpy(), _unscramble_w(ref[0]))
    _assert_carry(got[1].numpy(), _unscramble_w(ref[1]))
    np.testing.assert_allclose(got[2].numpy(), _unscramble2(ref[2]), atol=ATOL, rtol=RTOL)
    if kim:
        for g, r in zip(got[3], ref[3]):
            np.testing.assert_allclose(g.numpy(), _unscramble2(r), atol=ATOL, rtol=RTOL)
    else:
        assert got[3] is None
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5]), atol=ATOL, rtol=RTOL)
    diff = np.angle(np.exp(1j * (got_psi - ref_psi)))
    assert np.percentile(np.abs(diff), 99) < PSI_P99


def _unscramble_rows(x):
    """The JAX carry's last axis in natural order, for any number of rows."""
    perm = F.scramble_permutation(np.shape(x)[-1])
    out = np.empty_like(np.asarray(x))
    out[..., perm] = np.asarray(x)
    return out


def _rows_inputs(n, psi_max=2 * np.pi):
    rng = np.random.default_rng(n)
    shape = (LINE_ROWS, n)
    psi = rng.uniform(-psi_max, psi_max, shape).astype(np.float32)
    return psi, (0.5 + rng.uniform(0, 1, shape)).astype(np.float32)


@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
@pytest.mark.parametrize("n", LINE_SIDES)
def test_carry_entry_kernel_model_matches_jax(n, amp_kind):
    """carry_entry_kernel: (amp cos psi, amp sin psi) in the registers (amp
    = 1 for a scalar, which folds into the post scale), then the forward
    line FFT, against the JAX twin."""
    psi, amp_plane = _rows_inputs(n)
    jamp = jnp.float32(0.5) if amp_kind == "scalar" else jnp.asarray(amp_plane)
    ref = F._wgs_carry_entry_jnp(jnp.asarray(psi), jamp)
    a = 1.0 if amp_kind == "scalar" else torch.from_numpy(amp_plane)
    t = torch.from_numpy(psi)
    got = cuda_fft.line_fft_model(a * torch.cos(t), a * torch.sin(t), inverse=False)
    for g, r in zip(got, ref):
        _assert_carry(g.numpy(), _unscramble_rows(r))


@pytest.mark.parametrize("n", LINE_SIDES)
def test_carry_exit_kernel_model_matches_jax(n):
    """carry_exit_kernel: the unnormalized inverse line FFT of the carry,
    then atan2, against the JAX twin."""
    psi, _ = _rows_inputs(n)
    gr, gi = F._wgs_carry_entry_jnp(jnp.asarray(psi), jnp.float32(1.0))
    ref = np.asarray(F._wgs_carry_exit_jnp(gr, gi))
    zr, zi = cuda_fft.line_fft_model(torch.from_numpy(_unscramble_rows(gr)),
                                     torch.from_numpy(_unscramble_rows(gi)), inverse=True)
    got = torch.atan2(zi, zr).numpy()
    diff = np.angle(np.exp(1j * (got - ref)))
    assert np.percentile(np.abs(diff), 99) < PSI_P99


@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
@pytest.mark.parametrize("route", ["plain", "model"])
def test_carry_entry_warm_start_range(route, amp_kind):
    """psi uniform in +-1e3, as a warm start or a user's phase gives it:
    the plain version and the kernel's model against the JAX twin."""
    psi, amp_plane = _rows_inputs(2048, psi_max=1e3)
    jamp = jnp.float32(1.0) if amp_kind == "scalar" else jnp.asarray(amp_plane)
    ref = F._wgs_carry_entry_jnp(jnp.asarray(psi), jamp)
    a = 1.0 if amp_kind == "scalar" else torch.from_numpy(amp_plane)
    t = torch.from_numpy(psi)
    if route == "plain":
        got = T._wgs_carry_entry(t, a)
    else:
        got = cuda_fft.line_fft_model(a * torch.cos(t), a * torch.sin(t), inverse=False)
    for g, r in zip(got, ref):
        _assert_carry(g.numpy(), _unscramble_rows(r))
