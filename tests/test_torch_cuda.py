"""
The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the fixture, never at import). On a GPU machine without jax, run
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(the repository conftest configures jax). Tolerances are those of
``chip_smoke.py``: carry and transformed planes 1e-4 relative to their
peak, weights, phasors and stats atol 1e-4 / rtol 1e-3, ``arg F`` 1e-3
rad where ``|F| > 1e-3 max |F|``, psi 99th-percentile wrapped
difference below 2e-3.
"""

import numpy as np
import pytest
import torch

CARRY_RTOL = 1e-4
ATOL, RTOL = 1e-4, 1e-3
PSI_P99 = 2e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _inputs(shape, device, amp_kind, seed=0):
    H, W = shape
    rng = np.random.default_rng(seed)
    psi = rng.uniform(-4 * np.pi, 4 * np.pi, shape).astype(np.float32)
    target = np.zeros(shape, np.float32)
    target[rng.integers(0, H, 12), rng.integers(0, W, 12)] = 1.0
    target /= np.sqrt((target**2).sum())
    pff = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
    amp = (1.0 / np.sqrt(H * W) if amp_kind == "scalar"
           else torch.from_numpy((0.5 + rng.uniform(0, 1, shape)).astype(np.float32)).to(device))
    return (torch.from_numpy(psi).to(device), torch.from_numpy(target).to(device),
            (torch.from_numpy(np.cos(pff)).to(device), torch.from_numpy(np.sin(pff)).to(device)),
            amp)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64), (256, 512)])
@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
@pytest.mark.parametrize("rule", ["kim", "leonardo", "wu", "tanh"])
@pytest.mark.parametrize("stats_on", [True, False])
def test_kernels_match_plain(cuda, shape, amp_kind, rule, stats_on):
    from slmsuite_torch.ops import cuda_fft, fft

    psi, target, pff, amp = _inputs(shape, cuda, amp_kind)
    gr, gi = cuda_fft.carry_entry(psi, amp)
    pgr, pgi = fft._wgs_carry_entry(psi, amp)
    assert max(_rel(gr, pgr), _rel(gi, pgi)) <= CARRY_RTOL

    H, W = shape
    post = (amp if amp_kind == "scalar" else 1.0) / np.sqrt(H * W)
    scal = fft.pack_scalars(dict(
        post=post, inv_prev_norm=0.7, apply_update=1.0, use_theta=float(stats_on),
        feedback_exponent=0.8, feedback_factor=0.2, inv_fnorm=1.3,
        inv_tsum=float(1.0 / (target**2).sum()), inv_fsum=0.9,
    ), cuda)
    kim = rule == "kim"
    args = (pgr, pgi, amp, target, pff if kim else None, target,
            (target != 0).float() if stats_on else None, scal)
    kw = dict(rule=rule, kim=kim, stats_on=stats_on)
    got = cuda_fft.carry_step(*args, **kw)
    ref = fft._wgs_carry_step(*args, **kw)
    assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= CARRY_RTOL
    pairs = [(got[2], ref[2]), (got[4], ref[4]), (got[5], ref[5])]
    if kim:
        pairs += list(zip(got[3], ref[3]))
    for g, r in pairs:
        torch.testing.assert_close(g, r, atol=ATOL, rtol=RTOL)

    diff = torch.remainder(cuda_fft.carry_exit(pgr, pgi) - fft._wgs_carry_exit(pgr, pgi)
                           + np.pi, 2 * np.pi) - np.pi
    assert float(torch.quantile(diff.abs().flatten(), 0.99)) < PSI_P99


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda):
    from slmsuite_torch.ops import cuda_fft

    with pytest.raises(ValueError, match="powers of two"):
        cuda_fft.carry_entry(torch.zeros((96, 128), device=cuda), 1.0)
    with pytest.raises(ValueError, match="float32"):
        cuda_fft.carry_entry(torch.zeros((64, 64), device=cuda, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fft.carry_entry(torch.zeros((64, 64), device=cuda).t()[:, :64], 1.0)


@pytest.mark.cuda
def test_dispatchers_refuse_cuda_shapes_outside_the_gate(cuda):
    """A CUDA plane whose sides the kernels do not take raises; it never
    falls back to the plain versions."""
    from slmsuite_torch.ops import cuda_fft, fft

    plane = torch.zeros((96, 128), device=cuda)
    scal = fft.pack_scalars(dict.fromkeys(fft.SCALAR_KEYS, 0.0), cuda)
    cuda_fft.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="Non-power-of-two"):
        fft.wgs_carry_entry(plane, 1.0)
    with pytest.raises(NotImplementedError, match="Non-power-of-two"):
        fft.wgs_carry_exit(plane, plane)
    with pytest.raises(NotImplementedError, match="Non-power-of-two"):
        fft.wgs_carry_step(plane, plane, 1.0, plane, None, plane, plane, scal,
                           rule="kim", kim=False, stats_on=True)
    for call in (lambda: fft.fft2(plane, plane), lambda: fft.ifft2(plane, plane),
                 lambda: fft.fft2_polar(plane, plane),
                 lambda: fft.fft2_polar_from_phase(plane, 1.0),
                 lambda: fft.wexp_ifft2(plane, plane),
                 lambda: fft.wexp_ifft2_phase(plane, plane)):
        with pytest.raises(NotImplementedError, match="Non-power-of-two"):
            call()
    assert sum(cuda_fft.LAUNCHES.values()) == 0


@pytest.mark.cuda
def test_spot_hologram_runs_through_kernels(cuda):
    from slmsuite_torch.holography.algorithms import SpotHologram
    from slmsuite_torch.ops import cuda_fft

    holo = SpotHologram.make_rectangular_array(
        (256, 256), array_shape=(8, 8), array_pitch=(20, 20), basis="knm", device=cuda
    )
    holo.reset_phase(custom_phase=np.random.default_rng(1).uniform(-np.pi, np.pi, (256, 256)))
    cuda_fft.reset_launch_counts()
    holo.optimize(method="WGS-Kim", maxiter=10, stat_groups=["computational"], verbose=False)
    assert cuda_fft.LAUNCHES["cols_wgs_roundtrip"] == 10
    assert cuda_fft.LAUNCHES["rows_normfwd"] == 10
    efficiency = holo.stats["stats"]["computational"]["efficiency"][-1]
    assert 0 < efficiency <= 1


THETA_ATOL = 1e-3


def _assert_theta(got, ref, amp):
    on = amp > 1e-3 * amp.max()
    diff = torch.remainder(got - ref + np.pi, 2 * np.pi) - np.pi
    assert float(diff.abs()[on].max()) < THETA_ATOL


def _psi_p99(got, ref):
    diff = torch.remainder(got - ref + np.pi, 2 * np.pi) - np.pi
    return float(torch.quantile(diff.abs().flatten(), 0.99))


def _pair(shape, device, seed=2):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
                 for _ in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64), (256, 512)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_kernels_match_plain(cuda, shape, inverse):
    from slmsuite_torch.ops import cuda_fft, fft

    xr, xi = _pair(shape, cuda)
    for kernel, plain in ((cuda_fft.rows_fft, fft._rows_fft),
                          (cuda_fft.cols_fft, fft._cols_fft)):
        got = kernel(xr, xi, inverse=inverse, scale=0.5)
        ref = plain(xr, xi, inverse=inverse, scale=0.5)
        assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= CARRY_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64), (256, 512)])
def test_cols_fwd_polar_and_wexp_inv_match_plain(cuda, shape):
    from slmsuite_torch.ops import cuda_fft, fft

    xr, xi = _pair(shape, cuda)
    amp, theta = cuda_fft.cols_fwd_polar(xr, xi, 0.25)
    ref_amp, ref_theta = fft._cols_fwd_polar(xr, xi, 0.25)
    assert _rel(amp, ref_amp) <= CARRY_RTOL
    _assert_theta(theta, ref_theta, ref_amp)

    weights, phase = xr.abs(), xi * np.pi
    got = cuda_fft.cols_wexp_inv(weights, phase)
    ref = fft._cols_wexp_inv(weights, phase)
    assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= CARRY_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
def test_natural_dispatchers_match_plain(cuda, amp_kind):
    """The composed dispatchers on the card against their plain versions
    (torch.fft), and their launch counts."""
    from slmsuite_torch.ops import cuda_fft, fft

    psi, target, _, amp = _inputs((256, 512), cuda, amp_kind)
    xr, xi = _pair((256, 512), cuda)
    cuda_fft.reset_launch_counts()
    for name in ("fft2", "ifft2"):
        got, ref = getattr(fft, name)(xr, xi), getattr(fft, "_" + name)(xr, xi)
        assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= CARRY_RTOL
    got, ref = fft.fft2_polar(xr, xi), fft._fft2_polar(xr, xi)
    assert _rel(got[0], ref[0]) <= CARRY_RTOL
    _assert_theta(got[1], ref[1], ref[0])
    got, ref = fft.fft2_polar_from_phase(psi, amp), fft._fft2_polar_from_phase(psi, amp)
    assert _rel(got[0], ref[0]) <= CARRY_RTOL
    _assert_theta(got[1], ref[1], ref[0])
    weights = xr.abs()
    assert _psi_p99(fft.wexp_ifft2_phase(weights, ref[1]),
                    fft._wexp_ifft2_phase(weights, ref[1])) < PSI_P99
    got, plain = fft.wexp_ifft2(weights, ref[1]), fft._wexp_ifft2(weights, ref[1])
    assert max(_rel(got[0], plain[0]), _rel(got[1], plain[1])) <= CARRY_RTOL
    assert cuda_fft.LAUNCHES == dict(
        carry_entry=1, cols_wgs_roundtrip=0, rows_normfwd=0, carry_exit=1,
        rows_fft=4, cols_fft=2, cols_fwd_polar=2, cols_wexp_inv=2,
        cols_mraf_fwd=0, cols_mraf_mix_inv=0,
    )


@pytest.mark.cuda
def test_natural_holograms_run_through_kernels(cuda):
    """A padded GS SpotHologram and an unpadded WGS-Nogrette one with spot
    feedback run on the natural step's kernels, four launches per
    iteration; the result farfield adds rows_fft and cols_fft once."""
    from slmsuite_torch.holography.algorithms import SpotHologram
    from slmsuite_torch.ops import cuda_fft

    padded = SpotHologram.make_rectangular_array(
        (256, 256), array_shape=(4, 4), array_pitch=(20, 20), basis="knm",
        slm_shape=(128, 128), device=cuda,
    )
    cuda_fft.reset_launch_counts()
    padded.optimize(method="GS", maxiter=6, stat_groups=["computational"], verbose=False)
    assert cuda_fft.LAUNCHES["rows_fft"] == 2 * 6 + 1
    assert cuda_fft.LAUNCHES["cols_fwd_polar"] == 6
    assert cuda_fft.LAUNCHES["cols_wexp_inv"] == 6
    assert cuda_fft.LAUNCHES["cols_fft"] == 1
    assert 0 < padded.stats["stats"]["computational"]["efficiency"][-1] <= 1

    holo = SpotHologram.make_rectangular_array(
        (128, 128), array_shape=(4, 4), array_pitch=(20, 20), basis="knm", device=cuda
    )
    cuda_fft.reset_launch_counts()
    holo.optimize(method="WGS-Nogrette", maxiter=6, feedback="computational_spot",
                  stat_groups=["computational", "computational_spot"], verbose=False)
    for key in ("carry_entry", "cols_fwd_polar", "cols_wexp_inv", "carry_exit"):
        assert cuda_fft.LAUNCHES[key] == 6, (key, cuda_fft.LAUNCHES)
    assert 0 < holo.stats["stats"]["computational_spot"]["efficiency"][-1] <= 1


def _mraf_inputs(shape, device, amp_kind, seed=3):
    """The carry of a seeded psi, the cleaned spot target, weights, the
    region code (1 at the spots, 2 or 0 at random elsewhere), a Kim
    phasor pair and zero weights, on the card."""
    from slmsuite_torch.ops import fft

    psi, target, pff, amp = _inputs(shape, device, amp_kind, seed)
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy(rng.uniform(size=shape) < 0.5).to(device)
    mcode = torch.where(target > 0, 1.0, torch.where(noise, 2.0, 0.0)).contiguous()
    zw = torch.from_numpy(1e-3 * rng.standard_normal((2, *shape)).astype(np.float32)).to(device)
    gr, gi = fft._wgs_carry_entry(psi, amp)
    return gr, gi, amp, target, pff, mcode, zw


def _mraf_scal(shape, amp, target, stats_on, device):
    from slmsuite_torch.ops import fft

    return fft.pack_scalars(dict(
        post=fft.post_scale(amp, shape), inv_prev_norm=0.7, apply_update=1.0,
        use_theta=float(stats_on), feedback_exponent=0.8, feedback_factor=0.2,
        inv_fnorm=1.3, inv_tsum=float(1.0 / (target**2).sum()), inv_fsum=0.9,
        mraf_factor=0.4, zero_factor=0.3,
    ), device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64), (256, 512)])
@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
@pytest.mark.parametrize("rule", ["leonardo", "kim"])
@pytest.mark.parametrize("stats_on", [True, False])
@pytest.mark.parametrize("zero", [True, False])
def test_mraf_kernels_match_plain(cuda, shape, amp_kind, rule, stats_on, zero):
    """cols_mraf_fwd and cols_mraf_mix_inv against their plain versions,
    and the three-kernel MRAF carry step against its plain version."""
    from slmsuite_torch.ops import cuda_fft, fft

    gr, gi, amp, target, pff, mcode, zw = _mraf_inputs(shape, cuda, amp_kind)
    kim = rule == "kim"
    scal = _mraf_scal(shape, amp, target, stats_on, cuda)
    weights = target * 1.3
    mask = (target != 0).float() if stats_on else None
    fwd = (gr, gi, weights, target, mask, scal)
    got = cuda_fft.cols_mraf_fwd(*fwd, rule=rule, stats_on=stats_on)
    ref = fft._cols_mraf_fwd(*fwd, rule=rule, stats_on=stats_on)
    assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= CARRY_RTOL
    for g, r in zip(got[2:], ref[2:]):
        torch.testing.assert_close(g, r, atol=ATOL, rtol=RTOL)

    mix = (ref[0], ref[1], ref[2], mcode, pff if kim else None, zw if zero else None,
           ref[3], scal)
    got = cuda_fft.cols_mraf_mix_inv(*mix, kim=kim, zero=zero)
    plain = fft._cols_mraf_mix_inv(*mix, kim=kim, zero=zero)
    assert max(_rel(got[0], plain[0]), _rel(got[1], plain[1])) <= CARRY_RTOL
    for g, r in ([*zip(got[2], plain[2])] if kim else []) + ([(got[3], plain[3])] if zero else []):
        torch.testing.assert_close(g, r, atol=ATOL, rtol=RTOL)
    assert (got[2] is None) is not kim and (got[3] is None) is not zero

    step = (gr, gi, amp, weights, pff if kim else None, target, mask, mcode,
            zw if zero else None, scal)
    kw = dict(rule=rule, kim=kim, stats_on=stats_on, zero=zero)
    got, plain = cuda_fft.mraf_carry_step(*step, **kw), fft._mraf_carry_step(*step, **kw)
    assert max(_rel(got[0], plain[0]), _rel(got[1], plain[1])) <= CARRY_RTOL
    torch.testing.assert_close(got[5], plain[5], atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
def test_mraf_compositions_match_plain(cuda, amp_kind):
    """ifft2_phase, wgs_fused_step and mraf_fused_step on the card against
    their plain versions, and their launch counts."""
    from slmsuite_torch.ops import cuda_fft, fft

    shape = (256, 512)
    psi, target, _, amp = _inputs(shape, cuda, amp_kind)
    _, _, _, _, _, mcode, _ = _mraf_inputs(shape, cuda, amp_kind)
    angle = torch.from_numpy(np.random.default_rng(4).uniform(
        -np.pi, np.pi, shape).astype(np.float32)).to(cuda)
    scal = _mraf_scal(shape, amp, target, True, cuda)
    xr, xi = _pair(shape, cuda)
    cuda_fft.reset_launch_counts()
    assert _psi_p99(fft.ifft2_phase(xr, xi), fft._ifft2_phase(xr, xi)) < PSI_P99
    args = (psi, amp, target * 1.3, angle, target, (target != 0).float())
    kw = dict(rule="kim", kim=True, stats_on=True)
    for name, extra in (("wgs_fused_step", ()), ("mraf_fused_step", (mcode,))):
        got = getattr(fft, name)(*args, *extra, scal, **kw)
        ref = getattr(fft, "_" + name)(*args, *extra, scal, **kw)
        assert _psi_p99(got[0], ref[0]) < PSI_P99, name
        torch.testing.assert_close(got[1], ref[1], atol=ATOL, rtol=RTOL)
        diff = torch.remainder(got[2] - ref[2] + np.pi, 2 * np.pi) - np.pi
        assert float(diff[target > 0].abs().max()) < THETA_ATOL, name
        for g, r in zip(got[3:], ref[3:]):
            torch.testing.assert_close(g, r, atol=ATOL, rtol=RTOL)
    assert cuda_fft.LAUNCHES == dict(
        carry_entry=2, cols_wgs_roundtrip=1, rows_normfwd=0, carry_exit=3,
        rows_fft=0, cols_fft=1, cols_fwd_polar=0, cols_wexp_inv=0,
        cols_mraf_fwd=1, cols_mraf_mix_inv=1,
    )


@pytest.mark.cuda
def test_mraf_holograms_run_through_kernels(cuda):
    """An MRAF Hologram at 256^2: WGS-Kim with zero weights on the carry
    loop (three kernels per iteration), GS on the natural step (four)."""
    from slmsuite_torch.holography.algorithms import Hologram
    from slmsuite_torch.ops import cuda_fft

    yy, xx = np.meshgrid(np.arange(256) - 128, np.arange(256) - 128, indexing="ij")
    radius = np.hypot(xx, yy)
    target = (np.abs(radius - 32) < 3).astype(np.float32)
    target[radius > 64] = np.nan
    phi0 = np.random.default_rng(5).uniform(-np.pi, np.pi, (256, 256))
    n = 6
    for method, loop in (("WGS-Kim", dict(carry_entry=1, cols_mraf_fwd=n,
                                          cols_mraf_mix_inv=n, rows_normfwd=n,
                                          carry_exit=1)),
                         ("GS", dict(carry_entry=n, cols_fwd_polar=n, cols_fft=n,
                                     carry_exit=n))):
        holo = Hologram(target=target, device=cuda)
        holo.reset_phase(custom_phase=phi0)
        cuda_fft.reset_launch_counts()
        holo.optimize(method=method, maxiter=n, stat_groups=["computational"],
                      verbose=False, mraf_factor=0.5, zero_factor=0.1)
        launched = {k: v for k, v in cuda_fft.LAUNCHES.items() if v}
        # The result farfield adds one rows_fft and one cols_fft.
        loop = dict(loop, rows_fft=1, cols_fft=loop.get("cols_fft", 0) + 1)
        assert launched == loop, (method, launched)
        assert 0 < holo.stats["stats"]["computational"]["efficiency"][-1] <= 1
        assert holo.zero_weights.shape == (2, 256, 256)
