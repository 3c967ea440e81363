"""
The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the fixture, never at import). On a GPU machine without jax, run
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(the repository conftest configures jax). Tolerances are those of
``chip_smoke.py``: carry and transformed planes 1e-4 relative to their
peak, weights, phasors and stats atol 1e-4 / rtol 1e-3 (the phasor also
within the turn f32 round-off gives it near a zero of F), ``arg F``
1e-3 rad where ``|F| > 1e-3 max |F|``, psi 99th-percentile wrapped
difference below 2e-3.
"""

import numpy as np
import pytest
import torch

CARRY_RTOL = 1e-4
ATOL, RTOL = 1e-4, 1e-3
PSI_P99 = 2e-3
PSI_MAX_ATOL = 1e-4   # psi, where no point of the carry is near 0


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


def _assert_phasor(got, ref, amp_ff):
    """Kim's unit phasor F/|F| at every point within ATOL + RTOL |ref| plus
    the turn that f32 round-off gives it: an error of 2^-24 log2(H) rms|F|
    in F (the FFT's normwise bound, rms over the column) over |F|, which
    matters only near a zero of F; and of modulus 1."""
    rms = amp_ff.square().mean(dim=0, keepdim=True).sqrt()
    turn = 2.0**-24 * np.log2(amp_ff.shape[0]) * rms / amp_ff
    for g, r in zip(got, ref):
        bad = (g - r).abs() > ATOL + RTOL * r.abs() + turn
        assert not bool(bad.any()), f"{int(bad.sum())} phasor values off"
    assert float((got[0] ** 2 + got[1] ** 2 - 1).abs().max()) < 1e-5


#: Shapes of the carry step: the step kernels' launches differ with each
#: side (line_fft's plan, the column tile, the cluster of two at 4096 and
#: of four at 8192), so every power-of-two side from 64 to 8192 appears as
#: H and as W, with the rectangles both ways; and mixed lines (n = P m,
#: P = 8 or 16), as H and as W, beside powers of two and each other: 96 = 32 * 3,
#: 120 = 8 * 15, 1152 = 128 * 9, 1920 = 128 * 15, 792 = 8 * 9 * 11, 1272 =
#: 8 * 3 * 53, and 1080 = 8 * 135, whose lines have only odd factors
#: beyond P = 8. (At 1272x792 these inputs put a row's inverse FFT near 0
#: at one point, where rows_normfwd's amplitude replacement leaves even
#: the plain f32 step 2e-4 from float64: FFT_SHAPES holds the kernels
#: there.)
STEP_SHAPES = [(64, 64), (256, 512), (64, 4096), (4096, 64), (512, 256), (2048, 2048),
               (128, 1024), (1024, 128), (8192, 64), (64, 8192), (96, 128), (120, 72),
               (1152, 1920), (792, 1272), (1080, 1920)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", STEP_SHAPES)
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
    for g, r in [(got[2], ref[2]), (got[4], ref[4]), (got[5], ref[5])]:
        torch.testing.assert_close(g, r, atol=ATOL, rtol=RTOL)
    if kim:
        _assert_phasor(got[3], ref[3], torch.fft.fft(torch.complex(pgr, pgi), dim=0).abs())

    diff = torch.remainder(cuda_fft.carry_exit(pgr, pgi) - fft._wgs_carry_exit(pgr, pgi)
                           + np.pi, 2 * np.pi) - np.pi
    assert float(torch.quantile(diff.abs().flatten(), 0.99)) < PSI_P99


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 2048), (4096, 256), (256, 64)])
def test_cols_wgs_roundtrip_stats_repeat_bit_for_bit(cuda, shape):
    """The stats partials are reduced in a fixed order (each thread its
    points in turn, the block's warps in order, the blocks in order): two
    launches on the same inputs give the same bits, the cluster of two at
    4096 points included."""
    from slmsuite_torch.ops import cuda_fft, fft

    psi, target, pff, amp = _inputs(shape, cuda, "scalar")
    gr, gi = fft._wgs_carry_entry(psi, amp)
    args = (gr, gi, target * 1.3, target, (target != 0).float(), pff,
            _fwd_scal(shape, 1.0, target, True, cuda))
    kw = dict(rule="kim", kim=True, stats_on=True)
    first = cuda_fft.cols_wgs_roundtrip(*args, **kw)
    second = cuda_fft.cols_wgs_roundtrip(*args, **kw)
    assert torch.equal(first[4], second[4]) and torch.equal(first[5], second[5])
    assert torch.equal(first[0], second[0]) and torch.equal(first[2], second[2])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 128), (4096, 64)])
def test_step_kernels_zero_fields(cuda, shape):
    """A zero farfield gives the phasor (1, 0) and the weights of the plain
    version; a zero nearfield gives the amplitude itself, real, before the
    forward row FFT."""
    from slmsuite_torch.ops import cuda_fft, fft

    _, target, _, amp = _inputs(shape, cuda, "array")
    zero = torch.zeros(shape, device=cuda)
    args = (zero, zero, target * 1.3, target, (target != 0).float(), (zero, zero),
            _fwd_scal(shape, 1.0, target, True, cuda))
    kw = dict(rule="leonardo", kim=True, stats_on=True)
    got, ref = cuda_fft.cols_wgs_roundtrip(*args, **kw), fft._cols_wgs_roundtrip(*args, **kw)
    assert bool((got[3][0] == 1.0).all()) and bool((got[3][1] == 0.0).all())
    torch.testing.assert_close(got[2], ref[2], atol=ATOL, rtol=RTOL)
    assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= CARRY_RTOL

    for a in (1.0, amp):
        gr, gi = cuda_fft.rows_normfwd(zero, zero, a)
        field = torch.fft.fft(torch.complex(torch.ones_like(zero) * a, zero), dim=-1)
        assert max(_rel(gr, field.real), _rel(gi, field.imag)) <= CARRY_RTOL
        plain = fft._rows_normfwd(zero, zero, a)
        assert max(_rel(gr, plain[0]), _rel(gi, plain[1])) <= CARRY_RTOL
    # A zero carry leaves psi 0, as torch.atan2 gives it.
    assert bool((cuda_fft.carry_exit(zero, zero) == 0).all())


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda):
    from slmsuite_torch.ops import cuda_fft

    with pytest.raises(ValueError, match="multiples of 8"):
        cuda_fft.carry_entry(torch.zeros((100, 128), device=cuda), 1.0)
    with pytest.raises(ValueError, match="float32"):
        cuda_fft.carry_entry(torch.zeros((64, 64), device=cuda, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fft.carry_entry(torch.zeros((64, 64), device=cuda).t()[:, :64], 1.0)


@pytest.mark.cuda
def test_dispatchers_take_the_plain_tier_outside_the_gate(cuda):
    """A CUDA plane whose sides the kernels do not take (100 is not a
    multiple of 8; 8200, 16384 and 56 are out of range) runs the plain
    versions on the card: the same result as the plain version, no launch,
    and one PLAIN_ON_DEVICE count a dispatch."""
    from slmsuite_torch.ops import cuda_fft, fft

    gen = torch.Generator(device=cuda).manual_seed(3)
    plane = torch.rand((100, 128), device=cuda, generator=gen)
    other = torch.rand((100, 128), device=cuda, generator=gen)
    scal = fft.pack_scalars(dict.fromkeys(fft.SCALAR_KEYS, 0.0), cuda)
    cuda_fft.reset_launch_counts()
    fft.reset_plain_count()
    pairs = [
        (lambda: fft.wgs_carry_entry(plane, 1.0), lambda: fft._wgs_carry_entry(plane, 1.0)),
        (lambda: fft.wgs_carry_exit(plane, other), lambda: fft._wgs_carry_exit(plane, other)),
        (lambda: fft.wgs_carry_step(plane, other, 1.0, plane, None, plane, plane, scal,
                                    rule="kim", kim=False, stats_on=True),
         lambda: fft._wgs_carry_step(plane, other, 1.0, plane, None, plane, plane, scal,
                                     rule="kim", kim=False, stats_on=True)),
        (lambda: fft.fft2(plane, other), lambda: fft._fft2(plane, other)),
        (lambda: fft.ifft2(plane, other), lambda: fft._ifft2(plane, other)),
        (lambda: fft.fft2_polar(plane, other), lambda: fft._fft2_polar(plane, other)),
        (lambda: fft.fft2_polar_from_phase(plane, 1.0),
         lambda: fft._fft2_polar_from_phase(plane, 1.0)),
        (lambda: fft.wexp_ifft2(plane, other), lambda: fft._wexp_ifft2(plane, other)),
        (lambda: fft.wexp_ifft2_phase(plane, other),
         lambda: fft._wexp_ifft2_phase(plane, other)),
    ]
    for call, plain in pairs:
        for got, ref in zip(call(), plain()):
            if got is not None:
                assert torch.equal(got, ref)
    assert fft.PLAIN_ON_DEVICE == len(pairs)
    for shape in ((8200, 64), (64, 16384), (56, 64)):
        x = torch.zeros(shape, device=cuda)
        assert all(torch.equal(a, b) for a, b in zip(fft.fft2(x, x), fft._fft2(x, x)))
    assert fft.PLAIN_ON_DEVICE == len(pairs) + 3
    assert sum(cuda_fft.LAUNCHES.values()) == 0
    fft.reset_plain_count()


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
    """The 99th percentile of the wrapped difference (numpy's: torch.quantile
    takes at most 2^24 values, and an 8192^2 plane has 2^26)."""
    diff = torch.remainder(got - ref + np.pi, 2 * np.pi) - np.pi
    return float(np.percentile(diff.abs().flatten().cpu().numpy(), 99))


def _pair(shape, device, seed=2):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
                 for _ in range(2))


#: Every power-of-two side the kernels take, the two extreme rectangles
#: and 256x512; and planes with mixed lines (n = P m, P = 8 or 16): real panels
#: at padding_order=0 (1152x1920, 1080x1920, 1200x1920, 2464x4160), the
#: JAX package's kernel sides (1536, 6144), 792 and 1272 (odd factors 11
#: and 53), 1792 = 256 * 7, 96x128, and 8168 = 8 * 1021 both ways (a line
#: whose pass over m is one 1021-term direct sum).
FFT_SHAPES = [(n, n) for n in (64, 128, 256, 512, 1024, 2048, 4096, 8192)] + [
    (256, 512), (64, 4096), (4096, 64), (96, 128), (1152, 1920), (1080, 1920), (1200, 1920),
    (2464, 4160), (6144, 1536), (1272, 792), (1792, 96), (8168, 64), (64, 8168)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FFT_SHAPES)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("name", ["rows_fft", "cols_fft"])
def test_fft_kernels_match_plain(cuda, name, shape, inverse):
    from slmsuite_torch.ops import cuda_fft, fft

    xr, xi = _pair(shape, cuda)
    cuda_fft.reset_launch_counts()
    got = getattr(cuda_fft, name)(xr, xi, inverse=inverse, scale=0.5)
    ref = getattr(fft, "_" + name)(xr, xi, inverse=inverse, scale=0.5)
    assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= CARRY_RTOL
    assert cuda_fft.LAUNCHES[name] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FFT_SHAPES)
@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
@pytest.mark.parametrize("psi_max", [4 * np.pi, 1e6], ids=["4pi", "1e6"])
def test_carry_entry_and_exit_match_plain(cuda, shape, amp_kind, psi_max):
    """carry_entry and carry_exit, row kernels on the line FFT, at every
    line length and the rectangles, with psi in +-4 pi and in +-1e6 (past
    105615 sincosf takes its Payne-Hanek reduction)."""
    from slmsuite_torch.ops import cuda_fft, fft

    rng = np.random.default_rng(4)
    psi = torch.from_numpy(rng.uniform(-psi_max, psi_max, shape).astype(np.float32)).to(cuda)
    amp = (1.0 if amp_kind == "scalar" else
           torch.from_numpy((0.5 + rng.uniform(0, 1, shape)).astype(np.float32)).to(cuda))
    cuda_fft.reset_launch_counts()
    gr, gi = cuda_fft.carry_entry(psi, amp)
    pgr, pgi = fft._wgs_carry_entry(psi, amp)
    assert max(_rel(gr, pgr), _rel(gi, pgi)) <= CARRY_RTOL
    got, ref = cuda_fft.carry_exit(pgr, pgi), fft._wgs_carry_exit(pgr, pgi)
    assert _psi_p99(got, ref) < PSI_P99
    # The exit's inverse gives back W amp e^{i psi}, far from 0 at every
    # point, so every point is held, not a percentile: a fault confined to
    # one row of a block shows here.
    wrapped = torch.remainder(got - ref + np.pi, 2 * np.pi) - np.pi
    assert float(wrapped.abs().max()) <= PSI_MAX_ATOL
    assert cuda_fft.LAUNCHES["carry_entry"] == 1 and cuda_fft.LAUNCHES["carry_exit"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rows_fft", "cols_fft"])
def test_fft_wrappers_reject_strided_planes_and_take_offset_views(cuda, name):
    """A strided view raises and nothing is launched. A contiguous view
    that starts 4 bytes into its storage is transformed like any other:
    the kernels load and store 4 bytes at a time."""
    from slmsuite_torch.ops import cuda_fft, fft

    kernel = getattr(cuda_fft, name)
    flat = _pair((64 * 64 + 4,), cuda)[0]
    aligned = flat[:64 * 64].view(64, 64)
    shifted = flat[1:64 * 64 + 1].view(64, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    strided = torch.zeros((64, 128), device=cuda)[:, ::2]
    cuda_fft.reset_launch_counts()
    with pytest.raises(ValueError, match="contiguous"):
        kernel(strided, aligned, inverse=False)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(aligned, strided, inverse=True)
    assert cuda_fft.LAUNCHES[name] == 0
    got = kernel(shifted, aligned, inverse=False)
    ref = getattr(fft, "_" + name)(shifted, aligned, inverse=False)
    assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= CARRY_RTOL
    assert cuda_fft.LAUNCHES[name] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048, 4096, 8192, 96, 792, 1080, 1152,
                               1272, 1536, 1792, 1920, 4160, 6144, 8184])
def test_fft_launch_shapes_fit_the_card(cuda, n):
    """What the launchers report: blocks of at most 1024 threads, at most
    227 KB of shared memory (rows up to 4096 points: under the 48 KB that
    needs no attribute), row groups and tiles that divide the shortest side
    (8), whole 32-byte sectors a row segment of a power-of-two line's column
    tile, a cluster of two blocks at 4096 points and of four at 8192, and a
    thread for every 8 or 16 points of the lines a block holds. A plane
    whose other side is a multiple of 8 only narrows rows and tiles to 8.
    A mixed line's tile holds 8 columns or more wherever 8 columns'
    threads and shared memory fit a block."""
    from slmsuite_torch.ops import cuda_fft

    points = cuda_fft.line_points(n)
    pow2 = n & (n - 1) == 0
    rows_kernels = [k for k in cuda_fft.LINE_KERNELS if not k.startswith("cols")]
    assert rows_kernels == ["rows_fft", "rows_normfwd", "carry_entry", "carry_exit"]
    for kernel in rows_kernels:
        rows, blocks, threads, smem = cuda_fft.fft_launch_shape(kernel, n)
        assert blocks == 1 and threads * points == rows * n and threads <= 1024
        assert smem == rows * cuda_fft.line_pitch(n) * 8 and smem <= 227 * 1024
        if pow2:
            assert threads == max(256, n // points) and 64 % rows == 0
            assert n == 8192 or smem <= 48 * 1024
        else:
            assert 8 % rows == 0
        assert cuda_fft.fft_launch_shape(kernel, n, 1080)[0] == min(rows, 8)
    cols_kernels = [k for k in cuda_fft.LINE_KERNELS if k.startswith("cols")]
    assert cols_kernels == ["cols_fft", "cols_wgs_roundtrip", "cols_fwd_polar", "cols_wexp_inv",
                            "cols_mraf_fwd", "cols_mraf_mix_inv", "cols_wgs_fwd"]
    for kernel in cols_kernels:
        tc, blocks, threads, smem = cuda_fft.fft_launch_shape(kernel, n)
        assert 64 % tc == 0 and threads <= 1024 and smem <= 227 * 1024
        assert blocks == {4096: 2, 8192: 4}.get(n, 1)
        assert not pow2 or tc >= 8
        assert tc >= 8 or 8 * n // points > 1024 or 8 * cuda_fft.line_pitch(n) * 8 > 227 * 1024
        assert threads * blocks * points == tc * n
        assert smem * blocks == tc * cuda_fft.line_pitch(n) * 8
        narrow = cuda_fft.fft_launch_shape(kernel, n, 1080)
        assert narrow[0] == min(tc, 8) and narrow[1] == blocks
    for bad in (96 + 4, 16384, 32):
        with pytest.raises(ValueError, match="No rows_fft launch"):
            cuda_fft.fft_launch_shape("rows_fft", bad)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FFT_SHAPES)
@pytest.mark.parametrize("phase_max", [np.pi, 1e6], ids=["pi", "1e6"])
def test_cols_fwd_polar_and_wexp_inv_match_plain(cuda, shape, phase_max):
    """cols_fwd_polar and cols_wexp_inv, column kernels on the line FFT, at
    every line length (4096 on a cluster of two blocks) and the rectangles
    both ways, with one all-zero column (|F| = 0 and arg F = 0 there), and
    the phase in +-pi and in +-1e6 (past 105615 sincosf takes its
    Payne-Hanek reduction)."""
    from slmsuite_torch.ops import cuda_fft, fft

    xr, xi = _pair(shape, cuda)
    xr[:, 1], xi[:, 1] = 0.0, 0.0
    cuda_fft.reset_launch_counts()
    amp, theta = cuda_fft.cols_fwd_polar(xr, xi, 0.25)
    ref_amp, ref_theta = fft._cols_fwd_polar(xr, xi, 0.25)
    assert _rel(amp, ref_amp) <= CARRY_RTOL
    _assert_theta(theta, ref_theta, ref_amp)
    assert float(amp[:, 1].abs().max()) == 0.0 and float(theta[:, 1].abs().max()) == 0.0

    rng = np.random.default_rng(5)
    weights = xr.abs()
    phase = torch.from_numpy(rng.uniform(-phase_max, phase_max, shape).astype(np.float32)).to(cuda)
    got = cuda_fft.cols_wexp_inv(weights, phase)
    ref = fft._cols_wexp_inv(weights, phase)
    assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= CARRY_RTOL
    assert float(got[0][:, 1].abs().max()) == 0.0 and float(got[1][:, 1].abs().max()) == 0.0
    assert cuda_fft.LAUNCHES["cols_fwd_polar"] == 1 and cuda_fft.LAUNCHES["cols_wexp_inv"] == 1


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
        cols_mraf_fwd=0, cols_mraf_mix_inv=0, cols_wgs_fwd=0,
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(96, 128), (120, 72)])
def test_mixed_side_holograms_match_the_cpu(cuda, shape):
    """Holograms on planes whose sides are not powers of two run through
    the kernels and match the same runs on the CPU port: WGS-Kim on the
    carry loop (a 4x4 spot array), WGS-Nogrette with spot feedback on the
    natural step, and an MRAF ring image with WGS-Kim and zero weights,
    each from one seeded phase. Final efficiency and uniformity within
    1e-3, the exact launches, and the phase within PSI_P99 at the 99th
    percentile (the runs differ by the FFTs' f32 rounding only)."""
    from slmsuite_torch.holography.algorithms import Hologram, SpotHologram
    from slmsuite_torch.ops import cuda_fft

    H, W = shape
    phi0 = np.random.default_rng(9).uniform(-np.pi, np.pi, shape)
    yy, xx = np.meshgrid(np.arange(H) - H // 2, np.arange(W) - W // 2, indexing="ij")
    radius = np.hypot(xx, yy)
    ring = (np.abs(radius - H / 8) < 2).astype(np.float32)
    ring[radius > H / 4] = np.nan
    n = 12
    runs = {
        "carry": (lambda dev: SpotHologram.make_rectangular_array(
            shape, array_shape=(4, 4), array_pitch=(12, 12), basis="knm", device=dev),
            dict(method="WGS-Kim"), dict(carry_entry=1, cols_wgs_roundtrip=n,
                                         rows_normfwd=n, carry_exit=1)),
        "natural": (lambda dev: SpotHologram.make_rectangular_array(
            shape, array_shape=(4, 4), array_pitch=(12, 12), basis="knm", device=dev),
            dict(method="WGS-Nogrette", feedback="computational_spot"),
            dict(carry_entry=n, cols_fwd_polar=n, cols_wexp_inv=n, carry_exit=n)),
        "mraf": (lambda dev: Hologram(target=ring, device=dev),
                 dict(method="WGS-Kim", mraf_factor=0.5, zero_factor=0.1),
                 dict(carry_entry=1, cols_mraf_fwd=n, cols_mraf_mix_inv=n,
                      rows_normfwd=n, carry_exit=1)),
    }
    for name, (make, kw, loop) in runs.items():
        out = {}
        for device in (cuda, torch.device("cpu")):
            holo = make(device)
            holo.reset_phase(custom_phase=phi0)
            cuda_fft.reset_launch_counts()
            holo.optimize(maxiter=n, stat_groups=["computational"], verbose=False, **kw)
            if device.type == "cuda":
                launched = {k: v for k, v in cuda_fft.LAUNCHES.items() if v}
                assert launched == dict(loop, rows_fft=1, cols_fft=1), (name, launched)
            stats = holo.stats["stats"]["computational"]
            out[device.type] = (stats["efficiency"][-1], stats["uniformity"][-1],
                                torch.as_tensor(holo.get_phase()).float().cpu())
        for k in (0, 1):
            assert abs(out["cuda"][k] - out["cpu"][k]) < 1e-3, (name, out["cuda"][k],
                                                               out["cpu"][k])
        assert _psi_p99(out["cuda"][2], out["cpu"][2]) < PSI_P99, name


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
@pytest.mark.parametrize("shape", FFT_SHAPES)
@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
@pytest.mark.parametrize("rule", ["leonardo", "kim"])
@pytest.mark.parametrize("stats_on", [True, False])
@pytest.mark.parametrize("zero", [True, False])
def test_mraf_kernels_match_plain(cuda, shape, amp_kind, rule, stats_on, zero):
    """cols_mraf_fwd and cols_mraf_mix_inv, column kernels on the line FFT,
    against their plain versions at every line length (4096 on a cluster of
    two blocks) and the rectangles both ways, with one all-zero column of
    the carry (F = 0 there: the phasor (1, 0), the weight update at f = 0),
    and the three-kernel MRAF carry step against its plain version."""
    from slmsuite_torch.ops import cuda_fft, fft

    gr, gi, amp, target, pff, mcode, zw = _mraf_inputs(shape, cuda, amp_kind)
    gr[:, 1], gi[:, 1] = 0.0, 0.0
    kim = rule == "kim"
    scal = _mraf_scal(shape, amp, target, stats_on, cuda)
    weights = target * 1.3
    mask = (target != 0).float() if stats_on else None
    fwd = (gr, gi, weights, target, mask, scal)
    got = cuda_fft.cols_mraf_fwd(*fwd, rule=rule, stats_on=stats_on)
    ref = fft._cols_mraf_fwd(*fwd, rule=rule, stats_on=stats_on)
    assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= CARRY_RTOL
    assert float(got[0][:, 1].abs().max()) == 0.0 and float(got[1][:, 1].abs().max()) == 0.0
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
    if kim and stats_on:  # use_theta: the phasor of the zero column is (1, 0)
        assert bool((got[2][0][:, 1] == 1.0).all()) and bool((got[2][1][:, 1] == 0.0).all())

    step = (gr, gi, amp, weights, pff if kim else None, target, mask, mcode,
            zw if zero else None, scal)
    kw = dict(rule=rule, kim=kim, stats_on=stats_on, zero=zero)
    got, plain = cuda_fft.mraf_carry_step(*step, **kw), fft._mraf_carry_step(*step, **kw)
    assert max(_rel(got[0], plain[0]), _rel(got[1], plain[1])) <= CARRY_RTOL
    torch.testing.assert_close(got[5], plain[5], atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 4096), (4096, 64), (2048, 256)])
def test_cols_mraf_fwd_partials_have_the_launch_block_count(cuda, shape):
    """cols_mraf_fwd writes one row of stats partials a block: W / tc tiles
    of the launch shape's blocks, two a tile at 4096 points. The wrapper
    sizes the buffer by the library's count, and the launcher refuses any
    other count, so no launch writes past the buffer; the sums repeat bit
    for bit."""
    from slmsuite_torch.ops import cuda_fft, fft

    H, W = shape
    tc, blocks, _, _ = cuda_fft.fft_launch_shape("cols_mraf_fwd", H)
    assert blocks == (2 if H == 4096 else 1)
    n_blocks = cuda_fft._cols_blocks("cols_mraf_fwd", H, W)
    assert n_blocks == W // tc * blocks
    gr, gi, amp, target, _, _, _ = _mraf_inputs(shape, cuda, "scalar")
    scal = _mraf_scal(shape, amp, target, True, cuda)
    fwd = (gr, gi, target * 1.3, target, (target != 0).float(), scal)
    first = cuda_fft.cols_mraf_fwd(*fwd, rule="leonardo", stats_on=True)
    second = cuda_fft.cols_mraf_fwd(*fwd, rule="leonardo", stats_on=True)
    assert torch.equal(first[3], second[3]) and torch.equal(first[4], second[4])
    ref = fft._cols_mraf_fwd(*fwd, rule="leonardo", stats_on=True)
    torch.testing.assert_close(first[3], ref[3], atol=ATOL, rtol=RTOL)

    out = [torch.empty_like(gr) for _ in range(3)]
    sums = torch.empty(4, dtype=torch.float64, device=cuda)
    maxs = torch.empty(4, dtype=torch.float32, device=cuda)
    for wrong in (n_blocks // 2, n_blocks * 2):
        partials = torch.empty((max(wrong, n_blocks), 8), dtype=torch.float64, device=cuda)
        rc = cuda_fft._lib().slm_cols_mraf_fwd(
            gr.data_ptr(), gi.data_ptr(), fwd[2].data_ptr(), target.data_ptr(),
            fwd[4].data_ptr(), *(x.data_ptr() for x in out), scal.data_ptr(),
            partials.data_ptr(), sums.data_ptr(), maxs.data_ptr(), H, W, wrong,
            cuda_fft._twiddles(H, False, cuda).data_ptr(), 0, 1,
            torch.cuda.current_stream().cuda_stream)
        assert rc != 0, wrong
    torch.cuda.synchronize()


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
        cols_mraf_fwd=1, cols_mraf_mix_inv=1, cols_wgs_fwd=0,
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


#: The compressed kernels against their plain versions: max |diff| over
#: max |plain|. The kernel forms each phase by an fma chain and the plain
#: version by a matrix product, so a phase of ~500 rad may differ by an
#: f32 ulp (~3e-5 rad), and the sums run in another order (the largest
#: measured on an H100 at config 5 is 1.2e-6).
CMP_RTOL = 1e-4


def _cmp_inputs(D, P, N, device, seed=0):
    """Seeded basis (D, P), coefficients (D, N), farfield (N,), nearfield
    (P,) and amplitude (P,) pairs on the card, as the JAX package's
    compressed tests make them."""
    rng = np.random.default_rng(seed)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)

    return dict(
        basis=dev(rng.normal(size=(D, P)) * 2), coeffs=dev(rng.normal(size=(D, N)) * 5),
        ffr=dev(rng.normal(size=N)), ffi=dev(rng.normal(size=N)),
        nfr=dev(rng.normal(size=P)), nfi=dev(rng.normal(size=P)),
        amp=dev(0.5 + rng.uniform(0, 1, P)),
    )


def _rel_pair(got, ref):
    return max(_rel(got[0], ref[0]), _rel(got[1], ref[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("D, P, N", [(4, 3000, 17), (3, 65536, 256), (2, 8192, 600),
                                     (9, 5000, 100), (5, 4096, 300), (3, 65536, 300),
                                     (3, 65536, 600), (3, 65536, 9000), (3, 65536, 12000),
                                     (16, 16384, 4096), (17, 5000, 100), (17, 3000, 600),
                                     (21, 65536, 100), (21, 16384, 4096), (28, 4096, 300),
                                     (28, 8192, 256), (48, 3000, 17), (20, 5000, 97),
                                     (24, 3000, 301), (25, 9000, 45), (44, 5000, 97)])
@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
def test_compressed_kernels_match_plain(cuda, D, P, N, amp_kind):
    """f2n, n2f, fused_iter and fused_iter_cached against their plain
    versions, at unaligned sizes (padded pixels and pad spots), at config
    5's spot count, across n2f's spot groups and past one f2n spot chunk
    (300, 600 spots), with three float4 groups of Zernike terms in
    fused_iter's lanes-on-spots kernel (D = 9), past its 256 spots (300 to
    12,000 spots, and 4,096 at D = 16: fused_iter runs as f2n with the
    amplitude replacement, then n2f unnormalized), past the shared memory
    of the earlier n2f (12,000 spots at D = 3, 4,096 at D = 16) and with
    fused_iter_cached past the cos/sin it keeps (600 spots and more), and
    past 16 Zernike terms (17, 21 and 28: the wide f2n and n2f, and
    fused_iter's kernel staging five to seven float4 groups; 48, past the
    44 terms that kernel stages: fused_iter runs as f2n and n2f; 20, 24, 25
    and 44, each group count's last group whole or not, 44 the last
    compile-time instantiation of the wide kernels, at spot counts that
    are no multiple of 8 and pixels with a tail). One launch each, and one
    more of f2n and n2f where fused_iter runs as the two; past 16 terms
    each launch of f2n and n2f is counted as wide too."""
    from slmsuite_torch.ops import compressed as C
    from slmsuite_torch.ops import cuda_compressed as K

    x = _cmp_inputs(D, P, N, cuda)
    amp = 1.0 if amp_kind == "scalar" else x["amp"]
    K.reset_launch_counts()
    assert _rel_pair(K.f2n(x["ffr"], x["ffi"], x["coeffs"], x["basis"]),
                     C._farfield_to_nearfield(x["ffr"], x["ffi"], x["coeffs"],
                                              x["basis"])) <= CMP_RTOL
    got = K.n2f(x["nfr"], x["nfi"], x["coeffs"], x["basis"])
    assert got[0].shape == (N,)
    assert _rel_pair(got, C._nearfield_to_farfield(x["nfr"], x["nfi"], x["coeffs"],
                                                   x["basis"])) <= CMP_RTOL
    assert _rel_pair(K.fused_iter(x["ffr"], x["ffi"], x["coeffs"], x["basis"], amp),
                     C._fused_iteration(x["ffr"], x["ffi"], x["coeffs"], x["basis"],
                                        amp)) <= CMP_RTOL
    kc, ks = C.build_kernel_cache(x["coeffs"], x["basis"])
    got = K.fused_iter_cached(x["ffr"], x["ffi"], kc, ks, amp, N, P)
    assert got[0].shape == (N,)
    assert _rel_pair(got, C._fused_iteration_cached(x["ffr"], x["ffi"], kc, ks, amp, N,
                                                    P)) <= CMP_RTOL
    two = N > 256 or D > 44
    assert K.LAUNCHES == dict(f2n=1 + two, n2f=1 + two, fused_iter=int(not two),
                              fused_iter_cached=1)
    wide = D > 16
    assert K.WIDE_LAUNCHES == dict(f2n=(1 + two) * wide, n2f=(1 + two) * wide)


@pytest.mark.cuda
def test_compressed_reductions_repeat_bit_for_bit(cuda):
    """The cross-block reductions run in a fixed order: two launches on
    the same inputs give the same bits (fused_iter at 9,000 spots: f2n and
    n2f; the wide f2n and n2f at 21 terms)."""
    from slmsuite_torch.ops import compressed as C
    from slmsuite_torch.ops import cuda_compressed as K

    x = _cmp_inputs(3, 65536, 256, cuda, seed=1)
    big = _cmp_inputs(3, 65536, 9000, cuda, seed=1)
    wide = _cmp_inputs(21, 65536, 300, cuda, seed=1)
    kc, ks = C.build_kernel_cache(x["coeffs"], x["basis"])
    calls = (
        lambda: K.n2f(x["nfr"], x["nfi"], x["coeffs"], x["basis"]),
        lambda: K.fused_iter(x["ffr"], x["ffi"], x["coeffs"], x["basis"], x["amp"]),
        lambda: K.fused_iter_cached(x["ffr"], x["ffi"], kc, ks, x["amp"], 256, 65536),
        lambda: K.fused_iter(big["ffr"], big["ffi"], big["coeffs"], big["basis"], big["amp"]),
        lambda: K.n2f(wide["nfr"], wide["nfi"], wide["coeffs"], wide["basis"]),
        lambda: K.f2n(wide["ffr"], wide["ffi"], wide["coeffs"], wide["basis"], amp=wide["amp"]),
    )
    for call in calls:
        first, second = call(), call()
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_wide_compressed_kernels_against_float64(cuda):
    """The wide f2n and n2f at 21 terms on inputs whose phases reach 1e6
    (past 1e5 the kernels' sincos takes libdevice's sincosf) and are exact
    in f32 (as chip_smoke.py's wide_phase_inputs makes them: the basis in
    multiples of 1/4 within [-2, 2], the coefficients in multiples of 1/4
    up to scales spaced geometrically from 1 to 1e6 / 42, the first spot's
    all at the largest such multiple and the first pixel's basis all 2,
    where the phase is 999,999; every partial sum a multiple of 1/16 below
    2^20): against the plain versions run in float64 on the card, within
    CMP_RTOL of the largest float64 value."""
    from slmsuite_torch.ops import compressed as C
    from slmsuite_torch.ops import cuda_compressed as K

    D, P, N, top = 21, 3000, 17, 1e6
    rng = np.random.default_rng(4)
    basis = rng.integers(-8, 9, size=(D, P)) / 4
    scale = np.geomspace(top / (2 * D), 1, N)
    coeffs = np.round(rng.uniform(-1, 1, (D, N)) * scale * 4) / 4
    coeffs[:, 0], basis[:, 0] = np.floor(scale[0] * 4) / 4, 2.0
    assert np.abs(coeffs.T @ basis).max() == 2 * D * coeffs[0, 0] == 999_999 < 2**20
    x = _cmp_inputs(D, P, N, cuda, seed=4)
    x["basis"] = torch.from_numpy(basis.astype(np.float32)).to(cuda)
    x["coeffs"] = torch.from_numpy(coeffs.astype(np.float32)).to(cuda)
    cb = (x["coeffs"], x["basis"])
    for kernel, plain, args in ((K.f2n, C._farfield_to_nearfield, (x["ffr"], x["ffi"], *cb)),
                                (K.n2f, C._nearfield_to_farfield, (x["nfr"], x["nfi"], *cb))):
        ref = plain(*(a.double() for a in args))
        got = kernel(*args)
        peak = max(float(ref[0].abs().max()), float(ref[1].abs().max()))
        err = max(float((got[k].double() - ref[k]).abs().max()) for k in (0, 1)) / peak
        assert err <= CMP_RTOL, (kernel.__name__, err)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [600, 2000, 7248])
def test_wide_compressed_kernels_at_the_run_time_group_count(cuda, D):
    """The wide f2n (scaled, and the amplitude replacement) and n2f
    (normalized, and the unnormalized sum) past 44 terms, where the group
    count is known at run time, at each staging of that kernel: 600 terms
    (a ring of two buffers of eight items, 16 pairs a vote), 2,000 (one
    buffer of 16 items, with its extra barrier and restaging, 32 pairs a
    vote) and the limit slm_cmp_max_terms(), 7,248 (one buffer of eight
    items). 17 spots (pad spots; f2n restages its buffer) and 3,000 pixels
    (a tail block). The basis and coefficients are multiples of 1/4 within
    [-2, 2] and [-1, 1], so that every partial sum of a phase is a multiple
    of 1/16 below 2^20 and exact in f32: kernel and plain version differ in
    the sincos and the sums' order alone. Against the plain versions within
    CMP_RTOL; each call one wide launch."""
    from slmsuite_torch.ops import compressed as C
    from slmsuite_torch.ops import cuda_compressed as K

    assert K._lib().slm_cmp_max_terms() == 7248
    P, N = 3000, 17
    rng = np.random.default_rng(D)
    x = _cmp_inputs(D, P, N, cuda, seed=D)
    x["basis"] = torch.from_numpy(rng.integers(-8, 9, (D, P)).astype(np.float32) / 4).to(cuda)
    x["coeffs"] = torch.from_numpy(rng.integers(-4, 5, (D, N)).astype(np.float32) / 4).to(cuda)
    ff, nf, cb = (x["ffr"], x["ffi"]), (x["nfr"], x["nfi"]), (x["coeffs"], x["basis"])
    calls = {
        "f2n": (lambda: K.f2n(*ff, *cb), lambda: C._farfield_to_nearfield(*ff, *cb)),
        "f2n replace": (lambda: K.f2n(*ff, *cb, amp=x["amp"]),
                        lambda: C._farfield_to_nearfield(*ff, *cb, amp=x["amp"])),
        "n2f": (lambda: K.n2f(*nf, *cb), lambda: C._nearfield_to_farfield(*nf, *cb)),
        "n2f unnormalized": (lambda: K.n2f(*nf, *cb, normalize=False),
                             lambda: C._nearfield_to_farfield(*nf, *cb, normalize=False)),
    }
    for name, (kernel, plain) in calls.items():
        K.reset_launch_counts()
        got = kernel()
        assert {k: v for k, v in K.WIDE_LAUNCHES.items() if v} == {name.split()[0]: 1}, name
        assert _rel_pair(got, plain()) <= CMP_RTOL, name


#: The kernels' sincos on the card against float64 sin and cos of the same
#: f32 phase: the limit tests/test_torch_compressed.py holds the CPU model
#: of its reduction to (torch's sin in place of __sincosf).
SINCOS_ATOL = 6e-7


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 17])
def test_compressed_sincos_past_pi(cuda, D):
    """The kernels' sincos as f2n forms it (D = 1: f2n_kernel; D = 17:
    f2n_wide_kernel), read through f2n at one spot of farfield 1 on 65,536
    pixels (the phase is the first basis row, the other terms zero, so it
    is exact; the scale 1/256 is exact too): half of the phases lie within
    1e-3 of a half period, where k (the f32 product x kInv2Pi rounded) may
    be the farther integer and x - k 2 pi then lies past +-pi (at least
    1,000 of them here; the reduction folds it back); the other half
    uniform within the reduced range +-1e5. Each set, and the phases past
    +-pi alone, against float64 within SINCOS_ATOL."""
    from slmsuite_torch.ops import cuda_compressed as K

    P, half = 65536, 32768
    rng = np.random.default_rng(7)
    k = rng.integers(-15_000, 15_000, half)
    near = (2 * np.pi * (k + 0.5 + rng.uniform(-1e-3, 1e-3, half))).astype(np.float32)
    inside = rng.uniform(-K.REDUCED_LIMIT, K.REDUCED_LIMIT, P - half).astype(np.float32)
    x = np.concatenate([near, inside])
    x64 = x.astype(np.float64)
    y = x64 - np.round(x * np.float32(K.INV_2PI)).astype(np.float64) * 2 * np.pi
    past = np.abs(y) > np.pi
    assert past[:half].sum() >= 1000, past[:half].sum()
    basis, coeffs = np.zeros((D, P), np.float32), np.zeros((D, 1), np.float32)
    basis[0], coeffs[0] = x, 1.0
    one, zero = torch.ones(1, device=cuda), torch.zeros(1, device=cuda)
    nfr, nfi = K.f2n(one, zero, torch.from_numpy(coeffs).to(cuda),
                     torch.from_numpy(basis).to(cuda))
    c, s = (t.double().cpu().numpy() * 256 for t in (nfr, nfi))
    for tag, part in (("near a half", slice(0, half)), ("past pi", past),
                      ("uniform", slice(half, P))):
        err = max(np.abs(c[part] - np.cos(x64[part])).max(),
                  np.abs(s[part] - np.sin(x64[part])).max())
        assert err <= SINCOS_ATOL, (D, tag, err)


@pytest.mark.cuda
def test_compressed_dispatchers_route_cuda_to_kernels(cuda):
    """The dispatchers launch the kernels for CUDA tensors (never the plain
    versions), and the wrappers refuse what the kernels do not take: 17
    Zernike terms run (the wide kernels), terms past eight spots'
    coefficients in a block's shared memory raise."""
    from slmsuite_torch.ops import compressed as C
    from slmsuite_torch.ops import cuda_compressed as K

    x = _cmp_inputs(4, 3000, 17, cuda)
    K.reset_launch_counts()
    C.farfield_to_nearfield(x["ffr"], x["ffi"], x["coeffs"], x["basis"])
    C.nearfield_to_farfield(x["nfr"], x["nfi"], x["coeffs"], x["basis"])
    C.fused_iteration(x["ffr"], x["ffi"], x["coeffs"], x["basis"], x["amp"])
    kc, ks = C.build_kernel_cache(x["coeffs"], x["basis"])
    C.fused_iteration_cached(x["ffr"], x["ffi"], kc, ks, 1.0, 17, 3000)
    assert K.LAUNCHES == dict(f2n=1, n2f=1, fused_iter=1, fused_iter_cached=1)
    with pytest.raises(ValueError, match="float32"):
        K.f2n(x["ffr"].double(), x["ffi"], x["coeffs"], x["basis"])
    got = K.n2f(x["nfr"], x["nfi"], torch.zeros((17, 17), device=cuda),
                torch.zeros((17, 3000), device=cuda))
    ref = C._nearfield_to_farfield(x["nfr"], x["nfi"], torch.zeros((17, 17), device=cuda),
                                   torch.zeros((17, 3000), device=cuda))
    assert _rel_pair(got, ref) <= CMP_RTOL
    too_many = K._lib().slm_cmp_max_terms() + 1
    with pytest.raises(ValueError, match="Zernike terms"):
        K.n2f(x["nfr"], x["nfi"], torch.zeros((too_many, 17), device=cuda),
              torch.zeros((too_many, 3000), device=cuda))
    with pytest.raises(ValueError, match="pixels"):
        K.fused_iter(x["ffr"], x["ffi"], x["coeffs"], x["basis"], x["amp"][:100])


@pytest.mark.cuda
def test_compressed_hologram_runs_through_kernels(cuda, monkeypatch):
    """A CompressedSpotHologram on a 64^2 SimulatedSLM: the cached loop
    launches fused_iter_cached once per iteration and n2f once (the
    finalize); without the cache fused_iter runs once per iteration, n2f at
    the entry and the finalize, f2n at the exit. Both agree with the plain
    run on the card (normalized amp_ff and weights within 2e-3)."""
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM
    from slmsuite_torch.holography.algorithms import CompressedSpotHologram
    from slmsuite_torch.ops import compressed as C
    from slmsuite_torch.ops import cuda_compressed as K

    rng = np.random.default_rng(8)
    spots = np.vstack([rng.uniform(-8e-3, 8e-3, (2, 9)), rng.uniform(-2e-6, 2e-6, (1, 9))])
    phi0 = rng.uniform(-np.pi, np.pi, (64, 64))
    n = 6

    def run():
        holo = CompressedSpotHologram(spots, cameraslm=SimulatedSLM((64, 64)), device=cuda)
        holo.reset_phase(phi0)
        K.reset_launch_counts()
        holo.optimize("WGS-Kim", maxiter=n, verbose=False)
        amp, w = np.asarray(holo.amp_ff), np.asarray(holo.weights)
        return {k: v for k, v in K.LAUNCHES.items() if v}, amp / amp.max(), w / w.max()

    for cache_mb, expect in (("4096", dict(fused_iter_cached=n, n2f=1)),
                             ("0", dict(fused_iter=n, n2f=2, f2n=1))):
        monkeypatch.setenv("SLMSUITE_TORCH_COMPRESSED_CACHE_MB", cache_mb)
        launched, amp, w = run()
        assert launched == expect, (cache_mb, launched)
        for name in ("farfield_to_nearfield", "nearfield_to_farfield", "fused_iteration",
                     "fused_iteration_cached"):
            monkeypatch.setattr(C, name, getattr(C, "_" + name))
        plain_launched, plain_amp, plain_w = run()
        monkeypatch.undo()
        assert not plain_launched
        assert np.abs(amp - plain_amp).max() < 2e-3 and np.abs(w - plain_w).max() < 2e-3


@pytest.mark.cuda
def test_compressed_hologram_past_the_cached_spot_limit_recomputes(cuda, monkeypatch):
    """15,000 spots on a 64^2 SimulatedSLM with the cache on (it fits the
    budget): past fused_iter_cached's 14,272 spots the hologram takes the
    recomputing loop, whose fused_iter runs as f2n and n2f (past 256
    spots), and runs without raising; its amplitudes are finite."""
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM
    from slmsuite_torch.holography.algorithms import CompressedSpotHologram
    from slmsuite_torch.ops import cuda_compressed as K

    monkeypatch.setenv("SLMSUITE_TORCH_COMPRESSED_CACHE_MB", "4096")
    rng = np.random.default_rng(9)
    spots = rng.uniform(-2e-2, 2e-2, (2, 15000))
    holo = CompressedSpotHologram(spots, cameraslm=SimulatedSLM((64, 64)), device=cuda)
    assert not holo._kernel_cache_enabled()
    holo.reset_phase(rng.uniform(-np.pi, np.pi, (64, 64)))
    K.reset_launch_counts()
    n = 3
    holo.optimize("WGS-Kim", maxiter=n, verbose=False)
    assert {k: v for k, v in K.LAUNCHES.items() if v} == dict(f2n=n + 1, n2f=n + 2)
    assert np.isfinite(np.asarray(holo.amp_ff)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [17, 21])
def test_compressed_hologram_past_16_terms_runs_through_kernels(cuda, monkeypatch, D):
    """A CompressedSpotHologram with D Zernike terms (ANSI 0 .. D - 1) on a
    64^2 SimulatedSLM, cached and recomputing: each loop launches its
    kernels (the wide f2n and n2f past 16 terms) and agrees with the plain
    run on the card (normalized amp_ff and weights within 2e-3)."""
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM
    from slmsuite_torch.holography.algorithms import CompressedSpotHologram
    from slmsuite_torch.ops import compressed as C
    from slmsuite_torch.ops import cuda_compressed as K

    rng = np.random.default_rng(10)
    spots = np.zeros((D, 9))
    spots[1:3] = rng.uniform(-40, 40, (2, 9))
    spots[3:] = rng.uniform(-0.5, 0.5, (D - 3, 9))
    phi0 = rng.uniform(-np.pi, np.pi, (64, 64))
    n = 6

    def run():
        holo = CompressedSpotHologram(spots, basis=np.arange(D),
                                      cameraslm=SimulatedSLM((64, 64)), device=cuda)
        holo.reset_phase(phi0)
        K.reset_launch_counts()
        holo.optimize("WGS-Kim", maxiter=n, verbose=False)
        amp, w = np.asarray(holo.amp_ff), np.asarray(holo.weights)
        return {k: v for k, v in K.LAUNCHES.items() if v}, amp / amp.max(), w / w.max()

    for cache_mb, expect in (("4096", dict(fused_iter_cached=n, n2f=1)),
                             ("0", dict(fused_iter=n, n2f=2, f2n=1))):
        monkeypatch.setenv("SLMSUITE_TORCH_COMPRESSED_CACHE_MB", cache_mb)
        launched, amp, w = run()
        assert launched == expect, (cache_mb, launched)
        for name in ("farfield_to_nearfield", "nearfield_to_farfield", "fused_iteration",
                     "fused_iteration_cached"):
            monkeypatch.setattr(C, name, getattr(C, "_" + name))
        plain_launched, plain_amp, plain_w = run()
        monkeypatch.undo()
        assert not plain_launched
        assert np.abs(amp - plain_amp).max() < 2e-3 and np.abs(w - plain_w).max() < 2e-3


# ----------------------------------------------------------------------
# The forward half of the psi -> psi WGS step: cols_wgs_fwd.
# ----------------------------------------------------------------------


def _fwd_scal(shape, amp, target, use_theta, device, apply_update=1.0):
    from slmsuite_torch.ops import fft

    H, W = shape
    post = (amp if not torch.is_tensor(amp) else 1.0) / np.sqrt(H * W)
    return fft.pack_scalars(dict(
        post=post, inv_prev_norm=0.7, apply_update=apply_update, use_theta=float(use_theta),
        feedback_exponent=0.8, feedback_factor=0.2, inv_fnorm=1.3,
        inv_tsum=float(1.0 / (target**2).sum()), inv_fsum=0.9,
    ), device)


def _assert_fwd(got, ref, amp_ff, kim):
    assert max(_rel(got[0], ref[0]), _rel(got[1], ref[1])) <= CARRY_RTOL
    torch.testing.assert_close(got[2], ref[2], atol=ATOL, rtol=RTOL)
    if kim:
        _assert_theta(got[3], ref[3], amp_ff)
    else:
        assert got[3] is None
    assert got[4].dtype == torch.float64
    torch.testing.assert_close(got[4], ref[4], atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got[5], ref[5], atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64), (256, 512)])
@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
@pytest.mark.parametrize("rule", ["kim", "leonardo", "wu", "tanh"])
@pytest.mark.parametrize("kim", [True, False])
@pytest.mark.parametrize("stats_on", [True, False])
def test_cols_wgs_fwd_matches_plain(cuda, shape, amp_kind, rule, kim, stats_on):
    """``cols_wgs_fwd`` against ``_cols_wgs_fwd`` on the same carry, with
    the stored angle selected when stats are off and the current one when
    they are on."""
    from slmsuite_torch.ops import cuda_fft, fft

    psi, target, pff, amp = _inputs(shape, cuda, amp_kind)
    angle = torch.atan2(pff[1], pff[0])
    gr, gi = fft._wgs_carry_entry(psi, amp)
    scal = _fwd_scal(shape, amp, target, stats_on, cuda)
    args = (gr, gi, target * 1.3, target, (target != 0).float() if stats_on else None,
            angle if kim else None, scal)
    kw = dict(rule=rule, kim=kim, stats_on=stats_on)
    got, ref = cuda_fft.cols_wgs_fwd(*args, **kw), fft._cols_wgs_fwd(*args, **kw)
    _assert_fwd(got, ref, fft._fft2_polar_from_phase(psi, amp)[0], kim)
    if kim and not stats_on:
        assert torch.equal(got[3], angle)
    if not stats_on:
        assert got[4][:3].tolist() == [0.0, 0.0, 0.0]
        assert bool((got[5] == -3.0e38).all())


@pytest.mark.cuda
@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
def test_wgs_fused_forward_dispatches_to_kernels(cuda, amp_kind):
    """The dispatcher on CUDA tensors launches ``carry_entry`` and
    ``cols_wgs_fwd`` once each, ignores the ``post`` lane, passes the
    weights through on the first iteration, and gives the same sums on a
    second launch (fixed-order reduction)."""
    from slmsuite_torch.ops import cuda_fft, fft

    shape = (256, 512)
    psi, target, pff, amp = _inputs(shape, cuda, amp_kind)
    angle = torch.atan2(pff[1], pff[0])
    scal = _fwd_scal(shape, amp, target, True, cuda, apply_update=0.0)
    scal[0] = 123.0
    args = (psi, amp, target * 1.3, angle, target, (target != 0).float(), scal)
    kw = dict(rule="kim", kim=True, stats_on=True)
    cuda_fft.reset_launch_counts()
    got = fft.wgs_fused_forward(*args, **kw)
    assert {k: v for k, v in cuda_fft.LAUNCHES.items() if v} == dict(
        carry_entry=1, cols_wgs_fwd=1)
    ref = fft._wgs_fused_forward(*args, **kw)
    _assert_fwd(got, ref, fft._fft2_polar_from_phase(psi, amp)[0], True)
    assert torch.equal(got[2], target * 1.3)
    again = fft.wgs_fused_forward(*args, **kw)
    assert torch.equal(got[4], again[4]) and torch.equal(got[5], again[5])
    plane = torch.zeros((100, 128), device=cuda)
    cuda_fft.reset_launch_counts()
    fft.reset_plain_count()
    outside = fft.wgs_fused_forward(plane, 1.0, plane, None, plane, None, scal,
                                    rule="wu", kim=False, stats_on=False)
    assert fft.PLAIN_ON_DEVICE == 1 and sum(cuda_fft.LAUNCHES.values()) == 0
    assert outside[0].shape == (100, 128)
    fft.reset_plain_count()


@pytest.mark.cuda
def test_cols_wgs_fwd_zero_field_angle_is_zero(cuda):
    """A zero carry gives the angle 0 and the constrained field (w', 0)."""
    from slmsuite_torch.ops import cuda_fft

    shape = (64, 128)
    _, target, _, _ = _inputs(shape, cuda, "scalar")
    zero = torch.zeros(shape, device=cuda)
    scal = _fwd_scal(shape, 1.0, target, True, cuda)
    re, im, wout, pff, _, _ = cuda_fft.cols_wgs_fwd(
        zero, zero, target, target, None, zero + 1.0, scal, rule="wu", kim=True,
        stats_on=False)
    assert torch.equal(pff, zero) and torch.equal(im, zero) and torch.equal(re, wout)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, mraf", [((256, 256), False), ((512, 512), False),
                                         ((256, 256), True), ((512, 512), True)],
                         ids=["unpadded", "padded", "mraf-unpadded", "mraf-padded"])
def test_stepwise_backward_kernels_match_plain(cuda, shape, mraf, monkeypatch):
    """The host loop's backward on the card (``wexp_ifft2_phase`` without
    MRAF, ``ifft2`` with it; a 256^2 SLM with a propagation kernel, padded
    into 512^2 or not) against the same function on the plain versions:
    psi within the psi tolerance, and exactly the counted launches."""
    from slmsuite_torch.ops import cuda_fft, engine, fft, propagation

    slm_shape = (256, 256)
    rng = np.random.default_rng(30)

    def dev(x):
        return torch.as_tensor(x, device=cuda)

    farfield = dev((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                   .astype(np.complex64))
    weights = dev(rng.uniform(0, 1, shape).astype(np.float32))
    phase_ff = dev(rng.uniform(-np.pi, np.pi, shape).astype(np.float32))
    consts = {"kernel": dev(rng.uniform(-1, 1, slm_shape).astype(np.float32))}
    if mraf:
        code = rng.integers(0, 3, shape)
        consts.update(signal_mask=dev(code == 1), noise_mask=dev(code == 2),
                      zero_mask=dev(code == 0), mraf_factor=dev(np.float32(0.5)))
    config = engine.GSConfig(method="WGS-Kim", shape=shape, slm_shape=slm_shape,
                             mraf=mraf, mraf_factor=mraf, has_kernel=True)
    backward = propagation.stepwise_backward(config)
    cuda_fft.reset_launch_counts()
    got = backward(farfield, weights, phase_ff, consts)
    launched = {k: v for k, v in cuda_fft.LAUNCHES.items() if v}
    expect = dict(cols_fft=1, rows_fft=1) if mraf else dict(cols_wexp_inv=1, carry_exit=1)
    assert launched == expect, launched
    for name in ("ifft2", "wexp_ifft2_phase"):
        monkeypatch.setattr(fft, name, getattr(fft, "_" + name))
    ref = backward(farfield, weights, phase_ff, consts)
    assert got.shape == ref.shape == slm_shape and got.is_contiguous()
    assert _psi_p99(got, ref) < PSI_P99


@pytest.mark.cuda
def test_host_iteration_launches_the_counted_kernels(cuda):
    """One host-paced camera iteration on a rig that the device
    measurement does not model (read noise, averaging 2), on a 128^2 SLM
    and camera with a 256^2 hologram: the forward ``fft2`` (``rows_fft``,
    ``cols_fft``), one camera canvas ``fft2`` a frame, and the backward
    ``wexp_ifft2_phase`` (``cols_wexp_inv``, ``carry_exit``), each counted
    exactly; the weights and psi stay finite on the card."""
    from slmsuite_torch.models.engine_models import camera_loop_wgs
    from slmsuite_torch.ops import cuda_fft

    spots = np.array([[40.0, 64, 88, 64], [64.0, 40, 64, 88]])
    fs, holo = camera_loop_wgs(spot_ij=spots, shape=(256, 256), slm_side=128, cam_side=128,
                               M=np.array([[2.0e3, 50.0], [-50.0, 2.0e3]]), device=cuda)
    rng = np.random.default_rng(31)
    fs.cam.noise = {"read": lambda x: rng.normal(0.01 * x, 0.002 * x)}
    fs.cam.averaging = 2
    fs.cam.set_exposure(20.0)
    assert holo._sim_engine_inputs() is None
    holo.optimize("WGS-Kim", maxiter=2, verbose=False)
    holo._update_flags("WGS-Kim", False, "experimental_spot",
                       ["computational_spot", "experimental_spot"])
    config = holo._build_config()
    assert config.feedback == "external_spot"
    consts = holo._build_consts(config)
    cuda_fft.reset_launch_counts()
    holo._stepwise_iteration(config, consts, None)
    torch.cuda.synchronize()
    launched = {k: v for k, v in cuda_fft.LAUNCHES.items() if v}
    assert launched == dict(rows_fft=3, cols_fft=3, cols_wexp_inv=1, carry_exit=1), launched
    assert holo.iter == 3 and type(holo)._psi.resident(holo).is_cuda
    assert np.isfinite(holo.get_phase()).all() and np.isfinite(np.asarray(holo.weights)).all()


# ----------------------------------------------------------------------
# The plane dimension (B1): carry_entry, cols_fwd_polar, cols_wexp_inv,
# cols_fft and rows_fft on a (B, H, W) stack, in one launch.
# ----------------------------------------------------------------------

#: Stacks of the batched checks: the multiplane engine's 1024^2 at B = 8,
#: the shortest and the clustered (4096-point) columns, a rectangle.
STACK_SHAPES = [(8, 1024, 1024), (3, 64, 64), (3, 256, 512), (2, 4096, 128), (1, 128, 128),
                (3, 96, 128), (2, 1080, 1920)]


def _stack_inputs(shape, device, seed=0):
    rng = np.random.default_rng(seed)
    B, H, W = shape

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)

    return dict(
        xr=dev(rng.standard_normal(shape)), xi=dev(rng.standard_normal(shape)),
        psi=dev(rng.uniform(-4 * np.pi, 4 * np.pi, shape)),
        w=dev(rng.uniform(0, 1, shape)), phi=dev(rng.uniform(-np.pi, np.pi, shape)),
        amp=dev(0.5 + rng.uniform(0, 1, (H, W))),
    )


def _batched_calls(x):
    """Kernel name -> (batched call on the stacks, call on plane b, plain
    version on the stacks)."""
    from slmsuite_torch.ops import cuda_fft, fft

    xr, xi, psi, w, phi, amp = (x[k] for k in ("xr", "xi", "psi", "w", "phi", "amp"))
    return {
        "carry_entry": (lambda: cuda_fft.carry_entry(psi, amp),
                        lambda b: cuda_fft.carry_entry(psi[b], amp),
                        lambda: fft._wgs_carry_entry(psi, amp)),
        "carry_entry scalar": (lambda: cuda_fft.carry_entry(psi, 0.5),
                               lambda b: cuda_fft.carry_entry(psi[b], 0.5),
                               lambda: fft._wgs_carry_entry(psi, 0.5)),
        "cols_fwd_polar": (lambda: cuda_fft.cols_fwd_polar(xr, xi, 0.25),
                           lambda b: cuda_fft.cols_fwd_polar(xr[b], xi[b], 0.25),
                           lambda: fft._cols_fwd_polar(xr, xi, 0.25)),
        "cols_wexp_inv": (lambda: cuda_fft.cols_wexp_inv(w, phi),
                          lambda b: cuda_fft.cols_wexp_inv(w[b], phi[b]),
                          lambda: fft._cols_wexp_inv(w, phi)),
        "cols_fft": (lambda: cuda_fft.cols_fft(xr, xi, inverse=True, scale=0.5),
                     lambda b: cuda_fft.cols_fft(xr[b], xi[b], inverse=True, scale=0.5),
                     lambda: fft._cols_fft(xr, xi, inverse=True, scale=0.5)),
        "rows_fft": (lambda: cuda_fft.rows_fft(xr, xi, inverse=False, scale=0.5),
                     lambda b: cuda_fft.rows_fft(xr[b], xi[b], inverse=False, scale=0.5),
                     lambda: fft._rows_fft(xr, xi, inverse=False, scale=0.5)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("shape", STACK_SHAPES)
@pytest.mark.parametrize("name", ["carry_entry", "carry_entry scalar", "cols_fwd_polar",
                                  "cols_wexp_inv", "cols_fft", "rows_fft"])
def test_batched_kernels_match_single_launches_and_plain(cuda, shape, name):
    """A (B, H, W) stack in one launch equals B launches on its planes bit
    for bit (the code a plane runs is the same) and the plain version on
    the stack within CARRY_RTOL (``arg F``: 1e-3 rad where ``|F| > 1e-3 max
    |F|``); ``carry_entry`` takes one (H, W) amplitude plane for every
    plane of the stack."""
    from slmsuite_torch.ops import cuda_fft

    batched, single, plain = _batched_calls(_stack_inputs(shape, cuda))[name]
    cuda_fft.reset_launch_counts()
    got = batched()
    torch.cuda.synchronize()
    kernel = name.split()[0]
    assert {k: v for k, v in cuda_fft.LAUNCHES.items() if v} == {kernel: 1}
    planes = [single(b) for b in range(shape[0])]
    for g, parts in zip(got, zip(*planes)):
        assert g.shape == shape
        assert torch.equal(g, torch.stack(parts))
    ref = plain()
    if kernel == "cols_fwd_polar":
        assert _rel(got[0], ref[0]) <= CARRY_RTOL
        on = ref[0] > 1e-3 * ref[0].amax(dim=(-2, -1), keepdim=True)
        turn = torch.remainder(got[1] - ref[1] + np.pi, 2 * np.pi) - np.pi
        assert float(turn.abs()[on].max()) < 1e-3
    else:
        for g, r in zip(got, ref):
            assert _rel(g, r) <= CARRY_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["carry_entry", "cols_fwd_polar", "cols_wexp_inv",
                                  "cols_fft", "rows_fft"])
def test_plane_calls_equal_a_stack_of_one(cuda, name):
    """An (H, W) call runs the kernel with one plane: it equals the (1, H,
    W) stack's, bit for bit, and counts one launch."""
    from slmsuite_torch.ops import cuda_fft

    batched, single, _ = _batched_calls(_stack_inputs((1, 256, 512), cuda))[name]
    cuda_fft.reset_launch_counts()
    plane = single(0)
    assert cuda_fft.LAUNCHES[name] == 1
    for p, s in zip(plane, batched()):
        assert p.shape == (256, 512) and torch.equal(p, s[0])


@pytest.mark.cuda
def test_batched_wrappers_refuse_mismatched_stacks(cuda):
    """A stack takes one shape for all its planes and one (H, W) amplitude;
    the wrappers that take no stack refuse one."""
    from slmsuite_torch.ops import cuda_fft

    stack = torch.zeros((3, 64, 64), device=cuda)
    with pytest.raises(ValueError, match="Shape mismatch"):
        cuda_fft.cols_fft(stack, stack[:2], inverse=False)
    with pytest.raises(ValueError, match="does not match"):
        cuda_fft.carry_entry(stack, torch.ones((64, 128), device=cuda))
    with pytest.raises(ValueError, match="Shape mismatch"):
        cuda_fft.carry_entry(stack, torch.ones((3, 64, 64), device=cuda))
    with pytest.raises(ValueError, match="Shape mismatch"):
        cuda_fft.carry_exit(stack, stack)
    with pytest.raises(ValueError, match="Shape mismatch"):
        cuda_fft.rows_normfwd(stack, stack, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("mraf", [False, True])
def test_batched_multiplane_runs_one_launch_an_iteration(cuda, mraf):
    """The batched multiplane engine at 3 planes of 128^2 launches each
    kernel of its step once an iteration for all planes, and agrees with
    its plain versions (per-plane efficiency and uniformity within 1e-3)."""
    from slmsuite_torch.models.parallel_models import multiplane_batched
    from slmsuite_torch.ops import cuda_fft, fft

    run = multiplane_batched(3, N=128, mraf=mraf, device=cuda)
    cuda_fft.reset_launch_counts()
    _, _, stats, _, _ = run(None, 6)
    torch.cuda.synchronize()
    backward = dict(cols_fft=6) if mraf else dict(cols_wexp_inv=6)
    assert {k: v for k, v in cuda_fft.LAUNCHES.items() if v} == dict(
        carry_entry=6, cols_fwd_polar=6, rows_fft=6, **backward)
    names = ("fft2_polar_from_phase", "wexp_ifft2", "ifft2")
    saved = {n: getattr(fft, n) for n in names}
    try:
        for n in names:
            setattr(fft, n, getattr(fft, "_" + n))
        _, _, plain, _, _ = run(None, 6)
    finally:
        for n, f in saved.items():
            setattr(fft, n, f)
    assert float((stats[:, :, :2] - plain[:, :, :2]).abs().max()) <= 1e-3


# ----------------------------------------------------------------------
# Gradient phase retrieval: the differentiable transforms on the card.
# ----------------------------------------------------------------------


def _vjp_on(fn, inputs, cotangents):
    """Outputs of ``fn(*inputs)`` and the gradients of ``<outputs,
    cotangents>`` in the inputs (each input a fresh leaf)."""
    leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
    outputs = fn(*leaves)
    grads = torch.autograd.grad(outputs, leaves, cotangents)
    return [o.detach() for o in outputs], list(grads)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64), (256, 512), (2048, 2048), (4096, 64)])
def test_fft2_function_matches_plain_autograd(cuda, shape):
    """``grad.Fft2`` on the card: the forward through ``rows_fft`` and
    ``cols_fft``, the backward through ``cols_fft`` and ``rows_fft`` (one
    launch each way), against autograd through ``torch.fft`` on the card,
    within 1e-4 of the largest value."""
    from slmsuite_torch.ops import cuda_fft, fft
    from slmsuite_torch.ops import grad as G

    x, g = _pair(shape, cuda, seed=3), _pair(shape, cuda, seed=4)
    cuda_fft.reset_launch_counts()
    out, grads = _vjp_on(G.Fft2.apply, x, g)
    torch.cuda.synchronize()
    assert {k: v for k, v in cuda_fft.LAUNCHES.items() if v} == dict(rows_fft=2, cols_fft=2)
    ref_out, ref_grads = _vjp_on(fft._fft2, x, g)
    for got, ref in zip(out + grads, ref_out + ref_grads):
        assert _rel(got, ref) <= CARRY_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("D, N", [(3, 10), (3, 300), (16, 10), (16, 300)])
def test_compressed_overlap_function_matches_plain_autograd(cuda, D, N):
    """``grad.CompressedOverlap`` on the card: ``n2f`` unnormalized
    forward and ``f2n`` backward (one launch each), against autograd
    through the plain overlap on the card, within 1e-4 of the largest
    value."""
    from slmsuite_torch.ops import compressed as C
    from slmsuite_torch.ops import cuda_compressed as K
    from slmsuite_torch.ops import grad as G

    x = _cmp_inputs(D, 65536, N, cuda, seed=5)
    coeffs, basis = x["coeffs"], x["basis"]
    K.reset_launch_counts()
    out, grads = _vjp_on(lambda a, b: G.CompressedOverlap.apply(a, b, coeffs, basis),
                         (x["nfr"], x["nfi"]), (x["ffr"], x["ffi"]))
    torch.cuda.synchronize()
    assert {k: v for k, v in K.LAUNCHES.items() if v} == dict(n2f=1, f2n=1)
    ref_out, ref_grads = _vjp_on(lambda a, b: C._nearfield_to_farfield_raw(a, b, coeffs, basis),
                                 (x["nfr"], x["nfi"]), (x["ffr"], x["ffi"]))
    for got, ref in zip(out + grads, ref_out + ref_grads):
        assert _rel(got, ref) <= CMP_RTOL


@pytest.mark.cuda
def test_cg_runs_through_kernels_and_matches_the_cpu(cuda):
    """``Hologram`` CG on a 128^2 canvas holding a 64^2 SLM with a
    propagation kernel: two launches each of ``rows_fft`` and ``cols_fft``
    an iteration (forward and backward) and one each at the end; the loss
    at every iteration within 1e-4 relative of the same run on the CPU."""
    from slmsuite_torch.holography.algorithms import Hologram
    from slmsuite_torch.ops import cuda_fft

    rng = np.random.default_rng(6)
    target = np.zeros((128, 128), np.float32)
    target[rng.integers(16, 112, 12), rng.integers(16, 112, 12)] = 1.0
    kernel = rng.uniform(-1, 1, (64, 64)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (64, 64))
    losses = {}
    for device in (cuda, torch.device("cpu")):
        holo = Hologram(target, slm_shape=(64, 64), propagation_kernel=kernel, device=device)
        holo.reset_phase(phase)
        losses[device.type] = []
        cuda_fft.reset_launch_counts()
        holo.optimize("CG", maxiter=10, verbose=False,
                      callback=lambda h, out=losses[device.type]: out.append(
                          h.flags["loss_result"]) and False)
        if device.type == "cuda":
            assert {k: v for k, v in cuda_fft.LAUNCHES.items() if v} == dict(
                rows_fft=21, cols_fft=21)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.cuda
def test_cg_runs_cuda_shapes_outside_the_gate_on_the_plain_tier(cuda):
    """CG on a CUDA plane whose sides the kernels do not take runs the
    plain tier on the card, with no launch, and gives the CPU's losses."""
    from slmsuite_torch.holography.algorithms import Hologram
    from slmsuite_torch.ops import cuda_fft, fft

    losses = {}
    for device in (cuda, torch.device("cpu")):
        np.random.seed(5)
        holo = Hologram(np.ones((100, 128), np.float32), device=device)
        cuda_fft.reset_launch_counts()
        fft.reset_plain_count()
        holo.optimize("CG", maxiter=2, verbose=False)
        losses[device.type] = holo.flags["loss_result"]
        if device.type == "cuda":
            assert sum(cuda_fft.LAUNCHES.values()) == 0
            assert fft.PLAIN_ON_DEVICE > 0
    fft.reset_plain_count()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


# ----------------------------------------------------------------------
# The rig's calibrations on the card: the superpixel wavefront calibration
# (W1's pieces at 256^2), OpenCV's operations in torch, and the pin of the
# device measurement to the correction the calibration writes.
# ----------------------------------------------------------------------


def _superpixel_rig(device):
    """tests/hardware/test_cameraslm.py's 256^2 superpixel rig, calibrated
    analytically, with focus and astigmatism in the simulated source."""
    from slmsuite_torch.holography.toolbox.phase import zernike_sum
    from slmsuite_torch.models.engine_models import camera_loop_rig

    fs = camera_loop_rig(slm_side=256, cam_side=256,
                         M=np.array([[4.0e3, 100.0], [-100.0, 4.0e3]]), device=device)
    fs.fourier_calibrate_analytic(fs.cam.M, fs.cam.b)
    fs.slm.source["phase_sim"] = np.asarray(zernike_sum(fs.slm, (4, 3), (1.5, -1.0)),
                                            np.float32)
    return fs


@pytest.mark.cuda
@pytest.mark.parametrize("phase_steps", [8, 1])
def test_superpixel_calibration_runs_through_kernels_and_matches_the_cpu(cuda, phase_steps):
    """The superpixel calibration (32-pixel superpixels) on the card: one
    rows_fft and one cols_fft a camera frame; its raw data and processed
    correction against the same run on the CPU (the camera quantizes, so
    power within 1e-3 of its largest, the processed phase within 0.02 rad
    RMS weighted by the amplitude modulo a constant, the amplitude within
    1e-3); the corrected peak above 1.1 times the uncorrected one."""
    import warnings

    from slmsuite_torch.ops import cuda_fft

    runs = {}
    for device in (cuda, torch.device("cpu")):
        fs = _superpixel_rig(device)
        frames = [0]
        hw = fs.cam._get_image_hw

        def counted(*args, hw=hw, frames=frames, **kwargs):
            frames[0] += 1
            return hw(*args, **kwargs)

        fs.cam._get_image_hw = counted
        cuda_fft.reset_launch_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            raw = fs.wavefront_calibrate(calibration_points=np.array([[160.0], [110.0]]),
                                         superpixel_size=32, phase_steps=phase_steps, plot=-1)
            processed = fs.wavefront_calibration_superpixel_process(apply=True, smooth=2)
        torch.cuda.synchronize()
        runs[device.type] = (fs, raw, processed, dict(cuda_fft.LAUNCHES), frames[0])
    fs, raw, processed, launches, frames = runs["cuda"]
    assert launches["rows_fft"] == launches["cols_fft"] == frames > 0
    _, raw_cpu, processed_cpu, launches_cpu, _ = runs["cpu"]
    assert launches_cpu["rows_fft"] == 0
    for key in ("power", "normalization"):
        scale = np.nanmax(np.abs(raw_cpu[key]))
        assert np.nanmax(np.abs(raw[key] - raw_cpu[key])) <= 1e-3 * scale, key
    d = np.angle(np.exp(1j * (processed["phase"] - processed_cpu["phase"])))
    weight = processed_cpu["amplitude"]
    piston = np.angle(np.sum(weight * np.exp(1j * d)))
    rms = np.sqrt(np.sum(weight * np.angle(np.exp(1j * (d - piston))) ** 2) / weight.sum())
    assert rms <= 0.02, rms
    assert np.abs(processed["amplitude"] - processed_cpu["amplitude"]).max() <= 1e-3

    def peak():
        fs.slm.set_phase(None, settle=False)
        return float(fs.cam.get_image().astype(float).max())

    while peak() >= 0.9 * fs.cam.bitresolution:
        fs.cam.set_exposure(fs.cam.get_exposure() / 2)
    after = peak()
    correction = fs.slm.source.pop("phase")
    before = peak()
    fs.slm.source["phase"] = correction
    assert after > 1.1 * before, (after, before)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 9, 17, 129, 257])
def test_gaussian_blur_on_the_card_matches_the_cpu(cuda, k):
    from slmsuite_torch.holography.analysis import _cv

    image = torch.from_numpy(np.random.default_rng(k).uniform(0, 1, (300, 1024)))
    got = _cv.gaussian_blur(image.to(cuda), k).cpu()
    assert float((got - _cv.gaussian_blur(image, k)).abs().max()) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("interpolation", ["nearest", "cubic"])
@pytest.mark.parametrize("factor", [32, 64])
def test_resize_on_the_card_matches_the_cpu(cuda, interpolation, factor):
    from slmsuite_torch.holography.analysis import _cv

    small = torch.from_numpy(np.random.default_rng(factor).uniform(-1, 2, (16, 16)))
    size = (16 * factor, 16 * factor)
    got = _cv.resize(small.to(cuda), size, interpolation).cpu()
    assert float((got - _cv.resize(small, size, interpolation)).abs().max()) <= 1e-12


@pytest.mark.cuda
def test_device_measurement_follows_the_calibration_on_the_card(cuda):
    """Item 8's pin on the card: a spot hologram optimized with camera
    feedback on the device measurement path, then the superpixel
    calibration's correction applied and the hologram optimized again:
    its device constants are rebuilt, and each time the device measurement
    (one rows_fft, one cols_fft) equals set_phase -> get_image -> take
    within one count per window pixel."""
    import warnings

    from slmsuite_torch.holography import analysis
    from slmsuite_torch.holography.algorithms import SpotHologram
    from slmsuite_torch.ops import cuda_fft

    fs = _superpixel_rig(cuda)
    state = np.random.get_state()
    np.random.seed(4)
    holo = SpotHologram((512, 512), np.array([[150.0, 110.0, 130.0], [150.0, 150.0, 100.0]]),
                        basis="ij", cameraslm=fs, device=cuda)
    np.random.set_state(state)

    def check():
        holo._midloop_cleaning()
        cuda_fft.reset_launch_counts()
        fast, _ = holo._sim_spot_powers()
        assert cuda_fft.LAUNCHES["rows_fft"] == 1 and cuda_fft.LAUNCHES["cols_fft"] == 1
        holo.measure("ij")
        host = analysis.take(np.square(np.asarray(holo.img_ij, np.float64)), holo.spot_ij,
                             holo.spot_integration_width_ij, centered=True, integrate=True)
        assert host.min() > 0
        assert np.abs(fast - host).max() <= holo.spot_integration_width_ij ** 2

    fs.cam.set_exposure(30.0)
    holo.optimize("WGS-Kim", feedback="experimental_spot", maxiter=3, verbose=False)
    consts = holo._sim_engine_inputs()[0]
    check()
    fs.cam.set_exposure(1.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fs.wavefront_calibrate(calibration_points=np.array([[160.0], [110.0]]),
                               superpixel_size=64, phase_steps=8, plot=-1)
        fs.wavefront_calibration_superpixel_process(apply=True, smooth=2)
    fs.cam.set_exposure(30.0)
    holo.optimize("WGS-Kim", feedback="experimental_spot", maxiter=3, verbose=False)
    assert holo._sim_engine_inputs()[0] is not consts
    check()


# ----------------------------------------------------------------------
# The mesh engines on [cuda:0] * 4 (one card holding four shards).
# ----------------------------------------------------------------------

MESH_D = 4


def _mesh(cuda, axis):
    from slmsuite_torch.parallel.mesh import make_mesh

    return make_mesh(axis_names=(axis,), devices=[cuda] * MESH_D)


def _wrapped_max(a, b):
    d = np.asarray(a, float) - np.asarray(b, float)
    return float(np.abs(np.mod(d + np.pi, 2 * np.pi) - np.pi).max())


def _launched():
    from slmsuite_torch.ops import cuda_compressed, cuda_fft

    return {k: v for m in (cuda_fft, cuda_compressed) for k, v in m.LAUNCHES.items() if v}


def _reset_launches():
    from slmsuite_torch.ops import cuda_compressed, cuda_fft

    cuda_fft.reset_launch_counts()
    cuda_compressed.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 512), (2048, 2048), (8192, 8192)])
def test_mesh_distributed_fft2_kernels(cuda, shape):
    """The distributed 2D FFT on four shards of one card: ``rows_fft`` twice
    a shard, and the plain dense transform's result."""
    from slmsuite_torch.parallel.fft2d import distributed_fft2, distributed_ifft2

    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.complex(torch.randn(shape, device=cuda, generator=gen),
                      torch.randn(shape, device=cuda, generator=gen))
    mesh = _mesh(cuda, "space")
    _reset_launches()
    y = distributed_fft2(x, mesh)
    assert _launched() == {"rows_fft": 2 * MESH_D}
    ref = torch.fft.fft2(x, norm="ortho")
    assert float((y - ref).abs().max() / ref.abs().max()) <= CARRY_RTOL
    back = distributed_ifft2(y, mesh)
    assert float((back - x).abs().max() / x.abs().max()) <= CARRY_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["WGS-Kim", "WGS-Nogrette"])
def test_mesh_plane_hologram_kernels(cuda, method):
    """A 512^2 plane, rows over four shards, against the meshless run; per
    shard and iteration ``carry_entry``, ``rows_fft`` twice, ``carry_exit``,
    and nothing else in the loop."""
    from slmsuite_torch.holography.algorithms import Hologram

    rng = np.random.default_rng(9)
    target = np.zeros((512, 512), np.float32)
    ys, xs = np.mgrid[160:352:32, 128:384:32]
    target[ys.ravel(), xs.ravel()] = 1.0
    phi0 = rng.uniform(-np.pi, np.pi, (512, 512)).astype(np.float32)
    runs = []
    for mesh in (_mesh(cuda, "rows"), None):
        holo = Hologram(target.copy(), device=cuda)
        holo.reset_phase(custom_phase=phi0)
        _reset_launches()
        holo.optimize(method, maxiter=10, verbose=False, mesh=mesh, fix_phase_iteration=4,
                      stat_groups=["computational"])
        runs.append((holo, _launched()))
    (port, launches), (single, _) = runs
    # The loop's, and one rows_fft and cols_fft for the final farfield
    # (_populate_results on the gathered phase).
    assert launches == {"carry_entry": 10 * MESH_D, "rows_fft": 20 * MESH_D + 1,
                        "carry_exit": 10 * MESH_D, "cols_fft": 1}
    assert _wrapped_max(port.phase, single.phase) < 5e-4
    eff = [np.asarray(h.stats["stats"]["computational"]["efficiency"]) for h in (port, single)]
    np.testing.assert_allclose(eff[0], eff[1], atol=1e-4)


@pytest.mark.cuda
def test_mesh_multiplane_kernels(cuda):
    """8 planes of 256^2 over a data axis of four on one card: each shard
    one launch of each stack kernel an iteration; the meshless run's
    result."""
    from slmsuite_torch.models.parallel_models import multiplane_batched

    for mraf, backward in ((False, "cols_wexp_inv"), (True, "cols_fft")):
        run = multiplane_batched(8, N=256, method="WGS-Leonardo" if mraf else "WGS-Kim",
                                 mraf=mraf, device=cuda)
        _reset_launches()
        got = run(_mesh(cuda, "data"), 6)
        assert _launched() == {"carry_entry": 6 * MESH_D, "cols_fwd_polar": 6 * MESH_D,
                               backward: 6 * MESH_D, "rows_fft": 6 * MESH_D}
        ref = run(None, 6)
        assert _wrapped_max(got[0].cpu(), ref[0].cpu()) < 5e-4
        torch.testing.assert_close(got[2], ref[2], atol=1e-3, rtol=0)
        np.testing.assert_allclose(got[2][..., 0].cpu(), ref[2][..., 0].cpu(), atol=1e-4)


@pytest.mark.cuda
def test_mesh_compressed_kernels(cuda):
    """Config 5's plane (1024^2) and 256 spots with pixels over four shards:
    ``n2f`` at entry, ``fused_iter`` an iteration and ``f2n`` at exit on
    each shard; the one-shard run's result."""
    from slmsuite_torch.models.parallel_models import compressed_spots_3d
    from slmsuite_torch.parallel.mesh import make_mesh

    _reset_launches()
    state, stats = compressed_spots_3d(1024 * 1024, 256, device=cuda)(_mesh(cuda, "pixels"), 8)
    assert _launched() == {"n2f": MESH_D, "fused_iter": 8 * MESH_D, "f2n": MESH_D}
    ref, ref_stats = compressed_spots_3d(1024 * 1024, 256, device=cuda)(
        make_mesh(axis_names=("pixels",), devices=[cuda]), 8)
    assert _wrapped_max(state.psi.cpu(), ref.psi.cpu()) < 1e-3
    torch.testing.assert_close(state.weights, ref.weights, atol=1e-5, rtol=0)
    torch.testing.assert_close(stats[:, 0, 1], ref_stats[:, 0, 1], atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_mesh_batch_and_dryrun(cuda):
    """``optimize_batch`` of four frames over four shards equals the
    meshless batch bit for bit; ``dryrun_multichip(4)`` on ``[cuda:0] * 4``."""
    from slmsuite_torch.holography.algorithms import Hologram, optimize_batch
    from slmsuite_torch.models.parallel_models import dryrun_multichip

    phase0 = np.random.default_rng(1).uniform(-np.pi, np.pi, (256, 256)).astype(np.float32)
    batches = []
    for mesh in (_mesh(cuda, "data"), None):
        frames = []
        for t in range(MESH_D):
            target = np.zeros((256, 256), np.float32)
            target[64 + 16 * t, 96:160:16] = 1.0
            h = Hologram(target, device=cuda)
            h.reset_phase(phase0)
            frames.append(h)
        optimize_batch(frames, "WGS-Kim", maxiter=5, verbose=False, mesh=mesh)
        batches.append(frames)
    for a, b in zip(*batches):
        assert np.array_equal(a.phase, b.phase)
    errors = dryrun_multichip(MESH_D, devices=[cuda] * MESH_D)
    assert len(errors) == 7


@pytest.mark.cuda
def test_mesh_refuses_shards_the_kernels_do_not_take(cuda):
    """A row shard of 4 rows (64 rows over 16 shards), or rows of 100
    points, take the plain tier on the card: no launch, the plain FFT's
    result, and a PLAIN_ON_DEVICE count."""
    from slmsuite_torch.ops import fft
    from slmsuite_torch.parallel.fft2d import distributed_fft2
    from slmsuite_torch.parallel.mesh import make_mesh

    for shape, shards in (((64, 64), 16), ((64, 100), 4)):
        mesh = make_mesh(axis_names=("space",), devices=[cuda] * shards)
        _reset_launches()
        fft.reset_plain_count()
        x = torch.randn(shape, dtype=torch.complex64, device=cuda)
        got = distributed_fft2(x, mesh)
        assert _launched() == {} and fft.PLAIN_ON_DEVICE > 0
        torch.testing.assert_close(got, torch.fft.fft2(x, norm="ortho"), atol=1e-4, rtol=1e-4)
    fft.reset_plain_count()
