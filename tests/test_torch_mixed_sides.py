"""
Holograms on planes whose sides are not powers of two, on the port against
the JAX package, on the CPU: the sides the CUDA kernels take as mixed lines
(multiples of 8 that are not powers of two; ``csrc/fft_shared.cuh``), at
96x128 (96 = 32 * 3) and at 72x120 (a small SLM at ``padding_order=0``:
72 = 8 * 9, 120 = 8 * 15). The JAX package runs its jnp / einsum tier
there on the CPU; nothing in it changes.

Each case runs the port's WGS-Kim ``SpotHologram`` (the fused carry loop),
WGS-Nogrette with spot feedback (the natural step) and an MRAF ring image
(the carry-mode MRAF step, with and without zero weights) from one seeded
phase in both packages, and holds the phase, the weights and the stats to
the tolerances of ``tests/test_torch_natural.py`` and
``tests/test_torch_mraf.py`` (the MRAF phase at its 99th percentile). The same runs through ``cuda_fft``'s kernel
sequences, each kernel wrapper replaced by a counting plain version, give
the plain run's result with the launches the card would make.
"""

import numpy as np
import pytest
import torch

import slmsuite_torch
from slmsuite_torch.holography import algorithms as T
from slmsuite_torch.ops import cuda_fft
from slmsuite_torch.ops import fft as TF
from slmsuite_tpu.holography import algorithms as J


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    slmsuite_torch.set_default_device("cpu")
    yield
    slmsuite_torch.set_default_device("cuda")
    torch.set_num_threads(threads)


#: The tolerances of tests/test_torch_natural.py and tests/test_torch_mraf.py.
ITERS = 10
PHASE_ATOL = 5e-4
WEIGHT_ATOL = 1e-5
STATS_ATOL, STATS_RTOL = 1e-4, 1e-3

SHAPES = [(96, 128), (72, 120)]


def _holo_stats(holo, group):
    record = holo.stats["stats"][group]
    return np.stack([record[k] for k in ("efficiency", "uniformity", "pkpk_err",
                                         "std_err")], axis=-1)


def _assert_stats(got, ref):
    """Stats rows at STATS_ATOL / STATS_RTOL, std_err with the f32
    cancellation bound of the JAX package's form (test_torch_natural.py)."""
    np.testing.assert_allclose(got[..., :3], ref[..., :3],
                               atol=STATS_ATOL, rtol=STATS_RTOL, equal_nan=True)
    cancel = np.sqrt(np.finfo(np.float32).eps) * np.abs(1 - ref[..., 0])
    bad = np.abs(got[..., 3] - ref[..., 3]) > STATS_ATOL + STATS_RTOL * np.abs(ref[..., 3]) + cancel
    assert not bad.any(), (got[..., 3][bad], ref[..., 3][bad])


def _phase_err(a, b):
    dp = np.asarray(a) - np.asarray(b)
    dp = np.mod(dp - dp.flat[0] + np.pi, 2 * np.pi) - np.pi
    return np.abs(dp).max()


def _phase_p99(a, b):
    dp = np.asarray(a) - np.asarray(b)
    dp = np.mod(dp - dp.flat[0] + np.pi, 2 * np.pi) - np.pi
    return np.percentile(np.abs(dp), 99)


def _ring(shape):
    """An image: a ring of radius H / 8 whose pixels have seeded random
    amplitudes in [0.5, 1] (unit power), nan (the noise region) outside
    radius H / 4, as engine_models.image_mraf_target on a rectangle. The
    random amplitudes leave the target no symmetry, whose exact nulls in
    the nearfield would leave the phase undefined there."""
    H, W = shape
    yy, xx = np.meshgrid(np.arange(H) - H / 2, np.arange(W) - W / 2, indexing="ij")
    radius = np.hypot(xx, yy)
    ring = np.abs(radius - H / 8) < 1.5
    amp = np.random.default_rng(22).uniform(0.5, 1.0, shape)
    target = np.where(ring, amp, 0.0).astype(np.float32)
    target /= np.sqrt((target**2).sum())
    target[radius > H / 4] = np.nan
    return target


#: name -> (hologram maker, optimize keywords, stat groups, the kernels'
#: launches an iteration on the card).
RUNS = {
    "wgs_kim": (lambda m, s: m.SpotHologram.make_rectangular_array(
        s, array_shape=(4, 4), array_pitch=(11, 13), basis="knm"),
        dict(method="WGS-Kim", fix_phase_iteration=4), ["computational"],
        dict(cols_wgs_roundtrip=1, rows_normfwd=1)),
    "nogrette_spot": (lambda m, s: m.SpotHologram.make_rectangular_array(
        s, array_shape=(4, 4), array_pitch=(11, 13), basis="knm"),
        dict(method="WGS-Nogrette", feedback="computational_spot"),
        ["computational", "computational_spot"],
        dict(carry_entry=1, cols_fwd_polar=1, cols_wexp_inv=1, carry_exit=1)),
    "mraf_leonardo": (lambda m, s: m.Hologram(target=_ring(s)),
                      dict(method="WGS-Leonardo", mraf_factor=0.5), ["computational"],
                      dict(cols_mraf_fwd=1, cols_mraf_mix_inv=1, rows_normfwd=1)),
    "mraf_kim_zero": (lambda m, s: m.Hologram(target=_ring(s)),
                      dict(method="WGS-Kim", fix_phase_iteration=4, mraf_factor=0.5,
                           zero_factor=0.1), ["computational"],
                      dict(cols_mraf_fwd=1, cols_mraf_mix_inv=1, rows_normfwd=1)),
}


def _run(module, shape, name, phi0):
    make, kw, groups, _ = RUNS[name]
    holo = make(module, shape)
    holo.reset_phase(custom_phase=phi0)
    holo.optimize(maxiter=ITERS, verbose=False, stat_groups=groups, **kw)
    return holo


def _phi0(shape):
    return np.random.default_rng(21).uniform(-np.pi, np.pi, shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(RUNS))
@pytest.mark.parametrize("shape", SHAPES)
def test_mixed_side_hologram_matches_jax(shape, name):
    phi0 = _phi0(shape)
    tholo, jholo = (_run(module, shape, name, phi0) for module in (T, J))
    for group in RUNS[name][2]:
        _assert_stats(_holo_stats(tholo, group), _holo_stats(jholo, group))
    assert tholo.get_phase().shape == shape
    if name.startswith("mraf"):
        # The noise region's free amplitude leaves a few nearfield points
        # near a null, where the two packages' FFTs (another algorithm, f32)
        # give phases up to 9e-4 apart (measured, one point of 8640; the
        # 99th percentile is 9e-6): held at the 99th percentile (PSI_P99 of
        # tests/test_torch_natural.py, at PHASE_ATOL).
        assert _phase_p99(tholo.get_phase(), jholo.get_phase()) < PHASE_ATOL
    else:
        assert _phase_err(tholo.get_phase(), jholo.get_phase()) < PHASE_ATOL
    np.testing.assert_allclose(np.asarray(tholo.weights), np.asarray(jholo.weights),
                               atol=WEIGHT_ATOL)


@pytest.fixture
def counting_plain_kernels(monkeypatch):
    """Every ``cuda_fft`` kernel wrapper replaced by its plain version,
    counting its launches as the wrapper does, and the dispatchers' gate
    open for CPU tensors: the kernels' sequences on the CPU."""
    plain = {
        "carry_entry": TF._wgs_carry_entry, "carry_exit": TF._wgs_carry_exit,
        "rows_fft": TF._rows_fft, "cols_fft": TF._cols_fft,
        "cols_fwd_polar": TF._cols_fwd_polar, "cols_wexp_inv": TF._cols_wexp_inv,
        "rows_normfwd": TF._rows_normfwd, "cols_wgs_roundtrip": TF._cols_wgs_roundtrip,
        "cols_mraf_fwd": TF._cols_mraf_fwd, "cols_mraf_mix_inv": TF._cols_mraf_mix_inv,
        "cols_wgs_fwd": TF._cols_wgs_fwd,
    }
    assert sorted(plain) == sorted(cuda_fft.LINE_KERNELS)

    def counted(name, fn):
        def call(*args, **kwargs):
            cuda_fft.LAUNCHES[name] += 1
            return fn(*args, **kwargs)
        return call

    for name, fn in plain.items():
        monkeypatch.setattr(cuda_fft, name, counted(name, fn))
    for gate in ("use_kernels", "use_row_kernels"):
        monkeypatch.setattr(TF, gate, lambda x: True)


@pytest.mark.parametrize("name", sorted(RUNS))
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_sequences_at_mixed_sides_match_plain(shape, name, counting_plain_kernels):
    """The run through the kernels' sequences (each kernel its plain
    version) equals the plain run, and launches each loop kernel once an
    iteration: the dispatchers route a mixed-side plane as any other."""
    phi0 = _phi0(shape)
    cuda_fft.reset_launch_counts()
    seq = _run(T, shape, name, phi0)
    launched = dict(cuda_fft.LAUNCHES)
    with pytest.MonkeyPatch.context() as mp:
        for gate in ("use_kernels", "use_row_kernels"):
            mp.setattr(TF, gate, lambda x: False)
        plain = _run(T, shape, name, phi0)
    for kernel, per_iteration in RUNS[name][3].items():
        assert launched[kernel] == ITERS * per_iteration, (kernel, launched)
    for group in RUNS[name][2]:
        np.testing.assert_allclose(_holo_stats(seq, group), _holo_stats(plain, group),
                                   atol=STATS_ATOL, rtol=STATS_RTOL)
    assert _phase_err(seq.get_phase(), plain.get_phase()) < PHASE_ATOL
