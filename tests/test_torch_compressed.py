"""
The compressed slice of the port on the CPU, held against ``slmsuite_tpu``
on the same seeded numpy inputs:

- the toolbox copies (``convert_vector`` for every SLM unit in 2D and 3D,
  ``zernike_sum``, ``zernike_aperture``, ``_zernike_indices_parse``): atol
  1e-12, as both run the same float64 numpy;
- ``SimulatedSLM`` (geometry, source radius, ``display``) and the
  ``build_zernike_basis`` stack: exact, or atol 1e-12 for float64 values;
- the plain transforms, the cos/sin cache, the cached twins and the fused
  round trips against the jnp twins and, where the JAX package has a
  Pallas kernel, against it in interpret mode: max |diff| over max |JAX|
  within 1e-5 (the cache and the transforms: both sides run f32 matrix
  products and sincos; Pallas synthesizes its sincos with a minimax
  polynomial, so 1e-4 there);
- the kernels' period-reduced sincos, through its PyTorch model
  (``cuda_compressed.sincos_reduced_model``, the constants read from
  ``csrc/compressed.cu``), against float64 sin/cos of the same f32 phases
  within 6e-7 and against the TPU kernel's ``_sincos_reduced`` within
  1.2e-6 (see ``SINCOS_ATOL``);
- ``run_compressed_gs`` against the JAX engine, and ``CompressedSpotHologram``
  on a 64^2 ``SimulatedSLM``: weights, amp_ff and stats within 1e-4,
  ``phase_ff`` within 1e-3 rad (modulo 2 pi), the exit phase within 1e-3
  rad at its 99th percentile (the angle of a near-zero nearfield pixel is
  ill-conditioned), flags and iteration counts exact.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import slmsuite_torch
from slmsuite_torch import convert
from slmsuite_torch.hardware.slms.simulated import SimulatedSLM as TSLM
from slmsuite_torch.holography import algorithms as T
from slmsuite_torch.holography import toolbox as TT
from slmsuite_torch.holography.toolbox import phase as TP
from slmsuite_torch.ops import compressed as TC
from slmsuite_torch.ops import cuda_compressed as TK
from slmsuite_torch.parallel.mesh import make_mesh
from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM as JSLM
from slmsuite_tpu.holography import algorithms as J
from slmsuite_tpu.holography import toolbox as JT
from slmsuite_tpu.holography.toolbox import phase as JP
from slmsuite_tpu.ops import compressed as JC
from slmsuite_tpu.ops import pallas_compressed as JPC
from slmsuite_tpu.ops.pallas_fft import _sincos_reduced

#: SLM units of convert_vector (the camera units need a CameraSLM).
SLM_UNITS = ["norm", "kxy", "rad", "mrad", "deg", "knm", "freq", "lpmm", "zernike"]
TOOLBOX_ATOL = 1e-12
JNP_RTOL = 1e-5
PALLAS_RTOL = 1e-4
STATE_ATOL = 1e-4
PHASE_ATOL = 1e-3
#: The kernels' period-reduced sincos against float64 sin/cos of the same
#: f32 phases: the reduced argument is rounded twice (1.2e-7 each), the rare
#: fold adds 2 pi's f32 error (1.7e-7) and torch's f32 sin its own (0.6e-7),
#: 5.4e-7 in all; the largest seen on a million phases up to 1e5 is 4.1e-7.
SINCOS_ATOL = 6e-7
#: The same against the TPU kernel's _sincos_reduced, compiled as its kernel
#: compiles it (a two-term split and a minimax pair, up to 4e-7 off float64
#: there; uncompiled, without fused products, 1.2e-6): the two errors add.
SINCOS_TPU_ATOL = 1.2e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    slmsuite_torch.set_default_device("cpu")
    yield
    slmsuite_torch.set_default_device("cuda")
    torch.set_num_threads(threads)


def _slms(resolution=(64, 64), **kwargs):
    kwargs = dict(dict(pitch_um=(8, 8), wav_um=0.78), **kwargs)
    return TSLM(resolution, **kwargs), JSLM(resolution, **kwargs)


def _wrapped(a, b):
    d = np.asarray(a, float) - np.asarray(b, float)
    return np.abs(np.mod(d + np.pi, 2 * np.pi) - np.pi)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


@contextlib.contextmanager
def _numpy_global_state_kept():
    """Numpy's global generator left as it was (a hologram draws its initial
    phase from it): tests of other files that run after these in a worker
    draw from it unseeded."""
    state = np.random.get_state()
    try:
        yield
    finally:
        np.random.set_state(state)


# ----------------------------------------------------------------------
# Toolbox copies.
# ----------------------------------------------------------------------


@pytest.mark.parametrize("from_units", SLM_UNITS)
@pytest.mark.parametrize("dim", [2, 3])
def test_convert_vector_matches_jax(from_units, dim):
    """Every SLM unit to every other, 2D and 3D (focal power), on a
    1024x768 SLM and at an explicit ``knm`` shape."""
    tslm, jslm = _slms((1024, 768), pitch_um=(8, 9.2))
    rng = np.random.default_rng(1)
    vectors = rng.uniform(-0.01, 0.01, (dim, 5))
    if from_units == "knm":
        vectors[:2] = rng.uniform(0, 700, (2, 5))
    for to_units in SLM_UNITS:
        for shape in (None, (512, 640)):
            got = TT.convert_vector(vectors, from_units, to_units, hardware=tslm, shape=shape)
            want = JT.convert_vector(vectors, from_units, to_units, hardware=jslm, shape=shape)
            assert got.shape == want.shape == (dim, 5)
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=TOOLBOX_ATOL,
                                       err_msg=f"{from_units} -> {to_units} {shape}")


def test_convert_vector_camera_units_warn_nan():
    """Camera units without a Fourier-calibrated CameraSLM warn and give
    nan, as in the JAX package; a bad unit raises."""
    tslm, jslm = _slms()
    for mod, slm in ((TT, tslm), (JT, jslm)):
        with pytest.warns(UserWarning, match="Fourier-calibrated"):
            out = mod.convert_vector([[0.01], [0.0]], "kxy", "ij", hardware=slm)
        assert out.shape == (2, 1) and np.isnan(out).all()
        with pytest.raises(ValueError, match="not in"):
            mod.convert_vector([[0.01], [0.0]], "kxy", "furlong", hardware=slm)
    assert TT.BLAZE_UNITS == JT.BLAZE_UNITS and TT.CAMERA_UNITS == JT.CAMERA_UNITS


@pytest.mark.parametrize("vectors", [
    [1.0, 2.0], [[1.0, 2.0, 3.0]], np.arange(12.0).reshape(3, 4), (np.arange(3.0), np.ones(3)),
])
@pytest.mark.parametrize("handle", ["pass", "crop"])
def test_format_vectors_and_smallest_distance_match_jax(vectors, handle):
    got = TT.format_vectors(vectors, handle_dimension=handle)
    np.testing.assert_array_equal(got, JT.format_vectors(vectors, handle_dimension=handle))
    assert TT.smallest_distance(got) == JT.smallest_distance(got)


def test_smallest_distance_large_and_callable():
    points = np.random.default_rng(2).uniform(0, 100, (2, 450))
    for metric in ("chebyshev", "euclidean"):
        assert TT.smallest_distance(points, metric) == JT.smallest_distance(points, metric)
    metric = lambda a, b: float(np.abs(a - b).sum())  # noqa: E731
    assert TT.smallest_distance(points[:, :30], metric) == JT.smallest_distance(
        points[:, :30], metric)


@pytest.mark.parametrize("indices, D, smaller", [
    (None, 2, False), (None, 3, False), (None, 4, False), (None, 7, False), (5, None, False),
    (6, 4, True), ([2, 1, 4, 3], 4, False), ([2, 1, 4, 3, 12], 3, True),
])
def test_zernike_indices_parse_matches_jax(indices, D, smaller):
    np.testing.assert_array_equal(
        TP._zernike_indices_parse(indices, D, smaller),
        JP._zernike_indices_parse(indices, D, smaller),
    )


def test_zernike_indices_parse_errors_match_jax():
    for mod in (TP, JP):
        with pytest.raises(ValueError):
            mod._zernike_indices_parse(None, None)
        with pytest.raises(ValueError):
            mod._zernike_indices_parse([2, 1, 4], 2)


@pytest.mark.parametrize("aperture", [None, "cropped", "circular", "elliptical", 0.01,
                                      (0.01, 0.02)])
def test_zernike_aperture_matches_jax(aperture):
    tslm, jslm = _slms((48, 50))
    got = TP.zernike_aperture(tslm, aperture)
    want = JP.zernike_aperture(jslm, aperture)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    grid = [g * 0.5 for g in jslm.grid]
    np.testing.assert_allclose(TP.zernike_aperture(grid, aperture),
                               JP.zernike_aperture(grid, aperture), rtol=1e-12)


@pytest.mark.parametrize("indices", [[2, 1], [2, 1, 4], [2, 1, 4, 3], [0, 5, 7, 12, 20],
                                     [2, 1, -1], None])
@pytest.mark.parametrize("aperture, use_mask", [(None, True), ("circular", False),
                                                ("elliptical", np.nan), (1, False)])
def test_zernike_sum_matches_jax(indices, aperture, use_mask):
    """Sums of Zernike polynomials (one and a stack of three) on an SLM's
    grid, masked, unmasked and nan-masked, with the vortex term."""
    tslm, jslm = _slms((48, 50))
    D = 3 if indices is None else len(indices)
    weights = np.random.default_rng(3).normal(size=(D, 3))
    for w in (weights[:, 0], weights):
        got = TP.zernike_sum(tslm, indices, w, aperture=aperture, use_mask=use_mask)
        want = JP.zernike_sum(jslm, indices, w, aperture=aperture, use_mask=use_mask)
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=TOOLBOX_ATOL, equal_nan=True)
    mask_t = TP.zernike_sum(tslm, indices, weights[:, 0], use_mask="return")
    np.testing.assert_array_equal(mask_t, JP.zernike_sum(jslm, indices, weights[:, 0],
                                                         use_mask="return"))


# ----------------------------------------------------------------------
# SimulatedSLM and the basis stack.
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    dict(resolution=(64, 64)), dict(resolution=(50, 48), pitch_um=(8, 9.2), wav_um=0.78),
    dict(resolution=(40, 32), bitdepth=10, wav_um=0.633, wav_design_um=0.7),
    dict(resolution=(40, 32), wav_um=0.8, wav_design_um=0.6),
])
def test_simulated_slm_matches_jax(kwargs):
    """Geometry, the unmeasured source's fit, its Zernike scaling, spot
    radius and source amplitude, and the display after set_phase (float
    phase, None and integer data; both phase_scaling branches)."""
    resolution = kwargs.pop("resolution")
    tslm, jslm = TSLM(resolution, **kwargs), JSLM(resolution, **kwargs)
    assert tslm.shape == jslm.shape and tslm.bitresolution == jslm.bitresolution
    for attr in ("pitch_um", "pitch", "wav_um", "wav_design_um", "phase_scaling"):
        np.testing.assert_array_equal(getattr(tslm, attr), getattr(jslm, attr), err_msg=attr)
    for a, b in zip(tslm.grid, jslm.grid):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tslm.display, jslm.display)
    assert tslm.get_source_zernike_scaling() == jslm.get_source_zernike_scaling()
    assert tslm.get_spot_radius_kxy() == jslm.get_spot_radius_kxy()
    for key in ("amplitude_center_pix", "amplitude_radius", "amplitude_extent",
                "amplitude_extent_radius", "amplitude_sim", "phase_sim"):
        np.testing.assert_array_equal(tslm.source[key], jslm.source[key], err_msg=key)
    np.testing.assert_array_equal(tslm._get_source_amplitude(), jslm._get_source_amplitude())
    phase = np.random.default_rng(4).uniform(-3 * np.pi, 3 * np.pi, tslm.shape)
    np.testing.assert_array_equal(tslm.set_phase(phase), jslm.set_phase(phase))
    np.testing.assert_allclose(tslm.phase, jslm.phase, atol=TOOLBOX_ATOL)
    np.testing.assert_array_equal(tslm.set_phase(None), jslm.set_phase(None))
    data = (np.arange(np.prod(tslm.shape)) % tslm.bitresolution).astype(tslm.dtype)
    np.testing.assert_array_equal(tslm.set_phase(data.reshape(tslm.shape)),
                                  jslm.set_phase(data.reshape(jslm.shape)))
    np.testing.assert_allclose(tslm.phase, jslm.phase, atol=TOOLBOX_ATOL)


def test_compressed_consts_keep_their_scalars_on_the_device():
    """The engine's scalar constants (and CG's target) are uploaded once and
    kept while their values hold, so a call of the loop moves no constant
    to the device; a changed flag is uploaded anew."""
    tslm, _ = _slms((32, 32))
    with _numpy_global_state_kept():
        holo = T.CompressedSpotHologram(np.array([[1e-3, -2e-3], [2e-3, 0.0]]),
                                        cameraslm=tslm)
    first = holo._compressed_consts()
    again = holo._compressed_consts()
    for key in ("feedback_exponent", "feedback_factor", "fix_phase_iteration",
                "fix_phase_efficiency", "coeffs", "basis", "target"):
        assert again[key] is first[key], key
    holo.flags["feedback_exponent"] = 0.5
    changed = holo._compressed_consts()
    assert changed["feedback_exponent"] is not first["feedback_exponent"]
    assert float(changed["feedback_exponent"]) == 0.5
    assert changed["fix_phase_iteration"].dtype == torch.int32
    assert torch.isnan(changed["fix_phase_efficiency"])


def test_slm_write_is_the_jax_alias():
    """``SLM.write``, the JAX package's alias of ``set_phase``: it warns and
    writes the same display."""
    tslm, jslm = TSLM((40, 32), wav_um=0.8, wav_design_um=0.6), JSLM((40, 32), wav_um=0.8,
                                                                      wav_design_um=0.6)
    phase = np.random.default_rng(5).uniform(-3 * np.pi, 3 * np.pi, tslm.shape)
    with pytest.warns(UserWarning, match="alias"):
        got = tslm.write(phase)
    with pytest.warns(UserWarning, match="alias"):
        ref = jslm.write(phase)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tslm.display, jslm.display)


@pytest.mark.parametrize("indices", [[2, 1], [2, 1, 4], [2, 1, 4, 3], [2, 1, -1, 7]])
def test_build_zernike_basis_matches_jax(indices):
    tslm, jslm = _slms((48, 50))
    got = TC.build_zernike_basis(indices, tslm)
    want = JC.build_zernike_basis(indices, jslm)
    assert got.dtype == want.dtype == np.float32 and got.shape == (len(indices), 48 * 50)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# Transforms, cache and fused round trips.
# ----------------------------------------------------------------------


def _transform_inputs(N, P=3000, D=4, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        basis=(rng.normal(size=(D, P)) * 2).astype(np.float32),
        coeffs=(rng.normal(size=(D, N)) * 5).astype(np.float32),
        ffr=rng.normal(size=N).astype(np.float32), ffi=rng.normal(size=N).astype(np.float32),
        nfr=rng.normal(size=P).astype(np.float32), nfi=rng.normal(size=P).astype(np.float32),
        amp=(0.5 + rng.uniform(0, 1, P)).astype(np.float32),
    )


def _pallas(fn, *args):
    """``fn`` of ``pallas_compressed`` in interpret mode (restored after)."""
    JPC._INTERPRET = True
    try:
        return fn(*args)
    finally:
        JPC._INTERPRET = False


def _close_pair(got, want, rtol):
    assert got[0].shape == np.shape(want[0])
    assert max(_rel(got[0], want[0]), _rel(got[1], want[1])) <= rtol


@pytest.mark.parametrize("N", [16, 17, 300, 600])
def test_transforms_match_jax(N):
    """f2n and n2f at P = 3000 (padded pixels) against the jnp versions and
    the Pallas kernels, at spot counts within one spot group of the kernels'
    grids (four Zernike terms) and across two and three (300, 600 spots,
    nine terms)."""
    x = _transform_inputs(N, D=4 if N < 300 else 9)
    t = {k: _t(v) for k, v in x.items()}
    j = {k: jnp.asarray(v) for k, v in x.items()}
    got = TC.farfield_to_nearfield(t["ffr"], t["ffi"], t["coeffs"], t["basis"])
    _close_pair(got, JC.farfield_to_nearfield(j["ffr"], j["ffi"], j["coeffs"], j["basis"], N),
                JNP_RTOL)
    _close_pair(got, _pallas(JPC.farfield_to_nearfield, j["ffr"], j["ffi"], j["coeffs"],
                             j["basis"], N), PALLAS_RTOL)
    got = TC.nearfield_to_farfield(t["nfr"], t["nfi"], t["coeffs"], t["basis"])
    _close_pair(got, JC.nearfield_to_farfield(j["nfr"], j["nfi"], j["coeffs"], j["basis"], N),
                JNP_RTOL)
    _close_pair(got, _pallas(JPC.nearfield_to_farfield, j["nfr"], j["nfi"], j["coeffs"],
                             j["basis"], N), PALLAS_RTOL)
    _close_pair(TC._nearfield_to_farfield_raw(t["nfr"], t["nfi"], t["coeffs"], t["basis"]),
                JC.nearfield_to_farfield_raw(j["nfr"], j["nfi"], j["coeffs"], j["basis"], N),
                JNP_RTOL)


@pytest.mark.parametrize("N, D, P", [(12000, 3, 256), (4096, 16, 384)])
def test_transforms_past_the_earlier_spot_limits_match_jax(N, D, P):
    """f2n and n2f at spot counts past the shared memory of the earlier
    kernels (11,417 spots at D = 3, 3,171 at D = 16; the new ones take any
    count) against the jnp versions, on a small plane."""
    x = _transform_inputs(N, P=P, D=D)
    t = {k: _t(v) for k, v in x.items()}
    j = {k: jnp.asarray(v) for k, v in x.items()}
    got = TC.farfield_to_nearfield(t["ffr"], t["ffi"], t["coeffs"], t["basis"])
    assert got[0].shape == (P,)
    _close_pair(got, JC.farfield_to_nearfield(j["ffr"], j["ffi"], j["coeffs"], j["basis"], N),
                JNP_RTOL)
    got = TC.nearfield_to_farfield(t["nfr"], t["nfi"], t["coeffs"], t["basis"])
    assert got[0].shape == (N,)
    _close_pair(got, JC.nearfield_to_farfield(j["nfr"], j["nfi"], j["coeffs"], j["basis"], N),
                JNP_RTOL)


@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
@pytest.mark.parametrize("N", [17, 300])
def test_transforms_at_20_terms_match_jax(N, amp_kind):
    """f2n, n2f, the fused round trips (recomputed and cached) and the
    cos/sin cache at D = 20 Zernike terms, past the earlier kernels' 16
    (the Zernike calibration's hologram through the 5th radial order has
    21), against the jnp twins."""
    D, P = 20, 3000
    x = _transform_inputs(N, P=P, D=D)
    t = {k: _t(v) for k, v in x.items()}
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t_amp, j_amp = (1.0, jnp.float32(1.0)) if amp_kind == "scalar" else (t["amp"], j["amp"])
    _close_pair(TC.farfield_to_nearfield(t["ffr"], t["ffi"], t["coeffs"], t["basis"]),
                JC.farfield_to_nearfield(j["ffr"], j["ffi"], j["coeffs"], j["basis"], N),
                JNP_RTOL)
    _close_pair(TC.nearfield_to_farfield(t["nfr"], t["nfi"], t["coeffs"], t["basis"]),
                JC.nearfield_to_farfield(j["nfr"], j["nfi"], j["coeffs"], j["basis"], N),
                JNP_RTOL)
    _close_pair(TC.fused_iteration(t["ffr"], t["ffi"], t["coeffs"], t["basis"], t_amp),
                JC._fused_iteration_jnp(j["ffr"], j["ffi"], j["coeffs"], j["basis"], j_amp, N),
                JNP_RTOL)
    kc, ks = TC.build_kernel_cache(t["coeffs"], t["basis"])
    jkc, jks = JC.build_kernel_cache(j["coeffs"], j["basis"])
    np.testing.assert_allclose(kc, jkc, atol=1e-4)
    _close_pair(TC.fused_iteration_cached(t["ffr"], t["ffi"], kc, ks, t_amp, N, P),
                JC._fused_iteration_cached(j["ffr"], j["ffi"], jkc, jks, j_amp, N, P),
                JNP_RTOL)


def test_cache_rule_recomputes_past_the_cached_kernel_spot_limit(monkeypatch):
    """The cache is on where it fits the budget and ``fused_iter_cached``'s
    shared memory takes the spots (14,272), and off past that spot count on
    any device, so that the card runs the recomputing loop there, as the
    JAX package's dispatcher leaves its kernel (``fused_iter_cached_ok``)."""
    monkeypatch.setenv("SLMSUITE_TORCH_COMPRESSED_CACHE_MB", "4096")
    assert TC.fused_iter_cached_ok(14272) and not TC.fused_iter_cached_ok(14273)
    assert not TC.fused_iter_cached_ok(0)
    tslm, _ = _slms((16, 16))
    rng = np.random.default_rng(2)
    with _numpy_global_state_kept():
        within = T.CompressedSpotHologram(rng.uniform(-1e-2, 1e-2, (2, 14272)),
                                          cameraslm=tslm)
        past = T.CompressedSpotHologram(rng.uniform(-1e-2, 1e-2, (2, 14273)), cameraslm=tslm)
    assert within._kernel_cache_enabled() and not past._kernel_cache_enabled()
    past.optimize("WGS-Kim", maxiter=2, verbose=False)
    assert past.iter == 2 and np.isfinite(past.amp_ff).all()


@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
def test_transform_options_match_jax(amp_kind):
    """f2n's amplitude replacement (``amp``) is the JAX package's
    ``_amp_replace`` of its unscaled nearfield, every pixel valid, held
    where ``|nf|`` is at least 1e-2 of its largest (the angle of a
    near-zero nearfield pixel is ill-conditioned; elsewhere ``|amp
    nf/|nf||`` is ``amp`` alike); n2f unnormalized (``normalize=False``) is
    its raw overlap unscaled."""
    N, P = 17, 3000
    x = _transform_inputs(N)
    t = {k: _t(v) for k, v in x.items()}
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t_amp, j_amp = (1.0, None) if amp_kind == "scalar" else (t["amp"], j["amp"])
    got = TC._farfield_to_nearfield(t["ffr"], t["ffi"], t["coeffs"], t["basis"], amp=t_amp)
    nf = JC.farfield_to_nearfield(j["ffr"], j["ffi"], j["coeffs"], j["basis"], N)
    want = JPC._amp_replace(nf[0] * np.sqrt(P), nf[1] * np.sqrt(P), j_amp, jnp.ones(P),
                            amp_kind == "scalar")
    mag = np.hypot(np.asarray(nf[0]), np.asarray(nf[1]))
    kept = mag >= 1e-2 * mag.max()
    _close_pair([g.numpy()[kept] for g in got], [np.asarray(w)[kept] for w in want], JNP_RTOL)
    np.testing.assert_allclose(np.hypot(*(g.numpy() for g in got)),
                               np.hypot(*(np.asarray(w) for w in want)), rtol=1e-6)
    got = TC._nearfield_to_farfield(t["nfr"], t["nfi"], t["coeffs"], t["basis"], normalize=False)
    raw = JC.nearfield_to_farfield_raw(j["nfr"], j["nfi"], j["coeffs"], j["basis"], N)
    _close_pair(got, (raw[0] * np.sqrt(P), raw[1] * np.sqrt(P)), JNP_RTOL)


@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
def test_two_transform_round_trip_matches_jax(amp_kind):
    """The round trip as the card runs it past the 256 spots of
    ``fused_spots_kernel`` (here 9,000 spots at D = 3): f2n with the
    amplitude replacement, then n2f unnormalized, against the JAX package's
    ``_fused_iteration_jnp`` and the port's ``_fused_iteration``."""
    N, P = 9000, 2048
    x = _transform_inputs(N, P=P, D=3, seed=3)
    t = {k: _t(v) for k, v in x.items()}
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t_amp, j_amp = (1.0, jnp.float32(1.0)) if amp_kind == "scalar" else (t["amp"], j["amp"])
    cb = (t["coeffs"], t["basis"])
    nf = TC._farfield_to_nearfield(t["ffr"], t["ffi"], *cb, amp=t_amp)
    got = TC._nearfield_to_farfield(*nf, *cb, normalize=False)
    assert got[0].shape == (N,)
    _close_pair(got, JC._fused_iteration_jnp(j["ffr"], j["ffi"], j["coeffs"], j["basis"], j_amp,
                                             N), JNP_RTOL)
    _close_pair(got, TC._fused_iteration(t["ffr"], t["ffi"], *cb, t_amp), JNP_RTOL)


@pytest.mark.parametrize("N", [16, 17])
def test_kernel_cache_and_cached_twins_match_jax(N):
    """The cos/sin cache in the JAX layout (N padded to 8, pad rows of
    phase 0), and the cached entry and exit (pad rows sliced off before the
    norm)."""
    x = _transform_inputs(N)
    t = {k: _t(v) for k, v in x.items()}
    j = {k: jnp.asarray(v) for k, v in x.items()}
    kc, ks = TC.build_kernel_cache(t["coeffs"], t["basis"])
    jkc, jks = JC.build_kernel_cache(j["coeffs"], j["basis"])
    assert kc.shape == jkc.shape == (1, 24 if N == 17 else 16, TC.PIXEL_TILE)
    np.testing.assert_allclose(kc, jkc, atol=1e-5)
    np.testing.assert_allclose(ks, jks, atol=1e-5)
    assert TC.kernel_cache_bytes(N, 3000) == JC.kernel_cache_bytes(N, 3000)
    assert TC.kernel_cache_bytes(256, 1024**2) == JC.kernel_cache_bytes(256, 1024**2)
    _close_pair(TC.farfield_to_nearfield_cached(t["ffr"], t["ffi"], kc, ks, 3000),
                JC.farfield_to_nearfield_cached(j["ffr"], j["ffi"], jkc, jks, 3000), JNP_RTOL)
    _close_pair(TC.nearfield_to_farfield_cached(t["nfr"], t["nfi"], kc, ks, 3000, n_spots=N),
                JC.nearfield_to_farfield_cached(j["nfr"], j["nfi"], jkc, jks, 3000, n_spots=N),
                JNP_RTOL)
    # The cached twins and the recomputing transforms agree.
    _close_pair(TC.farfield_to_nearfield_cached(t["ffr"], t["ffi"], kc, ks, 3000),
                TC.farfield_to_nearfield(t["ffr"], t["ffi"], t["coeffs"], t["basis"]), JNP_RTOL)


@pytest.mark.parametrize("N", [16, 17])
@pytest.mark.parametrize("amp_kind", ["scalar", "array"])
def test_fused_iterations_match_jax(N, amp_kind):
    """The fused round trips (recomputed and cached; unnormalized) against
    the jnp twins and the Pallas kernels, with padded pixels masked."""
    x = _transform_inputs(N)
    t = {k: _t(v) for k, v in x.items()}
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t_amp, j_amp = (1.0, jnp.float32(1.0)) if amp_kind == "scalar" else (t["amp"], j["amp"])
    got = TC.fused_iteration(t["ffr"], t["ffi"], t["coeffs"], t["basis"], t_amp)
    _close_pair(got, JC._fused_iteration_jnp(j["ffr"], j["ffi"], j["coeffs"], j["basis"],
                                             j_amp, N), JNP_RTOL)
    _close_pair(got, _pallas(JPC.fused_iteration, j["ffr"], j["ffi"], j["coeffs"],
                             j["basis"], j_amp, N), PALLAS_RTOL)
    kc, ks = TC.build_kernel_cache(t["coeffs"], t["basis"])
    jkc, jks = JC.build_kernel_cache(j["coeffs"], j["basis"])
    got = TC.fused_iteration_cached(t["ffr"], t["ffi"], kc, ks, t_amp, N, 3000)
    _close_pair(got, JC._fused_iteration_cached(j["ffr"], j["ffi"], jkc, jks, j_amp, N, 3000),
                JNP_RTOL)
    _close_pair(got, _pallas(JPC.fused_iteration_cached, j["ffr"], j["ffi"], jkc, jks, j_amp,
                             N, 3000), PALLAS_RTOL)


def test_amp_replace_conventions():
    """A zero field becomes unit real (times amp), padded pixels give 0,
    no nan appears; the same as the JAX package's ``_amp_replace``."""
    re = np.array([0.0, 3.0, 0.0, -1.0, 2.0], np.float32)
    im = np.array([0.0, 4.0, 0.0, 0.0, 2.0], np.float32)
    valid = np.array([1, 1, 0, 1, 0], np.float32)
    amp = np.array([2.0, 2.0, 2.0, 0.5, 1.0], np.float32)
    for t_amp, j_amp, scalar in ((None, None, True), (_t(amp), jnp.asarray(amp), False)):
        got = TC._amp_replace(_t(re), _t(im), t_amp, _t(valid))
        want = JPC._amp_replace(jnp.asarray(re), jnp.asarray(im), j_amp,
                                jnp.asarray(valid), scalar)
        np.testing.assert_allclose(got[0], want[0], atol=1e-7)
        np.testing.assert_allclose(got[1], want[1], atol=1e-7)
        assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()


@pytest.mark.parametrize("top", [np.pi, 1e2, 1e4, 1e5, 1e6])
def test_sincos_reduced_model_matches_float64(top):
    """The model of the kernels' sincos on seeded f32 phases in +-top:
    period-reduced up to REDUCED_LIMIT (1e5), the plain sin and cos beyond."""
    x = np.random.default_rng(7).uniform(-top, top, 200_000).astype(np.float32)
    s, c = TK.sincos_reduced_model(torch.from_numpy(x))
    x64 = x.astype(np.float64)
    assert s.dtype == c.dtype == torch.float32
    assert np.abs(s.numpy() - np.sin(x64)).max() <= SINCOS_ATOL
    assert np.abs(c.numpy() - np.cos(x64)).max() <= SINCOS_ATOL
    assert (np.abs(x) > TK.REDUCED_LIMIT).any() == (top > TK.REDUCED_LIMIT)


@pytest.mark.parametrize("top", [np.pi, 1e3, 1e5])
def test_sincos_reduced_model_matches_tpu_reduction(top):
    """The model against the TPU kernel's own period-reduced sincos
    (``pallas_fft._sincos_reduced``) on the same phases."""
    x = np.random.default_rng(8).uniform(-top, top, 200_000).astype(np.float32)
    s, c = TK.sincos_reduced_model(torch.from_numpy(x))
    js, jc = (np.asarray(v) for v in jax.jit(_sincos_reduced)(jnp.asarray(x)))
    assert np.abs(s.numpy() - js).max() <= SINCOS_TPU_ATOL
    assert np.abs(c.numpy() - jc).max() <= SINCOS_TPU_ATOL


def test_sincos_reduced_constants_match_the_kernel_source():
    """The model's constants are the kernel's (``compressed.cu``), as f32."""
    source = (Path(TK.__file__).resolve().parent.parent / "csrc" / "compressed.cu").read_text()

    def const(name):
        return np.float32(float(re.search(rf"constexpr float {name} = ([0-9.e+-]+)f;",
                                          source).group(1)))

    assert const("kInv2Pi") == np.float32(TK.INV_2PI)
    assert (const("k2PiA"), const("k2PiB"), const("k2PiC")) == tuple(
        np.float32(t) for t in TK.TWO_PI_TERMS)
    assert const("kPiF") == np.float32(TK.PI_F32) == np.float32(np.pi)
    assert const("k2PiF") == np.float32(TK.TWO_PI_F32) == np.float32(2 * np.pi)
    assert const("kReducedLimit") == np.float32(TK.REDUCED_LIMIT)
    # The split: the first term has 8 significant bits, the three sum to 2 pi.
    assert float(TK.TWO_PI_TERMS[0]) * 2**5 == 201
    assert abs(sum(map(float, TK.TWO_PI_TERMS)) - 2 * np.pi) < 1e-17


def test_mraf_mix_matches_jax():
    rng = np.random.default_rng(5)
    vals = [rng.normal(size=9).astype(np.float32) for _ in range(4)]
    sig = np.array([1, 1, 0, 0, 1, 0, 1, 0, 1], bool)
    noi = np.array([0, 0, 1, 0, 0, 1, 0, 0, 0], bool)
    got = TC.apply_compressed_mraf_mix(*map(_t, vals), dict(
        signal_mask=torch.from_numpy(sig), noise_mask=torch.from_numpy(noi),
        mraf_k=torch.tensor(0.5)))
    want = JC.apply_compressed_mraf_mix(*map(jnp.asarray, vals), dict(
        signal_mask=jnp.asarray(sig), noise_mask=jnp.asarray(noi), mraf_k=jnp.float32(0.5)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ----------------------------------------------------------------------
# The engine.
# ----------------------------------------------------------------------


def _engine_consts(N, P, mraf, seed=6):
    """Numpy consts of the compressed engine: a 48x50 SLM's [2, 1, 4] basis
    and 3D spots, an array amplitude, a target with noise (nan) and null
    (0) spots when ``mraf``."""
    rng = np.random.default_rng(seed)
    _, jslm = _slms((50, 48))
    basis = JC.build_zernike_basis([2, 1, 4], jslm)
    spots = np.vstack([rng.uniform(-8e-3, 8e-3, (2, N)), rng.uniform(-2e-6, 2e-6, (1, N))])
    coeffs = JT.convert_vector(spots, "kxy", "zernike", hardware=jslm).astype(np.float32)
    target = rng.uniform(0.5, 1.0, N)
    if mraf:
        target[::4] = np.nan
        target[1::6] = 0.0
    target = (target / np.sqrt(np.nansum(target**2))).astype(np.float32)
    amp = (0.5 + rng.uniform(0, 1, P)).astype(np.float32)
    clean = np.nan_to_num(target)
    consts = dict(
        amp=amp / np.sqrt((amp**2).sum()), coeffs=coeffs, basis=basis, target=clean,
        stat_mask=clean != 0, feedback_exponent=np.float32(0.8),
        feedback_factor=np.float32(0.1), fix_phase_iteration=np.int32(3),
        fix_phase_efficiency=np.float32(np.nan),
    )
    if mraf:
        consts.update(signal_mask=~np.isnan(target) & (clean > 0), noise_mask=np.isnan(target),
                      mraf_k=np.float32(0.5))
    return consts, clean


ENGINE_CASES = {
    "GS": dict(method="GS"),
    "WGS-Leonardo": dict(method="WGS-Leonardo"),
    "WGS-Kim-iteration": dict(method="WGS-Kim"),
    "WGS-Kim-efficiency": dict(method="WGS-Kim", fix_phase_efficiency=0.6),
    "WGS-Kim-mraf": dict(method="WGS-Kim", mraf=True),
    "WGS-Leonardo-mraf": dict(method="WGS-Leonardo", mraf=True),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
@pytest.mark.parametrize("cache", [False, True])
def test_run_compressed_gs_matches_jax(case, cache):
    """Six iterations of the port's engine and the JAX engine from one
    numpy state, with stats, per-spot MRAF, Kim's two triggers, the cache
    on and off; then a second run continuing from the first."""
    spec = dict(ENGINE_CASES[case])
    method, mraf = spec["method"], spec.get("mraf", False)
    N, P = 17, 48 * 50
    consts, target = _engine_consts(N, P, mraf)
    if "fix_phase_efficiency" in spec:
        consts["fix_phase_efficiency"] = np.float32(spec["fix_phase_efficiency"])
    kw = dict(method=method, n_pixels=P, n_spots=N, stat_groups=("computational_spot",),
              kim_efficiency_trigger="fix_phase_efficiency" in spec, mraf=mraf,
              kernel_cache=cache)
    jconfig = JC.CompressedGSConfig(use_pallas=False, **kw)
    tconfig = TC.CompressedGSConfig(**kw)
    jconsts = {k: jnp.asarray(v) for k, v in consts.items()}
    tconsts = convert.consts_from_numpy(consts, device="cpu")
    if cache:
        jconsts["kc_tiles"], jconsts["ks_tiles"] = JC.build_kernel_cache(
            jconsts["coeffs"], jconsts["basis"])
        tconsts["kc_tiles"], tconsts["ks_tiles"] = TC.build_kernel_cache(
            tconsts["coeffs"], tconsts["basis"])
    psi0 = np.random.default_rng(7).uniform(-np.pi, np.pi, P).astype(np.float32)
    arrays = dict(psi=psi0, weights=target, phase_ff=np.zeros(N, np.float32),
                  fixed_phase=False, unfixed_streak=np.int32(0), iteration=np.int32(0))
    jstate = JC.CompressedGSState(*(jnp.asarray(arrays[f]) for f in JC.CompressedGSState._fields))
    tstate = convert.compressed_state_from_numpy(arrays, device="cpu")
    for n in (6, 4):
        jstate, jstats = JC.run_compressed_gs(jconfig, jstate, jconsts, n)
        tstate, tstats = TC.run_compressed_gs(tconfig, tstate, tconsts, n)
        assert tstats.shape == jstats.shape == (n, 2, 4)
        np.testing.assert_allclose(tstats, np.asarray(jstats), atol=STATE_ATOL, rtol=1e-3)
        np.testing.assert_allclose(tstate.weights, np.asarray(jstate.weights), atol=STATE_ATOL)
        assert _wrapped(tstate.phase_ff, jstate.phase_ff).max() < PHASE_ATOL
        assert np.quantile(_wrapped(tstate.psi, jstate.psi), 0.99) < PHASE_ATOL
        for field in ("fixed_phase", "unfixed_streak", "iteration"):
            assert int(getattr(tstate, field)) == int(getattr(jstate, field)), field


def test_run_compressed_gs_zero_iterations():
    config = TC.CompressedGSConfig(method="GS", n_pixels=10, n_spots=3,
                                   stat_groups=("computational_spot",))
    state = convert.compressed_state_from_numpy(dict(
        psi=np.zeros(10), weights=np.ones(3), phase_ff=np.zeros(3), fixed_phase=False,
        unfixed_streak=0, iteration=0), device="cpu")
    same, stats = TC.run_compressed_gs(config, state, {}, 0)
    assert same is state and stats.shape == (0, 2, 4)


# ----------------------------------------------------------------------
# CompressedSpotHologram.
# ----------------------------------------------------------------------


def _spots(kind, N=9, seed=8):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-8e-3, 8e-3, (2, N))
    if kind == "2d":
        return xy, "kxy"
    if kind == "3d":
        return np.vstack([xy, rng.uniform(-2e-6, 2e-6, (1, N))]), "kxy"
    return np.vstack([rng.uniform(-5, 5, (2, N)), rng.uniform(-0.1, 0.1, (2, N))]), [2, 1, 4, 3]


def _hologram_pair(kind, spot_amp=None, **kwargs):
    vectors, basis = _spots(kind)
    tslm, jslm = _slms()
    t = T.CompressedSpotHologram(vectors, basis=basis, spot_amp=spot_amp, cameraslm=tslm,
                                 **kwargs)
    j = J.CompressedSpotHologram(vectors, basis=basis, spot_amp=spot_amp, cameraslm=jslm)
    phi0 = np.random.default_rng(9).uniform(-np.pi, np.pi, (64, 64)).astype(np.float32)
    t.reset_phase(phi0)
    j.reset_phase(phi0)
    return t, j


def _assert_holograms_agree(t, j, groups=("computational_spot",)):
    assert t.iter == j.iter
    np.testing.assert_allclose(t.amp_ff, np.asarray(j.amp_ff), atol=STATE_ATOL)
    np.testing.assert_allclose(t.weights, np.asarray(j.weights), atol=STATE_ATOL)
    assert _wrapped(t.phase_ff, j.phase_ff).max() < PHASE_ATOL
    assert np.quantile(_wrapped(t.phase, j.phase), 0.99) < PHASE_ATOL
    assert t.phase.shape == (64, 64) and t.flags["fixed_phase"] == j.flags["fixed_phase"]
    for group in groups:
        for key, series in j.stats["stats"][group].items():
            np.testing.assert_allclose(t.stats["stats"][group][key], series,
                                       atol=STATE_ATOL, rtol=1e-3, err_msg=f"{group}/{key}")
    assert t.stats["flags"]["fixed_phase"] == j.stats["flags"]["fixed_phase"]


@pytest.mark.parametrize("kind", ["2d", "3d", "basis2143"])
@pytest.mark.parametrize("cache_mb", ["4096", "0"])
def test_compressed_hologram_matches_jax(kind, cache_mb, monkeypatch):
    """Two successive WGS-Kim optimize() calls on a 64^2 SimulatedSLM from
    one reset_phase, cache on and off (each package's own variable)."""
    monkeypatch.setenv("SLMSUITE_TORCH_COMPRESSED_CACHE_MB", cache_mb)
    monkeypatch.setenv("SLMSUITE_TPU_COMPRESSED_CACHE_MB", cache_mb)
    t, j = _hologram_pair(kind)
    assert t.zernike_basis.tolist() == j.zernike_basis.tolist()
    np.testing.assert_allclose(t.spot_zernike, j.spot_zernike, rtol=1e-12)
    np.testing.assert_allclose(t.spot_kxy, j.spot_kxy, rtol=1e-12)
    np.testing.assert_array_equal(t.zernike_basis_cartesian, j.zernike_basis_cartesian)
    np.testing.assert_array_equal(t.target, j.target)
    np.testing.assert_array_equal(t.amp, j.amp)
    assert t._kernel_cache_enabled() == j._kernel_cache_enabled() == (cache_mb != "0")
    for maxiter in (5, 4):
        for holo in (t, j):
            holo.optimize("WGS-Kim", maxiter=maxiter, verbose=False,
                          stat_groups=["computational_spot"], fix_phase_iteration=3)
        _assert_holograms_agree(t, j)
    assert t.iter == 9 and t.flags["feedback"] == "computational_spot"
    far_t, far_j = t.get_farfield(), j.get_farfield()
    np.testing.assert_allclose(np.abs(far_t), np.abs(far_j), atol=STATE_ATOL)


@pytest.mark.parametrize("method", ["GS", "WGS-Leonardo"])
def test_compressed_hologram_methods_and_chunks_match_jax(method):
    """GS and Leonardo with verbose chunking (entry and exit per chunk)."""
    t, j = _hologram_pair("3d")
    for holo in (t, j):
        holo.optimize(method, maxiter=12, verbose=True, stat_groups=["computational_spot"])
    _assert_holograms_agree(t, j)


def test_compressed_hologram_per_spot_mraf_matches_jax():
    """Per-spot MRAF: nan spot_amp entries are noise spots, zeros null
    spots; the scanned engine with mraf_factor."""
    spot_amp = np.ones(9)
    spot_amp[::4] = np.nan
    spot_amp[1] = 0.0
    t, j = _hologram_pair("2d", spot_amp=spot_amp)
    assert t._mraf_enabled() and j._mraf_enabled()
    for holo in (t, j):
        holo.optimize("WGS-Kim", maxiter=6, verbose=False, mraf_factor=0.5,
                      stat_groups=["computational_spot"])
    _assert_holograms_agree(t, j)


def test_compressed_hologram_host_helpers_match_jax():
    """_populate_results, _update_weights and _populate_stats (the host
    pieces of the stepwise loop) on the same state."""
    t, j = _hologram_pair("3d")
    for holo in (t, j):
        holo.optimize("WGS-Leonardo", maxiter=3, verbose=False)
        holo._populate_results()
        holo._update_weights()
        holo._update_stats(["computational_spot", "external_spot"])
    np.testing.assert_allclose(t.weights, np.asarray(j.weights), atol=STATE_ATOL)
    for group in ("computational_spot", "external_spot"):
        for key, series in j.stats["stats"][group].items():
            np.testing.assert_allclose(t.stats["stats"][group][key], series, atol=STATE_ATOL,
                                       err_msg=f"{group}/{key}")


def test_compressed_hologram_reuses_device_consts():
    """The device constants and the cache persist across calls and are
    rebuilt when the spot coefficients change."""
    t, _ = _hologram_pair("3d")
    t.optimize("WGS-Kim", maxiter=2, verbose=False)
    consts = t._compressed_consts(kernel_cache=True)
    again = t._compressed_consts(kernel_cache=True)
    assert again["basis"] is consts["basis"] and again["kc_tiles"] is consts["kc_tiles"]
    t.spot_zernike = t.spot_zernike * 1.01
    moved = t._compressed_consts(kernel_cache=True)
    assert moved["kc_tiles"] is not consts["kc_tiles"]
    assert moved["coeffs"] is not consts["coeffs"]


def test_compressed_constructor_errors_match_jax():
    tslm, jslm = _slms()
    for mod, slm in ((T, tslm), (J, jslm)):
        with pytest.raises(ValueError, match="cameraslm"):
            mod.CompressedSpotHologram(np.zeros((2, 3)))
        with pytest.raises(ValueError, match="x, y"):
            mod.CompressedSpotHologram(np.zeros((2, 3)), basis=[4, 3], cameraslm=slm)
        with pytest.raises(ValueError, match="at least one spot"):
            mod.CompressedSpotHologram(np.zeros((2, 0)), cameraslm=slm)
        with pytest.raises(ValueError, match="spot dimension"):
            mod.CompressedSpotHologram(np.zeros((2, 3)), basis=[2, 1, 4], cameraslm=slm)
        with pytest.raises(ValueError, match="same length"):
            mod.CompressedSpotHologram(np.zeros((2, 3)), spot_amp=[1, 2], cameraslm=slm)
        holo = mod.CompressedSpotHologram(np.zeros((2, 3)), cameraslm=slm)
        with pytest.raises(NameError):
            holo.get_padded_shape()
        assert len(holo) == 3 and holo.spot_ij is None
        with pytest.warns(UserWarning, match="piston"):
            mod.CompressedSpotHologram(np.zeros((3, 3)), basis=[0, 2, 1], cameraslm=slm)


class _FakeCameraSLM:
    """A CameraSLM's shape: an SLM and a camera, uncalibrated."""

    def __init__(self, slm):
        self.slm, self.cam = slm, object()
        self.calibrations = {}


def test_compressed_unported_paths_raise():
    """The paths that raised before they were ported run: a mesh run (the
    pixels over a mesh of CPU shards, ``tests/test_torch_parallel.py``
    holds it against the JAX package), the host-paced loop (callbacks,
    external feedback, MRAF with zero_factor) and CG (``tests/test_torch_hostloop.py``
    and ``tests/test_torch_cg.py`` hold them against the JAX package);
    camera feedback on a bare SLM raises, for want of a camera, as in the
    JAX package; an uncalibrated CameraSLM takes the hologram without
    camera positions (a calibrated one: ``tests/test_torch_wavefront.py``);
    a ``cuda`` flag that contradicts the device raises ValueError."""
    tslm, _ = _slms()
    vectors, _ = _spots("2d")
    holo = T.CompressedSpotHologram(vectors, cameraslm=tslm)
    for kwargs in (dict(callback=lambda h: False), dict(feedback="external_spot")):
        holo.optimize("WGS-Kim", maxiter=2, verbose=False, **kwargs)
    assert holo.iter == 4
    for kwargs in (dict(feedback="experimental_spot"), dict(stat_groups=["experimental_spot"])):
        with pytest.raises(RuntimeError, match="cameraslm"):
            holo.optimize("WGS-Kim", maxiter=2, verbose=False, **kwargs)
    holo.iter = 4
    holo.optimize("CG", maxiter=2, verbose=False)
    assert holo.iter == 6 and np.isfinite(holo.flags["loss_result"])
    holo.optimize("WGS-Kim", maxiter=2, verbose=False, feedback="computational_spot",
                  stat_groups=[], mesh=make_mesh(axis_names=("pixels",), devices=["cpu"] * 4))
    assert holo.iter == 8 and holo._mesh.size == 4 and not holo._kernel_cache_enabled()
    holo.optimize("WGS-Kim", maxiter=1, verbose=False, mesh=None)
    assert holo.iter == 9 and holo._mesh is None
    mraf_amp = np.ones(9)
    mraf_amp[0] = np.nan
    mraf_amp[1] = 0.0
    mraf = T.CompressedSpotHologram(vectors, spot_amp=mraf_amp, cameraslm=tslm)
    mraf.optimize("WGS-Kim", maxiter=2, verbose=False, zero_factor=0.1)
    assert mraf.iter == 2 and np.abs(mraf._zero_weights_c).max() > 0
    with _numpy_global_state_kept():
        on_camera = T.CompressedSpotHologram(vectors, cameraslm=_FakeCameraSLM(tslm))
    assert on_camera.spot_ij is None and on_camera.spot_integration_width_ij is None
    with pytest.raises(ValueError, match="laterally"):
        T.CompressedSpotHologram(vectors * 1e3, cameraslm=_FakeCameraSLM(tslm))
    with pytest.raises(ValueError, match="contradicts"):
        T.CompressedSpotHologram(vectors, cameraslm=tslm, cuda=True)
    assert T.CompressedSpotHologram(vectors, cameraslm=tslm, cuda=False).cuda is False


# ----------------------------------------------------------------------
# SLM objects in Hologram and FeedbackHologram.
# ----------------------------------------------------------------------


def test_hologram_takes_an_slm_as_slm_shape():
    """An SLM object as ``slm_shape`` gives its shape (and its measured
    source amplitude as amp), as in the JAX package; the hologram runs."""
    tslm, jslm = _slms((48, 32))
    target = np.zeros((32, 48))
    target[8:24:4, 8:40:4] = 1.0
    t = T.Hologram(target, slm_shape=tslm)
    j = J.Hologram(target, slm_shape=jslm)
    assert t.slm_shape == j.slm_shape == (32, 48) and np.isscalar(t.amp)
    assert t.amp == j.amp
    amp = np.random.default_rng(10).uniform(0.5, 1, (32, 48))
    tslm.source["amplitude"], jslm.source["amplitude"] = amp, amp
    t = T.Hologram(target, slm_shape=tslm)
    j = J.Hologram(target, slm_shape=jslm)
    np.testing.assert_allclose(t.amp, np.asarray(j.amp), rtol=1e-6)
    t.optimize(method="GS", maxiter=2, verbose=False)
    assert t.iter == 2 and np.isfinite(t.get_phase()).all()
    # A CameraSLM gives its SLM's shape and source, as in the JAX package.
    t = T.Hologram(target, slm_shape=_FakeCameraSLM(tslm))
    j = J.Hologram(target, slm_shape=_FakeCameraSLM(jslm))
    assert t.slm_shape == j.slm_shape == (32, 48)
    np.testing.assert_allclose(t.amp, np.asarray(j.amp), rtol=1e-6)


def test_feedback_hologram_takes_a_bare_slm():
    """A bare SLM as ``cameraslm`` sets amp and slm_shape and leaves
    ``cameraslm`` None, as in the JAX package; it runs."""
    tslm, jslm = _slms((48, 32))
    t = T.FeedbackHologram((64, 64), cameraslm=tslm)
    j = J.FeedbackHologram((64, 64), cameraslm=jslm)
    assert t.cameraslm is None and j.cameraslm is None
    assert t.slm_shape == j.slm_shape == (32, 48)
    np.testing.assert_allclose(t.amp, np.asarray(j.amp), rtol=1e-6)
    t.set_target(np.pad(np.ones((4, 4)), 30))
    t.optimize(method="GS", maxiter=2, verbose=False)
    assert t.iter == 2
    # A CameraSLM is kept, and its SLM gives amp and slm_shape.
    fake = _FakeCameraSLM(tslm)
    fake.calibrations = {}
    t = T.FeedbackHologram((64, 64), cameraslm=fake)
    assert t.cameraslm is fake and t.slm_shape == (32, 48)
    np.testing.assert_allclose(t.amp, np.asarray(j.amp), rtol=1e-6)
    # Without a Fourier calibration target_ij is kept and not resampled.
    t = T.FeedbackHologram((64, 64), target_ij=np.ones((8, 8)), cameraslm=fake)
    j = J.FeedbackHologram((64, 64), target_ij=np.ones((8, 8)), cameraslm=fake)
    np.testing.assert_array_equal(t.target_ij, j.target_ij)
    np.testing.assert_array_equal(t.target, np.asarray(j.target))
    assert t._cam_points is None and j._cam_points is None
    with pytest.raises(ValueError, match="CameraSLM or SLM"):
        T.FeedbackHologram((64, 64), cameraslm=object())
