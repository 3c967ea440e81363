"""
The batched multiplane engine and ``MultiplaneHologram`` of the port
against ``slmsuite_tpu`` on the CPU: ``run_batched_gs`` (GS, WGS-Kim with
and without ``fix_phase_efficiency``, WGS-Leonardo, WGS-Nogrette, padded,
kernel-free, MRAF with ``mraf_factor``), its resume, the
``multiplane_batched`` model, ``MultiplaneHologram`` on the batched path
and on the host meta loop (a callback; ``SpotHologram`` children),
``set_target``, recursion and the plane weights, and
``get_multiplane_defocus_blur`` against the JAX package's ``cv2`` version.
Inputs come from ``numpy.random.default_rng(seed)`` and go to both
packages; B = 3 planes of 64^2 (the padded case: 32^2 in 64^2).

Each ``run_batched_gs`` case runs twice in the port: on the plain
versions, and with ``cuda_fft``'s compositions over stacks
(``fft2_polar_from_phase``, ``wexp_ifft2``, ``ifft2``) on the plain
versions of the kernels, counting one launch of each kernel an iteration
for all planes, as on the card.

Tolerances: stats 1e-4 abs / 1e-3 rel (the goldens'; std_err also
``sqrt(eps32) (1 - efficiency)``, the uncertainty of the JAX package's f32
variance, as ``tests/test_torch_natural.py`` holds it), psi 5e-3 rad
wrapped (the goldens' phase), weights 1e-5 of their maximum, Kim's phase
store 1e-3 rad wrapped on the targets' spots, Kim flags exact. The defocus
blur: 1e-12 of the stack's maximum for float64 images, 1e-6 for float32
ones (which cv2 blurs in float32).
"""

import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slmsuite_torch
from slmsuite_torch import convert
from slmsuite_torch.holography import algorithms as T
from slmsuite_torch.models import parallel_models as TPM
from slmsuite_torch.ops import cuda_fft
from slmsuite_torch.ops import fft as TF
from slmsuite_torch.parallel import multiplane as TM
from slmsuite_torch.parallel.mesh import make_mesh
from slmsuite_tpu.holography import algorithms as J
from slmsuite_tpu.models import parallel_models as JPM
from slmsuite_tpu.parallel import multiplane as JM


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


STATS_ATOL, STATS_RTOL = 1e-4, 1e-3
PHASE_ATOL = 5e-3
WEIGHT_RTOL = 1e-5
STORE_ATOL = 1e-3
B, N = 3, 64


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    slmsuite_torch.set_default_device("cpu")
    yield
    slmsuite_torch.set_default_device("cuda")
    torch.set_num_threads(threads)


@pytest.fixture
def kernel_route(monkeypatch):
    """The kernels' gates true for CPU tensors and each kernel wrapper of
    ``cuda_fft`` replaced by a counting plain version: the dispatchers take
    ``cuda_fft``'s compositions, as on the card."""
    for gate in ("use_kernels", "use_row_kernels"):
        monkeypatch.setattr(TF, gate, lambda x: True)
    for name, plain in (("carry_entry", TF._wgs_carry_entry), ("rows_fft", TF._rows_fft),
                        ("cols_fft", TF._cols_fft), ("cols_fwd_polar", TF._cols_fwd_polar),
                        ("cols_wexp_inv", TF._cols_wexp_inv)):
        def counted(*args, _name=name, _plain=plain, **kwargs):
            cuda_fft.LAUNCHES[_name] += 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(cuda_fft, name, counted)
    cuda_fft.reset_launch_counts()
    yield cuda_fft.LAUNCHES
    cuda_fft.reset_launch_counts()


def _phase_err(a, b):
    dp = np.asarray(a, float) - np.asarray(b, float)
    return np.abs(np.mod(dp + np.pi, 2 * np.pi) - np.pi).max()


def _problem(seed=0, slm=(N, N), mraf=False):
    """B 3x3 spot targets shifted per plane (nan outside a window per plane
    with ``mraf``), random kernels of growing depth, a random phase."""
    rng = np.random.default_rng(seed)
    targets = np.zeros((B, N, N), np.float32)
    for b in range(B):
        idx = ((np.arange(3) - 1) * 8 + N // 2 + 2 * b).astype(int)
        xs, ys = np.meshgrid(idx, idx)
        targets[b, ys.ravel(), xs.ravel()] = 1.0
        targets[b] /= np.sqrt((targets[b] ** 2).sum())
        if mraf:
            noise = np.ones((N, N), bool)
            noise[N // 4:3 * N // 4, N // 4 + b:3 * N // 4] = False
            targets[b, noise & (targets[b] == 0)] = np.nan
    kernels = np.stack([0.3 * (b + 1) * rng.uniform(-1, 1, slm).astype(np.float32)
                        for b in range(B)])
    psi0 = rng.uniform(-np.pi, np.pi, slm).astype(np.float32)
    plane_weights = np.array([1.0, 2.0, 3.0], np.float32)
    return targets, kernels, psi0, plane_weights / np.sqrt((plane_weights**2).sum())


#: run_batched_gs cases: (method, has_kernel, padded, mraf, fix_phase_efficiency).
CASES = {
    "GS": ("GS", True, False, False, None),
    "WGS-Kim": ("WGS-Kim", True, False, False, None),
    "WGS-Kim efficiency": ("WGS-Kim", True, False, False, 0.001),
    "WGS-Leonardo": ("WGS-Leonardo", True, False, False, None),
    "WGS-Nogrette": ("WGS-Nogrette", True, False, False, None),
    "WGS-Kim no kernel": ("WGS-Kim", False, False, False, None),
    "WGS-Kim padded": ("WGS-Kim", True, True, False, None),
    "MRAF WGS-Leonardo mraf_factor": ("WGS-Leonardo", True, False, True, None),
    "MRAF WGS-Kim padded": ("WGS-Kim", True, True, True, None),
}


def _both(case, n=8, seed=0):
    """The case's config and consts in both packages (the port's through
    convert), and the JAX package's run."""
    method, has_kernel, padded, mraf, efficiency = CASES[case]
    slm = (N // 2, N // 2) if padded else (N, N)
    targets, kernels, psi0, pw = _problem(seed, slm, mraf)
    if not has_kernel:
        kernels = np.zeros_like(kernels)
    kw = dict(method=method, shape=(N, N), slm_shape=slm, n_planes=B, has_kernel=has_kernel,
              kim_efficiency_trigger=efficiency is not None, mraf=mraf, mraf_factor=mraf)
    jconfig = JM.BatchedGSConfig(**kw)
    consts = JM.make_multiplane_consts(
        targets, kernels, pw, 1.0 / np.sqrt(np.prod(slm)), fix_phase_iteration=3,
        fix_phase_efficiency=efficiency, mraf_factor=0.5 if mraf else None,
    )
    weights0 = np.nan_to_num(targets)
    ref = [np.asarray(x) for x in JM.run_batched_gs(
        jconfig, jnp.asarray(psi0), jnp.asarray(weights0), consts, n)]
    tconsts = convert.multiplane_consts_from_numpy(
        {k: np.asarray(v) for k, v in consts.items()}, device="cpu")
    return convert.batched_config_from_jax(jconfig), tconsts, psi0, weights0, ref


def _assert_stats(got, ref):
    """Stats columns [efficiency, uniformity, pkpk_err, std_err] at
    STATS_ATOL / STATS_RTOL, std_err with the JAX package's f32 variance
    uncertainty ``sqrt(eps32) (1 - efficiency)`` added."""
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    np.testing.assert_allclose(got[..., :3], ref[..., :3], atol=STATS_ATOL, rtol=STATS_RTOL)
    cancel = np.sqrt(np.finfo(np.float32).eps) * np.abs(1 - ref[..., 0])
    bad = np.abs(got[..., 3] - ref[..., 3]) > STATS_ATOL + STATS_RTOL * np.abs(ref[..., 3]) + cancel
    assert not bad.any(), (got[..., 3][bad], ref[..., 3][bad])


def _assert_run(got, ref, weights0):
    psi, weights, stats, phase_ff, fixed = (x.numpy() for x in got)
    jpsi, jweights, jstats, jphase_ff, jfixed = ref
    assert stats.shape == jstats.shape == (len(stats), B, 5)
    _assert_stats(stats[..., :4], jstats[..., :4])
    np.testing.assert_array_equal(stats[..., 4], jstats[..., 4])
    assert _phase_err(psi, jpsi) < PHASE_ATOL
    np.testing.assert_allclose(weights / np.abs(jweights).max(),
                               jweights / np.abs(jweights).max(), atol=WEIGHT_RTOL)
    np.testing.assert_array_equal(fixed, jfixed)
    spots = weights0 > 0
    assert _phase_err(phase_ff[spots], jphase_ff[spots]) < STORE_ATOL


@pytest.mark.parametrize("route", ["plain", "kernel compositions"])
@pytest.mark.parametrize("case", list(CASES))
def test_run_batched_gs_matches_jax(case, route, request):
    config, consts, psi0, weights0, ref = _both(case)
    launches = request.getfixturevalue("kernel_route") if route != "plain" else None
    got = TM.run_batched_gs(config, psi0, weights0, consts, 8)
    _assert_run(got, ref, weights0)
    if launches is not None:
        # One launch of each kernel an iteration for all B planes; without
        # kernels the planes' forward is one plane's.
        backward = dict(cols_fft=8) if config.mraf else dict(cols_wexp_inv=8)
        assert {k: v for k, v in launches.items() if v} == dict(
            carry_entry=8, cols_fwd_polar=8, rows_fft=8, **backward)


def test_run_batched_gs_resumes_like_one_run():
    """Two runs of 5, the second resumed from the first's iteration count,
    phase store and Kim flags, equal one run of 10 exactly (the Kim fixing
    completes in the first segment), as the JAX package's do."""
    config, consts, psi0, weights0, _ = _both("WGS-Kim")
    p_f, w_f, s_f, pf_f, fx_f = TM.run_batched_gs(config, psi0, weights0, consts, 10)
    p_a, w_a, s_a, pf_a, fx_a = TM.run_batched_gs(config, psi0, weights0, consts, 5)
    assert bool(fx_a.all())
    p_b, w_b, s_b, pf_b, fx_b = TM.run_batched_gs(
        config, p_a, w_a, consts, 5, start_iteration=5, phase_ff=pf_a, fixed=fx_a)
    for got, ref in ((p_b, p_f), (w_b, w_f), (pf_b, pf_f), (fx_b, fx_f),
                     (torch.cat([s_a, s_b]), s_f)):
        assert torch.equal(got, ref)


def test_run_batched_gs_resume_matches_jax():
    """A resumed segment of the port against the JAX package's, from the
    same first segment's state."""
    method, *_ = CASES["WGS-Kim"]
    config, consts, psi0, weights0, _ = _both("WGS-Kim")
    targets, kernels, _, pw = _problem(0)
    jconfig = JM.BatchedGSConfig(method=method, shape=(N, N), slm_shape=(N, N), n_planes=B)
    jconsts = JM.make_multiplane_consts(targets, kernels, pw, 1.0 / N, fix_phase_iteration=3)
    first = JM.run_batched_gs(jconfig, jnp.asarray(psi0), jnp.asarray(weights0), jconsts, 2)
    ref = [np.asarray(x) for x in JM.run_batched_gs(
        jconfig, first[0], first[1], jconsts, 6, start_iteration=2, phase_ff=first[3],
        fixed=first[4])]
    got = TM.run_batched_gs(config, np.asarray(first[0]), np.asarray(first[1]), consts, 6,
                            start_iteration=2, phase_ff=np.asarray(first[3]),
                            fixed=np.asarray(first[4]))
    _assert_run(got, ref, weights0)


@pytest.mark.parametrize("mraf", [False, True])
def test_multiplane_batched_model_matches_jax(mraf):
    """``models.parallel_models.multiplane_batched`` in both packages, six
    iterations from the same seed."""
    ref = [np.asarray(x) for x in JPM.multiplane_batched(B, N=N, mraf=mraf)(None, 6)]
    run = TPM.multiplane_batched(B, N=N, mraf=mraf, device="cpu")
    _assert_run(run(None, 6), ref, run.weights0.numpy())


def test_run_batched_gs_refuses_a_mesh():
    """A mesh whose axis the planes do not divide is refused; one they
    divide runs them there (``tests/test_torch_parallel.py`` holds the mesh
    runs against the JAX package), here as the one-device run."""
    config, consts, psi0, weights0, ref = _both("GS")
    with pytest.raises(ValueError, match=f"Plane count {B} must divide the mesh axis 'data'"):
        TM.run_batched_gs(config, psi0, weights0, consts, 1,
                          mesh=make_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="must divide"):
        TPM.multiplane_batched(B, N=N, device="cpu")(make_mesh(devices=["cpu"] * 2), 1)
    _assert_run(TM.run_batched_gs(config, psi0, weights0, consts, 8,
                                  mesh=make_mesh(devices=["cpu"] * B)), ref, weights0)


def test_batched_gate_takes_the_plain_tier_on_other_cuda_stacks():
    """The kernels' gate reads a stack's last two sides: a CUDA (B, 100,
    128) stack takes the plain tier (counted in PLAIN_ON_DEVICE), where a
    (B, 128, 128) or a (B, 96, 128) one takes the kernels; the batched
    engine on a device that is neither the CPU nor CUDA raises before any
    launch, without naming a ROADMAP entry."""
    def fake_cuda(shape):
        return types.SimpleNamespace(device=torch.device("cuda"), is_cuda=True, shape=shape)

    TF.reset_plain_count()
    assert TF.use_kernels(fake_cuda((B, 128, 128))) is True
    assert TF.use_kernels(fake_cuda((B, 96, 128))) is True
    assert TF.PLAIN_ON_DEVICE == 0
    assert TF.use_kernels(fake_cuda((B, 100, 128))) is False
    assert TF.PLAIN_ON_DEVICE == 1
    TF.reset_plain_count()
    shape = (100, 128)
    config = TM.BatchedGSConfig(method="WGS-Kim", shape=shape, slm_shape=shape, n_planes=B)
    consts = TM.make_multiplane_consts(np.ones((B, *shape)), np.zeros((B, *shape)),
                                       np.ones(B), 0.01, device="meta")
    cuda_fft.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="CPU or on a CUDA device"):
        TM.run_batched_gs(config, torch.zeros(shape, device="meta"),
                          torch.zeros((B, *shape), device="meta"), consts, 1)
    assert sum(cuda_fft.LAUNCHES.values()) == 0


# ----------------------------------------------------------------------
# MultiplaneHologram.
# ----------------------------------------------------------------------


def _children(module, kind="Hologram", shape=(N, N)):
    """B children: 3x3 spot arrays shifted per plane behind random kernels
    (Hologram), or 3x3 knm spot arrays (SpotHologram), on an amplitude plane."""
    amp = np.ones(shape, np.float32)
    out = []
    for b in range(B):
        if kind == "SpotHologram":
            out.append(module.SpotHologram.make_rectangular_array(
                shape, array_shape=(3, 3), array_pitch=(8, 8), array_center=(30 + 2 * b, 32),
                basis="knm"))
            continue
        target = np.zeros(shape, np.float32)
        idx = ((np.arange(3) - 1) * 8 + shape[0] // 2 + 2 * b).astype(int)
        xs, ys = np.meshgrid(idx, idx)
        target[ys.ravel(), xs.ravel()] = 1.0
        kernel = 0.5 * np.random.default_rng(b).uniform(-1, 1, shape).astype(np.float32)
        out.append(module.Hologram(target, amp=amp.copy(), slm_shape=shape,
                                   propagation_kernel=kernel))
    return out


def _pair(kind="Hologram"):
    np.random.seed(0)
    jholo = J.MultiplaneHologram(_children(J, kind), weights=[1, 2, 3])
    return jholo, convert.multiplane_hologram_from_jax(jholo, device="cpu")


def _optimize_both(jholo, tholo, method, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jholo.optimize(method, verbose=False, **kwargs)
    tholo.optimize(method, verbose=False, **kwargs)


def _assert_holograms(jholo, tholo, groups=("computational",)):
    assert tholo.iter == jholo.iter
    assert _phase_err(tholo.phase, jholo.phase) < PHASE_ATOL
    for jc, tc in zip(jholo.holograms, tholo.holograms):
        assert tc.iter == jc.iter
        assert tc.flags["fixed_phase"] == jc.flags["fixed_phase"]
        jw, tw = np.asarray(jc.weights), np.asarray(tc.weights)
        np.testing.assert_allclose(tw / np.abs(jw).max(), jw / np.abs(jw).max(),
                                   atol=WEIGHT_RTOL)
        for group in groups:
            keys = ("efficiency", "uniformity", "pkpk_err", "std_err")
            _assert_stats(np.stack([tc.stats["stats"][group][k] for k in keys], axis=-1),
                          np.stack([jc.stats["stats"][group][k] for k in keys], axis=-1))
        assert tc.stats["flags"]["fixed_phase"] == jc.stats["flags"]["fixed_phase"]


@pytest.mark.parametrize("method", ["GS", "WGS-Kim", "WGS-Leonardo"])
def test_multiplane_hologram_batched_path_matches_jax(method, monkeypatch):
    """A homogeneous computational problem runs the batched engine (and
    not the meta loop) in both packages, and ends in the same state."""
    jholo, tholo = _pair()
    taken = []
    batched = T.MultiplaneHologram._optimize_gs_batched
    monkeypatch.setattr(T.MultiplaneHologram, "_optimize_gs_batched",
                        lambda self, *a: taken.append(1) or batched(self, *a))
    _optimize_both(jholo, tholo, method, maxiter=6, stat_groups=["computational"],
                   fix_phase_iteration=3)
    assert taken == [1]
    assert type(tholo)._psi.resident(tholo) is not None  # The phase stays on the device.
    _assert_holograms(jholo, tholo)


def test_multiplane_hologram_batched_resume_matches_jax():
    """Two optimize calls on the batched path in both packages: the second
    resumes from the children's iteration count, Kim flags and store."""
    jholo, tholo = _pair()
    for maxiter in (4, 3):
        _optimize_both(jholo, tholo, "WGS-Kim", maxiter=maxiter,
                       stat_groups=["computational"], fix_phase_iteration=3)
    _assert_holograms(jholo, tholo)
    assert tholo.iter == 7


@pytest.mark.parametrize("kind", ["Hologram", "SpotHologram"])
@pytest.mark.parametrize("method", ["GS", "WGS-Kim"])
def test_multiplane_hologram_meta_loop_matches_jax(kind, method):
    """A callback (and SpotHologram children) takes the host meta loop in
    both packages; the callback sees the parent each iteration and stops
    the loop when it returns True."""
    jholo, tholo = _pair(kind)
    seen = {"J": [], "T": []}

    def callback(tag):
        return lambda h: seen[tag].append(h.iter) or h.iter == 4

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jholo.optimize(method, maxiter=8, verbose=False, stat_groups=["computational"],
                       fix_phase_iteration=3, callback=callback("J"))
    tholo.optimize(method, maxiter=8, verbose=False, stat_groups=["computational"],
                   fix_phase_iteration=3, callback=callback("T"))
    assert seen["T"] == seen["J"] == [0, 1, 2, 3, 4]
    _assert_holograms(jholo, tholo)


def test_multiplane_hologram_meta_loop_launches(kernel_route):
    """Each host meta iteration runs, per child, the forward fft2
    (``rows_fft``, ``cols_fft``) and the complex backward ``wexp_ifft2``
    (``cols_wexp_inv``, ``rows_fft``): the complex windows are summed
    before the angle is taken."""
    _, tholo = _pair()
    tholo.optimize("WGS-Kim", maxiter=2, verbose=False, stat_groups=["computational"],
                   callback=lambda h: False)
    # Two iterations, then the parent's _populate_results (one fft2).
    assert {k: v for k, v in kernel_route.items() if v} == dict(
        rows_fft=4 * B + 1, cols_fft=2 * B + 1, cols_wexp_inv=2 * B)


def test_multiplane_hologram_plumbing():
    """set_target raises, recursion and non-hologram children are refused,
    the plane weights are normalized, the children share the parent's
    amplitude, and flags reach the children."""
    np.random.seed(0)
    tholo = T.MultiplaneHologram(_children(T), weights=[1, 2, 3])
    assert len(tholo) == B
    assert np.isclose(np.sum(np.square(tholo.weights)), 1)
    np.testing.assert_allclose(tholo.weights, np.array([1, 2, 3]) / np.sqrt(14), rtol=1e-6)
    assert all(h.amp is tholo.amp for h in tholo.holograms)
    with pytest.raises(RuntimeError, match="child holograms directly"):
        tholo.set_target(None)
    with pytest.raises(ValueError, match="recursion"):
        T.MultiplaneHologram([tholo])
    with pytest.raises(ValueError, match="child holograms"):
        T.MultiplaneHologram([np.zeros((N, N))])
    tholo._update_flags("WGS-Kim", False, None, ["computational"], feedback_exponent=0.7)
    assert all(h.flags["feedback_exponent"] == 0.7 for h in tholo.holograms)
    jholo, _ = _pair()
    np.testing.assert_allclose(tholo.weights, jholo.weights, rtol=1e-6)


def test_propagation_kernel_is_uploaded_once_while_unchanged():
    """Each child's kernel reaches the device once: the same tensor on every
    call (a CG call of a multiplane hologram made one upload a child), a new
    one after the kernel is replaced or edited in place, with its values."""
    holo = T.MultiplaneHologram(_children(T))
    child = holo.holograms[1]
    first = child._kernel_device()
    assert first is child._kernel_device()
    np.testing.assert_array_equal(first.numpy(), child.propagation_kernel)
    child.propagation_kernel[:] += 1
    edited = child._kernel_device()
    assert edited is not first
    np.testing.assert_array_equal(edited.numpy(), child.propagation_kernel)
    child.propagation_kernel = child.propagation_kernel * 2
    assert child._kernel_device() is not edited
    np.testing.assert_array_equal(child._kernel_device().numpy(), child.propagation_kernel)
    assert T.Hologram(np.ones((N, N)), device="cpu")._kernel_device() is None


def test_multiplane_hologram_refusals():
    """``optimize(mesh=...)`` on a mesh the planes do not divide warns and
    runs the host meta loop, as in the JAX package
    (``tests/test_torch_parallel.py`` holds the mesh runs); ``"CG"``, which
    raised before it was ported, runs (``tests/test_torch_cg.py`` holds it
    against the JAX package); a callback, a host stat group or
    ``zero_factor`` keeps the batched engine off."""
    _, tholo = _pair()
    with pytest.warns(UserWarning, match="mesh-sharded multiplane optimization unavailable"):
        tholo.optimize("WGS-Kim", maxiter=1, verbose=False,
                       mesh=make_mesh(devices=["cpu"] * 2))
    tholo.optimize("CG", maxiter=1, verbose=False, mesh=None)
    assert tholo.iter == 2 and all(h.iter == 2 for h in tholo.holograms)
    assert tholo._mesh is None
    tholo._update_flags("WGS-Kim", False, None, ["computational"])
    assert tholo._mesh_eligible(None)
    assert not tholo._mesh_eligible(lambda h: False)
    tholo._update_flags("WGS-Kim", False, None, ["computational", "computational_spot"])
    assert not tholo._mesh_eligible(None)
    tholo._update_flags("WGS-Kim", False, None, ["computational"])
    tholo.holograms[1].flags["zero_factor"] = 0.1
    assert not tholo._mesh_eligible(None)


#: The defocus blur against cv2, over the stack's maximum: cv2 blurs a
#: float32 image in float32 (its rounding), a float64 one in float64; the
#: port blurs both in float64.
BLUR_RTOL = {np.float32: 1e-6, np.float64: 1e-12}


def _blur_rig():
    from slmsuite_tpu.hardware.cameras.simulated import SimulatedCamera as JCamera
    from slmsuite_tpu.hardware.cameraslms import FourierSLM as JFourierSLM
    from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM as JSLM

    side = 128
    slm = JSLM(resolution=(side, side), pitch_um=(8, 8), wav_um=0.78)
    slm.set_source_analytic("gaussian2d", sim=True, x0=0, y0=0, a=1, c=0,
                            wx=0.35 * side * slm.pitch[0], wy=0.35 * side * slm.pitch[1])
    cam = JCamera(slm, resolution=(side, side), pitch_um=(5.5, 5.5))
    cam.set_exposure(1.0)
    fs = JFourierSLM(cam, slm)
    fs.fourier_calibrate_analytic(np.array([[2.0e3, 50.0], [-50.0, 2.0e3]]),
                                  np.array([[64.0], [64.0]]))
    return fs, convert.rig_from_jax(fs, device="cpu")


@pytest.mark.parametrize("sharp_focus", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_defocus_blur_matches_cv2_version(sharp_focus, dtype):
    """``get_multiplane_defocus_blur`` without cv2 against the JAX
    package's ``cv2.GaussianBlur``: blur widths from 1 (none) through
    OpenCV's small tables to sampled Gaussians wider than the image, with
    its reflect-101 borders."""
    pytest.importorskip("cv2")
    jfs, tfs = _blur_rig()
    rng = np.random.default_rng(3)
    images = (rng.uniform(size=(4, 40, 56)) * (rng.uniform(size=(4, 40, 56)) > 0.9))
    images = images.astype(dtype)
    depths = [0.0, 5e-4, 1e-3, 5e-3]
    for returns in (None, [0.0, 2e-3, 1e-2]):
        ref = J.MultiplaneHologram.get_multiplane_defocus_blur(
            jfs, images, depths, return_depths=returns, sharp_focus=sharp_focus)
        got = T.MultiplaneHologram.get_multiplane_defocus_blur(
            tfs, images, depths, return_depths=returns, sharp_focus=sharp_focus, device="cpu")
        assert got.shape == ref.shape and got.dtype == np.float64
        np.testing.assert_allclose(got, ref, atol=BLUR_RTOL[dtype] * np.abs(ref).max(), rtol=0)
    with pytest.raises(ValueError, match="3D stack"):
        T.MultiplaneHologram.get_multiplane_defocus_blur(tfs, images[0], depths[:1])
    with pytest.raises(ValueError, match="same number"):
        T.MultiplaneHologram.get_multiplane_defocus_blur(tfs, images, depths[:2])
