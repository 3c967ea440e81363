"""
The mesh engines of the port against ``slmsuite_tpu`` on the CPU: the
mesh, its collectives, the distributed 2D FFT, the row-sharded plane, the
batched multiplane engine over a ``data`` axis, the pixel-sharded
compressed spots, ``run_gs_batch`` and ``optimize_batch`` over a mesh, the
public ``optimize(mesh=...)`` of ``Hologram``, ``MultiplaneHologram`` and
``CompressedSpotHologram``, the mesh models and ``dryrun_multichip``.

The JAX side runs on a mesh of 4 of the 8 virtual CPU devices that
``tests/conftest.py`` makes; the port on ``make_mesh(devices=[cpu] * 4)``,
one process, every exchange made. Inputs are the same, seeded with numpy.
Each mesh run is also held against the port's own meshless run, and the
engines also run through the kernels' wrappers (counting plain versions),
which each shard calls once a step.

Bounds are ``tests/test_parallel.py``'s: the plane's wrapped psi within
5e-4 and efficiency within 1e-4; the multiplane's wrapped psi within 5e-4
and stats within 1e-3 (its efficiency within 1e-4); the compressed
wrapped psi within 1e-3, ``amp_ff`` within 1e-5 and uniformity within
1e-4. Stats against the JAX package add
the std_err slack of ``tests/test_torch_multiplane.py``
(``sqrt(eps32) (1 - efficiency)``, the JAX package's f32 variance).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slmsuite_torch
from slmsuite_torch import convert
from slmsuite_torch.holography import algorithms as T
from slmsuite_torch.models import parallel_models as TPM
from slmsuite_torch.ops import collectives as C
from slmsuite_torch.ops import compressed as TC
from slmsuite_torch.ops import cuda_compressed, cuda_fft
from slmsuite_torch.ops import engine as TE
from slmsuite_torch.ops import fft as TF
from slmsuite_torch.parallel import compressed as TPC
from slmsuite_torch.parallel import fft2d as TFD
from slmsuite_torch.parallel import mesh as TMESH
from slmsuite_torch.parallel import multiplane as TM
from slmsuite_torch.parallel import plane as TP
from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM as JSLM
from slmsuite_torch.hardware.slms.simulated import SimulatedSLM as TSLM
from slmsuite_tpu.holography import algorithms as J
from slmsuite_tpu.models import parallel_models as JPM
from slmsuite_tpu.ops import compressed as JC
from slmsuite_tpu.ops import engine as JE
from slmsuite_tpu.parallel import compressed as JPC
from slmsuite_tpu.parallel import fft2d as JFD
from slmsuite_tpu.parallel import mesh as JMESH
from slmsuite_tpu.parallel import multiplane as JM
from slmsuite_tpu.parallel import plane as JP

D = 4
CPU = torch.device("cpu")
PLANE_PSI, PLANE_EFF = 5e-4, 1e-4
MP_PSI, MP_STATS, MP_EFF = 5e-4, 1e-3, 1e-4
CMP_PSI, CMP_AMP, CMP_UNIFORMITY = 1e-3, 1e-5, 1e-4
STATS_ATOL, STATS_RTOL = 1e-4, 1e-3
STAT_KEYS = ("efficiency", "uniformity", "pkpk_err", "std_err")


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


def _meshes(axis):
    """The port's 4-shard CPU mesh and the JAX package's on 4 of its 8
    virtual devices, on one axis."""
    return (TMESH.make_mesh(axis_names=(axis,), devices=[CPU] * D),
            JMESH.make_mesh(axis_names=(axis,), devices=jax.devices()[:D]))


def _wrapped(a, b):
    d = np.asarray(a, float) - np.asarray(b, float)
    return np.abs(np.mod(d + np.pi, 2 * np.pi) - np.pi)


def _assert_stats(got, ref):
    """Stats columns [efficiency, uniformity, pkpk_err, std_err] at
    STATS_ATOL / STATS_RTOL, std_err with the f32-variance slack."""
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    np.testing.assert_allclose(got[..., :3], ref[..., :3], atol=STATS_ATOL, rtol=STATS_RTOL)
    cancel = np.sqrt(np.finfo(np.float32).eps) * np.abs(1 - ref[..., 0])
    bad = np.abs(got[..., 3] - ref[..., 3]) > STATS_ATOL + STATS_RTOL * np.abs(ref[..., 3]) + cancel
    assert not bad.any(), (got[..., 3][bad], ref[..., 3][bad])


@pytest.fixture
def kernel_route(monkeypatch):
    """The kernels' gates true for CPU tensors and each wrapper a counting
    plain version, as ``tests/test_torch_multiplane.py``'s ``kernel_route``:
    the engines' launches counted as the card counts them."""
    for gate in ("use_kernels", "use_row_kernels"):
        monkeypatch.setattr(TF, gate, lambda x: True)
    monkeypatch.setattr(TC, "_on_card", lambda x: True)
    plain = {
        cuda_fft: (("carry_entry", TF._wgs_carry_entry), ("carry_exit", TF._wgs_carry_exit),
                   ("rows_fft", TF._rows_fft), ("cols_fft", TF._cols_fft),
                   ("cols_fwd_polar", TF._cols_fwd_polar),
                   ("cols_wexp_inv", TF._cols_wexp_inv)),
        cuda_compressed: (("f2n", TC._farfield_to_nearfield),
                          ("n2f", TC._nearfield_to_farfield),
                          ("fused_iter", TC._fused_iteration)),
    }
    for module, pairs in plain.items():
        for name, fn in pairs:
            def counted(*args, _module=module, _name=name, _fn=fn, **kwargs):
                _module.LAUNCHES[_name] += 1
                return _fn(*args, **kwargs)

            monkeypatch.setattr(module, name, counted)
    for module in plain:
        module.reset_launch_counts()
    yield lambda: {k: v for m in plain for k, v in m.LAUNCHES.items() if v}
    for module in plain:
        module.reset_launch_counts()


# ----------------------------------------------------------------------
# The mesh and its collectives.
# ----------------------------------------------------------------------


def test_make_mesh_matches_jax():
    """Shapes, axes, the devices along an axis, a repeated device, and the
    JAX package's error for axes that do not multiply to the count."""
    tmesh = TMESH.make_mesh(axis_sizes=(2, 2), axis_names=("data", "rows"),
                            devices=[CPU] * 4)
    jmesh = JMESH.make_mesh(axis_sizes=(2, 2), axis_names=("data", "rows"),
                            devices=jax.devices()[:4])
    assert dict(tmesh.shape) == dict(jmesh.shape) == {"data": 2, "rows": 2}
    assert list(tmesh.shape) == ["data", "rows"] and tmesh.axis_names == jmesh.axis_names
    assert tmesh.size == 4 and tmesh.axis_devices("rows") == [CPU, CPU]
    assert TMESH.make_mesh(devices=["cpu"] * 3).shape == {"data": 3}
    with pytest.raises(ValueError, match="no axis"):
        tmesh.axis_devices("pixels")
    messages = []
    for module, devices in ((TMESH, [CPU] * 4), (JMESH, jax.devices()[:4])):
        with pytest.raises(ValueError) as err:
            module.make_mesh(axis_sizes=(3,), axis_names=("data",), devices=devices)
        messages.append(str(err.value))
    assert messages[0] == messages[1] == "Mesh axes (3,) do not multiply to device count 4."
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TMESH.make_mesh()


def test_collectives():
    """Rank-order reductions on every shard, all_to_all tiled and untiled
    (``jax.lax.all_to_all``'s layout), split and gather."""
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.normal(size=(4, 8)).astype(np.float32)) for _ in range(D)]
    stacked = np.stack([x.numpy() for x in xs])
    for fn, ref in ((C.psum, stacked.sum(0)), (C.pmin, stacked.min(0)),
                    (C.pmax, stacked.max(0))):
        out = fn(xs)
        assert len(out) == D
        for o in out:
            np.testing.assert_allclose(o.numpy(), ref, rtol=1e-6)
    total = xs[0] + xs[1] + xs[2] + xs[3]
    assert torch.equal(C.reduce_sum(xs), total)  # Rank order: bit for bit.
    tiled = C.all_to_all(xs, split_axis=1, concat_axis=0)
    for d, out in enumerate(tiled):
        assert torch.equal(out, torch.cat([x[:, 2 * d:2 * d + 2] for x in xs], dim=0))
    untiled = C.all_to_all(xs, split_axis=0, concat_axis=0, tiled=False)
    for d, out in enumerate(untiled):
        assert torch.equal(out, torch.stack([x[d] for x in xs]))
    with pytest.raises(ValueError, match="equal chunks"):
        C.all_to_all([x[:, :7] for x in xs], split_axis=1, concat_axis=0)
    plane = torch.arange(32.0).reshape(8, 4)
    parts = C.split(plane, [CPU] * D)
    assert [tuple(p.shape) for p in parts] == [(2, 4)] * D
    assert all(p.is_contiguous() for p in C.split(plane, [CPU] * 2, axis=1))
    assert torch.equal(C.gather(parts, CPU), plane)
    with pytest.raises(ValueError, match="does not divide"):
        C.split(plane, [CPU] * 3)


# ----------------------------------------------------------------------
# The distributed 2D FFT and the row gate.
# ----------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 64), (32, 128)])
def test_distributed_fft2_matches_dense_and_jax(shape):
    """The ortho transform and its inverse against ``torch.fft.fft2`` and
    the JAX package's on 4 devices; the round trip returns the input."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    tmesh, jmesh = _meshes("space")
    y = TFD.distributed_fft2(torch.as_tensor(x), tmesh)
    dense = torch.fft.fft2(torch.as_tensor(x), norm="ortho")
    scale = float(dense.abs().max())
    assert float((y - dense).abs().max()) < 1e-5 * scale
    jy = np.asarray(JFD.distributed_fft2(jnp.asarray(x), jmesh))
    assert np.abs(y.numpy() - jy).max() < 1e-5 * scale
    back = TFD.distributed_ifft2(y, tmesh)
    assert float((back - torch.as_tensor(x)).abs().max()) < 1e-5 * np.abs(x).max()
    np.testing.assert_allclose(
        TFD.distributed_ifft2(torch.as_tensor(x), tmesh).numpy(),
        torch.fft.ifft2(torch.as_tensor(x), norm="ortho").numpy(), atol=1e-5 * np.abs(x).max())


def test_distributed_fft2_indivisible_raises_like_jax():
    tmesh, jmesh = _meshes("space")
    messages = []
    for fn, x in ((TFD.distributed_fft2, torch.zeros((64, 66), dtype=torch.complex64)),
                  (JFD.distributed_fft2, jnp.zeros((64, 66), jnp.complex64)),
                  (TFD.distributed_ifft2, torch.zeros((66, 64), dtype=torch.complex64))):
        with pytest.raises(ValueError, match="divisible by the mesh axis 'space'") as err:
            fn(x, tmesh if fn is not JFD.distributed_fft2 else jmesh)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def _fake_cuda(shape):
    import types

    return types.SimpleNamespace(device=torch.device("cuda"), is_cuda=True, shape=shape)


def test_row_gate_reads_the_line_length():
    """Row-only transforms take a shard of any multiple of 8 rows whose line
    the kernels take (a 256-row plane over 8 shards has 32; a 64-row plane
    over 8, 8), and take the plain tier on the card for a line or a row
    count they do not take; the plane gate still reads both sides. A shard
    on a device that is neither the CPU nor CUDA raises before any launch."""
    for shape in ((32, 256), (8, 64), (16, 8192), (2, 24, 1920)):
        assert TF.use_row_kernels(_fake_cuda(shape)) is True
    TF.reset_plain_count()
    for shape in ((32, 100), (12, 256), (16, 16384), (16, 32)):
        assert TF.use_row_kernels(_fake_cuda(shape)) is False
    assert TF.use_kernels(_fake_cuda((32, 256))) is False
    assert TF.PLAIN_ON_DEVICE == 5
    TF.reset_plain_count()
    assert TF.use_row_kernels(torch.zeros((3, 5))) is False
    x = torch.randn(16, 64)
    for got, ref in zip(TF.rows_fft(x, x.flip(0), inverse=True, scale=0.5),
                        TF._rows_fft(x, x.flip(0), inverse=True, scale=0.5)):
        assert torch.equal(got, ref)
    assert torch.equal(TF.wgs_carry_exit(*TF.wgs_carry_entry(x, 1.0)),
                       TF._wgs_carry_exit(*TF._wgs_carry_entry(x, 1.0)))
    meta = TMESH.make_mesh(axis_names=("rows",), devices=["meta"] * D)
    run = TPM.sharded_plane_wgs(N=64, device="cpu")
    cuda_fft.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="CPU or on a CUDA device"):
        TFD.distributed_fft2(torch.zeros((64, 64), dtype=torch.complex64, device="meta"), meta,
                             axis_name="rows")
    with pytest.raises(NotImplementedError, match="CPU or on a CUDA device"):
        run(meta, 1)
    assert sum(cuda_fft.LAUNCHES.values()) == 0


# ----------------------------------------------------------------------
# The row-sharded plane.
# ----------------------------------------------------------------------


@pytest.mark.parametrize("method", ["WGS-Kim", "GS", "WGS-Nogrette"])
def test_sharded_plane_model_matches_jax_and_meshless(method):
    """``sharded_plane_wgs`` in both packages on 4 shards, and the port's
    engine on one device (``run_gs``) from the same state."""
    tmesh, jmesh = _meshes("rows")
    state, stats = TPM.sharded_plane_wgs(64, method=method, device="cpu")(tmesh, 8)
    jstate, jstats = JPM.sharded_plane_wgs(64, method=method)(jmesh, 8)
    assert _wrapped(state.psi, jstate.psi).max() < PLANE_PSI
    _assert_stats(stats[:, 0].numpy(), np.asarray(jstats)[:, 0])
    np.testing.assert_array_equal(stats[:, 1, 1].numpy(), np.asarray(jstats)[:, 1, 1])
    np.testing.assert_allclose(state.weights.numpy(), np.asarray(jstate.weights), atol=1e-5)
    assert int(state.iteration) == 8 and bool(state.fixed_phase) == bool(jstate.fixed_phase)

    config = TE.GSConfig(method=method, shape=(64, 64), slm_shape=(64, 64),
                         stat_groups=("computational",))
    run = TPM.sharded_plane_wgs(64, method=method, device="cpu")
    one = run(TMESH.make_mesh(axis_names=("rows",), devices=[CPU]), 8)
    single = TE.run_gs(config, *_plane_model_inputs(method), 8)
    for other in (one, single):
        assert _wrapped(state.psi, other[0].psi).max() < PLANE_PSI
        np.testing.assert_allclose(stats[:, 0, 0].numpy(), other[1][:, 0, 0].numpy(),
                                   atol=PLANE_EFF)


def _plane_model_inputs(method):
    """``sharded_plane_wgs``'s state and consts, built as the model builds
    them, for the one-device engine."""
    from slmsuite_torch.ops.propagation import fold_phase

    rng = np.random.default_rng(0)
    N = 64
    target = np.zeros((N, N), np.float32)
    target[N // 2, N // 4] = target[N // 4, N // 2] = 1.0
    target /= np.sqrt((target**2).sum())
    config = TE.GSConfig(method=method, shape=(N, N), slm_shape=(N, N),
                         stat_groups=("computational",))
    state = TE.init_gs_state(config, fold_phase(
        rng.uniform(-np.pi, np.pi, (N, N)).astype(np.float32), (N, N)), target.copy(),
        device="cpu")
    consts = convert.consts_from_numpy(dict(
        amp=np.float32(1.0 / N), target=target, stat_mask=target != 0,
        feedback_exponent=np.float32(0.8), feedback_factor=np.float32(0.1),
        fix_phase_iteration=np.int32(5), fix_phase_efficiency=np.float32(np.nan)),
        device="cpu")
    return state, consts


def test_sharded_plane_launches_per_shard(kernel_route):
    """Per shard and iteration: ``carry_entry``, ``rows_fft`` twice and
    ``carry_exit``, the same result as the plain run."""
    tmesh, _ = _meshes("rows")
    state, _ = TPM.sharded_plane_wgs(64, device="cpu")(tmesh, 5)
    assert kernel_route() == {"carry_entry": 5 * D, "rows_fft": 2 * 5 * D, "carry_exit": 5 * D}
    assert state.psi.shape == (64, 64) and np.isfinite(state.psi.numpy()).all()


def _plane_target(mraf=False, seed=9):
    rng = np.random.default_rng(seed)
    target = np.zeros((64, 64), np.float32)
    ys, xs = np.mgrid[20:44:8, 16:48:8]
    target[ys.ravel(), xs.ravel()] = 1.0
    if mraf:
        noise = np.ones((64, 64), bool)
        noise[16:48, 12:52] = False
        target[noise] = np.nan
    return target, rng.uniform(-np.pi, np.pi, (64, 64)).astype(np.float32)


#: Plane cases: (method, flags, kernel, mraf, amplitude plane).
PLANE_CASES = {
    "WGS-Kim": ("WGS-Kim", dict(fix_phase_iteration=4), False, False, False),
    "WGS-Kim efficiency": ("WGS-Kim", dict(fix_phase_efficiency=0.5), False, False, False),
    "WGS-Leonardo kernel": ("WGS-Leonardo", {}, True, False, False),
    "WGS-Wu amplitude plane": ("WGS-Wu", {}, False, False, True),
    "MRAF WGS-Kim zero_factor": ("WGS-Kim", dict(mraf_factor=0.5, zero_factor=0.1), False,
                                 True, False),
}


def _plane_holograms(module, case):
    method, flags, kernel, mraf, amp_plane = PLANE_CASES[case]
    target, phi0 = _plane_target(mraf)
    kwargs = {}
    if amp_plane:
        amp = np.random.default_rng(3).uniform(0.5, 1.0, (64, 64)).astype(np.float32)
        kwargs["amp"] = amp / np.sqrt((amp**2).sum())
    holo = module.Hologram(target.copy(), **kwargs)
    if kernel:
        yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
        holo.propagation_kernel = (1e-3 * ((yy - 32) ** 2 + (xx - 32) ** 2)).astype(np.float32)
    holo.reset_phase(custom_phase=phi0)
    return holo, method, dict(flags, stat_groups=["computational"])


@pytest.mark.parametrize("case", list(PLANE_CASES))
def test_plane_hologram_mesh_matches_jax_and_meshless(case):
    """``Hologram.optimize(mesh=...)``: rows over 4 shards, in two calls (the
    mesh persists), against the JAX package's on 4 devices and the port's
    meshless run; no fallback warning."""
    tmesh, jmesh = _meshes("rows")
    runs = {}
    for label, module, mesh in (("port", T, tmesh), ("jax", J, jmesh), ("single", T, None)):
        holo, method, flags = _plane_holograms(module, case)
        with warnings.catch_warnings():
            warnings.simplefilter("error" if module is T else "ignore")
            holo.optimize(method, maxiter=6, verbose=False, mesh=mesh, **flags)
            holo.optimize(method, maxiter=4, verbose=True, **flags)
        assert holo._mesh is mesh
        runs[label] = holo
    port, ref, single = runs["port"], runs["jax"], runs["single"]
    stats = {k: np.stack([h.stats["stats"]["computational"][s] for s in STAT_KEYS], -1)
             for k, h in runs.items()}
    for other in (ref, single):
        assert port.iter == other.iter == 10
        assert _wrapped(port.phase, other.phase).max() < PLANE_PSI
        assert port.flags["fixed_phase"] == other.flags["fixed_phase"]
    np.testing.assert_allclose(stats["port"][:, 0], stats["single"][:, 0], atol=PLANE_EFF)
    np.testing.assert_allclose(stats["port"][:, 0], stats["jax"][:, 0], atol=PLANE_EFF)
    _assert_stats(stats["port"], stats["jax"])
    assert port.stats["flags"]["fixed_phase"] == ref.stats["flags"]["fixed_phase"]
    if PLANE_CASES[case][3]:
        np.testing.assert_allclose(np.asarray(port.zero_weights), np.asarray(single.zero_weights),
                                   atol=1e-6)


def test_plane_mesh_fallbacks_warn_like_jax():
    """A padded farfield warns and runs on one device (the same run as
    without a mesh); a callback warns and runs the host loop; ``mesh=None``
    clears the mesh; the engine itself refuses the padded configuration."""
    tmesh, jmesh = _meshes("rows")
    target, phi0 = _plane_target()
    padded, full = {}, {}
    for module, mesh in ((T, tmesh), (J, jmesh)):
        holo = module.Hologram(target.copy(), slm_shape=(32, 32))
        holo.reset_phase(custom_phase=phi0[:32, :32])
        with pytest.warns(UserWarning, match="mesh-sharded plane optimization requires "
                                             "farfield shape == SLM shape"):
            holo.optimize("WGS-Kim", maxiter=3, verbose=False, mesh=mesh)
        other = module.Hologram(target.copy())
        with pytest.warns(UserWarning, match="requires the fully-computational path"):
            other.optimize("GS", maxiter=2, verbose=False, mesh=mesh, callback=lambda h: False)
        assert holo.iter == 3 and other.iter == 2 and other._mesh is mesh
        other.optimize("GS", maxiter=1, verbose=False, mesh=None)
        assert other._mesh is None
        padded[module], full[module] = holo._build_config(), other._build_config()
    assert not TP.plane_shardable(padded[T], D) and not JP.plane_shardable(padded[J], D)
    assert TP.plane_shardable(full[T], D) and JP.plane_shardable(full[J], D)
    assert not TP.plane_shardable(full[T], 3)
    solo = T.Hologram(target.copy(), slm_shape=(32, 32))
    solo.reset_phase(custom_phase=phi0[:32, :32])
    solo.optimize("WGS-Kim", maxiter=3, verbose=False)
    meshed = T.Hologram(target.copy(), slm_shape=(32, 32))
    meshed.reset_phase(custom_phase=phi0[:32, :32])
    with pytest.warns(UserWarning, match="running on a single device"):
        meshed.optimize("WGS-Kim", maxiter=3, verbose=False, mesh=tmesh)
    assert np.array_equal(solo.phase, meshed.phase)
    config = meshed._build_config()
    with pytest.raises(ValueError, match="not row-shardable"):
        TP.run_sharded_plane_gs(config, meshed._build_state(config),
                                meshed._build_consts(config), tmesh, 1)


# ----------------------------------------------------------------------
# Multiplane planes over a data axis.
# ----------------------------------------------------------------------

B, N = 8, 64


def _mp_problem(mraf=False, seed=0):
    """B 3x3 spot targets shifted per plane (nan outside a window with
    ``mraf``), random kernels, a random phase, growing plane weights."""
    rng = np.random.default_rng(seed)
    targets = np.zeros((B, N, N), np.float32)
    for b in range(B):
        idx = ((np.arange(3) - 1) * 8 + N // 2 + 2 * (b % 4)).astype(int)
        xs, ys = np.meshgrid(idx, idx + b // 4)
        targets[b, ys.ravel(), xs.ravel()] = 1.0
        targets[b] /= np.sqrt((targets[b] ** 2).sum())
        if mraf:
            noise = np.ones((N, N), bool)
            noise[N // 4:3 * N // 4, N // 4 + b % 4:3 * N // 4] = False
            targets[b, noise & (targets[b] == 0)] = np.nan
    kernels = np.stack([0.1 * (b + 1) * rng.uniform(-1, 1, (N, N)).astype(np.float32)
                        for b in range(B)])
    psi0 = rng.uniform(-np.pi, np.pi, (N, N)).astype(np.float32)
    pw = np.arange(1, B + 1, dtype=np.float32)
    return targets, kernels, psi0, pw / np.sqrt((pw**2).sum())


MP_CASES = {
    "GS": ("GS", False, None),
    "WGS-Kim": ("WGS-Kim", False, None),
    "WGS-Kim efficiency": ("WGS-Kim", False, 0.001),
    "MRAF WGS-Leonardo": ("WGS-Leonardo", True, None),
}


def _mp_both(case, n=6):
    method, mraf, efficiency = MP_CASES[case]
    targets, kernels, psi0, pw = _mp_problem(mraf)
    kw = dict(method=method, shape=(N, N), slm_shape=(N, N), n_planes=B,
              kim_efficiency_trigger=efficiency is not None, mraf=mraf, mraf_factor=mraf)
    jconfig = JM.BatchedGSConfig(**kw)
    consts = JM.make_multiplane_consts(targets, kernels, pw, 1.0 / N, fix_phase_iteration=3,
                                       fix_phase_efficiency=efficiency,
                                       mraf_factor=0.5 if mraf else None)
    weights0 = np.nan_to_num(targets)
    _, jmesh = _meshes("data")
    ref = [np.asarray(x) for x in JM.run_batched_gs(
        jconfig, jnp.asarray(psi0), jnp.asarray(weights0), consts, n, mesh=jmesh)]
    tconsts = convert.multiplane_consts_from_numpy(
        {k: np.asarray(v) for k, v in consts.items()}, device="cpu")
    return convert.batched_config_from_jax(jconfig), tconsts, psi0, weights0, ref


def _assert_mp(got, ref):
    psi, weights, stats, phase_ff, fixed = (np.asarray(x) for x in got)
    jpsi, jweights, jstats, jphase_ff, jfixed = (np.asarray(x) for x in ref)
    assert stats.shape == jstats.shape
    np.testing.assert_allclose(stats[..., 0], jstats[..., 0], atol=MP_EFF)
    np.testing.assert_allclose(stats[..., :4], jstats[..., :4], atol=MP_STATS)
    np.testing.assert_array_equal(stats[..., 4], jstats[..., 4])
    assert _wrapped(psi, jpsi).max() < MP_PSI
    np.testing.assert_allclose(weights, jweights, atol=1e-5 * np.abs(jweights).max())
    np.testing.assert_array_equal(fixed, jfixed)


@pytest.mark.parametrize("case", list(MP_CASES))
def test_run_batched_gs_mesh_matches_jax_and_meshless(case):
    """8 planes over a data axis of 4, against the JAX package's mesh run
    and the port's one-device run, resumed for a second segment."""
    config, consts, psi0, weights0, ref = _mp_both(case)
    tmesh, _ = _meshes("data")
    got = TM.run_batched_gs(config, psi0, weights0, consts, 6, mesh=tmesh)
    _assert_mp(got, ref)
    single = TM.run_batched_gs(config, psi0, weights0, consts, 6)
    _assert_mp(got, single)
    resumed = [TM.run_batched_gs(config, got[0], got[1], consts, 3, mesh=m, start_iteration=6,
                                 phase_ff=got[3], fixed=got[4]) for m in (tmesh, None)]
    _assert_mp(*resumed)


def test_run_batched_gs_mesh_launches_per_shard(kernel_route):
    """Each shard runs its 2 planes as one stack: one launch of each
    kernel a shard and iteration (MRAF: ``cols_fft`` for ``cols_wexp_inv``)."""
    tmesh, _ = _meshes("data")
    for case, backward in (("WGS-Kim", "cols_wexp_inv"), ("MRAF WGS-Leonardo", "cols_fft")):
        config, consts, psi0, weights0, ref = _mp_both(case, n=4)
        cuda_fft.reset_launch_counts()
        got = TM.run_batched_gs(config, psi0, weights0, consts, 4, mesh=tmesh)
        assert kernel_route() == {"carry_entry": 4 * D, "cols_fwd_polar": 4 * D,
                                  backward: 4 * D, "rows_fft": 4 * D}
        _assert_mp(got, ref)


@pytest.mark.parametrize("mraf", [False, True])
def test_multiplane_batched_model_mesh_matches_jax(mraf):
    """``multiplane_batched``'s ``run(mesh, n)`` in both packages on 4
    shards, and the port's against its meshless run."""
    tmesh, jmesh = _meshes("data")
    method = "WGS-Leonardo" if mraf else "WGS-Kim"
    ref = JPM.multiplane_batched(B, N=N, method=method, mraf=mraf)(jmesh, 5)
    run = TPM.multiplane_batched(B, N=N, method=method, mraf=mraf, device="cpu")
    got = run(tmesh, 5)
    _assert_mp(got, ref)
    _assert_mp(got, run(None, 5))


def _mp_children(module, n_planes=B):
    amp = np.ones((N, N), np.float32)
    out = []
    for b in range(n_planes):
        target = np.zeros((N, N), np.float32)
        idx = ((np.arange(3) - 1) * 8 + N // 2 + 2 * (b % 4)).astype(int)
        xs, ys = np.meshgrid(idx, idx + b // 4)
        target[ys.ravel(), xs.ravel()] = 1.0
        kernel = 0.5 * np.random.default_rng(b).uniform(-1, 1, (N, N)).astype(np.float32)
        out.append(module.Hologram(target, amp=amp.copy(), slm_shape=(N, N),
                                   propagation_kernel=kernel))
    return out


def _mp_pair(n_planes=B):
    np.random.seed(0)
    jholo = J.MultiplaneHologram(_mp_children(J, n_planes), weights=np.arange(1, n_planes + 1))
    return jholo, convert.multiplane_hologram_from_jax(jholo, device="cpu")


def test_multiplane_hologram_mesh_matches_jax_and_meshless():
    """``MultiplaneHologram.optimize(mesh=...)``: 8 planes over 4 shards in
    both packages, and the port against its meshless run."""
    tmesh, jmesh = _meshes("data")
    jholo, tholo = _mp_pair()
    _, single = _mp_pair()
    kw = dict(maxiter=6, verbose=False, stat_groups=["computational"], fix_phase_iteration=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jholo.optimize("WGS-Kim", mesh=jmesh, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tholo.optimize("WGS-Kim", mesh=tmesh, **kw)
    single.optimize("WGS-Kim", **kw)
    assert tholo._mesh is tmesh and tholo.iter == jholo.iter == single.iter == 6
    for other in (jholo, single):
        assert _wrapped(tholo.phase, other.phase).max() < MP_PSI
        for tc, oc in zip(tholo.holograms, other.holograms):
            got = np.stack([tc.stats["stats"]["computational"][k] for k in STAT_KEYS], -1)
            ref = np.stack([oc.stats["stats"]["computational"][k] for k in STAT_KEYS], -1)
            np.testing.assert_allclose(got[:, 0], ref[:, 0], atol=MP_EFF)
            np.testing.assert_allclose(got, ref, atol=MP_STATS)
            assert tc.flags["fixed_phase"] == oc.flags["fixed_phase"]
            assert tc.stats["flags"]["fixed_phase"] == oc.stats["flags"]["fixed_phase"]


def test_multiplane_mesh_fallback_warns_like_jax():
    """3 planes do not divide a mesh of 4: both packages warn and run the
    host meta loop."""
    tmesh, jmesh = _meshes("data")
    jholo, tholo = _mp_pair(n_planes=3)
    for holo, mesh in ((jholo, jmesh), (tholo, tmesh)):
        with pytest.warns(UserWarning, match=r"mesh-sharded multiplane optimization "
                                             r"unavailable \(plane count 3 must divide "
                                             r"the mesh \(4\)\); running the host meta loop"):
            holo.optimize("WGS-Leonardo", maxiter=3, verbose=False, mesh=mesh)
        assert holo.iter == 3
    assert _wrapped(tholo.phase, jholo.phase).max() < 5e-3


# ----------------------------------------------------------------------
# Pixel-sharded compressed spots.
# ----------------------------------------------------------------------


def _cmp_setup(module, method="WGS-Kim", n_pixels=4096, n_spots=24):
    """``tests/test_parallel.py``'s compressed problem in either package."""
    rng = np.random.default_rng(7)
    basis = rng.normal(size=(4, n_pixels)).astype(np.float32) * 2
    coeffs = rng.normal(size=(4, n_spots)).astype(np.float32) * 10
    target = np.full(n_spots, 1 / np.sqrt(n_spots), np.float32)
    amp = np.full(n_pixels, 1 / np.sqrt(n_pixels), np.float32)
    psi0 = rng.uniform(-np.pi, np.pi, n_pixels).astype(np.float32)
    arrays = dict(amp=amp, coeffs=coeffs, basis=basis, target=target, stat_mask=target != 0,
                  feedback_exponent=np.float32(0.8), feedback_factor=np.float32(0.1),
                  fix_phase_iteration=np.int32(5), fix_phase_efficiency=np.float32(np.nan))
    state = dict(psi=psi0, weights=target.copy(), phase_ff=np.zeros(n_spots, np.float32),
                 fixed_phase=np.bool_(False), unfixed_streak=np.int32(0), iteration=np.int32(0))
    kw = dict(method=method, n_pixels=n_pixels, n_spots=n_spots,
              stat_groups=("computational_spot",))
    if module is JC:
        return (JC.CompressedGSConfig(use_pallas=False, **kw),
                JC.CompressedGSState(**{k: jnp.asarray(v) for k, v in state.items()}),
                {k: jnp.asarray(v) for k, v in arrays.items()})
    return (TC.CompressedGSConfig(**kw), convert.compressed_state_from_numpy(state, device="cpu"),
            convert.consts_from_numpy(arrays, device="cpu"))


@pytest.mark.parametrize("method", ["WGS-Kim", "GS"])
def test_sharded_compressed_matches_jax_and_meshless(method):
    """12 iterations over 4 pixel shards in both packages, and the port's
    mesh run against its one-device engine."""
    tmesh, jmesh = _meshes("pixels")
    config, state, consts = _cmp_setup(TC, method)
    got, stats = TPC.run_sharded_compressed_gs(
        config, state, TPC.shard_compressed_consts(consts, tmesh), tmesh, 12)
    jconfig, jstate, jconsts = _cmp_setup(JC, method)
    ref, jstats = JPC.run_sharded_compressed_gs(
        jconfig, jstate, JPC.shard_compressed_consts(jconsts, jmesh, "pixels"), jmesh, 12,
        "pixels")
    single, sstats = TC.run_compressed_gs(config, state, consts, 12)
    for other, ostats in ((ref, jstats), (single, sstats)):
        assert _wrapped(got.psi, np.asarray(other.psi)).max() < CMP_PSI
        np.testing.assert_allclose(got.weights.numpy(), np.asarray(other.weights), atol=CMP_AMP)
        ostats = np.asarray(ostats)
        np.testing.assert_allclose(stats[:, 0, 1].numpy(), ostats[:, 0, 1], atol=CMP_UNIFORMITY)
        _assert_stats(stats[:, 0].numpy(), ostats[:, 0])
        assert int(got.iteration) == int(other.iteration) == 12


def test_sharded_compressed_launches_per_shard(kernel_route):
    """Per shard: ``n2f`` at entry, ``fused_iter`` an iteration, ``f2n`` at
    exit (the round trip of the port's carry on each slab)."""
    tmesh, _ = _meshes("pixels")
    config, state, consts = _cmp_setup(TC)
    ref, _ = TC.run_compressed_gs(config, state, consts, 5)
    cuda_compressed.reset_launch_counts()
    got, _ = TPC.run_sharded_compressed_gs(
        config, state, TPC.shard_compressed_consts(consts, tmesh), tmesh, 5)
    assert kernel_route() == {"n2f": D, "fused_iter": 5 * D, "f2n": D}
    assert _wrapped(got.psi, ref.psi).max() < CMP_PSI


def test_shard_compressed_consts_refuses_like_jax():
    tmesh, jmesh = _meshes("pixels")
    messages = []
    for module, pmod, mesh in ((TC, TPC, tmesh), (JC, JPC, jmesh)):
        _, _, consts = _cmp_setup(module, n_pixels=4098)
        with pytest.raises(ValueError) as err:
            pmod.shard_compressed_consts(consts, mesh, "pixels")
        messages.append(str(err.value))
    assert messages[0] == messages[1] == "Pixel count 4098 must divide the mesh axis (4)."
    shards = TPC.shard_compressed_consts(_cmp_setup(TC)[2], tmesh)
    assert len(shards) == D and tuple(shards[0]["basis"].shape) == (4, 1024)
    assert shards[0]["basis"].is_contiguous() and tuple(shards[3]["amp"].shape) == (1024,)


def test_compressed_model_mesh_matches_jax():
    tmesh, jmesh = _meshes("pixels")
    state, stats = TPM.compressed_spots_3d(device="cpu")(tmesh, 6)
    jstate, jstats = JPM.compressed_spots_3d()(jmesh, 6)
    assert _wrapped(state.psi, np.asarray(jstate.psi)).max() < CMP_PSI
    np.testing.assert_allclose(state.weights.numpy(), np.asarray(jstate.weights), atol=CMP_AMP)
    _assert_stats(stats[:, 0].numpy(), np.asarray(jstats)[:, 0])


def _cmp_holograms(resolution=(64, 64)):
    rng = np.random.default_rng(8)
    vectors = np.vstack([rng.uniform(-8e-3, 8e-3, (2, 16)), rng.uniform(-2e-6, 2e-6, (1, 16))])
    kw = dict(pitch_um=(8, 8), wav_um=0.78)
    t = T.CompressedSpotHologram(vectors, basis="kxy", cameraslm=TSLM(resolution, **kw))
    j = J.CompressedSpotHologram(vectors, basis="kxy", cameraslm=JSLM(resolution, **kw))
    s = T.CompressedSpotHologram(vectors, basis="kxy", cameraslm=TSLM(resolution, **kw))
    phi0 = np.random.default_rng(9).uniform(-np.pi, np.pi, resolution).astype(np.float32)
    for holo in (t, j, s):
        holo.reset_phase(phi0)
    return t, j, s


def test_compressed_hologram_mesh_matches_jax_and_recomputing_loop(monkeypatch):
    """``CompressedSpotHologram.optimize(mesh=...)``: 16 3D spots on a 64^2
    SLM, pixels over 4, in two calls, against the JAX package's mesh run
    and the port's recomputing (cache-off) loop on one device; the cache is
    off under a mesh."""
    monkeypatch.setenv("SLMSUITE_TORCH_COMPRESSED_CACHE_MB", "0")
    tmesh, jmesh = _meshes("pixels")
    t, j, s = _cmp_holograms()
    kw = dict(stat_groups=["computational_spot"], fix_phase_iteration=3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t.optimize("WGS-Kim", maxiter=5, verbose=False, mesh=tmesh, **kw)
        assert not t._kernel_cache_enabled()
        t.optimize("WGS-Kim", maxiter=4, verbose=True, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j.optimize("WGS-Kim", maxiter=5, verbose=False, mesh=jmesh, **kw)
        j.optimize("WGS-Kim", maxiter=4, verbose=True, **kw)
    s.optimize("WGS-Kim", maxiter=5, verbose=False, **kw)
    s.optimize("WGS-Kim", maxiter=4, verbose=True, **kw)
    assert t._mesh is tmesh and t.iter == j.iter == s.iter == 9
    for other in (j, s):
        np.testing.assert_allclose(t.amp_ff, np.asarray(other.amp_ff), atol=CMP_AMP)
        np.testing.assert_allclose(t.weights, np.asarray(other.weights), atol=CMP_AMP)
        assert _wrapped(t.phase, other.phase).max() < CMP_PSI
        assert t.flags["fixed_phase"] == other.flags["fixed_phase"]
        stats = t.stats["stats"]["computational_spot"]
        ostats = other.stats["stats"]["computational_spot"]
        np.testing.assert_allclose(stats["uniformity"], ostats["uniformity"], atol=CMP_UNIFORMITY)
        np.testing.assert_allclose(stats["efficiency"], ostats["efficiency"], atol=STATS_ATOL)


def test_compressed_mesh_fallbacks_warn_like_jax():
    """3969 pixels do not divide a mesh of 4, and a callback needs the host
    loop: both packages warn and run on one device."""
    tmesh, jmesh = _meshes("pixels")
    t, j, _ = _cmp_holograms((63, 63))
    for holo, mesh in ((t, tmesh), (j, jmesh)):
        with pytest.warns(UserWarning, match=r"mesh-sharded compressed optimization unavailable "
                                             r"\(pixel count 3969 must divide the mesh \(4\)\); "
                                             r"running on a single device"):
            holo.optimize("WGS-Kim", maxiter=2, verbose=False, mesh=mesh)
        with pytest.warns(UserWarning, match="requires the fully-computational path"):
            holo.optimize("WGS-Kim", maxiter=2, verbose=False, callback=lambda h: False)
        assert holo.iter == 4
    np.testing.assert_allclose(t.weights, np.asarray(j.weights), atol=1e-4)


# ----------------------------------------------------------------------
# Independent holograms over a data axis.
# ----------------------------------------------------------------------


def _frame_target(t, shape=(64, 64), n_spots=5, seed=0):
    rng = np.random.default_rng(seed)
    radii = rng.uniform(0.15, 0.35, n_spots) * shape[0]
    phases = rng.uniform(0, 2 * np.pi, n_spots)
    target = np.zeros(shape, np.float32)
    for r, p0 in zip(radii, phases):
        target[int(shape[0] / 2 + r * np.sin(p0 + 0.15 * t)),
               int(shape[1] / 2 + r * np.cos(p0 + 0.15 * t))] = 1.0
    return target / np.sqrt((target**2).sum())


def _frames(module, K=D):
    phase0 = np.random.default_rng(1).uniform(-np.pi, np.pi, (64, 64)).astype(np.float32)
    frames = []
    for t in range(K):
        h = module.Hologram(_frame_target(t), slm_shape=(64, 64))
        h.reset_phase(phase0)
        frames.append(h)
    return frames


@pytest.mark.parametrize("method", ["WGS-Kim", "WGS-Nogrette"])
def test_optimize_batch_mesh_matches_jax_and_meshless(method):
    """4 frames over a data axis of 4 (the fused loop; the natural step):
    against the JAX package's mesh batch, and bit for bit against the
    port's meshless batch."""
    tmesh, jmesh = _meshes("data")
    kw = dict(maxiter=5, verbose=False, stat_groups=["computational"], fix_phase_iteration=3)
    mesh_batch, single, ref = _frames(T), _frames(T), _frames(J)
    T.optimize_batch(mesh_batch, method, mesh=tmesh, **kw)
    T.optimize_batch(single, method, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        J.optimize_batch(ref, method, mesh=jmesh, **kw)
    for t, s, j in zip(mesh_batch, single, ref):
        assert np.array_equal(t.phase, s.phase) and t.stats["stats"] == s.stats["stats"]
        assert t.iter == j.iter == 5 and t.flags["fixed_phase"] == j.flags["fixed_phase"]
        assert _wrapped(t.phase, j.phase).max() < 5e-3
        got = np.stack([t.stats["stats"]["computational"][k] for k in STAT_KEYS], -1)
        want = np.stack([j.stats["stats"]["computational"][k] for k in STAT_KEYS], -1)
        _assert_stats(got, want)


def test_run_gs_batch_mesh_refuses_an_indivisible_batch_like_jax():
    """3 instances over a mesh of 4: both packages' engines refuse with one
    message; the port's batch over a 3-device axis runs."""
    tmesh, jmesh = _meshes("data")
    messages = []
    for module, engine, mesh in ((T, TE, tmesh), (J, JE, jmesh)):
        frames = _frames(module, K=3)
        with pytest.raises(ValueError) as err:
            module.optimize_batch(frames, "GS", maxiter=1, verbose=False, mesh=mesh)
        messages.append(str(err.value))
    assert messages[0] == messages[1] == (
        "Batch size 3 must divide the mesh (4 devices) for sharded batch optimization.")
    frames = _frames(T, K=3)
    T.optimize_batch(frames, "GS", maxiter=2, verbose=False,
                     mesh=TMESH.make_mesh(devices=[CPU] * 3))
    assert all(h.iter == 2 for h in frames)


def test_dryrun_multichip_on_cpu_shards():
    """The port's dryrun: every mesh model on 4 CPU shards against its
    one-shard or meshless run, within the JAX package's bounds."""
    errors = TPM.dryrun_multichip(D, devices=[CPU] * D)
    assert set(errors) == {"multiplane stats", "multiplane MRAF stats", "compressed stats",
                           "compressed weights", "plane stats", "plane psi",
                           "optimize_batch phase"}
    with pytest.raises(ValueError, match="needs 4 devices"):
        TPM.dryrun_multichip(D, devices=[CPU] * 2)
