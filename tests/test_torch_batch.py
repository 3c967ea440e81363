"""
``optimize_batch`` and ``ops.engine.run_gs_batch`` of the port on the CPU:
against ``slmsuite_tpu``'s ``optimize_batch`` on the same frames
(``examples/batched_holography.py``'s rotating spot arrays, at 64^2, and a
32^2 SLM in a 64^2 farfield), against the port's own individual
``optimize`` calls (identical: each instance runs the engine's own loop),
a resumed batch, a batch over a mesh, and the refusals (a heterogeneous
batch, camera feedback, a mesh whose axis the batch does not divide).

Tolerances against the JAX package: stats 1e-4 abs / 1e-3 rel (the
goldens'; std_err also ``sqrt(eps32) (1 - efficiency)``, the uncertainty
of the JAX package's f32 variance), the unfolded phase 5e-3 rad wrapped
(the goldens'), weights 1e-5 of their maximum. Against the port's
individual runs: exact.
"""

import warnings

import numpy as np
import pytest
import torch

import jax

import slmsuite_torch
from slmsuite_torch.holography import algorithms as T
from slmsuite_torch.ops import engine as TE
from slmsuite_torch.parallel.mesh import make_mesh
from slmsuite_tpu.holography import algorithms as J
from slmsuite_tpu.parallel import mesh as JMESH


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


STATS_ATOL, STATS_RTOL = 1e-4, 1e-3
PHASE_ATOL = 5e-3
WEIGHT_RTOL = 1e-5
K = 3
STAT_KEYS = ("efficiency", "uniformity", "pkpk_err", "std_err")


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    slmsuite_torch.set_default_device("cpu")
    yield
    slmsuite_torch.set_default_device("cuda")
    torch.set_num_threads(threads)


def frame_target(shape, t, n_spots=5, seed=0):
    """examples/batched_holography.py's frame ``t``: a spot array rotating
    with the frame index."""
    rng = np.random.default_rng(seed)
    radii = rng.uniform(0.15, 0.35, n_spots) * shape[0]
    phases = rng.uniform(0, 2 * np.pi, n_spots)
    target = np.zeros(shape, np.float32)
    for r, p0 in zip(radii, phases):
        target[int(shape[0] / 2 + r * np.sin(p0 + 0.15 * t)),
               int(shape[1] / 2 + r * np.cos(p0 + 0.15 * t))] = 1.0
    return target / np.sqrt((target**2).sum())


def _frames(module, shape=(64, 64), slm=None, mraf=False):
    """K frames warm-started from one seeded phase (with ``mraf``, nan
    outside a central window: the MRAF noise region)."""
    slm = slm or shape
    phase0 = np.random.default_rng(1).uniform(-np.pi, np.pi, slm).astype(np.float32)
    frames = []
    for t in range(K):
        target = frame_target(shape, t)
        if mraf:
            window = np.zeros(shape, bool)
            window[8:56, 8:56] = True
            target[~window] = np.nan
        h = module.Hologram(target, slm_shape=slm)
        h.reset_phase(phase0)
        frames.append(h)
    return frames


def _phase_err(a, b):
    dp = np.asarray(a, float) - np.asarray(b, float)
    dp = np.mod(dp - dp.flat[0] + np.pi, 2 * np.pi) - np.pi
    return np.abs(dp).max()


def _stats(h):
    return np.stack([h.stats["stats"]["computational"][k] for k in STAT_KEYS], axis=-1)


def _assert_like_jax(t, j):
    assert t.iter == j.iter and t.flags["fixed_phase"] == j.flags["fixed_phase"]
    assert _phase_err(t.phase, j.phase) < PHASE_ATOL
    jw, tw = np.asarray(j.weights), np.asarray(t.weights)
    np.testing.assert_allclose(tw / np.abs(jw).max(), jw / np.abs(jw).max(), atol=WEIGHT_RTOL)
    got, ref = _stats(t), _stats(j)
    np.testing.assert_allclose(got[:, :3], ref[:, :3], atol=STATS_ATOL, rtol=STATS_RTOL)
    cancel = np.sqrt(np.finfo(np.float32).eps) * np.abs(1 - ref[:, 0])
    assert (np.abs(got[:, 3] - ref[:, 3]) <= STATS_ATOL + STATS_RTOL * np.abs(ref[:, 3])
            + cancel).all()
    assert t.stats["flags"]["fixed_phase"] == j.stats["flags"]["fixed_phase"]


#: (method, optimize flags, frame options): the fused carry loop (Kim,
#: Leonardo), the natural step (GS, Nogrette, the padded farfield) and the
#: MRAF carry loop.
CASES = {
    "WGS-Kim": ("WGS-Kim", dict(fix_phase_iteration=3), {}),
    "WGS-Leonardo": ("WGS-Leonardo", {}, {}),
    "GS": ("GS", {}, {}),
    "WGS-Nogrette": ("WGS-Nogrette", {}, {}),
    "WGS-Kim padded": ("WGS-Kim", {}, dict(slm=(32, 32))),
    "MRAF WGS-Leonardo": ("WGS-Leonardo", dict(mraf_factor=0.5), dict(mraf=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimize_batch_matches_jax(case):
    method, flags, options = CASES[case]
    jframes, tframes = _frames(J, **options), _frames(T, **options)
    kw = dict(maxiter=6, verbose=False, stat_groups=["computational"], **flags)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        J.optimize_batch(jframes, method, **kw)
    assert T.optimize_batch(tframes, method, **kw) is tframes
    for t, j in zip(tframes, jframes):
        _assert_like_jax(t, j)


@pytest.mark.parametrize("case", list(CASES))
def test_optimize_batch_equals_individual_runs(case):
    """Each frame of a batch ends exactly where its own ``optimize`` call
    ends: phase, weights, Kim store, flags and stats."""
    method, flags, options = CASES[case]
    batch, solo = _frames(T, **options), _frames(T, **options)
    kw = dict(maxiter=6, verbose=False, stat_groups=["computational"], **flags)
    T.optimize_batch(batch, method, **kw)
    for h in solo:
        h.optimize(method, **kw)
    for b, s in zip(batch, solo):
        assert np.array_equal(b.phase, s.phase)
        assert np.array_equal(np.asarray(b.weights), np.asarray(s.weights))
        assert np.array_equal(np.asarray(b._phase_ff_folded), np.asarray(s._phase_ff_folded))
        assert b.iter == s.iter == 6 and b.flags == s.flags
        assert b.stats["stats"] == s.stats["stats"]


def test_optimize_batch_resumes_like_individual_runs():
    """Two batches in a row (the second without stats, then with) equal
    two individual calls in a row for each frame."""
    batch, solo = _frames(T), _frames(T)
    for maxiter, groups in ((4, []), (3, ["computational"])):
        T.optimize_batch(batch, "WGS-Kim", maxiter=maxiter, verbose=False,
                         stat_groups=groups, fix_phase_iteration=3)
        for h in solo:
            h.optimize("WGS-Kim", maxiter=maxiter, verbose=False, stat_groups=groups,
                       fix_phase_iteration=3)
    for b, s in zip(batch, solo):
        assert b.iter == s.iter == 7 and np.array_equal(b.phase, s.phase)
        assert b.stats["stats"] == s.stats["stats"]


def test_run_gs_batch_stacks_instances():
    """The engine's batch: states and consts stacked on K in, stacked
    states and stats (K, n, groups + 1, 4) out, each instance as its own
    ``run_gs``; an amplitude plane per instance too; over a mesh of K CPU
    shards the same, and a mesh that K does not divide refused."""
    frames = _frames(T)
    amp = np.random.default_rng(2).uniform(0.5, 1.0, (64, 64)).astype(np.float32)
    for h in frames:
        h.amp = amp / np.sqrt((amp**2).sum())
        h._update_flags("WGS-Kim", False, None, ["computational"])
    configs = [h._build_config() for h in frames]
    consts = [h._build_consts(c) for h, c in zip(frames, configs)]
    states = [h._build_state(c) for h, c in zip(frames, configs)]
    stacked = TE.GSState(*(None if f[0] is None else torch.stack(f) for f in zip(*states)))
    stacked_consts = {k: torch.stack([torch.as_tensor(c[k]) for c in consts]) for k in consts[0]}
    final, stats = TE.run_gs_batch(configs[0], stacked, stacked_consts, 5)
    assert stats.shape == (K, 5, 2, 4) and final.psi.shape == (K, 64, 64)
    for k in range(K):
        state, rows = TE.run_gs(configs[k], states[k], consts[k], 5)
        assert torch.equal(final.psi[k], state.psi) and torch.equal(stats[k], rows)
        assert torch.equal(final.weights[k], state.weights)
    # Over a mesh: the K instances cut over its axis (K must divide it), the
    # same runs on each shard's device.
    on_mesh, mesh_stats = TE.run_gs_batch(configs[0], stacked, stacked_consts, 5,
                                          mesh=make_mesh(devices=["cpu"] * K))
    assert torch.equal(on_mesh.psi, final.psi) and torch.equal(mesh_stats, stats)
    with pytest.raises(ValueError, match=f"Batch size {K} must divide the mesh"):
        TE.run_gs_batch(configs[0], stacked, stacked_consts, 1,
                        mesh=make_mesh(devices=["cpu"] * 2))


def test_optimize_batch_refusals():
    """A heterogeneous batch (two classes, two configurations), camera
    feedback and a mesh whose axis the batch does not divide are refused,
    with the JAX package's messages; an empty batch is returned as it is."""
    assert T.optimize_batch([]) == []
    for module in (J, T):
        mixed = [module.Hologram(frame_target((64, 64), 0)),
                 module.SpotHologram.make_rectangular_array(
                     (64, 64), array_shape=(2, 2), array_pitch=(8, 8), basis="knm")]
        with pytest.raises(ValueError, match="Homogeneous batch required; got SpotHologram "
                                             "alongside Hologram"):
            module.optimize_batch(mixed, "GS", maxiter=1, verbose=False)
        shapes = [module.Hologram(frame_target((64, 64), 0)),
                  module.Hologram(frame_target((128, 128), 0))]
        with pytest.raises(ValueError, match="same engine configuration"):
            module.optimize_batch(shapes, "GS", maxiter=1, verbose=False)
        # optimize_batch takes no feedback argument: it reads the flag.
        spots = [module.SpotHologram.make_rectangular_array(
            (64, 64), array_shape=(2, 2), array_pitch=(8, 8), basis="knm") for _ in range(2)]
        for h in spots:
            h.flags["feedback"] = "experimental_spot"
        with pytest.raises(ValueError, match="fully-computational feedback only"):
            module.optimize_batch(spots, "WGS-Kim", maxiter=1, verbose=False)
    # A mesh whose axis K does not divide, with the JAX package's message.
    messages = []
    for module, mesh in ((T, make_mesh(devices=["cpu"] * 2)),
                         (J, JMESH.make_mesh(devices=jax.devices()[:2]))):
        with pytest.raises(ValueError) as err:
            module.optimize_batch(_frames(module), "GS", maxiter=1, verbose=False, mesh=mesh)
        messages.append(str(err.value))
    assert messages[0] == messages[1] == (
        f"Batch size {K} must divide the mesh (2 devices) for sharded batch optimization.")
