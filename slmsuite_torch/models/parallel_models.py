"""
The mesh models of the port (PyTorch counterpart of
:mod:`slmsuite_tpu.models.parallel_models`).

Each builder returns ``run(mesh, n_iterations)``, which runs the model's
engine over a :class:`slmsuite_torch.parallel.mesh.Mesh` (``mesh=None``
where the engine has a meshless form) from inputs made on ``device`` from
the seed. :meth:`dryrun_multichip` holds each model on an n-shard mesh
against a one-shard mesh (``__graft_entry__.dryrun_multichip``'s checks).
"""

import numpy as np
import torch

from slmsuite_torch import resolve_device


def multiplane_batched(n_planes, N=64, method="WGS-Kim", seed=0, mraf=False, device=None):
    """B-plane batched multiplane WGS: one spot per plane, a constant
    propagation kernel per plane, the nearfields summed into the shared
    phase; planes data-parallel over a ``data`` mesh axis. With ``mraf``
    each plane carries a nan noise region (amplitude freedom). Returns
    ``run(mesh, n_iterations, axis_name="data")``, which runs
    :meth:`slmsuite_torch.parallel.multiplane.run_batched_gs` from the
    seeded initial phase on ``device`` (the package default when None).
    ``run.config``, ``run.consts``, ``run.psi0`` and ``run.weights0`` are
    its inputs."""
    from slmsuite_torch.ops.propagation import fold_phase
    from slmsuite_torch.parallel.multiplane import (
        BatchedGSConfig,
        make_multiplane_consts,
        run_batched_gs,
    )

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    shape = (N, N)
    targets = np.zeros((n_planes, N, N), np.float32)
    for b in range(n_planes):
        targets[b, 16 + (2 * b) % 32, 20 + (3 * b) % 24] = 1.0
        targets[b] /= np.sqrt((targets[b] ** 2).sum())
        if mraf:
            noise = np.ones(shape, bool)
            noise[12:52, 8 + b % 4:56] = False
            targets[b, noise] = np.nan
    kernels = np.stack([np.full(shape, 0.05 * b, np.float32) for b in range(n_planes)])

    config = BatchedGSConfig(
        method=method, shape=shape, slm_shape=shape, n_planes=n_planes,
        mraf=mraf, mraf_factor=mraf,
    )
    consts = make_multiplane_consts(
        targets, kernels, np.full(n_planes, 1 / np.sqrt(n_planes), np.float32), 1.0 / N,
        mraf_factor=0.5 if mraf else None, device=device,
    )
    psi0 = torch.as_tensor(
        fold_phase(rng.uniform(-np.pi, np.pi, shape).astype(np.float32), shape), device=device
    )
    weights0 = torch.as_tensor(np.nan_to_num(targets), device=device)

    def run(mesh, n_iterations, axis_name="data"):
        return run_batched_gs(config, psi0, weights0, consts, n_iterations, mesh=mesh,
                              axis_name=axis_name)

    run.config, run.consts, run.psi0, run.weights0 = config, consts, psi0, weights0
    return run


def compressed_spots_3d(n_pixels=64 * 64, n_spots=16, method="WGS-Kim", seed=0, device=None):
    """Pixel-sharded grid-free Zernike spot model: each shard owns a pixel
    slab; one (n_spots,) sum across the shards per iteration. Returns
    ``run(mesh, n_iterations, axis_name="pixels")``, which runs
    :meth:`slmsuite_torch.parallel.compressed.run_sharded_compressed_gs`."""
    from slmsuite_torch.ops.compressed import CompressedGSConfig, CompressedGSState
    from slmsuite_torch.parallel.compressed import (
        run_sharded_compressed_gs,
        shard_compressed_consts,
    )

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    basis = rng.normal(size=(3, n_pixels)).astype(np.float32)
    coeffs = rng.normal(size=(3, n_spots)).astype(np.float32) * 5
    target = np.full(n_spots, 1 / np.sqrt(n_spots), np.float32)

    def tensor(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    config = CompressedGSConfig(
        method=method, n_pixels=n_pixels, n_spots=n_spots,
        stat_groups=("computational_spot",), kim_efficiency_trigger=False,
    )
    consts = {
        "amp": 1 / np.sqrt(n_pixels),
        "coeffs": tensor(coeffs),
        "basis": tensor(basis),
        "target": tensor(target),
        "stat_mask": tensor(target != 0, torch.bool),
        "feedback_exponent": tensor(np.float32(0.8)),
        "feedback_factor": tensor(np.float32(0.1)),
        "fix_phase_iteration": tensor(np.int32(5), torch.int32),
        "fix_phase_efficiency": tensor(np.float32(np.nan)),
    }
    state = CompressedGSState(
        psi=tensor(rng.uniform(-np.pi, np.pi, n_pixels).astype(np.float32)),
        weights=tensor(target.copy()),
        phase_ff=torch.zeros(n_spots, dtype=torch.float32, device=device),
        fixed_phase=torch.zeros((), dtype=torch.bool, device=device),
        unfixed_streak=torch.zeros((), dtype=torch.int32, device=device),
        iteration=torch.zeros((), dtype=torch.int32, device=device),
    )

    def run(mesh, n_iterations, axis_name="pixels"):
        sharded = shard_compressed_consts(consts, mesh, axis_name)
        return run_sharded_compressed_gs(config, state, sharded, mesh, n_iterations, axis_name)

    return run


def sharded_plane_wgs(N, method="WGS-Kim", seed=0, device=None):
    """Row-sharded full-plane WGS: the pencil FFT over a ``rows`` mesh axis,
    the norms and stats reduced across the shards. Returns ``run(mesh,
    n_iterations, axis_name="rows")``, which runs
    :meth:`slmsuite_torch.parallel.plane.run_sharded_plane_gs`."""
    from slmsuite_torch.ops.engine import GSConfig, init_gs_state
    from slmsuite_torch.ops.propagation import fold_phase
    from slmsuite_torch.parallel.plane import run_sharded_plane_gs

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    target = np.zeros((N, N), np.float32)
    target[N // 2, N // 4] = target[N // 4, N // 2] = 1.0
    target /= np.sqrt((target**2).sum())
    config = GSConfig(
        method=method, shape=(N, N), slm_shape=(N, N), stat_groups=("computational",),
    )

    def tensor(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    consts = {
        "amp": 1.0 / N,
        "target": tensor(target),
        "stat_mask": tensor(target != 0, torch.bool),
        "feedback_exponent": tensor(np.float32(0.8)),
        "feedback_factor": tensor(np.float32(0.1)),
        "fix_phase_iteration": tensor(np.int32(5), torch.int32),
        "fix_phase_efficiency": tensor(np.float32(np.nan)),
    }
    state = init_gs_state(
        config,
        fold_phase(rng.uniform(-np.pi, np.pi, (N, N)).astype(np.float32), (N, N)),
        target.copy(),
        device=device,
    )

    def run(mesh, n_iterations, axis_name="rows"):
        return run_sharded_plane_gs(config, state, consts, mesh, n_iterations, axis_name)

    return run


def _check(name, mesh_val, ref_val, atol):
    """Raise where the mesh run and its reference differ by more than ``atol``."""
    err = float((torch.as_tensor(mesh_val).double().cpu()
                 - torch.as_tensor(ref_val).double().cpu()).abs().max())
    if not err <= atol:
        raise AssertionError(
            f"multichip parity FAILED on {name}: max|mesh - single| = {err:.3e} > {atol:g}"
        )
    return err


def dryrun_multichip(n_devices, devices=None):
    """
    Each mesh model on an ``n_devices``-shard mesh against its one-shard or
    meshless run, with ``__graft_entry__.dryrun_multichip``'s bounds: the
    batched multiplane model (plain and MRAF) over ``data``, the compressed
    model over ``pixels``, the row-sharded plane over ``rows`` and
    ``optimize_batch`` over ``data``. ``devices`` defaults to the CUDA
    devices, each taken in turn as often as needed (``[cuda:0] * n`` on one
    card); the models' inputs live on the first. The plane and the batch
    are 64^2 (the kernels' shortest line) where the JAX package's are
    ``8 n`` and 16^2. Returns ``{check: largest difference}``; raises
    AssertionError on a check that fails.
    """
    from slmsuite_torch.holography.algorithms import Hologram, optimize_batch
    from slmsuite_torch.parallel.mesh import make_mesh

    if devices is None:
        count = torch.cuda.device_count()
        if not count:
            raise RuntimeError("dryrun_multichip found no CUDA device; pass devices=.")
        devices = [torch.device("cuda", i % count) for i in range(n_devices)]
    devices = [torch.device(d) for d in devices][:n_devices]
    if len(devices) < n_devices:
        raise ValueError(f"dryrun_multichip needs {n_devices} devices, got {len(devices)}.")
    home = devices[0]
    errors = {}

    mesh = make_mesh(axis_names=("data",), devices=devices)
    for label, kw in (("multiplane", {}), ("multiplane MRAF", dict(method="WGS-Leonardo",
                                                                  mraf=True))):
        run = multiplane_batched(n_planes=n_devices * 2, device=home, **kw)
        stats = run(mesh, 2)[2]
        errors[f"{label} stats"] = _check(f"{label} stats", stats, run(None, 2)[2], 1e-3)

    cmesh = make_mesh(axis_names=("pixels",), devices=devices)
    cmesh_1 = make_mesh(axis_names=("pixels",), devices=devices[:1])
    cstate, cstats = compressed_spots_3d(device=home)(cmesh, 2)
    cstate_1, cstats_1 = compressed_spots_3d(device=home)(cmesh_1, 2)
    errors["compressed stats"] = _check("compressed stats", cstats, cstats_1, 2e-4)
    errors["compressed weights"] = _check("compressed weights", cstate.weights,
                                          cstate_1.weights, 2e-4)

    N = 8 * max(8, n_devices)
    pmesh = make_mesh(axis_names=("rows",), devices=devices)
    pmesh_1 = make_mesh(axis_names=("rows",), devices=devices[:1])
    pstate, pstats = sharded_plane_wgs(N=N, device=home)(pmesh, 2)
    pstate_1, pstats_1 = sharded_plane_wgs(N=N, device=home)(pmesh_1, 2)
    errors["plane stats"] = _check("plane stats", pstats, pstats_1, 2e-4)
    errors["plane psi"] = _check("plane psi", pstate.psi, pstate_1.psi, 2e-3)

    rng = np.random.default_rng(0)
    batch, phase0 = [], []
    for i in range(n_devices):
        target = np.zeros((64, 64), np.float32)
        target[16 + (8 * i) % 32, 24 + (12 * i) % 32] = 1.0
        h = Hologram(target, slm_shape=(64, 64), device=home)
        p0 = rng.uniform(-np.pi, np.pi, (64, 64)).astype(np.float32)
        h.reset_phase(p0)
        batch.append(h)
        phase0.append((target, p0))
    optimize_batch(batch, "WGS-Kim", maxiter=2, verbose=False, mesh=mesh)
    solo = Hologram(phase0[0][0], slm_shape=(64, 64), device=home)
    solo.reset_phase(phase0[0][1])
    solo.optimize("WGS-Kim", maxiter=2, verbose=False)
    errors["optimize_batch phase"] = _check("optimize_batch phase", batch[0].phase,
                                            solo.phase, 1e-4)
    return errors
