"""
The multiplane model of the port (PyTorch counterpart of
:mod:`slmsuite_tpu.models.parallel_models`): ``multiplane_batched``, the
B-plane batched multiplane WGS, on one device. The reference's mesh
models (``compressed_spots_3d``, ``sharded_plane_wgs``) come with the
distributed engines (ROADMAP.md queue 1, item 11).
"""

import numpy as np
import torch

from slmsuite_torch import resolve_device


def multiplane_batched(n_planes, N=64, method="WGS-Kim", seed=0, mraf=False, device=None):
    """B-plane batched multiplane WGS: one spot per plane, a constant
    propagation kernel per plane, the nearfields summed into the shared
    phase. With ``mraf`` each plane carries a nan noise region (amplitude
    freedom). Returns ``run(mesh, n_iterations)``, which
    runs :meth:`slmsuite_torch.parallel.multiplane.run_batched_gs` from the
    seeded initial phase on ``device`` (the package default when None);
    ``mesh`` must be None (item 11). ``run.config``, ``run.consts``,
    ``run.psi0`` and ``run.weights0`` are its inputs."""
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

    def run(mesh, n_iterations):
        return run_batched_gs(config, psi0, weights0, consts, n_iterations, mesh=mesh)

    run.config, run.consts, run.psi0, run.weights0 = config, consts, psi0, weights0
    return run
