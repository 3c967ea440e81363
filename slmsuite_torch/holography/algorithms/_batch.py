"""
Batched optimization of independent holograms (PyTorch counterpart of
:mod:`slmsuite_tpu.holography.algorithms._batch`).

K *independent* :class:`~slmsuite_torch.holography.algorithms.Hologram`
instances (frames of a tweezer-rearrangement movie, a parameter scan,
per-wavelength variants) advance through one call; each instance runs the
engine's own loop on its kernels (:meth:`slmsuite_torch.ops.engine.run_gs_batch`),
and its results land back on it exactly as if it had been optimized
alone. With a mesh the instances are cut over its devices, with no
collective.
"""

import numpy as np
import torch

from slmsuite_torch.ops import engine as _engine


def _stack(values):
    """Per-instance values stacked on a leading K: tensors with
    :func:`torch.stack`, scalar amplitudes into an f32 (K,) tensor, None
    kept."""
    if values[0] is None:
        return None
    return torch.stack([v if torch.is_tensor(v) else torch.tensor(v, dtype=torch.float32)
                        for v in values])


def optimize_batch(
    holograms,
    method="GS",
    maxiter=20,
    verbose=True,
    stat_groups=[],
    mesh=None,
    axis_name="data",
    **kwargs,
):
    """
    Optimize K independent holograms in one call.

    All holograms must be homogeneous: the same class, farfield/SLM
    shapes, and (after flag parsing) the same engine configuration;
    targets, initial phases, amplitudes and weights are free to differ.
    Fully computational feedback only (no camera loops).

    Parameters
    ----------
    holograms : list of Hologram
        The instances to optimize. Results are written back to each
        (phase, farfield, weights, stats) as if optimized individually.
    method, maxiter, verbose, stat_groups, **kwargs
        As :meth:`~slmsuite_torch.holography.algorithms.Hologram.optimize`.
    mesh : slmsuite_torch.parallel.mesh.Mesh OR None
        Cut the batch over ``axis_name``; the batch size must divide the
        mesh. No collectives are made.
    axis_name : str
        Mesh axis to cut over.

    Returns
    -------
    list of Hologram
        The same instances, advanced ``maxiter`` iterations.
    """
    if len(holograms) == 0:
        return holograms

    cls = type(holograms[0])
    for h in holograms:
        if type(h) is not cls:
            raise ValueError(
                f"Homogeneous batch required; got {type(h).__name__} "
                f"alongside {cls.__name__}."
            )

    configs, consts_list, states, starts = [], [], [], []
    for h in holograms:
        h._update_flags(method, verbose > 1, None, stat_groups, **kwargs)
        if h._engine_feedback() != "computational":
            raise ValueError(
                "optimize_batch supports fully-computational feedback only."
            )
        config = h._build_config()
        configs.append(config)
        consts_list.append(h._build_consts(config))
        states.append(h._build_state(config))
        starts.append(h.iter)

    if any(c != configs[0] for c in configs[1:]):
        raise ValueError(
            "Homogeneous batch required: every hologram must produce the "
            "same engine configuration (same shapes, method, flags, and "
            "stat groups)."
        )

    stacked_state = _engine.GSState(*(_stack(list(field)) for field in zip(*states)))
    stacked_consts = {key: _stack([c[key] for c in consts_list]) for key in consts_list[0]}
    final, stats = _engine.run_gs_batch(configs[0], stacked_state, stacked_consts, maxiter,
                                        mesh=mesh, axis_name=axis_name)

    stats = stats.cpu().numpy()
    for i, h in enumerate(holograms):
        h._sync_from_state(_engine.GSState(*(None if f is None else f[i] for f in final)))
        if h._device_stat_groups():
            h._record_scan_stats(stats[i], starts[i])
        h._populate_results()
    return holograms
