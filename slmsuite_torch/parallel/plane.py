r"""
Row-sharded full-plane GS (PyTorch counterpart of
:mod:`slmsuite_tpu.parallel.plane`): a farfield whose rows are cut over a
mesh axis.

Each shard holds ``H/D`` rows of every plane (psi, weights, phase store,
target, masks, kernel, amplitude plane). One iteration, in lockstep over
the shards (:mod:`slmsuite_torch.ops.collectives`):

- forward: ``carry_entry`` (``amp e^{i(psi + kernel)}`` and its unnormalized
  row FFT, the single-device fused loop's entry), the global transpose, the
  column transform as ``rows_fft`` of the transposed blocks with the ortho
  and amplitude scale, the transpose back (:mod:`~slmsuite_torch.parallel.fft2d`);
- stats, the WGS weight norm and Nogrette's mean reduce across shards
  (:meth:`slmsuite_torch.ops.stats.calculate_stats` and
  :meth:`slmsuite_torch.ops.weights.update_weights_generic` on lists of
  shards); Kim's flags are formed once, from the reduced efficiency, and
  given to every shard, so the shards cannot disagree;
- the constraint (``w e^{i phi}`` or the MRAF mix) is shard-local;
- backward: the transpose, the inverse column transform as ``rows_fft``
  of the transposed blocks, the transpose back, and ``carry_exit`` (the
  inverse row FFT and ``atan2``; the normalization drops out of the
  angle), minus the kernel.

Per shard and iteration: ``carry_entry`` 1, ``rows_fft`` 2, ``carry_exit``
1, and four exchanges of the complex plane. Requires full-plane geometry
(farfield shape == SLM shape) and computational feedback and stats
(:meth:`plane_shardable`). Reached from the public API through
``Hologram.optimize(mesh=...)``.
"""

import torch

from slmsuite_torch.ops import collectives as C
from slmsuite_torch.ops import fft as _fft
from slmsuite_torch.ops.engine import GSConfig, GSState, _mraf_mix
from slmsuite_torch.ops.stats import calculate_stats
from slmsuite_torch.ops.weights import update_weights_generic
from slmsuite_torch.parallel import fft2d as F

__all__ = ["plane_shardable", "make_sharded_plane_step", "run_sharded_plane_gs"]


def plane_shardable(config: GSConfig, n_devices: int):
    """Whether the row-sharded engine covers ``config`` on ``n_devices``:
    full-plane geometry (farfield shape == SLM shape; a propagation
    kernel is fine, it is a shard-local elementwise phase), computational
    feedback (no spot gathers, whose index maps would cross shards),
    rows divisible by the mesh."""
    needs_spot = (
        config.feedback == "computational_spot"
        or "computational_spot" in config.stat_groups
    )
    H, W = config.shape
    return (
        tuple(config.shape) == tuple(config.slm_shape)
        and config.feedback == "computational"
        and not needs_spot
        and all(g == "computational" for g in config.stat_groups)
        and H % n_devices == 0
        and W % n_devices == 0  # The pencil transpose splits columns too.
    )


def _kim(config, state, efficiency, consts):
    """Kim's decision from the reduced efficiency, once: ``(fixed, streak)``
    on the first shard's device."""
    was_not_fixed = torch.logical_not(state.fixed_phase)
    fixed = state.fixed_phase
    if config.kim_efficiency_trigger:
        fixed = fixed | (efficiency > consts["fix_phase_efficiency"])
    streak = torch.where(was_not_fixed, state.unfixed_streak + 1, state.unfixed_streak)
    n_fix = consts["fix_phase_iteration"]
    iter_trigger = was_not_fixed & (state.iteration >= n_fix - 1) & (streak >= n_fix)
    return (fixed | iter_trigger) & (state.iteration > 0), streak


def make_sharded_plane_step(config: GSConfig):
    """The lockstep step ``step(state, shards) -> (state, stats)``: the plane
    fields of ``state`` are lists of per-shard rows, its scalars tensors on
    the first shard's device; ``shards`` holds each shard's constants
    (:meth:`_shard_consts`). The stats are ``(n_groups + 1, 4)`` on the first
    shard's device, the last row ``[efficiency, fixed_phase, 0, 0]``."""
    assert all(g == "computational" for g in config.stat_groups)
    needs_eff = bool(config.stat_groups) or (config.is_kim and config.kim_efficiency_trigger)

    def step(state, shards):
        devices = [sh["target"].device for sh in shards]
        first = shards[0]

        # Forward: rows (carry_entry), transpose, columns, transpose back.
        gr, gi = [], []
        for psi, sh in zip(state.psi, shards):
            with C.on_device(psi.device):
                total = psi + sh["kernel"] if config.has_kernel else psi
                r, i = _fft.wgs_carry_entry(total, sh["amp"])
            gr.append(r)
            gi.append(i)
        fr, fi = F.rows_fft_shards(*F.transpose_pairs(gr, gi), inverse=False,
                                   scale=first["_post"])
        fr, fi = F.transpose_pairs(fr, fi)
        amp_ff = [torch.sqrt(torch.square(r) + torch.square(i)) for r, i in zip(fr, fi)]
        theta = [torch.atan2(i, r) for r, i in zip(fr, fi)]

        # Stats and the Kim decision from reduced scalars.
        efficiency = first["_nan"]
        stats_rows = []
        if needs_eff:
            row = calculate_stats(
                amp_ff, [sh["target"] for sh in shards], [sh["stat_mask"] for sh in shards],
                efficiency_compensation=False,
            )
            stats_rows = [row] * len(config.stat_groups)
            efficiency = row[0]

        weights = state.weights
        if config.is_wgs:
            updated = update_weights_generic(
                weights, amp_ff, [sh["target"] for sh in shards], config.method,
                [sh["feedback_exponent"] for sh in shards],
                [sh["feedback_factor"] for sh in shards],
            )
            apply = C.broadcast(state.iteration > 0, devices)
            weights = [torch.where(a, u, w) for a, u, w in zip(apply, updated, weights)]

        if config.is_kim:
            fixed, streak = _kim(config, state, efficiency, first)
            keep = C.broadcast(torch.logical_not(state.fixed_phase), devices)
            phase_ff = [torch.where(k, t, p) for k, t, p in zip(keep, theta, state.phase_ff)]
        else:
            fixed, streak = torch.zeros_like(state.fixed_phase), state.unfixed_streak
            phase_ff = theta

        # The constraint, shard-local.
        re, im, zero_weights = [], [], []
        for d, sh in enumerate(shards):
            if config.mraf:
                (r, i), zw = _mraf_mix(config, sh, amp_ff[d], theta[d], weights[d],
                                       phase_ff[d], state.zero_weights[d])
            else:
                r = weights[d] * torch.cos(phase_ff[d])
                i = weights[d] * torch.sin(phase_ff[d])
                zw = state.zero_weights[d]
            re.append(r)
            im.append(i)
            zero_weights.append(zw)

        # Backward: transpose, columns, transpose back, rows and angle.
        hr, hi = F.rows_fft_shards(*F.transpose_pairs(re, im), inverse=True)
        hr, hi = F.transpose_pairs(hr, hi)
        psi = []
        for r, i, sh in zip(hr, hi, shards):
            with C.on_device(r.device):
                p = _fft.wgs_carry_exit(r, i)
            psi.append(p - sh["kernel"] if config.has_kernel else p)

        new_state = GSState(
            psi=psi, weights=weights, phase_ff=phase_ff, zero_weights=zero_weights,
            fixed_phase=fixed, unfixed_streak=streak, iteration=state.iteration + 1,
            w_norm=state.w_norm,
        )
        zero = first["_zero"]
        internal = torch.stack([efficiency, state.fixed_phase.to(torch.float32), zero, zero])
        return new_state, torch.stack(stats_rows + [internal])

    return step


_ROW_CONSTS = (
    "target", "stat_mask", "signal_mask", "noise_mask", "zero_mask", "kernel",
)


def _shard_consts(config, consts, devices):
    """Each shard's constants: the row constants (and an amplitude plane)
    cut into row blocks, the rest on every shard's device, plus the scale
    of the column pass (``_post``: the ortho scale, times a scalar
    amplitude, which ``carry_entry`` leaves out) and the step's 0-d zero
    and nan."""
    shards = [{} for _ in devices]
    for key, value in consts.items():
        if key in _ROW_CONSTS or (key == "amp" and not _fft.is_scalar_amp(value)):
            parts = C.split(value, devices)
        elif torch.is_tensor(value):
            parts = C.broadcast(value, devices)
        else:
            parts = [value] * len(devices)
        for sh, part in zip(shards, parts):
            sh[key] = part
    post = _fft.post_scale(consts["amp"], config.shape)
    for sh, device in zip(shards, devices):
        sh["_post"] = post
        sh["_zero"] = torch.zeros((), dtype=torch.float32, device=device)
        sh["_nan"] = torch.full((), float("nan"), dtype=torch.float32, device=device)
    return shards


def run_sharded_plane_gs(config, state, consts, mesh, n_iterations, axis_name="rows"):
    """
    Run ``n_iterations`` of full-plane GS with rows sharded over
    ``axis_name`` of ``mesh``.

    ``state``/``consts`` follow :mod:`slmsuite_torch.ops.engine` conventions
    (natural layout, whole planes); they are cut into row blocks here, and
    the final state is gathered back on the device of ``state.psi``.
    Returns ``(state, stats)`` shaped like :meth:`ops.engine.run_gs`.
    """
    devices = mesh.axis_devices(axis_name)
    if not plane_shardable(config, len(devices)):
        raise ValueError("Configuration not row-shardable (see plane_shardable).")
    home = state.psi.device
    shards = _shard_consts(config, consts, devices)
    first = devices[0]
    zero_weights = (C.split(state.zero_weights, devices, axis=1) if config.zero_factor
                    else C.broadcast(state.zero_weights, devices))
    sharded = GSState(
        psi=C.split(state.psi, devices),
        weights=C.split(state.weights, devices),
        phase_ff=C.split(state.phase_ff, devices),
        zero_weights=zero_weights,
        fixed_phase=state.fixed_phase.to(first),
        unfixed_streak=state.unfixed_streak.to(first),
        iteration=state.iteration.to(first),
        w_norm=state.w_norm,
    )
    step = make_sharded_plane_step(config)
    rows = []
    for _ in range(int(n_iterations)):
        sharded, stats = step(sharded, shards)
        rows.append(stats)
    n_rows = len(config.stat_groups) + 1
    stats = (torch.stack(rows).to(home) if rows
             else torch.zeros((0, n_rows, 4), dtype=torch.float32, device=home))
    final = GSState(
        psi=C.gather(sharded.psi, home),
        weights=C.gather(sharded.weights, home),
        phase_ff=C.gather(sharded.phase_ff, home),
        zero_weights=(C.gather(sharded.zero_weights, home, axis=1) if config.zero_factor
                      else state.zero_weights),
        fixed_phase=sharded.fixed_phase.to(home),
        unfixed_streak=sharded.unfixed_streak.to(home),
        iteration=sharded.iteration.to(home),
        w_norm=state.w_norm,
    )
    return final, stats

