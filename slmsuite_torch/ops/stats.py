r"""
Per-iteration statistics (PyTorch twin of :mod:`slmsuite_tpu.ops.stats`).

Metrics: efficiency, uniformity, pkpk_err, std_err, computed over the
nonzero/non-nan region of the target. :meth:`calculate_stats` runs on the
device; :meth:`calculate_stats_numpy` is the host twin that returns the
reference's dict form.
"""

import numpy as np
import torch

from slmsuite_torch.ops import collectives as C

#: Order of the metrics in the stats vector.
STAT_KEYS = ("efficiency", "uniformity", "pkpk_err", "std_err")

_NEG_FILL = -3.0e38
_POS_FILL = 3.0e38


def calculate_stats(
    feedback_amp,
    target_amp,
    mask=None,
    efficiency_compensation=True,
    total=None,
):
    """
    Device stats: a length-4 f32 tensor ``[efficiency, uniformity,
    pkpk_err, std_err]``.

    Parameters
    ----------
    feedback_amp, target_amp : torch.Tensor OR list of torch.Tensor
        Computed or measured amplitudes, and target amplitudes (nan
        allowed; excluded through ``mask``). Lists hold a plane cut into
        shards (``slmsuite_tpu``'s ``axis_name`` form): each shard reduces
        its own pixels and the partials reduce across the shards in rank
        order (:mod:`slmsuite_torch.ops.collectives`), in two rounds: the
        power sums, overlap and count first (``err_elem`` needs the global
        target sum and feedback norm), then the extremes and the float64
        error moments. The stats are on the first shard's device.
    mask : torch.Tensor OR list OR None
        Boolean mask of valid pixels (``target != 0 & ~isnan``); computed
        when None.
    efficiency_compensation : bool
        Scale the feedback power by the overlap efficiency.
    total : float OR 0-d tensor OR None
        Total measured power; replaces the overlap efficiency when given.
    """
    if not isinstance(feedback_amp, list):
        feedback_amp, target_amp, mask = [feedback_amp], [target_amp], [mask]
    devices = C.devices_of(feedback_amp)
    mask = [(t != 0) & ~torch.isnan(t) if m is None else m for t, m in zip(target_amp, mask)]
    target_clean = [torch.nan_to_num(t) for t in target_amp]

    feedback_pwr = [torch.square(f) for f in feedback_amp]
    feedback_pwr_sum = C.reduce_sum([p.sum() for p in feedback_pwr])
    target_pwr = [torch.square(t) for t in target_clean]
    target_pwr_sum = C.reduce_sum([p.sum() for p in target_pwr])
    overlap = C.reduce_sum([(t * f).sum() for t, f in zip(target_clean, feedback_amp)])

    if total is not None:
        efficiency = feedback_pwr_sum / total
        f_norm = feedback_pwr_sum
    else:
        efficiency = torch.square(overlap) / (feedback_pwr_sum * target_pwr_sum)
        f_norm = (
            feedback_pwr_sum * efficiency
            if efficiency_compensation
            else feedback_pwr_sum
        )

    count = C.reduce_sum([m.sum() for m in mask])
    umin, umax, err_min, err_max, err_sum, err_sq_sum = [], [], [], [], [], []
    for m, fp, tp, t_sum, f_sum in zip(mask, feedback_pwr, target_pwr,
                                       C.broadcast(target_pwr_sum, devices),
                                       C.broadcast(f_norm, devices)):
        u = torch.where(m, fp / torch.where(m, tp, 1.0), 0.0)
        err_elem = torch.where(m, tp / t_sum - fp / f_sum, 0.0)
        umin.append(torch.where(m, u, _POS_FILL).min())
        umax.append(torch.where(m, u, _NEG_FILL).max())
        err_min.append(torch.where(m, err_elem, _POS_FILL).min())
        err_max.append(torch.where(m, err_elem, _NEG_FILL).max())
        moments = error_moments(err_elem)
        err_sum.append(moments[0])
        err_sq_sum.append(moments[1])
    umin, umax = C.reduce_min(umin), C.reduce_max(umax)
    err_min, err_max = C.reduce_min(err_min), C.reduce_max(err_max)

    uniformity = 1 - (umax - umin) / (umax + umin)
    pkpk_err = count * (err_max - err_min)
    std_err = std_from_moments(C.reduce_sum(err_sum), C.reduce_sum(err_sq_sum), count)

    return torch.stack(
        [v.to(torch.float32) for v in (efficiency, uniformity, pkpk_err, std_err)]
    )


def error_moments(err):
    """``(sum err, sum err^2)`` accumulated in float64.

    Near convergence the mean error is about ``(1 - efficiency) / count``,
    so ``E[e^2] - E[e]^2`` cancels most of its digits: formed in f32 it is
    off by ~1e-4 of ``std_err``. The JAX package forms it in f32."""
    err = err.to(torch.float64)
    return err.sum(), torch.square(err).sum()


def std_from_moments(err_sum, err_sq_sum, count):
    """``count * std(err)`` from float64 moments, as float32."""
    err_mean = err_sum / count
    err_var = err_sq_sum / count - torch.square(err_mean)
    return (count * torch.sqrt(torch.clamp(err_var, min=0.0))).to(torch.float32)


def calculate_stats_numpy(
    feedback_amp, target_amp, efficiency_compensation=True, total=None, raw=False
):
    """
    Host (numpy) twin of :meth:`calculate_stats`, returning the
    reference's dict form.
    """
    feedback_amp = np.asarray(feedback_amp, dtype=float)
    target_amp = np.asarray(target_amp, dtype=float)

    feedback_pwr = np.square(feedback_amp)
    target_pwr = np.square(target_amp)

    if total is not None:
        efficiency = float(np.nansum(feedback_pwr) / total)

    feedback_pwr_sum = np.sum(feedback_pwr)
    feedback_pwr = feedback_pwr / feedback_pwr_sum
    feedback_amp = feedback_amp / np.sqrt(feedback_pwr_sum)

    target_pwr_sum = np.nansum(target_pwr)
    target_pwr = target_pwr / target_pwr_sum
    target_amp = target_amp / np.sqrt(target_pwr_sum)

    if total is None:
        efficiency = float(np.square(np.nansum(target_amp * feedback_amp)))
        if efficiency_compensation:
            feedback_pwr = feedback_pwr / efficiency

    mask = np.logical_and(target_pwr != 0, ~np.isnan(target_pwr))
    ratio = feedback_pwr[mask] / target_pwr[mask]
    err = target_pwr[mask] - feedback_pwr[mask]

    rmin, rmax = float(np.amin(ratio)), float(np.amax(ratio))

    stats = {
        "efficiency": efficiency,
        "uniformity": 1 - (rmax - rmin) / (rmax + rmin),
        "pkpk_err": err.size * float(np.amax(err) - np.amin(err)),
        "std_err": err.size * float(np.std(err)),
    }

    if raw:
        ratio_full = np.full_like(target_pwr, np.nan)
        ratio_full[mask] = ratio
        stats["raw_pwr"] = np.square(feedback_amp)
        stats["raw_pwr_ratio"] = ratio_full

    return stats
