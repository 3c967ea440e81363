r"""
WGS weight-update rules (PyTorch twin of :mod:`slmsuite_tpu.ops.weights`).

One elementwise function implements all five weighting methods
(``feedback``/``target`` are amplitudes, :math:`p` = ``feedback_exponent``,
:math:`f` = ``feedback_factor``):

- Leonardo / Kim:   :math:`w \leftarrow w (T/F)^p`
- Nogrette:         :math:`w \leftarrow w / (1 - f(1 - F/T))` (normalized)
- Wu:               :math:`w \leftarrow w \exp(p(T - F))`
- tanh:             :math:`w \leftarrow w (1 + f\tanh(p(T - F)))`
"""

import torch

from slmsuite_torch.ops import collectives as C


def update_weights_generic(
    weights,
    feedback_amp,
    target_amp,
    method,
    feedback_exponent=0.8,
    feedback_factor=0.1,
    nan_checks=True,
):
    """
    WGS weight update, renormalized to unit norm.

    Parameters
    ----------
    weights, feedback_amp, target_amp : torch.Tensor OR list of torch.Tensor
        Current weights, measured/computed amplitudes and target
        amplitudes, all of one shape. Lists hold a plane cut into shards
        (``slmsuite_tpu``'s ``axis_name`` form): the feedback norm,
        Nogrette's nan-mean and the final norm reduce across the shards in
        rank order (:mod:`slmsuite_torch.ops.collectives`), everything else
        is shard-local, and the new weights are a list too.
    method : str
        ``"WGS-Leonardo"``, ``"WGS-Kim"``, ``"WGS-Nogrette"``, ``"WGS-Wu"``
        or ``"WGS-tanh"``.
    feedback_exponent, feedback_factor : float or 0-d tensor
        Method tuning; with shards, also a list of per-shard 0-d tensors.
    nan_checks : bool
        Guard divisions by zero and nan infiltration.
    """
    method_lower = method.lower()
    if not method_lower.startswith("wgs-"):
        raise ValueError("Weighting is only for WGS methods.")
    rule = method_lower[4:]
    sharded = isinstance(weights, list)
    if not sharded:
        weights, feedback_amp, target_amp = [weights], [feedback_amp], [target_amp]
    D = len(weights)
    devices = C.devices_of(weights)
    p = feedback_exponent if isinstance(feedback_exponent, list) else [feedback_exponent] * D
    f = feedback_factor if isinstance(feedback_factor, list) else [feedback_factor] * D

    def norms(xs):
        """Root of sum of squares over every shard, ignoring nan, on each
        shard's device."""
        sq = [torch.nansum(torch.square(torch.abs(x))) for x in xs]
        return C.broadcast(torch.sqrt(C.reduce_sum(sq)), devices)

    # For Leonardo/Kim the feedback normalization is a scalar factor that
    # the final renormalization removes exactly, so it is skipped (as in
    # the JAX package). Nogrette, Wu and tanh need the normalized values.
    feedback = feedback_amp
    if "wu" in rule or "tanh" in rule or "nogrette" in rule:
        feedback = [x / n for x, n in zip(feedback_amp, norms(feedback_amp))]
    corrected = []
    for fb, t, pd in zip(feedback, target_amp, p):
        if "wu" in rule or "tanh" in rule:
            c = t - pd * fb
        elif nan_checks:
            # NaN targets (MRAF noise regions) land on factor 1.
            on = (t != 0) & ~torch.isnan(t)
            c = fb / torch.where(on, t, 1.0)
            c = torch.where(torch.isfinite(c) & on, c, 1.0)
        else:
            c = fb / t
        corrected.append(c)
    if "nogrette" in rule:
        mean = (C.reduce_sum([torch.nansum(c) for c in corrected])
                / C.reduce_sum([(~torch.isnan(c)).sum() for c in corrected]))
        means = C.broadcast(mean, devices)

    new_weights = []
    for d, (w, c, pd, fd) in enumerate(zip(weights, corrected, p, f)):
        if "leonardo" in rule or "kim" in rule:
            c = torch.pow(c, -pd)
        elif "nogrette" in rule:
            c = c * (-1.0 / means[d]) + 1.0
            c = 1.0 / (1.0 - fd * c)
        elif "wu" in rule:
            c = torch.exp(pd * c)
        elif "tanh" in rule:
            c = 1.0 + fd * torch.tanh(pd * c)
        else:
            raise ValueError(f"Method '{method}' not recognized.")
        if nan_checks:
            c = torch.where(torch.isinf(c), 1.0, c)
        w = w * c
        if nan_checks:
            w = torch.nan_to_num(w, nan=0.0001)
        new_weights.append(w)
    new_weights = [w / n for w, n in zip(new_weights, norms(new_weights))]
    return new_weights if sharded else new_weights[0]
