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


def _norm(x):
    """Root of sum of squares, ignoring nan."""
    return torch.sqrt(torch.nansum(torch.square(torch.abs(x))))


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
    weights, feedback_amp, target_amp : torch.Tensor
        Current weights, measured/computed amplitudes and target
        amplitudes, all of one shape.
    method : str
        ``"WGS-Leonardo"``, ``"WGS-Kim"``, ``"WGS-Nogrette"``, ``"WGS-Wu"``
        or ``"WGS-tanh"``.
    feedback_exponent, feedback_factor : float or 0-d tensor
        Method tuning.
    nan_checks : bool
        Guard divisions by zero and nan infiltration.
    """
    method_lower = method.lower()
    if not method_lower.startswith("wgs-"):
        raise ValueError("Weighting is only for WGS methods.")
    rule = method_lower[4:]

    # For Leonardo/Kim the feedback normalization is a scalar factor that
    # the final renormalization removes exactly, so it is skipped (as in
    # the JAX package). Nogrette, Wu and tanh need the normalized values.
    if "wu" in rule or "tanh" in rule:
        feedback = feedback_amp / _norm(feedback_amp)
        corrected = target_amp - feedback_exponent * feedback
    else:
        if "nogrette" in rule:
            feedback = feedback_amp / _norm(feedback_amp)
        else:
            feedback = feedback_amp
        if nan_checks:
            # NaN targets (MRAF noise regions) land on factor 1.
            on = (target_amp != 0) & ~torch.isnan(target_amp)
            corrected = feedback / torch.where(on, target_amp, 1.0)
            corrected = torch.where(torch.isfinite(corrected) & on, corrected, 1.0)
        else:
            corrected = feedback / target_amp

    if "leonardo" in rule or "kim" in rule:
        corrected = torch.pow(corrected, -feedback_exponent)
    elif "nogrette" in rule:
        valid = ~torch.isnan(corrected)
        mean = torch.nansum(corrected) / valid.sum()
        corrected = corrected * (-1.0 / mean) + 1.0
        corrected = 1.0 / (1.0 - feedback_factor * corrected)
    elif "wu" in rule:
        corrected = torch.exp(feedback_exponent * corrected)
    elif "tanh" in rule:
        corrected = 1.0 + feedback_factor * torch.tanh(feedback_exponent * corrected)
    else:
        raise ValueError(f"Method '{method}' not recognized.")

    if nan_checks:
        corrected = torch.where(torch.isinf(corrected), 1.0, corrected)

    new_weights = weights * corrected
    if nan_checks:
        new_weights = torch.nan_to_num(new_weights, nan=0.0001)

    return new_weights / _norm(new_weights)
