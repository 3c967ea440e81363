r"""
The optimizers that gradient phase retrieval steps
(:meth:`~slmsuite_torch.holography.algorithms.Hologram.optimize_cg`): the
update rules of optax 0.2.6's ``adam``, ``adamw``, ``sgd``, ``rmsprop`` and
``adagrad``, on torch tensors, with optax's argument names and defaults.
The JAX package steps optax; optax imports jax, so the port keeps its own
copy of these rules.

Each optimizer is functional, as optax's are: ``init(psi) -> state`` and
``update(grads, state, psi) -> (psi', state')``, where ``psi' = psi + u``
for optax's update ``u``. Nothing is written in place. The step count is a
host integer: a schedule (``learning_rate`` a Python callable of the count,
optax's ``ScalarOrSchedule``) and the bias corrections cost no transfer.

optax's order of operations is kept, and not ``torch.optim``'s, whose
defaults and rounding differ: optax adds RMSprop's ``eps`` inside the
square root, starts Adagrad's accumulator at 0.1, and forms Adam's
denominator as ``sqrt(nu_hat + eps_root) + eps`` from bias-corrected
moments. The bias corrections ``1 - decay**count`` are formed in float32,
as optax forms them. The state stays in the dtype of psi (float32).
"""

from typing import Callable, NamedTuple

import numpy as np
import torch


class Optimizer(NamedTuple):
    """``init(psi) -> state``; ``update(grads, state, psi) -> (psi', state')``."""

    init: Callable
    update: Callable


def _correction(decay, count):
    """optax's bias correction ``1 - decay**count``, formed in float32."""
    return float(np.float32(1) - np.float32(decay) ** count)


def _rate(learning_rate, count):
    """The learning rate of update ``count`` (0 for the first)."""
    return learning_rate(count) if callable(learning_rate) else learning_rate


def _trace(u, trace, decay, nesterov):
    """optax's ``trace``: ``(update, trace')``."""
    trace = u + decay * trace
    return (u + decay * trace if nesterov else trace), trace


def _adam_direction(g, state, b1, b2, eps, eps_root, nesterov):
    """optax's ``scale_by_adam``: ``(update, mu', nu')``."""
    count = state["count"] + 1
    mu = (1 - b1) * g + b1 * state["mu"]
    nu = (1 - b2) * torch.square(g) + b2 * state["nu"]
    if nesterov:
        mu_hat = (b1 * (mu / _correction(b1, count + 1))
                  + (1 - b1) * (g / _correction(b1, count)))
    else:
        mu_hat = mu / _correction(b1, count)
    nu_hat = nu / _correction(b2, count)
    return mu_hat / (torch.sqrt(nu_hat + eps_root) + eps), mu, nu


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, *, nesterov=False):
    """optax's ``adam``."""
    return adamw(learning_rate, b1, b2, eps, eps_root, weight_decay=None, nesterov=nesterov)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4, *,
          nesterov=False):
    """optax's ``adamw`` (``weight_decay`` None: ``adam``)."""

    def init(psi):
        return {"count": 0, "mu": torch.zeros_like(psi), "nu": torch.zeros_like(psi)}

    def update(grads, state, psi):
        u, mu, nu = _adam_direction(grads, state, b1, b2, eps, eps_root, nesterov)
        if weight_decay is not None:
            u = u + weight_decay * psi
        count = state["count"]
        return psi + -_rate(learning_rate, count) * u, {"count": count + 1, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def sgd(learning_rate, momentum=None, nesterov=False):
    """optax's ``sgd``."""

    def init(psi):
        return {"count": 0, "trace": None if momentum is None else torch.zeros_like(psi)}

    def update(grads, state, psi):
        u, trace = grads, None
        if momentum is not None:
            u, trace = _trace(grads, state["trace"], momentum, nesterov)
        count = state["count"]
        return psi + -_rate(learning_rate, count) * u, {"count": count + 1, "trace": trace}

    return Optimizer(init, update)


def rmsprop(learning_rate, decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True,
            centered=False, momentum=None, nesterov=False, bias_correction=False):
    """optax's ``rmsprop``: ``scale_by_rms`` (``scale_by_stddev`` when
    ``centered``), the learning rate, then the momentum ``trace``."""

    def init(psi):
        return {
            "count": 0,
            "mu": torch.zeros_like(psi) if centered else None,
            "nu": torch.full_like(psi, initial_scale),
            "trace": None if momentum is None else torch.zeros_like(psi),
        }

    def update(grads, state, psi):
        count = state["count"]
        nu = (1 - decay) * torch.square(grads) + decay * state["nu"]
        mu = (1 - decay) * grads + decay * state["mu"] if centered else None
        mu_hat, nu_hat = mu, nu
        if bias_correction:
            nu_hat = nu / _correction(decay, count + 1)
            if centered:
                mu_hat = mu / _correction(decay, count + 1)
        denom = nu_hat - torch.square(mu_hat) if centered else nu_hat
        if eps_in_sqrt:
            scaling = torch.rsqrt(denom + eps)
        else:
            scaling = 1 / (torch.sqrt(denom) + eps)
        u = -_rate(learning_rate, count) * (scaling * grads)
        trace = None
        if momentum is not None:
            u, trace = _trace(u, state["trace"], momentum, nesterov)
        return psi + u, {"count": count + 1, "mu": mu, "nu": nu, "trace": trace}

    return Optimizer(init, update)


def adagrad(learning_rate, initial_accumulator_value=0.1, eps=1e-7):
    """optax's ``adagrad``."""

    def init(psi):
        return {"count": 0, "sum": torch.full_like(psi, initial_accumulator_value)}

    def update(grads, state, psi):
        total = torch.square(grads) + state["sum"]
        inv = torch.where(total > 0, torch.rsqrt(total + eps), 0.0)
        count = state["count"]
        return (psi + -_rate(learning_rate, count) * (inv * grads),
                {"count": count + 1, "sum": total})

    return Optimizer(init, update)


OPTIMIZERS = {"adam": adam, "adamw": adamw, "sgd": sgd, "rmsprop": rmsprop,
              "adagrad": adagrad}


def get_optimizer(name, kwargs):
    """The optimizer ``name`` (case-insensitive) made from ``kwargs``, where
    ``lr`` is an alias of ``learning_rate``, as the JAX package takes them
    (the ``optimizer`` and ``optimizer_kwargs`` flags)."""
    name = str(name).lower()
    if name not in OPTIMIZERS:
        raise NotImplementedError(
            f"Optimizer '{name}' is not ported; the port has {sorted(OPTIMIZERS)} "
            "(ROADMAP.md queue 1, item 12, part two, 'the other optax optimizers')."
        )
    kwargs = dict(kwargs)
    if "lr" in kwargs:
        kwargs["learning_rate"] = kwargs.pop("lr")
    return OPTIMIZERS[name](**kwargs)
