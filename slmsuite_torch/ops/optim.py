r"""
The optimizers that gradient phase retrieval steps
(:meth:`~slmsuite_torch.holography.algorithms.Hologram.optimize_cg`): every
name of optax 0.2.6 that the JAX package's CG can build
(``getattr(optax, name)(**kwargs)``, stepped by ``update(grads, state,
psi)`` and ``optax.apply_updates``), on torch tensors, with optax's argument
names, defaults and order of operations. The JAX package steps optax; optax
imports jax, so the port keeps its own copy of these rules.

Everything public here is built as optax builds it, as a :class:`Transform`
(``init(psi) -> state``; ``update(u, state, psi) -> (u', state')``): the 32
optimizers that take a learning rate (chains of transforms) and optax's 59
building blocks that take none, the gradient transformations (``clip``,
``scale_by_adam``, ``trace``, ...) and the combinators that take other
transforms (``chain``, ``masked``, ``partition``, ``flatten``,
``apply_if_finite``, ``inject_hyperparams``, ...). A combinator takes the
port's transforms where optax takes its own; a mask or a label is what optax
reads for the single array CG hands it: a Python bool or a label, or a
callable of the array. :func:`apply_updates` adds an update to psi, as
optax's does. :func:`get_optimizer` builds a name and returns an
:class:`Optimizer`, whose ``update(grads, state, psi)`` returns ``(psi + u,
state')``. Nothing is written in place.

Step counts are host integers, so a schedule (``learning_rate`` a Python
callable of the count, optax's ``ScalarOrSchedule``), ``should_transform_fn``
and the bias corrections cost no transfer. What depends on the data stays on
the device: ``apply_if_finite``'s counters, ``zero_nans``' flag, DoG's
running maxima, L-BFGS's memory. Where optax selects on the device
(``apply_if_finite``; ``conditionally_transform`` and ``conditionally_mask``
when the condition is a tensor), both branches are computed and selected
with ``torch.where``; a host count that differs between them becomes a
device tensor, which every rule here takes as it takes an integer. No update
reads a tensor on the host.

optax's order of operations is kept, and not ``torch.optim``'s, whose
defaults and rounding differ: optax adds RMSprop's ``eps`` inside the
square root, starts Adagrad's accumulator at 0.1, and forms Adam's
denominator as ``sqrt(nu_hat + eps_root) + eps`` from bias-corrected
moments. The scalars optax forms in float32 (``1 - decay**count``,
RAdam's rectification, Adafactor's decay, the noise scale of
``add_noise``, Fromage's multiplier, ``inject_hyperparams``' numeric
hyperparameters) are formed in float32 here too. The state stays in the
dtype of psi (float32) unless a ``mu_dtype`` or ``accumulator_dtype`` (a
``torch.dtype``) says otherwise. Norms and means over psi (LAMB, LARS,
Fromage, NovoGrad, Adafactor, SM3, the clipping rules, DoG, L-BFGS) treat
psi as one parameter, as optax treats the single array it is handed: a
plane for ``Hologram``, ``SpotHologram`` and ``MultiplaneHologram``, the
flat pixel vector for ``CompressedSpotHologram``.

``add_noise`` (and ``noisy_sgd``) cannot draw jax's bits: its ``key`` (or
the deprecated ``seed``) is an integer that seeds the port's own stream,
split each step as ``jax.random.split`` splits a key (:func:`_split_key`),
and the noise is drawn by :func:`_normal_like`; a step that
``apply_if_finite`` rejects still takes its key. Six names build and fail
under CG as they fail in the reference: ``chain`` with no transform raises
optax's ``ValueError``; ``inject_hyperparams`` and
``inject_stateful_hyperparams`` return a factory, which has no ``init``;
``lookahead`` needs ``LookaheadParams``, which a tensor is not;
``scale_by_polyak``, ``scale_by_backtracking_linesearch`` and
``scale_by_zoom_linesearch`` (so also ``polyak_sgd`` and ``lbfgs`` with its
default line search) need the loss value, which CG's ``update(grads,
state, psi)`` does not pass: their update raises optax's ``TypeError``. Any
other name raises ``AttributeError``, as ``getattr(optax, name)`` does.
"""

import functools
import inspect
import logging
import warnings
from collections import OrderedDict
from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class Transform(NamedTuple):
    """One of optax's gradient transformations: ``init(psi) -> state``;
    ``update(u, state, psi) -> (u', state')``."""

    init: Callable
    update: Callable


class Optimizer(NamedTuple):
    """A transform stepped as CG steps it: ``init(psi) -> state``;
    ``update(grads, state, psi) -> (psi', state')``."""

    init: Callable
    update: Callable


NO_PARAMS_MSG = (
    "You are using a transformation that requires the current value of "
    "parameters, but you are not passing `params` when calling `update`."
)


def _no_state(psi):
    return None


def _needs_params(psi):
    if psi is None:
        raise ValueError(NO_PARAMS_MSG)


def apply_updates(psi, updates):
    """optax's ``apply_updates``: ``psi + updates`` in psi's dtype."""
    if updates is None:
        return psi
    return (psi + updates).to(psi.dtype)


def chain(*args):
    """optax's ``chain``: each transform in turn on the previous one's
    update. With no transform it raises optax's ``ValueError``."""
    init_fns, update_fns = zip(*args)

    def init(psi):
        return tuple(fn(psi) for fn in init_fns)

    def update(u, state, psi=None):
        if len(update_fns) != len(state):
            raise ValueError("The number of updates and states has to be the same in chain! "
                             "Make sure you have called init first!")
        new = []
        for fn, s in zip(update_fns, state):
            u, s = fn(u, s, psi)
            new.append(s)
        return u, tuple(new)

    return Transform(init, update)


# ----------------------------------------------------------------------
# Helpers: optax's tree math on one tensor.
# ----------------------------------------------------------------------


def _f32(x):
    return np.float32(x)


def _correction(decay, count):
    """optax's bias correction ``1 - decay**count``, formed in float32 (on
    the device when the count is a tensor)."""
    if torch.is_tensor(count):
        return 1 - torch.pow(float(_f32(decay)), count.to(torch.float32))
    return float(_f32(1) - _f32(decay) ** count)


def _when(cond, a, b):
    """``a`` where ``cond`` holds, else ``b``: a host branch for a host
    condition, ``torch.where`` for a tensor."""
    if torch.is_tensor(cond):
        return torch.where(cond, a, b)
    return a if cond else b


class _Key(int):
    """A random key in a transform's state: a rejected step still takes it
    (:func:`_select` keeps the new one)."""


def _select(cond, new, old):
    """optax's ``lax.cond`` between two states of one structure: ``new``
    where the device condition ``cond`` holds, else ``old``. Host values
    that agree stay on the host; host numbers that differ become device
    tensors."""
    if new is old:
        return new
    if torch.is_tensor(new) or torch.is_tensor(old):
        return torch.where(cond, new, old)
    if isinstance(new, _Key):
        return new
    if isinstance(new, tuple) and hasattr(new, "_fields"):
        return type(new)(*(_select(cond, a, b) for a, b in zip(new, old)))
    if isinstance(new, (tuple, list)):
        return type(new)(_select(cond, a, b) for a, b in zip(new, old))
    if isinstance(new, dict):
        return type(new)((k, _select(cond, new[k], old[k])) for k in new)
    if isinstance(new, (bool, int, float, np.number)) and new != old:
        return torch.where(cond, new, old)
    return new


def _moment(g, t, decay, order):
    """optax's ``update_moment``: ``(1 - decay) g**order + decay t``."""
    return (1 - decay) * (g if order == 1 else g**order) + decay * t


def _cast(t, dtype):
    return t if dtype is None else t.to(dtype)


def _zeros(psi, dtype=None):
    return torch.zeros_like(psi, dtype=dtype)


def _norm(x):
    """``jnp.linalg.norm`` of the whole tensor, as jax forms it (torch's
    ``vector_norm`` in float32 rounds worse on a large plane)."""
    return torch.sqrt(torch.sum(x * x))


def _vdot(x, y):
    """optax's ``tree.vdot`` of two real tensors."""
    return torch.sum(x * y)


def _safe_norm(x, min_norm):
    """optax's ``numerics.safe_norm`` of the whole tensor."""
    norm = _norm(x)
    return torch.where(norm <= min_norm, min_norm, norm)


def _safe_rms(x, min_rms):
    """optax's ``numerics.safe_root_mean_squares``."""
    rms = torch.sqrt(torch.mean(x * x))
    return torch.where(rms <= min_rms, min_rms, rms)


def _mask_on(mask, tree):
    """A mask as optax's ``masked`` reads it for one array: a bool, or a
    callable of the array (psi at init, the update after)."""
    return bool(mask(tree) if callable(mask) else mask)


# ----------------------------------------------------------------------
# Leaves (optax's ``transform.py`` and ``transforms/``).
# ----------------------------------------------------------------------


def identity():
    return Transform(_no_state, lambda u, s, psi=None: (u, s))


def set_to_zero():
    return Transform(_no_state, lambda u, s, psi=None: (torch.zeros_like(u), s))


def stateless(f):
    """optax's ``stateless``: ``f(updates, params)``."""
    return Transform(_no_state, lambda u, s, psi=None: (f(u, psi), None))


def stateless_with_tree_map(f):
    """optax's ``stateless_with_tree_map``: ``f(update, param)`` of each
    leaf; CG's one tensor is the one leaf, so :func:`stateless`."""
    return stateless(f)


def scale(step_size):
    return Transform(_no_state, lambda u, s, psi=None: (step_size * u, s))


def scale_by_schedule(step_size_fn):
    def update(u, count, psi=None):
        step = step_size_fn(count)
        step = step.to(u.dtype) if torch.is_tensor(step) else float(_f32(step))
        return step * u, count + 1

    return Transform(lambda psi: 0, update)


def scale_by_learning_rate(learning_rate=None, *, flip_sign=True):
    """optax's ``scale_by_learning_rate``: ``-learning_rate * u`` (with
    ``flip_sign``); None is the identity. Also a top-level optimizer, as in
    optax."""
    if learning_rate is None:
        return identity()
    m = -1 if flip_sign else 1
    if callable(learning_rate):
        return scale_by_schedule(lambda count: m * learning_rate(count))
    return scale(m * learning_rate)


def clip(max_delta):
    return Transform(_no_state, lambda u, s, psi=None: (torch.clamp(u, -max_delta, max_delta), s))


def clip_by_block_rms(threshold):
    def update(u, state, psi=None):
        denom = torch.clamp(torch.sqrt(torch.mean(u * u)) / threshold, min=1.0)
        return u / denom, state

    return Transform(_no_state, update)


def clip_by_global_norm(max_norm):
    def update(u, state, psi=None):
        g_norm = _norm(u)
        return torch.where(g_norm < max_norm, u, (u / g_norm) * max_norm), state

    return Transform(_no_state, update)


def _unitwise_norm(x, axis=None):
    """optax's ``unitwise_norm``: the L2 norm of each unit, over ``axis``
    or, by rank, the whole vector, axis 0 (rank 2, 3) or axes 0-2 (rank 4)."""
    if axis is not None:
        dims = axis
    elif sum(n != 1 for n in x.shape) <= 1:
        dims = tuple(range(x.ndim))
    elif x.ndim in (2, 3):
        dims = 0
    elif x.ndim == 4:
        dims = (0, 1, 2)
    else:
        raise ValueError(f"Expected parameter with shape in {1, 2, 3, 4}, got "
                         f"{tuple(x.shape)}. Use axis parameter to specify reduction axes for "
                         "other shapes.")
    squared = torch.sum(x * x, dim=dims, keepdim=True)
    return torch.broadcast_to(torch.sqrt(squared), x.shape)


def adaptive_grad_clip(clipping, eps=1e-3, axis=None):
    def update(u, state, psi):
        _needs_params(psi)
        g_norm, p_norm = _unitwise_norm(u, axis), _unitwise_norm(psi, axis)
        max_norm = clipping * torch.clamp(p_norm, min=eps)
        clipped = u * (max_norm / torch.clamp(g_norm, min=1e-6))
        return torch.where(g_norm < max_norm, u, clipped), state

    return Transform(_no_state, update)


def add_decayed_weights(weight_decay=0.0, mask=None):
    def update(u, count, psi):
        _needs_params(psi)
        # optax never advances this count: a schedule is read at step 0.
        s = weight_decay(count) if callable(weight_decay) else weight_decay
        return u + s * psi, count

    inner = Transform(lambda psi: 0 if callable(weight_decay) else None, update)
    return inner if mask is None else masked(inner, mask)


def add_noise(eta, gamma, key=None, *, seed=None):
    """optax's ``add_noise``; ``key`` (or the deprecated ``seed``) is an
    integer seeding the port's own stream (see the module's docstring)."""
    if seed is not None:
        warnings.warn('"seed" is deprecated and will be removed in optax 0.2.7, use "key".',
                      DeprecationWarning)
        if key is not None:
            raise ValueError("Only one of seed or key can be specified.")
        key = seed
    if key is None:
        warnings.warn("Specifying a key will be required in optax 0.2.7.")
        key = 0
    if isinstance(key, bool) or not isinstance(key, (int, np.integer)):
        raise TypeError(f"add_noise's key must be an integer seed, not {type(key).__name__}")

    def update(u, state, psi=None):
        count, key = state
        count = count + 1
        if torch.is_tensor(count):
            std = torch.sqrt(float(_f32(eta)) / count.to(torch.float32) ** float(_f32(gamma)))
        else:
            std = float(np.sqrt(_f32(eta) / _f32(count) ** _f32(gamma)))
        key, sample = _split_key(key)
        return u + std * _normal_like(sample, u), (count, _Key(key))

    return Transform(lambda psi: (0, _Key(key)), update)


def _split_key(key):
    """``(next key, sample key)`` from an integer key, as
    ``jax.random.split`` gives two keys from one (another stream)."""
    words = np.random.SeedSequence(int(key)).generate_state(4, dtype=np.uint32)
    return int(words[0]) << 32 | int(words[1]), int(words[2]) << 32 | int(words[3])


def _normal_like(key, like):
    """Standard normal noise of ``like``'s shape, dtype and device, drawn
    from ``key`` (``add_noise``'s sampler)."""
    gen = torch.Generator(device=like.device).manual_seed(key)
    return torch.randn(like.shape, generator=gen, dtype=like.dtype, device=like.device)


def apply_every(k=1):
    """optax's ``apply_every``: accumulate ``k`` updates, emit their sum
    on every ``k``-th step and zeros between."""

    def update(u, state, psi=None):
        count, grad_acc = state
        c = count % k
        grad_acc = (c != 0) * grad_acc + u
        return (c == k - 1) * grad_acc, ((count + 1) % k, grad_acc)

    return Transform(lambda psi: (0, _zeros(psi)), update)


def centralize():
    """optax's ``centralize``: a tensor of rank 2 or more less its mean
    over every axis but the first (a vector is left as it is)."""

    def update(u, state, psi=None):
        if u.ndim > 1:
            u = u - u.mean(dim=tuple(range(1, u.ndim)), keepdim=True)
        return u, state

    return Transform(_no_state, update)


def ema(decay, debias=True, accumulator_dtype=None):
    def update(u, state, psi=None):
        count, ema_ = state
        new = _moment(u, ema_, decay, 1)
        count = count + 1
        out = new / _correction(decay, count) if debias else new
        return out, (count, _cast(new, accumulator_dtype))

    return Transform(lambda psi: (0, _zeros(psi, accumulator_dtype)), update)


def trace(decay, nesterov=False, accumulator_dtype=None):
    def update(u, trace_, psi=None):
        new = u + decay * trace_
        out = u + decay * new if nesterov else new
        return out, _cast(new, accumulator_dtype)

    return Transform(lambda psi: _zeros(psi, accumulator_dtype), update)


def keep_params_nonnegative():
    def update(u, state, psi):
        _needs_params(psi)
        return torch.where(psi + u < 0.0, -psi, u), state

    return Transform(_no_state, update)


def normalize_by_update_norm(scale_factor=1.0, eps=1e-6):
    def update(u, state, psi=None):
        return u / ((_norm(u) + eps) / scale_factor), state

    return Transform(_no_state, update)


def zero_nans():
    """optax's ``zero_nans``; its state (whether the last update held a
    nan) is a device bool."""

    def init(psi):
        return torch.zeros((), dtype=torch.bool, device=psi.device)

    def update(u, state, psi=None):
        nan = torch.isnan(u)
        return torch.where(nan, 0.0, u), torch.any(nan)

    return Transform(init, update)


def snapshot(measure_name, measure):
    """optax's ``snapshot``: the state holds ``{measure_name:
    measure(update)}`` (of psi at init)."""
    return Transform(lambda psi: {measure_name: measure(psi)},
                     lambda u, s, psi=None: (u, {measure_name: measure(u)}))


def _adam_moments(g, mu, nu, b1, b2, count_inc, nesterov):
    """The moments and bias-corrected moments of optax's ``scale_by_adam``
    (shared by its Adam, AMSGrad, RAdam and AdaBelief forms)."""
    if nesterov:
        mu_hat = (b1 * (mu / _correction(b1, count_inc + 1))
                  + (1 - b1) * (g / _correction(b1, count_inc)))
    else:
        mu_hat = mu / _correction(b1, count_inc)
    return mu_hat, nu / _correction(b2, count_inc)


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None, *, nesterov=False):
    def init(psi):
        return (0, _zeros(psi, mu_dtype), _zeros(psi))

    def update(g, state, psi=None):
        count, mu, nu = state
        mu = _moment(g, mu, b1, 1)
        nu = _moment(g, nu, b2, 2)
        mu_hat, nu_hat = _adam_moments(g, mu, nu, b1, b2, count + 1, nesterov)
        return (mu_hat / (torch.sqrt(nu_hat + eps_root) + eps),
                (count + 1, _cast(mu, mu_dtype), nu))

    return Transform(init, update)


def scale_by_amsgrad(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None):
    def init(psi):
        return (0, _zeros(psi, mu_dtype), _zeros(psi), _zeros(psi))

    def update(g, state, psi=None):
        count, mu, nu, nu_max = state
        mu = _moment(g, mu, b1, 1)
        nu = _moment(g, nu, b2, 2)
        mu_hat, nu_hat = _adam_moments(g, mu, nu, b1, b2, count + 1, False)
        nu_max = torch.maximum(nu_max, nu_hat)
        return (mu_hat / (torch.sqrt(nu_max + eps_root) + eps),
                (count + 1, _cast(mu, mu_dtype), nu, nu_max))

    return Transform(init, update)


def scale_by_adamax(b1=0.9, b2=0.999, eps=1e-8):
    def update(g, state, psi=None):
        count, mu, nu = state
        mu = _moment(g, mu, b1, 1)
        nu = torch.maximum(torch.abs(g) + eps, b2 * nu)
        return (mu / _correction(b1, count + 1)) / nu, (count + 1, mu, nu)

    return Transform(lambda psi: (0, _zeros(psi), _zeros(psi)), update)


def scale_by_lion(b1=0.9, b2=0.99, mu_dtype=None):
    def update(g, state, psi=None):
        count, mu = state
        u = torch.sign((1.0 - b1) * g + b1 * mu)
        return u, (count + 1, _cast(_moment(g, mu, b2, 1), mu_dtype))

    return Transform(lambda psi: (0, _zeros(psi, mu_dtype)), update)


def scale_by_adadelta(rho=0.9, eps=1e-6):
    def update(g, state, psi=None):
        e_g, e_x = state
        e_g = _moment(g, e_g, rho, 2)
        u = (torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps)) * g
        return u, (e_g, _moment(u, e_x, rho, 2))

    return Transform(lambda psi: (_zeros(psi), _zeros(psi)), update)


def scale_by_adan(b1=0.98, b2=0.92, b3=0.99, eps=1e-8, eps_root=0.0):
    def init(psi):
        return (_zeros(psi), _zeros(psi), _zeros(psi), _zeros(psi), 0)

    def update(g, state, psi=None):
        m, v, n, g_prev, t = state
        diff = _when(t == 0, torch.zeros_like(g), g - g_prev)
        m = _moment(g, m, b1, 1)
        v = _moment(diff, v, b2, 1)
        n = _moment(g + (1 - b2) * diff, n, b3, 2)
        t = t + 1
        m_hat = m / _correction(b1, t)
        v_hat = v / _correction(b2, t)
        n_hat = n / _correction(b3, t)
        u = (m_hat + (1 - b2) * v_hat) / (torch.sqrt(n_hat + eps_root) + eps)
        return u, (m, v, n, g, t)

    return Transform(init, update)


def scale_by_belief(b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16, *, nesterov=False):
    def update(g, state, psi=None):
        count, mu, nu = state
        mu = _moment(g, mu, b1, 1)
        nu = _moment(g - mu, nu, b2, 2) + eps_root
        mu_hat, nu_hat = _adam_moments(g, mu, nu, b1, b2, count + 1, nesterov)
        return mu_hat / (torch.sqrt(nu_hat) + eps), (count + 1, mu, nu)

    return Transform(lambda psi: (0, _zeros(psi), _zeros(psi)), update)


def scale_by_yogi(b1=0.9, b2=0.999, eps=1e-3, eps_root=0.0, initial_accumulator_value=1e-6):
    def init(psi):
        return (0, torch.full_like(psi, initial_accumulator_value),
                torch.full_like(psi, initial_accumulator_value))

    def update(g, state, psi=None):
        count, mu, nu = state
        mu = _moment(g, mu, b1, 1)
        g2 = g * g
        nu = nu - (1 - b2) * torch.sign(nu - g2) * g2
        mu_hat, nu_hat = _adam_moments(g, mu, nu, b1, b2, count + 1, False)
        return mu_hat / (torch.sqrt(nu_hat + eps_root) + eps), (count + 1, mu, nu)

    return Transform(init, update)


def scale_by_radam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, threshold=5.0, *, nesterov=False):
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    r_den = _f32((ro_inf - 4.0) * (ro_inf - 2.0))

    def update(g, state, psi=None):
        count, mu, nu = state
        mu = _moment(g, mu, b1, 1)
        nu = _moment(g, nu, b2, 2)
        count = count + 1
        mu_hat, nu_hat = _adam_moments(g, mu, nu, b1, b2, count, nesterov)
        if torch.is_tensor(count):
            b2t = torch.pow(float(_f32(b2)), count.to(torch.float32))
            ro = float(_f32(ro_inf)) - 2 * count.to(torch.float32) * b2t / (1 - b2t)
            r = torch.sqrt((ro - 4.0) * (ro - 2.0) * float(_f32(ro_inf)) / (float(r_den) * ro))
            u = torch.where(ro >= threshold,
                            r * mu_hat / (torch.sqrt(nu_hat + eps_root) + eps), mu_hat)
            return u, (count, mu, nu)
        b2t = _f32(b2) ** _f32(count)
        ro = _f32(ro_inf) - _f32(2 * count) * b2t / (_f32(1) - b2t)
        if ro >= threshold:
            r = np.sqrt((ro - _f32(4.0)) * (ro - _f32(2.0)) * _f32(ro_inf) / (r_den * ro))
            u = float(r) * mu_hat / (torch.sqrt(nu_hat + eps_root) + eps)
        else:
            u = mu_hat
        return u, (count, mu, nu)

    return Transform(lambda psi: (0, _zeros(psi), _zeros(psi)), update)


def scale_by_rms(decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True,
                 bias_correction=False):
    def update(g, state, psi=None):
        count, nu = state
        nu = _moment(g, nu, decay, 2)
        nu_hat = nu / _correction(decay, count + 1) if bias_correction else nu
        if eps_in_sqrt:
            scaling = torch.rsqrt(nu_hat + eps)
        else:
            scaling = 1 / (torch.sqrt(nu_hat) + eps)
        return scaling * g, (count + 1 if bias_correction else 0, nu)

    return Transform(lambda psi: (0, torch.full_like(psi, initial_scale)), update)


def scale_by_stddev(decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True,
                    bias_correction=False):
    def update(g, state, psi=None):
        count, mu, nu = state
        mu = _moment(g, mu, decay, 1)
        nu = _moment(g, nu, decay, 2)
        mu_hat, nu_hat = mu, nu
        if bias_correction:
            mu_hat = mu / _correction(decay, count + 1)
            nu_hat = nu / _correction(decay, count + 1)
        if eps_in_sqrt:
            scaling = torch.rsqrt(nu_hat - mu_hat * mu_hat + eps)
        else:
            scaling = 1 / (torch.sqrt(nu_hat - mu_hat * mu_hat) + eps)
        return scaling * g, (count + 1 if bias_correction else 0, mu, nu)

    return Transform(lambda psi: (0, _zeros(psi), torch.full_like(psi, initial_scale)), update)


def scale_by_rss(initial_accumulator_value=0.1, eps=1e-7):
    def update(g, total, psi=None):
        total = g * g + total
        return torch.where(total > 0, torch.rsqrt(total + eps), 0.0) * g, total

    return Transform(lambda psi: torch.full_like(psi, initial_accumulator_value), update)


def _scale_by_rprop(learning_rate, eta_minus=0.5, eta_plus=1.2, min_step_size=1e-6,
                    max_step_size=50.0):
    def init(psi):
        return (torch.full_like(psi, learning_rate), _zeros(psi))

    def update(g, state, psi=None):
        step_sizes, prev = state
        sign = g * prev
        grown = step_sizes * torch.where(sign > 0, eta_plus, eta_minus)
        step_sizes = torch.where(sign == 0, step_sizes,
                                 torch.clamp(grown, min_step_size, max_step_size))
        new_prev = torch.where(sign < 0, torch.zeros_like(g), step_sizes * torch.sign(g))
        # optax steps by the previous update (not the new one) where the
        # sign held.
        u = torch.where(sign < 0, torch.zeros_like(prev), prev)
        return u, (step_sizes, new_prev)

    return Transform(init, update)


def scale_by_sign():
    return Transform(_no_state, lambda u, s, psi=None: (torch.sign(u), s))


def scale_by_trust_ratio(min_norm=0.0, trust_coefficient=1.0, eps=0.0):
    def update(u, state, psi):
        _needs_params(psi)
        param_norm = _safe_norm(psi, min_norm)
        update_norm = _safe_norm(u, min_norm)
        ratio = trust_coefficient * param_norm / (update_norm + eps)
        zero = torch.logical_or(param_norm == 0.0, update_norm == 0.0)
        return u * torch.where(zero, 1.0, ratio), state

    return Transform(_no_state, update)


def scale_by_param_block_norm(min_scale=1e-3):
    def update(u, state, psi):
        _needs_params(psi)
        return u * _safe_norm(psi, min_scale), state

    return Transform(_no_state, update)


def scale_by_param_block_rms(min_scale=1e-3):
    def update(u, state, psi):
        _needs_params(psi)
        return u * _safe_rms(psi, min_scale), state

    return Transform(_no_state, update)


def scale_by_sm3(b1=0.9, b2=1.0, eps=1e-8):
    """optax's ``scale_by_sm3``: one accumulator vector per axis of psi."""
    coeffs = ((1.0 - b2) if b2 != 1.0 else 1.0, b2)

    def init(psi):
        return ([psi.new_zeros(s) for s in psi.shape], _zeros(psi))

    def update(g, state, psi=None):
        mu, nu = state
        if g.ndim < 2:
            accum = coeffs[0] * g**2 + coeffs[1] * mu[0]
        else:
            shaped = [v.reshape([1] * i + [g.shape[i]] + [1] * (g.ndim - i - 1))
                      for i, v in enumerate(mu)]
            least = shaped[0]
            for v in shaped[1:]:
                least = torch.minimum(least, v)
            accum = coeffs[0] * g**2 + coeffs[1] * least
        inv = torch.where(accum > 0, torch.rsqrt(accum + eps), 0.0)
        nu = _moment(g * inv, nu, b1, 1)
        if g.ndim < 2:
            mu = [accum]
        else:
            mu = [torch.amax(accum, dim=[d for d in range(g.ndim) if d != i])
                  for i in range(g.ndim)]
        return nu, (mu, nu)

    return Transform(init, update)


def scale_by_novograd(b1=0.9, b2=0.25, eps=1e-8, eps_root=0.0, weight_decay=0.0,
                      mu_dtype=None):
    def update(g, state, psi):
        count, mu, nu = state
        count = count + 1
        first = count == 1
        sq = (_norm(g) ** 2).to(nu.dtype)
        nu = _when(first, sq, _moment(sq, nu, b2, 1))
        step = g / (torch.sqrt(nu + eps_root) + eps) + weight_decay * psi
        mu = _cast(_when(first, step, b1 * mu + step), mu_dtype)
        return mu, (count, mu, nu)

    return Transform(lambda psi: (0, _zeros(psi, mu_dtype), psi.new_zeros(())), update)


def scale_by_optimistic_gradient(alpha=1.0, beta=1.0):
    def update(g, state, psi=None):
        initial, prev = state
        prev = _when(initial, g, prev)
        return (alpha + beta) * g - beta * prev, (False, g)

    return Transform(lambda psi: (True, _zeros(psi)), update)


def scale_by_distance_over_gradients(reps_rel=1e-6, eps=1e-8, param_dtype=torch.float32,
                                     global_scale=1.0):
    """optax's ``scale_by_distance_over_gradients`` (DoG), deprecated as in
    optax; its running maximum distance and sum of squares stay on the
    device. As optax 0.2.6 computes it: its step ``_tx(g, d, g_sos)`` is
    mapped over ``(max_dist, g_sos, updates)`` in that order, so the update
    is ``global_scale * g_sos / sqrt(updates + eps) * max_dist`` (nan where
    an update is below ``-eps``)."""
    warnings.warn("The function scale_by_distance_over_gradients is deprecated. Please use "
                  "optax.tree.cast instead.", DeprecationWarning)

    def l2(x, y=0.0):
        return torch.sqrt(torch.square(x - y).sum())

    def init(psi):
        return (reps_rel * (1 + l2(psi)), torch.zeros(1, device=psi.device),
                psi.to(param_dtype))

    def update(u, state, psi):
        max_dist, g_sos, init_params = state
        max_dist = torch.maximum(max_dist, l2(psi, init_params))
        g_sos = g_sos + torch.square(u).sum()
        return global_scale * (g_sos / torch.sqrt(u + eps)) * max_dist, (max_dist, g_sos,
                                                                        init_params)

    return Transform(init, update)


def _set_row(memory, index, row):
    """``memory.at[index].set(row)``, without writing ``memory``."""
    if torch.is_tensor(index):
        return memory.index_copy(0, index.reshape(1), row.unsqueeze(0))
    memory = memory.clone()
    memory[index] = row
    return memory


def scale_by_lbfgs(memory_size=10, scale_init_precond=True):
    """optax's ``scale_by_lbfgs``: the two-loop recursion over the last
    ``memory_size`` differences of psi and of the update, kept on the device
    (state: count, psi, update, the two memories, their weights)."""
    if memory_size < 1:
        raise ValueError("memory_size must be >= 1")

    def init(psi):
        memory = psi.new_zeros((memory_size, *psi.shape))
        return (0, _zeros(psi), _zeros(psi), memory, memory,
                torch.zeros(memory_size, device=psi.device))

    def update(u, state, psi):
        count, params, updates, dp_memory, du_memory, weights = state
        index = count % memory_size
        prev_index = (count - 1) % memory_size
        started = count > 0
        dp, du = psi - params, u - updates
        vdot = _vdot(du, dp)
        weight = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
        dp = _when(started, dp, torch.zeros_like(dp))
        du = _when(started, du, torch.zeros_like(du))
        weight = _when(started, weight, torch.zeros_like(weight))
        dp_memory = _set_row(dp_memory, prev_index, dp)
        du_memory = _set_row(du_memory, prev_index, du)
        weights = _set_row(weights, prev_index, weight.to(weights.dtype))
        if scale_init_precond:
            numerator = _vdot(du, dp)
            denominator = torch.sum(du * du)
            identity_scale = torch.where(denominator > 0.0, numerator / denominator, 1.0)
            capped_inv_norm = torch.clamp(1.0 / _norm(u), max=1.0)
            identity_scale = _when(started, identity_scale, capped_inv_norm)
        else:
            identity_scale = 1.0
        if torch.is_tensor(index):
            order = (index + torch.arange(memory_size, device=u.device)) % memory_size
        else:
            order = [(index + i) % memory_size for i in range(memory_size)]
        vec, alphas = u, [None] * memory_size
        for i in reversed(range(memory_size)):
            j = order[i]
            alphas[i] = weights[j] * _vdot(dp_memory[j], vec)
            vec = (vec + -alphas[i] * du_memory[j]).to(u.dtype)
        vec = identity_scale * vec
        for i in range(memory_size):
            j = order[i]
            beta = weights[j] * _vdot(du_memory[j], vec)
            vec = (vec + (alphas[i] - beta) * dp_memory[j]).to(u.dtype)
        return vec, (count + 1, psi, u, dp_memory, du_memory, weights)

    return Transform(init, update)


def _scale_by_factored_rms(factored=True, decay_rate=0.8, step_offset=0,
                           min_dim_size_to_factor=128, epsilon=1e-30):
    """optax's ``scale_by_factored_rms`` (Adafactor's second moment): row
    and column accumulators on the two largest axes of psi when both are at
    least ``min_dim_size_to_factor``, else one per element."""

    def dims(shape):
        if not factored or len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < min_dim_size_to_factor:
            return None
        return int(order[-2]), int(order[-1])

    def init(psi):
        d = dims(psi.shape)
        if d is None:
            return (0, None, None, _zeros(psi))
        d1, d0 = d
        return (0, psi.new_zeros(np.delete(psi.shape, d0).tolist()),
                psi.new_zeros(np.delete(psi.shape, d1).tolist()), None)

    def update(g, state, psi=None):
        count, v_row, v_col, v = state
        if torch.is_tensor(count):
            t = (count - step_offset + 1).to(torch.float32)
            decay = 1.0 - t ** float(_f32(-decay_rate))
        else:
            t = _f32(count - step_offset + 1)
            decay = float(_f32(1.0) - t ** _f32(-decay_rate))
        grad_sqr = g * g + epsilon
        d = dims(g.shape)
        if d is None:
            v = decay * v + (1.0 - decay) * grad_sqr
            return g * v**-0.5, (count + 1, None, None, v)
        d1, d0 = d
        v_row = decay * v_row + (1.0 - decay) * torch.mean(grad_sqr, dim=d0)
        v_col = decay * v_col + (1.0 - decay) * torch.mean(grad_sqr, dim=d1)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = torch.mean(v_row, dim=reduced_d1, keepdim=True)
        row_factor = (v_row / row_col_mean) ** -0.5
        col_factor = v_col**-0.5
        u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        return u, (count + 1, v_row, v_col, None)

    return Transform(init, update)


def _needs_value(name, needed):
    """A transform whose update needs more than CG passes (the loss value):
    it builds, and its update raises optax's ``TypeError``."""

    def update(u, state, psi=None):
        args = ", ".join(f"'{n}'" for n in needed[:-1])
        args = f"{args}, and '{needed[-1]}'" if args else f"'{needed[-1]}'"
        raise TypeError(f"{name}.<locals>.update_fn() missing {len(needed)} required "
                        f"keyword-only argument{'s' if len(needed) > 1 else ''}: {args}")

    return Transform(_no_state, update)


def scale_by_polyak(f_min=0.0, max_learning_rate=1.0, eps=0.0, variant="sps"):
    return _needs_value("scale_by_polyak", ("value",))


def scale_by_backtracking_linesearch(max_backtracking_steps, slope_rtol=1e-4,
                                     decrease_factor=0.8, increase_factor=1.5,
                                     max_learning_rate=1.0, atol=0.0, rtol=0.0,
                                     store_grad=False, verbose=False):
    return _needs_value("scale_by_backtracking_linesearch", ("value", "grad", "value_fn"))


def scale_by_zoom_linesearch(max_linesearch_steps, max_learning_rate=None, tol=0.0,
                             increase_factor=2.0, slope_rtol=1e-4, curv_rtol=0.9,
                             approx_dec_rtol=1e-6, stepsize_precision=1e-5,
                             initial_guess_strategy="keep", verbose=False):
    return _needs_value("scale_by_zoom_linesearch", ("value", "grad", "value_fn"))


# ----------------------------------------------------------------------
# Combinators (optax's ``transforms/``, ``lookahead.py``, ``schedules/``).
# ----------------------------------------------------------------------


def with_extra_args_support(tx):
    """optax's ``with_extra_args_support``: the port passes no extra
    arguments (CG has none), so the transform as it is."""
    return Transform(tx.init, tx.update)


def named_chain(*args):
    names = [name for name, _ in args]
    if len(names) != len(set(names)):
        raise ValueError(f"Named transformations must have unique names, but got {names}")

    def init(psi):
        return OrderedDict((name, tx.init(psi)) for name, tx in args)

    def update(u, state, psi=None):
        new = OrderedDict()
        for name, tx in args:
            u, new[name] = tx.update(u, state[name], psi)
        return u, new

    return Transform(init, update)


def masked(inner, mask, *, mask_compatible_extra_args=False):
    """optax's ``masked`` on one array: ``inner`` where the mask is on,
    the update passed through (and no inner state) where it is off."""

    def init(psi):
        return inner.init(psi) if _mask_on(mask, psi) else None

    def update(u, state, psi=None):
        if not _mask_on(mask, u):
            return u, state
        return inner.update(u, state, psi)

    return Transform(init, update)


def freeze(mask):
    """optax's ``freeze``: zero updates where the mask is on."""
    return masked(set_to_zero(), mask)


class PartitionState(NamedTuple):
    inner_states: dict


def partition(transforms, param_labels, *, mask_compatible_extra_args=False):
    """optax's ``partition`` (and ``multi_transform``) on one array: the
    transform whose key is the array's label (``param_labels``, or its
    value on the array); the others see it masked off."""
    transforms = dict(transforms)

    def label_of(tree):
        return param_labels(tree) if callable(param_labels) else param_labels

    def init(psi):
        label = label_of(psi)
        labels = set() if label is None else {label}
        if not labels.issubset(transforms.keys()):
            raise ValueError("Some parameters have no corresponding transformation.\n"
                             f"Parameter labels: {list(sorted(labels))} \n"
                             f"Transforms keys: {list(sorted(transforms.keys()))} \n")
        return PartitionState({group: masked(tx, label == group).init(psi)
                               for group, tx in transforms.items()})

    def update(u, state, psi=None):
        label = label_of(u)
        new = {}
        for group, tx in transforms.items():
            u, new[group] = masked(tx, label == group).update(u, state.inner_states[group], psi)
        return u, PartitionState(new)

    return Transform(init, update)


multi_transform = partition


def selective_transform(optimizer, *, freeze_mask):
    """optax's ``selective_transform``: ``optimizer`` where ``freeze_mask``
    is off, zero updates where it is on."""
    return partition({"train": optimizer, "freeze": set_to_zero()},
                     param_labels=lambda params: "freeze" if freeze_mask else "train")


def flatten(inner):
    """optax's ``flatten``: ``inner`` on the raveled array (a factored rule,
    Adafactor or SM3, then sees a vector)."""

    def init(psi):
        return inner.init(psi.reshape(-1))

    def update(u, state, psi=None):
        flat = None if psi is None else psi.reshape(-1)
        out, state = inner.update(u.reshape(-1), state, flat)
        return out.reshape(u.shape), state

    return Transform(init, update)


def conditionally_transform(inner, should_transform_fn, forward_extra_args=False):
    """optax's ``conditionally_transform``: ``inner`` on the steps where
    ``should_transform_fn(step)`` holds, the update passed through (and
    the inner state kept) on the others. State: ``(inner_state, step)``."""

    def update(u, state, psi=None):
        inner_state, step = state
        cond = should_transform_fn(step)
        if not torch.is_tensor(cond):
            out = inner.update(u, inner_state, psi) if cond else (u, inner_state)
        else:
            out = _select(cond, inner.update(u, inner_state, psi), (u, inner_state))
        return out[0], (out[1], step + 1)

    return Transform(lambda psi: (inner.init(psi), 0), update)


def conditionally_mask(inner, should_transform_fn, forward_extra_args=False):
    """optax's ``conditionally_mask``: ``inner`` on the steps where
    ``should_transform_fn(step)`` holds, zero updates (and the inner state
    kept) on the others. State: ``(step, inner_state)``."""

    def update(u, state, psi=None):
        step, inner_state = state
        cond = should_transform_fn(step)
        if not torch.is_tensor(cond):
            out = inner.update(u, inner_state, psi) if cond else (torch.zeros_like(u),
                                                                   inner_state)
        else:
            out = _select(cond, inner.update(u, inner_state, psi),
                          (torch.zeros_like(u), inner_state))
        return out[0], (step + 1, out[1])

    return Transform(lambda psi: (0, inner.init(psi)), update)


class ApplyIfFiniteState(NamedTuple):
    notfinite_count: Any
    last_finite: Any
    total_notfinite: Any
    inner_state: Any


def apply_if_finite(inner, max_consecutive_errors):
    """optax's ``apply_if_finite``: ``inner``'s update where the update is
    finite (or after more than ``max_consecutive_errors`` non-finite ones
    in a row), else zeros and the inner state kept. Decided on the device:
    the counters are device tensors, and both outcomes are formed and
    selected (:func:`_select`)."""

    def init(psi):
        zero = torch.zeros((), dtype=torch.int32, device=psi.device)
        return ApplyIfFiniteState(zero, torch.ones((), dtype=torch.bool, device=psi.device),
                                  zero, inner.init(psi))

    def update(u, state, psi=None):
        isfinite = torch.all(torch.isfinite(u))
        notfinite_count = torch.where(isfinite, 0, state.notfinite_count + 1)
        apply = torch.logical_or(isfinite, notfinite_count > max_consecutive_errors)
        new_u, new_inner = inner.update(u, state.inner_state, psi)
        return torch.where(apply, new_u, 0.0), ApplyIfFiniteState(
            notfinite_count, isfinite,
            torch.where(isfinite, state.total_notfinite, state.total_notfinite + 1),
            _select(apply, new_inner, state.inner_state))

    return Transform(init, update)


class LookaheadParams(NamedTuple):
    """optax's ``LookaheadParams``: the fast and slow parameters."""

    fast: Any
    slow: Any

    @classmethod
    def init_synced(cls, params):
        return cls(slow=params, fast=params)


def lookahead(fast_optimizer, sync_period, slow_step_size, reset_state=False):
    """optax's ``lookahead``. Its parameters are ``LookaheadParams``; on
    the tensor CG hands it, ``init`` logs optax's warning and ``update``
    raises ``AttributeError``, as optax's does."""
    if sync_period < 1:
        raise ValueError("Synchronization period must be >= 1.")

    def init(psi):
        fast = getattr(psi, "fast", None)
        if fast is None:
            logging.warning("`params` has no attribute `fast`. Continuing by assuming that "
                            "only fast parameters were passed to lookahead init.")
            fast = psi
        return (fast_optimizer.init(fast), 0)

    def update(u, state, psi):
        fast_state, steps_since_sync = state
        u, fast_state = fast_optimizer.update(u, fast_state, psi.fast)
        sync_next = steps_since_sync == sync_period - 1
        diff = psi.fast + u - psi.slow
        u = LookaheadParams(fast=u - sync_next * (1 - slow_step_size) * diff,
                            slow=slow_step_size * sync_next * diff)
        if reset_state and sync_next:
            fast_state = fast_optimizer.init(psi.fast)
        return u, (fast_state, (steps_since_sync + 1) % sync_period)

    return Transform(init, update)


class InjectStatefulHyperparamsState(NamedTuple):
    count: Any
    hyperparams: dict
    hyperparams_states: dict
    inner_state: Any


class WrappedScheduleState(NamedTuple):
    count: Any


class WrappedSchedule:
    """optax's ``WrappedSchedule``: a schedule of the step count, kept as a
    stateful schedule by ``inject_hyperparams``."""

    def __init__(self, schedule_fn):
        self.schedule_fn = schedule_fn

    def init(self):
        return WrappedScheduleState(count=0)

    def update(self, state):
        return WrappedScheduleState(count=state.count + 1)

    def __call__(self, state):
        return self.schedule_fn(state.count)


_NP_FLOATS = {torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64}


def _convert_floats(x, dtype):
    """optax's ``_convert_floats``: a floating hyperparameter in ``dtype``
    (a host number rounded to it, a tensor cast), anything else as it is."""
    if torch.is_tensor(x):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, (float, np.floating)) or (isinstance(x, np.ndarray)
                                               and np.issubdtype(x.dtype, np.floating)):
        rounded = np.asarray(x, dtype=_NP_FLOATS.get(dtype, dtype))
        return float(rounded) if rounded.ndim == 0 else rounded
    return x


def _torch_dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(v): k for k, v in _NP_FLOATS.items()}[np.dtype(dtype)]


def inject_hyperparams(inner_factory, static_args=(), hyperparam_dtype=None):
    """optax's ``inject_hyperparams``: a factory taking ``inner_factory``'s
    arguments whose transform keeps the numeric ones (and schedules, read
    at the step count) in its state, ``(count, hyperparams,
    hyperparams_states, inner_state)``, in ``hyperparam_dtype`` (psi's
    dtype by default), and builds ``inner_factory`` from them each step."""
    static_args = {static_args} if isinstance(static_args, str) else set(static_args)
    signature = inspect.signature(inner_factory)
    if not static_args.issubset(signature.parameters):
        raise ValueError(
            "`static_args` must specify a subset of `inner_factory`'s parameters. "
            f"Given `static_args`: {static_args}. `inner_factory` parameters: "
            f"{set(signature.parameters.keys())}")
    hyperparam_dtype = _torch_dtype(hyperparam_dtype)

    @functools.wraps(inner_factory)
    def wrapped_transform(*args, **kwargs):
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        sched_hps, numeric_hps, other_hps = {}, {}, {}
        for name, value in bound.arguments.items():
            if name in static_args or isinstance(value, bool):
                other_hps[name] = value
            elif callable(value) and hasattr(value, "init") and hasattr(value, "update"):
                sched_hps[name] = value  # A stateful schedule, as WrappedSchedule.
            elif callable(value):
                sched_hps[name] = WrappedSchedule(value)
            elif isinstance(value, (int, float, np.number, np.ndarray, torch.Tensor)):
                numeric_hps[name] = value
            else:
                other_hps[name] = value

        def init(psi):
            dtype = psi.dtype if hyperparam_dtype is None else hyperparam_dtype
            hparams = {k: _convert_floats(v, dtype) for k, v in numeric_hps.items()}
            hparams_states = {k: f.init() for k, f in sched_hps.items()}
            hparams.update({k: _convert_floats(f(hparams_states[k]), dtype)
                            for k, f in sched_hps.items()})
            return InjectStatefulHyperparamsState(
                0, hparams, hparams_states, inner_factory(**other_hps, **hparams).init(psi))

        def update(u, state, psi=None):
            dtype = u.dtype if hyperparam_dtype is None else hyperparam_dtype
            hparams = {k: _convert_floats(v, dtype) for k, v in state.hyperparams.items()}
            hparams.update({k: _convert_floats(f(state.hyperparams_states[k]), dtype)
                            for k, f in sched_hps.items()})
            hparams_states = {k: f.update(state.hyperparams_states[k])
                              for k, f in sched_hps.items()}
            u, inner_state = inner_factory(**other_hps, **hparams).update(
                u, state.inner_state, psi)
            return u, InjectStatefulHyperparamsState(state.count + 1, hparams, hparams_states,
                                                     inner_state)

        return Transform(init, update)

    return wrapped_transform


def inject_stateful_hyperparams(inner_factory, static_args=(), hyperparam_dtype=None):
    warnings.warn("inject_stateful_hyperparams is deprecated, use inject_hyperparams instead",
                  DeprecationWarning)
    return inject_hyperparams(inner_factory, static_args, hyperparam_dtype)


# ----------------------------------------------------------------------
# The optimizers (optax's ``alias.py``).
# ----------------------------------------------------------------------


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None, *,
         nesterov=False):
    return chain(scale_by_adam(b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov),
                 scale_by_learning_rate(learning_rate))


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None,
          weight_decay=1e-4, mask=None, *, nesterov=False):
    return chain(scale_by_adam(b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov),
                 add_decayed_weights(weight_decay, mask), scale_by_learning_rate(learning_rate))


def nadam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None, *,
          nesterov=True):
    """optax's ``nadam``: ``adam`` with ``nesterov=True``."""
    return adam(learning_rate, b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov)


def nadamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None,
           weight_decay=1e-4, mask=None, *, nesterov=True):
    """optax's ``nadamw``: ``adamw`` with ``nesterov=True``."""
    return adamw(learning_rate, b1, b2, eps, eps_root, mu_dtype, weight_decay, mask,
                 nesterov=nesterov)


def sgd(learning_rate, momentum=None, nesterov=False, accumulator_dtype=None):
    head = [] if momentum is None else [trace(momentum, nesterov, accumulator_dtype)]
    return chain(*head, scale_by_learning_rate(learning_rate))


def rmsprop(learning_rate, decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True,
            centered=False, momentum=None, nesterov=False, bias_correction=False):
    """optax's ``rmsprop``: ``scale_by_rms`` (``scale_by_stddev`` when
    ``centered``), the learning rate, then the momentum ``trace``."""
    rule = scale_by_stddev if centered else scale_by_rms
    return chain(rule(decay, eps, initial_scale, eps_in_sqrt, bias_correction),
                 scale_by_learning_rate(learning_rate),
                 identity() if momentum is None else trace(momentum, nesterov))


def adagrad(learning_rate, initial_accumulator_value=0.1, eps=1e-7):
    return chain(scale_by_rss(initial_accumulator_value, eps),
                 scale_by_learning_rate(learning_rate))


def adabelief(learning_rate, b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16, *,
              nesterov=False):
    return chain(scale_by_belief(b1, b2, eps, eps_root, nesterov=nesterov),
                 scale_by_learning_rate(learning_rate))


def adadelta(learning_rate=None, rho=0.9, eps=1e-6, weight_decay=0.0,
             weight_decay_mask=None):
    return chain(add_decayed_weights(weight_decay, weight_decay_mask),
                 scale_by_adadelta(rho, eps), scale_by_learning_rate(learning_rate))


def adafactor(learning_rate=None, min_dim_size_to_factor=128, decay_rate=0.8,
              decay_offset=0, multiply_by_parameter_scale=True, clipping_threshold=1.0,
              momentum=None, dtype_momentum=torch.float32, weight_decay_rate=None,
              eps=1e-30, factored=True, weight_decay_mask=None):
    tx = [_scale_by_factored_rms(factored, decay_rate, decay_offset,
                                 min_dim_size_to_factor, eps)]
    if clipping_threshold is not None:
        tx.append(clip_by_block_rms(clipping_threshold))
    if learning_rate is not None:
        tx.append(scale_by_learning_rate(learning_rate, flip_sign=False))
    if multiply_by_parameter_scale:
        tx.append(scale_by_param_block_rms())
    if momentum is not None:
        tx.append(ema(momentum, debias=False, accumulator_dtype=dtype_momentum))
    if weight_decay_rate is not None:
        tx.append(add_decayed_weights(weight_decay_rate, weight_decay_mask))
    tx.append(scale(-1))
    return chain(*tx)


def adamax(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    return chain(scale_by_adamax(b1, b2, eps), scale_by_learning_rate(learning_rate))


def adamaxw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4, mask=None):
    return chain(scale_by_adamax(b1, b2, eps), add_decayed_weights(weight_decay, mask),
                 scale_by_learning_rate(learning_rate))


def adan(learning_rate, b1=0.98, b2=0.92, b3=0.99, eps=1e-8, eps_root=1e-8,
         weight_decay=0.0, mask=None):
    return chain(scale_by_adan(b1, b2, b3, eps, eps_root),
                 add_decayed_weights(weight_decay, mask), scale_by_learning_rate(learning_rate))


def amsgrad(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None):
    return chain(scale_by_amsgrad(b1, b2, eps, eps_root, mu_dtype),
                 scale_by_learning_rate(learning_rate))


def fromage(learning_rate, min_norm=1e-6):
    """optax's ``fromage``: its multiplier ``1/sqrt(1 + lr**2)`` in float32."""
    if not callable(learning_rate):
        mult = _f32(1) / np.sqrt(_f32(1 + learning_rate**2))
        return chain(scale_by_trust_ratio(min_norm),
                     scale_by_learning_rate(float(_f32(learning_rate) * mult)),
                     add_decayed_weights(float(mult - _f32(1))))

    def mult_lr(count):
        return _f32(1) / np.sqrt(_f32(1 + learning_rate(count) ** 2))

    return chain(scale_by_trust_ratio(min_norm),
                 scale_by_learning_rate(lambda c: float(mult_lr(c) * _f32(learning_rate(c)))),
                 add_decayed_weights(lambda c: float(mult_lr(c) - _f32(1))))


def lamb(learning_rate, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0, weight_decay=0.0,
         mask=None):
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 add_decayed_weights(weight_decay, mask), scale_by_trust_ratio(),
                 scale_by_learning_rate(learning_rate))


def lars(learning_rate, weight_decay=0.0, weight_decay_mask=True, trust_coefficient=0.001,
         eps=0.0, trust_ratio_mask=True, momentum=0.9, nesterov=False):
    return chain(add_decayed_weights(weight_decay, weight_decay_mask),
                 masked(scale_by_trust_ratio(trust_coefficient=trust_coefficient, eps=eps),
                        trust_ratio_mask),
                 scale_by_learning_rate(learning_rate), trace(momentum, nesterov))


def lion(learning_rate, b1=0.9, b2=0.99, mu_dtype=None, weight_decay=1e-3, mask=None):
    return chain(scale_by_lion(b1, b2, mu_dtype), add_decayed_weights(weight_decay, mask),
                 scale_by_learning_rate(learning_rate))


def noisy_sgd(learning_rate, eta=0.01, gamma=0.55, key=None, *, seed=None):
    """optax's ``noisy_sgd``: ``add_noise`` (its ``key``, see the module's
    docstring), then the learning rate."""
    return chain(add_noise(eta, gamma, key, seed=seed), scale_by_learning_rate(learning_rate))


def novograd(learning_rate, b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0, weight_decay=0.0):
    return chain(scale_by_novograd(b1, b2, eps, eps_root, weight_decay),
                 scale_by_learning_rate(learning_rate))


def optimistic_gradient_descent(learning_rate, alpha=1.0, beta=1.0):
    return chain(scale_by_optimistic_gradient(alpha, beta), scale_by_learning_rate(learning_rate))


def optimistic_adam(learning_rate, optimism=None, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                    mu_dtype=None, *, nesterov=True):
    warnings.warn("`optimistic_adam` is deprecated, please use `optimistic_adam_v2` "
                  "instead.", category=DeprecationWarning)
    if callable(learning_rate):
        raise ValueError("This version of `optimistic_adam` does not support learning rate "
                         "schedules but `optimistic_adam_v2` does.")
    if optimism is None:
        optimism = learning_rate
    return chain(scale_by_adam(b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov),
                 scale_by_optimistic_gradient(alpha=learning_rate, beta=optimism),
                 scale_by_learning_rate(1.0))


def optimistic_adam_v2(learning_rate, *, alpha=1.0, beta=1.0, b1=0.9, b2=0.999, eps=1e-8,
                       eps_root=0.0, mu_dtype=None, nesterov=True):
    return chain(scale_by_adam(b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov),
                 scale_by_optimistic_gradient(alpha, beta), scale_by_learning_rate(learning_rate))


def radam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, threshold=5.0, *,
          nesterov=False):
    return chain(scale_by_radam(b1, b2, eps, eps_root, threshold, nesterov=nesterov),
                 scale_by_learning_rate(learning_rate))


def rprop(learning_rate, eta_minus=0.5, eta_plus=1.2, min_step_size=1e-6,
          max_step_size=50.0):
    return chain(_scale_by_rprop(learning_rate, eta_minus, eta_plus, min_step_size,
                                 max_step_size), scale(-1.0))


def scale_by_rprop(learning_rate, eta_minus=0.5, eta_plus=1.2, min_step_size=1e-6,
                   max_step_size=50.0):
    """optax's ``scale_by_rprop``, also a top-level optimizer: its steps are
    applied with their sign, as ``rprop`` flips them."""
    return _scale_by_rprop(learning_rate, eta_minus, eta_plus, min_step_size, max_step_size)


def sign_sgd(learning_rate):
    return chain(scale_by_sign(), scale_by_learning_rate(learning_rate))


def sm3(learning_rate, momentum=0.9):
    return chain(scale_by_sm3(momentum), scale(-learning_rate))


def yogi(learning_rate, b1=0.9, b2=0.999, eps=1e-3):
    return chain(scale_by_yogi(b1, b2, eps), scale_by_learning_rate(learning_rate))


def lbfgs(learning_rate=None, memory_size=10, scale_init_precond=True,
          linesearch=scale_by_zoom_linesearch(max_linesearch_steps=20,
                                              initial_guess_strategy="one")):
    """optax's ``lbfgs``: ``scale_by_lbfgs``, the rate (``-1`` without
    one), then the line search, whose default needs the loss value."""
    rate = scale(-1.0) if learning_rate is None else scale_by_learning_rate(learning_rate)
    return chain(scale_by_lbfgs(memory_size, scale_init_precond), rate,
                 identity() if linesearch is None else linesearch)


def polyak_sgd(max_learning_rate=1.0, scaling=1.0, f_min=0.0, eps=0.0, variant="sps"):
    return chain(sgd(learning_rate=scaling),
                 scale_by_polyak(max_learning_rate=max_learning_rate, f_min=f_min, eps=eps,
                                 variant=variant))


OPTIMIZERS = {f.__name__: f for f in (
    adabelief, adadelta, adafactor, adagrad, adam, adamax, adamaxw, adamw, adan, amsgrad,
    fromage, lamb, lars, lion, nadam, nadamw, noisy_sgd, novograd, optimistic_adam,
    optimistic_adam_v2, optimistic_gradient_descent, radam, rmsprop, rprop,
    scale_by_learning_rate, scale_by_rprop, sgd, sign_sgd, sm3, yogi, lbfgs, polyak_sgd)}

#: optax 0.2.6's gradient transformations that take no learning rate: a
#: user reaches them through ``optimizer_kwargs`` of their own.
BUILDING_BLOCKS = {
    "adaptive_grad_clip": adaptive_grad_clip, "add_decayed_weights": add_decayed_weights,
    "add_noise": add_noise, "apply_every": apply_every, "apply_if_finite": apply_if_finite,
    "centralize": centralize, "chain": chain, "clip": clip,
    "clip_by_block_rms": clip_by_block_rms, "clip_by_global_norm": clip_by_global_norm,
    "conditionally_mask": conditionally_mask,
    "conditionally_transform": conditionally_transform, "ema": ema, "flatten": flatten,
    "freeze": freeze, "identity": identity, "inject_hyperparams": inject_hyperparams,
    "inject_stateful_hyperparams": inject_stateful_hyperparams,
    "keep_params_nonnegative": keep_params_nonnegative, "lookahead": lookahead,
    "masked": masked, "multi_transform": multi_transform, "named_chain": named_chain,
    "normalize_by_update_norm": normalize_by_update_norm, "partition": partition,
    "scale": scale, "scale_by_adadelta": scale_by_adadelta, "scale_by_adam": scale_by_adam,
    "scale_by_adamax": scale_by_adamax, "scale_by_adan": scale_by_adan,
    "scale_by_amsgrad": scale_by_amsgrad,
    "scale_by_backtracking_linesearch": scale_by_backtracking_linesearch,
    "scale_by_belief": scale_by_belief,
    "scale_by_distance_over_gradients": scale_by_distance_over_gradients,
    "scale_by_lbfgs": scale_by_lbfgs, "scale_by_lion": scale_by_lion,
    "scale_by_novograd": scale_by_novograd,
    "scale_by_optimistic_gradient": scale_by_optimistic_gradient,
    "scale_by_param_block_norm": scale_by_param_block_norm,
    "scale_by_param_block_rms": scale_by_param_block_rms, "scale_by_polyak": scale_by_polyak,
    "scale_by_radam": scale_by_radam, "scale_by_rms": scale_by_rms,
    "scale_by_rss": scale_by_rss, "scale_by_schedule": scale_by_schedule,
    "scale_by_sign": scale_by_sign, "scale_by_sm3": scale_by_sm3,
    "scale_by_stddev": scale_by_stddev, "scale_by_trust_ratio": scale_by_trust_ratio,
    "scale_by_yogi": scale_by_yogi, "scale_by_zoom_linesearch": scale_by_zoom_linesearch,
    "selective_transform": selective_transform, "set_to_zero": set_to_zero,
    "snapshot": snapshot, "stateless": stateless,
    "stateless_with_tree_map": stateless_with_tree_map, "trace": trace,
    "with_extra_args_support": with_extra_args_support, "zero_nans": zero_nans,
}


def _stepper(tx):
    """CG's step of a transform: ``update(grads, state, psi)`` returns
    ``(apply_updates(psi, u), state')``. Its attributes are read at the
    call, so a name that builds no transform (``inject_hyperparams``'
    factory) raises there, as optax's does."""

    def init(psi):
        return tx.init(psi)

    def update(grads, state, psi):
        u, state = tx.update(grads, state, psi)
        return apply_updates(psi, u), state

    return Optimizer(init, update)


def get_optimizer(name, kwargs):
    """The optimizer or building block ``name`` (case-insensitive) made from
    ``kwargs``, where ``lr`` is an alias of ``learning_rate``, as the JAX
    package takes them (the ``optimizer`` and ``optimizer_kwargs`` flags),
    stepped as CG steps it (:class:`Optimizer`)."""
    name = str(name).lower()
    factory = OPTIMIZERS.get(name, BUILDING_BLOCKS.get(name))
    if factory is None:
        raise AttributeError(f"module 'optax' has no attribute '{name}'")
    kwargs = dict(kwargs)
    if "lr" in kwargs:
        kwargs["learning_rate"] = kwargs.pop("lr")
    return _stepper(factory(**kwargs))
