r"""
The optimizers that gradient phase retrieval steps
(:meth:`~slmsuite_torch.holography.algorithms.Hologram.optimize_cg`): every
optimizer of optax 0.2.6 that the JAX package's CG can build by name with a
learning rate (``getattr(optax, name)(**kwargs)``, stepped by
``update(grads, state, psi)``), on torch tensors, with optax's argument
names, defaults and order of operations. The JAX package steps optax; optax
imports jax, so the port keeps its own copy of these rules.

Each optimizer is built as optax builds it, as a chain of transforms, each
functional: ``init(psi) -> state`` and ``update(u, state, psi) -> (u',
state')``. The chain's ``update(grads, state, psi)`` returns ``(psi + u,
state')`` for optax's final update ``u`` (``optax.apply_updates``). Nothing
is written in place. Step counts are host integers, so a schedule
(``learning_rate`` a Python callable of the count, optax's
``ScalarOrSchedule``) and the bias corrections cost no transfer.

optax's order of operations is kept, and not ``torch.optim``'s, whose
defaults and rounding differ: optax adds RMSprop's ``eps`` inside the
square root, starts Adagrad's accumulator at 0.1, and forms Adam's
denominator as ``sqrt(nu_hat + eps_root) + eps`` from bias-corrected
moments. The scalars optax forms in float32 (``1 - decay**count``,
RAdam's rectification, Adafactor's decay, the noise scale of
``noisy_sgd``, Fromage's multiplier) are formed in float32 here too. The
state stays in the dtype of psi (float32) unless a ``mu_dtype`` or
``accumulator_dtype`` (a ``torch.dtype``) says otherwise. Norms and means
over psi (LAMB, LARS, Fromage, NovoGrad, Adafactor, SM3) treat psi as one
parameter, as optax treats the single array it is handed: a plane for
``Hologram``, ``SpotHologram`` and ``MultiplaneHologram``, the flat pixel
vector for ``CompressedSpotHologram``.

``noisy_sgd`` cannot draw jax's bits: its ``key`` (or the deprecated
``seed``) is an integer that seeds the port's own stream, split each step
as ``jax.random.split`` splits a key (:func:`_split_key`), and the noise is
drawn by :func:`_normal_like`. ``lbfgs`` and ``polyak_sgd`` build, and
their ``update`` raises optax's ``TypeError``: they need the loss value
(and ``lbfgs`` its function), which CG's ``update(grads, state, psi)``
does not pass. optax's building blocks (``scale_by_adam``, ``clip``,
``add_decayed_weights``, ...) take no learning rate and are not ported
(ROADMAP.md queue 1, item 13); any other name raises ``AttributeError``,
as ``getattr(optax, name)`` does.
"""

import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch


class Optimizer(NamedTuple):
    """``init(psi) -> state``; ``update(grads, state, psi) -> (psi', state')``."""

    init: Callable
    update: Callable


class Transform(NamedTuple):
    """One of optax's gradient transformations: ``init(psi) -> state``;
    ``update(u, state, psi) -> (u', state')``."""

    init: Callable
    update: Callable


def _no_state(psi):
    return None


def _chain(*transforms):
    """optax's ``chain`` of transforms, applied as ``apply_updates``."""

    def init(psi):
        return tuple(t.init(psi) for t in transforms)

    def update(grads, state, psi):
        u, new = grads, []
        for t, s in zip(transforms, state):
            u, s = t.update(u, s, psi)
            new.append(s)
        return psi + u, tuple(new)

    return Optimizer(init, update)


# ----------------------------------------------------------------------
# Helpers: optax's tree math on one tensor.
# ----------------------------------------------------------------------


def _f32(x):
    return np.float32(x)


def _correction(decay, count):
    """optax's bias correction ``1 - decay**count``, formed in float32."""
    return float(_f32(1) - _f32(decay) ** count)


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


def _safe_norm(x, min_norm):
    """optax's ``numerics.safe_norm`` of the whole tensor."""
    norm = _norm(x)
    return torch.where(norm <= min_norm, torch.as_tensor(min_norm, dtype=x.dtype,
                                                         device=x.device), norm)


def _safe_rms(x, min_rms):
    """optax's ``numerics.safe_root_mean_squares``."""
    rms = torch.sqrt(torch.mean(x * x))
    return torch.where(rms <= min_rms, torch.as_tensor(min_rms, dtype=x.dtype,
                                                       device=x.device), rms)


def _mask_on(mask, tree):
    """A mask as optax's ``masked`` reads it for one array: a bool, or a
    callable of the array (psi at init, the update after)."""
    return bool(mask(tree) if callable(mask) else mask)


# ----------------------------------------------------------------------
# Transforms (optax's, in ``transform.py`` and ``transforms/``).
# ----------------------------------------------------------------------


def _scale(step_size):
    return Transform(_no_state, lambda u, s, psi: (step_size * u, s))


def _scale_by_schedule(step_size_fn):
    def update(u, count, psi):
        step = step_size_fn(count)
        step = step.to(u.dtype) if torch.is_tensor(step) else float(_f32(step))
        return step * u, count + 1

    return Transform(lambda psi: 0, update)


def scale_by_learning_rate(learning_rate=None, *, flip_sign=True):
    """optax's ``scale_by_learning_rate``: ``-learning_rate * u`` (with
    ``flip_sign``); None is the identity. Also a top-level optimizer, as in
    optax."""
    return _chain(_lr(learning_rate, flip_sign=flip_sign))


def _lr(learning_rate, flip_sign=True):
    if learning_rate is None:
        return Transform(_no_state, lambda u, s, psi: (u, s))
    m = -1 if flip_sign else 1
    if callable(learning_rate):
        return _scale_by_schedule(lambda count: m * learning_rate(count))
    return _scale(m * learning_rate)


def _trace(decay, nesterov=False, accumulator_dtype=None):
    def update(u, trace, psi):
        new = u + decay * trace
        out = u + decay * new if nesterov else new
        return out, _cast(new, accumulator_dtype)

    return Transform(lambda psi: _zeros(psi, accumulator_dtype), update)


def _ema(decay, accumulator_dtype=None):
    """optax's ``ema`` with ``debias=False`` (Adafactor's momentum)."""

    def update(u, ema, psi):
        new = _moment(u, ema, decay, 1)
        return new, _cast(new, accumulator_dtype)

    return Transform(lambda psi: _zeros(psi, accumulator_dtype), update)


def _masked(inner, mask):
    """optax's ``masked`` on one array: ``inner`` where the mask is on,
    the update passed through where it is off."""

    def init(psi):
        return inner.init(psi) if _mask_on(mask, psi) else None

    def update(u, state, psi):
        if not _mask_on(mask, u):
            return u, state
        return inner.update(u, state, psi)

    return Transform(init, update)


def _add_decayed_weights(weight_decay=0.0, mask=None):
    def update(u, count, psi):
        # optax never advances this count: a schedule is read at step 0.
        s = weight_decay(count) if callable(weight_decay) else weight_decay
        return u + s * psi, count

    inner = Transform(lambda psi: 0 if callable(weight_decay) else None, update)
    return inner if mask is None else _masked(inner, mask)


def _adam_moments(g, mu, nu, b1, b2, count_inc, nesterov):
    """The moments and bias-corrected moments of optax's ``scale_by_adam``
    (shared by its Adam, AMSGrad, RAdam and AdaBelief forms)."""
    if nesterov:
        mu_hat = (b1 * (mu / _correction(b1, count_inc + 1))
                  + (1 - b1) * (g / _correction(b1, count_inc)))
    else:
        mu_hat = mu / _correction(b1, count_inc)
    return mu_hat, nu / _correction(b2, count_inc)


def _scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None, *,
                   nesterov=False):
    def init(psi):
        return (0, _zeros(psi, mu_dtype), _zeros(psi))

    def update(g, state, psi):
        count, mu, nu = state
        mu = _moment(g, mu, b1, 1)
        nu = _moment(g, nu, b2, 2)
        mu_hat, nu_hat = _adam_moments(g, mu, nu, b1, b2, count + 1, nesterov)
        return (mu_hat / (torch.sqrt(nu_hat + eps_root) + eps),
                (count + 1, _cast(mu, mu_dtype), nu))

    return Transform(init, update)


def _scale_by_amsgrad(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None):
    def init(psi):
        return (0, _zeros(psi, mu_dtype), _zeros(psi), _zeros(psi))

    def update(g, state, psi):
        count, mu, nu, nu_max = state
        mu = _moment(g, mu, b1, 1)
        nu = _moment(g, nu, b2, 2)
        mu_hat, nu_hat = _adam_moments(g, mu, nu, b1, b2, count + 1, False)
        nu_max = torch.maximum(nu_max, nu_hat)
        return (mu_hat / (torch.sqrt(nu_max + eps_root) + eps),
                (count + 1, _cast(mu, mu_dtype), nu, nu_max))

    return Transform(init, update)


def _scale_by_adamax(b1=0.9, b2=0.999, eps=1e-8):
    def update(g, state, psi):
        count, mu, nu = state
        mu = _moment(g, mu, b1, 1)
        nu = torch.maximum(torch.abs(g) + eps, b2 * nu)
        return (mu / _correction(b1, count + 1)) / nu, (count + 1, mu, nu)

    return Transform(lambda psi: (0, _zeros(psi), _zeros(psi)), update)


def _scale_by_lion(b1=0.9, b2=0.99, mu_dtype=None):
    def update(g, state, psi):
        count, mu = state
        u = torch.sign((1.0 - b1) * g + b1 * mu)
        return u, (count + 1, _cast(_moment(g, mu, b2, 1), mu_dtype))

    return Transform(lambda psi: (0, _zeros(psi, mu_dtype)), update)


def _scale_by_adadelta(rho=0.9, eps=1e-6):
    def update(g, state, psi):
        e_g, e_x = state
        e_g = _moment(g, e_g, rho, 2)
        u = (torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps)) * g
        return u, (e_g, _moment(u, e_x, rho, 2))

    return Transform(lambda psi: (_zeros(psi), _zeros(psi)), update)


def _scale_by_adan(b1=0.98, b2=0.92, b3=0.99, eps=1e-8, eps_root=0.0):
    def init(psi):
        return (_zeros(psi), _zeros(psi), _zeros(psi), _zeros(psi), 0)

    def update(g, state, psi):
        m, v, n, g_prev, t = state
        diff = torch.zeros_like(g) if t == 0 else g - g_prev
        m = _moment(g, m, b1, 1)
        v = _moment(diff, v, b2, 1)
        n = _moment(g + (1 - b2) * diff, n, b3, 2)
        t += 1
        m_hat = m / _correction(b1, t)
        v_hat = v / _correction(b2, t)
        n_hat = n / _correction(b3, t)
        u = (m_hat + (1 - b2) * v_hat) / (torch.sqrt(n_hat + eps_root) + eps)
        return u, (m, v, n, g, t)

    return Transform(init, update)


def _scale_by_belief(b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16, *, nesterov=False):
    def update(g, state, psi):
        count, mu, nu = state
        mu = _moment(g, mu, b1, 1)
        nu = _moment(g - mu, nu, b2, 2) + eps_root
        mu_hat, nu_hat = _adam_moments(g, mu, nu, b1, b2, count + 1, nesterov)
        return mu_hat / (torch.sqrt(nu_hat) + eps), (count + 1, mu, nu)

    return Transform(lambda psi: (0, _zeros(psi), _zeros(psi)), update)


def _scale_by_yogi(b1=0.9, b2=0.999, eps=1e-3, eps_root=0.0,
                   initial_accumulator_value=1e-6):
    def init(psi):
        return (0, torch.full_like(psi, initial_accumulator_value),
                torch.full_like(psi, initial_accumulator_value))

    def update(g, state, psi):
        count, mu, nu = state
        mu = _moment(g, mu, b1, 1)
        g2 = g * g
        nu = nu - (1 - b2) * torch.sign(nu - g2) * g2
        mu_hat, nu_hat = _adam_moments(g, mu, nu, b1, b2, count + 1, False)
        return mu_hat / (torch.sqrt(nu_hat + eps_root) + eps), (count + 1, mu, nu)

    return Transform(init, update)


def _scale_by_radam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, threshold=5.0, *,
                    nesterov=False):
    ro_inf = 2.0 / (1.0 - b2) - 1.0

    def update(g, state, psi):
        count, mu, nu = state
        mu = _moment(g, mu, b1, 1)
        nu = _moment(g, nu, b2, 2)
        count += 1
        b2t = _f32(b2) ** _f32(count)
        ro = _f32(ro_inf) - _f32(2 * count) * b2t / (_f32(1) - b2t)
        mu_hat, nu_hat = _adam_moments(g, mu, nu, b1, b2, count, nesterov)
        if ro >= threshold:
            r = np.sqrt((ro - _f32(4.0)) * (ro - _f32(2.0)) * _f32(ro_inf)
                        / (_f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
            u = float(r) * mu_hat / (torch.sqrt(nu_hat + eps_root) + eps)
        else:
            u = mu_hat
        return u, (count, mu, nu)

    return Transform(lambda psi: (0, _zeros(psi), _zeros(psi)), update)


def _scale_by_rprop(learning_rate, eta_minus=0.5, eta_plus=1.2, min_step_size=1e-6,
                    max_step_size=50.0):
    def init(psi):
        return (torch.full_like(psi, learning_rate), _zeros(psi))

    def update(g, state, psi):
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


def _scale_by_sign():
    return Transform(_no_state, lambda u, s, psi: (torch.sign(u), s))


def _scale_by_trust_ratio(min_norm=0.0, trust_coefficient=1.0, eps=0.0):
    def update(u, state, psi):
        param_norm = _safe_norm(psi, min_norm)
        update_norm = _safe_norm(u, min_norm)
        ratio = trust_coefficient * param_norm / (update_norm + eps)
        zero = torch.logical_or(param_norm == 0.0, update_norm == 0.0)
        return u * torch.where(zero, torch.ones_like(ratio), ratio), state

    return Transform(_no_state, update)


def _scale_by_param_block_rms(min_scale=1e-3):
    return Transform(_no_state, lambda u, s, psi: (u * _safe_rms(psi, min_scale), s))


def _clip_by_block_rms(threshold):
    def update(u, state, psi):
        denom = torch.clamp(torch.sqrt(torch.mean(u * u)) / threshold, min=1.0)
        return u / denom, state

    return Transform(_no_state, update)


def _scale_by_sm3(b1=0.9, b2=1.0, eps=1e-8):
    """optax's ``scale_by_sm3``: one accumulator vector per axis of psi."""
    coeffs = ((1.0 - b2) if b2 != 1.0 else 1.0, b2)

    def init(psi):
        return ([psi.new_zeros(s) for s in psi.shape], _zeros(psi))

    def update(g, state, psi):
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


def _scale_by_novograd(b1=0.9, b2=0.25, eps=1e-8, eps_root=0.0, weight_decay=0.0):
    def update(g, state, psi):
        count, mu, nu = state
        count += 1
        sq = _norm(g) ** 2
        nu = sq if count == 1 else _moment(sq, nu, b2, 1)
        step = g / (torch.sqrt(nu + eps_root) + eps) + weight_decay * psi
        mu = step if count == 1 else b1 * mu + step
        return mu, (count, mu, nu)

    return Transform(lambda psi: (0, _zeros(psi), psi.new_zeros(())), update)


def _scale_by_optimistic_gradient(alpha=1.0, beta=1.0):
    def update(g, prev, psi):
        prev = g if prev is None else prev
        return (alpha + beta) * g - beta * prev, g

    return Transform(lambda psi: None, update)


def _add_noise(eta, gamma, key):
    def update(u, state, psi):
        count, key = state
        count += 1
        std = np.sqrt(_f32(eta) / _f32(count) ** _f32(gamma))
        key, sample = _split_key(key)
        return u + float(std) * _normal_like(sample, u), (count, key)

    return Transform(lambda psi: (0, key), update)


def _split_key(key):
    """``(next key, sample key)`` from an integer key, as
    ``jax.random.split`` gives two keys from one (another stream)."""
    words = np.random.SeedSequence(int(key)).generate_state(4, dtype=np.uint32)
    return int(words[0]) << 32 | int(words[1]), int(words[2]) << 32 | int(words[3])


def _normal_like(key, like):
    """Standard normal noise of ``like``'s shape, dtype and device, drawn
    from ``key`` (``noisy_sgd``'s sampler)."""
    gen = torch.Generator(device=like.device).manual_seed(key)
    return torch.randn(like.shape, generator=gen, dtype=like.dtype, device=like.device)


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

    def update(g, state, psi):
        count, v_row, v_col, v = state
        t = _f32(count - step_offset + 1)
        decay = float(_f32(1.0) - t ** _f32(-decay_rate))
        grad_sqr = g * g + epsilon
        d = dims(psi.shape)
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


# ----------------------------------------------------------------------
# The optimizers (optax's ``alias.py``).
# ----------------------------------------------------------------------


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None, *,
         nesterov=False):
    return _chain(_scale_by_adam(b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov),
                  _lr(learning_rate))


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None,
          weight_decay=1e-4, mask=None, *, nesterov=False):
    return _chain(_scale_by_adam(b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov),
                  _add_decayed_weights(weight_decay, mask), _lr(learning_rate))


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
    head = [] if momentum is None else [_trace(momentum, nesterov, accumulator_dtype)]
    return _chain(*head, _lr(learning_rate))


def rmsprop(learning_rate, decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True,
            centered=False, momentum=None, nesterov=False, bias_correction=False):
    """optax's ``rmsprop``: ``scale_by_rms`` (``scale_by_stddev`` when
    ``centered``), the learning rate, then the momentum ``trace``."""

    def init(psi):
        return (0, _zeros(psi) if centered else None, torch.full_like(psi, initial_scale))

    def update(g, state, psi):
        count, mu, nu = state
        nu = _moment(g, nu, decay, 2)
        mu = _moment(g, mu, decay, 1) if centered else None
        mu_hat, nu_hat = mu, nu
        if bias_correction:
            nu_hat = nu / _correction(decay, count + 1)
            if centered:
                mu_hat = mu / _correction(decay, count + 1)
        denom = nu_hat - mu_hat * mu_hat if centered else nu_hat
        if eps_in_sqrt:
            scaling = torch.rsqrt(denom + eps)
        else:
            scaling = 1 / (torch.sqrt(denom) + eps)
        return scaling * g, (count + 1, mu, nu)

    tail = [] if momentum is None else [_trace(momentum, nesterov)]
    return _chain(Transform(init, update), _lr(learning_rate), *tail)


def adagrad(learning_rate, initial_accumulator_value=0.1, eps=1e-7):
    def update(g, total, psi):
        total = g * g + total
        return torch.where(total > 0, torch.rsqrt(total + eps), 0.0) * g, total

    return _chain(Transform(lambda psi: torch.full_like(psi, initial_accumulator_value),
                            update), _lr(learning_rate))


def adabelief(learning_rate, b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16, *,
              nesterov=False):
    return _chain(_scale_by_belief(b1, b2, eps, eps_root, nesterov=nesterov),
                  _lr(learning_rate))


def adadelta(learning_rate=None, rho=0.9, eps=1e-6, weight_decay=0.0,
             weight_decay_mask=None):
    return _chain(_add_decayed_weights(weight_decay, weight_decay_mask),
                  _scale_by_adadelta(rho, eps), _lr(learning_rate))


def adafactor(learning_rate=None, min_dim_size_to_factor=128, decay_rate=0.8,
              decay_offset=0, multiply_by_parameter_scale=True, clipping_threshold=1.0,
              momentum=None, dtype_momentum=torch.float32, weight_decay_rate=None,
              eps=1e-30, factored=True, weight_decay_mask=None):
    tx = [_scale_by_factored_rms(factored, decay_rate, decay_offset,
                                 min_dim_size_to_factor, eps)]
    if clipping_threshold is not None:
        tx.append(_clip_by_block_rms(clipping_threshold))
    if learning_rate is not None:
        tx.append(_lr(learning_rate, flip_sign=False))
    if multiply_by_parameter_scale:
        tx.append(_scale_by_param_block_rms())
    if momentum is not None:
        tx.append(_ema(momentum, accumulator_dtype=dtype_momentum))
    if weight_decay_rate is not None:
        tx.append(_add_decayed_weights(weight_decay_rate, weight_decay_mask))
    tx.append(_scale(-1))
    return _chain(*tx)


def adamax(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    return _chain(_scale_by_adamax(b1, b2, eps), _lr(learning_rate))


def adamaxw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4, mask=None):
    return _chain(_scale_by_adamax(b1, b2, eps), _add_decayed_weights(weight_decay, mask),
                  _lr(learning_rate))


def adan(learning_rate, b1=0.98, b2=0.92, b3=0.99, eps=1e-8, eps_root=1e-8,
         weight_decay=0.0, mask=None):
    return _chain(_scale_by_adan(b1, b2, b3, eps, eps_root),
                  _add_decayed_weights(weight_decay, mask), _lr(learning_rate))


def amsgrad(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None):
    return _chain(_scale_by_amsgrad(b1, b2, eps, eps_root, mu_dtype), _lr(learning_rate))


def fromage(learning_rate, min_norm=1e-6):
    """optax's ``fromage``: its multiplier ``1/sqrt(1 + lr**2)`` in float32."""
    if not callable(learning_rate):
        mult = _f32(1) / np.sqrt(_f32(1 + learning_rate**2))
        return _chain(_scale_by_trust_ratio(min_norm),
                      _lr(float(_f32(learning_rate) * mult)),
                      _add_decayed_weights(float(mult - _f32(1))))

    def mult_lr(count):
        return _f32(1) / np.sqrt(_f32(1 + learning_rate(count) ** 2))

    return _chain(_scale_by_trust_ratio(min_norm),
                  _lr(lambda c: float(mult_lr(c) * _f32(learning_rate(c)))),
                  _add_decayed_weights(lambda c: float(mult_lr(c) - _f32(1))))


def lamb(learning_rate, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0, weight_decay=0.0,
         mask=None):
    return _chain(_scale_by_adam(b1, b2, eps, eps_root),
                  _add_decayed_weights(weight_decay, mask), _scale_by_trust_ratio(),
                  _lr(learning_rate))


def lars(learning_rate, weight_decay=0.0, weight_decay_mask=True, trust_coefficient=0.001,
         eps=0.0, trust_ratio_mask=True, momentum=0.9, nesterov=False):
    return _chain(_add_decayed_weights(weight_decay, weight_decay_mask),
                  _masked(_scale_by_trust_ratio(trust_coefficient=trust_coefficient,
                                                eps=eps), trust_ratio_mask),
                  _lr(learning_rate), _trace(momentum, nesterov))


def lion(learning_rate, b1=0.9, b2=0.99, mu_dtype=None, weight_decay=1e-3, mask=None):
    return _chain(_scale_by_lion(b1, b2, mu_dtype), _add_decayed_weights(weight_decay, mask),
                  _lr(learning_rate))


def noisy_sgd(learning_rate, eta=0.01, gamma=0.55, key=None, *, seed=None):
    """optax's ``noisy_sgd``; ``key`` (or the deprecated ``seed``) is an
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
        raise TypeError(f"noisy_sgd's key must be an integer seed, not {type(key).__name__}")
    return _chain(_add_noise(eta, gamma, int(key)), _lr(learning_rate))


def novograd(learning_rate, b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0, weight_decay=0.0):
    return _chain(_scale_by_novograd(b1, b2, eps, eps_root, weight_decay), _lr(learning_rate))


def optimistic_gradient_descent(learning_rate, alpha=1.0, beta=1.0):
    return _chain(_scale_by_optimistic_gradient(alpha, beta), _lr(learning_rate))


def optimistic_adam(learning_rate, optimism=None, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                    mu_dtype=None, *, nesterov=True):
    warnings.warn("`optimistic_adam` is deprecated, please use `optimistic_adam_v2` "
                  "instead.", category=DeprecationWarning)
    if callable(learning_rate):
        raise ValueError("This version of `optimistic_adam` does not support learning rate "
                         "schedules but `optimistic_adam_v2` does.")
    if optimism is None:
        optimism = learning_rate
    return _chain(_scale_by_adam(b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov),
                  _scale_by_optimistic_gradient(alpha=learning_rate, beta=optimism),
                  _lr(1.0))


def optimistic_adam_v2(learning_rate, *, alpha=1.0, beta=1.0, b1=0.9, b2=0.999, eps=1e-8,
                       eps_root=0.0, mu_dtype=None, nesterov=True):
    return _chain(_scale_by_adam(b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov),
                  _scale_by_optimistic_gradient(alpha, beta), _lr(learning_rate))


def radam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, threshold=5.0, *,
          nesterov=False):
    return _chain(_scale_by_radam(b1, b2, eps, eps_root, threshold, nesterov=nesterov),
                  _lr(learning_rate))


def rprop(learning_rate, eta_minus=0.5, eta_plus=1.2, min_step_size=1e-6,
          max_step_size=50.0):
    return _chain(_scale_by_rprop(learning_rate, eta_minus, eta_plus, min_step_size,
                                  max_step_size), _scale(-1.0))


def scale_by_rprop(learning_rate, eta_minus=0.5, eta_plus=1.2, min_step_size=1e-6,
                   max_step_size=50.0):
    """optax's ``scale_by_rprop`` as an optimizer: its steps are applied
    with their sign, as ``rprop`` flips them."""
    return _chain(_scale_by_rprop(learning_rate, eta_minus, eta_plus, min_step_size,
                                  max_step_size))


def sign_sgd(learning_rate):
    return _chain(_scale_by_sign(), _lr(learning_rate))


def sm3(learning_rate, momentum=0.9):
    return _chain(_scale_by_sm3(momentum), _scale(-learning_rate))


def yogi(learning_rate, b1=0.9, b2=0.999, eps=1e-3):
    return _chain(_scale_by_yogi(b1, b2, eps), _lr(learning_rate))


def _needs_value(name, needed):
    """An optimizer whose update needs more than CG passes: it builds, and
    its update raises optax's ``TypeError``."""

    def update(grads, state, psi):
        args = ", ".join(f"'{n}'" for n in needed[:-1])
        args = f"{args}, and '{needed[-1]}'" if args else f"'{needed[-1]}'"
        raise TypeError(f"{name}'s update_fn() missing {len(needed)} required keyword-only "
                        f"argument{'s' if len(needed) > 1 else ''}: {args}")

    return Optimizer(_no_state, update)


def lbfgs(learning_rate=None, memory_size=10, scale_init_precond=True, linesearch=None):
    return _needs_value("scale_by_zoom_linesearch", ("value", "grad", "value_fn"))


def polyak_sgd(max_learning_rate=1.0, scaling=1.0, f_min=0.0, eps=0.0, variant="sps"):
    return _needs_value("scale_by_polyak", ("value",))


OPTIMIZERS = {f.__name__: f for f in (
    adabelief, adadelta, adafactor, adagrad, adam, adamax, adamaxw, adamw, adan, amsgrad,
    fromage, lamb, lars, lion, nadam, nadamw, noisy_sgd, novograd, optimistic_adam,
    optimistic_adam_v2, optimistic_gradient_descent, radam, rmsprop, rprop,
    scale_by_learning_rate, scale_by_rprop, sgd, sign_sgd, sm3, yogi, lbfgs, polyak_sgd)}

# optax 0.2.6's gradient transformations that take no learning rate: a
# user reaches them only through ``optimizer_kwargs`` of their own.
BUILDING_BLOCKS = (
    "adaptive_grad_clip", "add_decayed_weights", "add_noise", "apply_every",
    "apply_if_finite", "centralize", "chain", "clip", "clip_by_block_rms",
    "clip_by_global_norm", "conditionally_mask", "conditionally_transform", "ema",
    "flatten", "freeze", "identity", "inject_hyperparams", "inject_stateful_hyperparams",
    "keep_params_nonnegative", "lookahead", "masked", "multi_transform", "named_chain",
    "normalize_by_update_norm", "partition", "scale", "scale_by_adadelta", "scale_by_adam",
    "scale_by_adamax", "scale_by_adan", "scale_by_amsgrad",
    "scale_by_backtracking_linesearch", "scale_by_belief",
    "scale_by_distance_over_gradients", "scale_by_lbfgs", "scale_by_lion",
    "scale_by_novograd", "scale_by_optimistic_gradient", "scale_by_param_block_norm",
    "scale_by_param_block_rms", "scale_by_polyak", "scale_by_radam", "scale_by_rms",
    "scale_by_rss", "scale_by_schedule", "scale_by_sign", "scale_by_sm3",
    "scale_by_stddev", "scale_by_trust_ratio", "scale_by_yogi", "scale_by_zoom_linesearch",
    "selective_transform", "set_to_zero", "snapshot", "stateless",
    "stateless_with_tree_map", "trace", "with_extra_args_support", "zero_nans",
)


def get_optimizer(name, kwargs):
    """The optimizer ``name`` (case-insensitive) made from ``kwargs``, where
    ``lr`` is an alias of ``learning_rate``, as the JAX package takes them
    (the ``optimizer`` and ``optimizer_kwargs`` flags)."""
    name = str(name).lower()
    if name in BUILDING_BLOCKS:
        raise NotImplementedError(
            f"optax's building block '{name}' takes no learning rate and is not ported "
            "(ROADMAP.md queue 1, item 13, 'optax's building blocks')."
        )
    if name not in OPTIMIZERS:
        raise AttributeError(f"module 'optax' has no attribute '{name}'")
    kwargs = dict(kwargs)
    if "lr" in kwargs:
        kwargs["learning_rate"] = kwargs.pop("lr")
    return OPTIMIZERS[name](**kwargs)
