"""
The port's optimizers (``slmsuite_torch/ops/optim.py``) against optax 0.2.6
on the CPU: every optimizer the JAX package's CG can build by name with a
learning rate, over 5 updates from the same seeded parameters and
gradients, within 1e-6 absolute on the float32 parameters after every
update (as ``tests/test_torch_cg.py::test_optimizer_matches_optax`` holds
the first five); Adafactor and SM3 at a factored (128 x 192) and an
unfactored shape and on the flat vector ``CompressedSpotHologram`` hands
them; ``noisy_sgd`` with optax's noise injected and in distribution; and
short CG runs of ``Hologram.optimize("CG", optimizer=...)`` against the JAX
package's (the loss at every iteration within 1e-4 relative, final
efficiency and uniformity within 1e-4, psi at the 99th percentile within
5e-3 rad, as ``tests/test_torch_cg.py`` holds its runs).

The norms of LAMB, LARS, Fromage and NovoGrad are sums over psi, which
torch and XLA's CPU backend add in different orders, so these are held at
the small shape (the sums' rounding then differs by an ulp at most).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import slmsuite_torch
from slmsuite_torch.ops import optim as TO
from test_torch_cg import _assert_runs_agree, _hologram_pair, _losses

OPTIM_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    slmsuite_torch.set_default_device("cpu")
    yield
    slmsuite_torch.set_default_device("cuda")
    torch.set_num_threads(threads)


def _schedule(count):
    return 0.1 * 0.5**count


def _halving(count):
    return 0.2 / (1 + count)


# name -> (optax name, kwargs); every name of the 25 the port added, with
# the options that change its rule.
CASES = {
    "adabelief": ("adabelief", dict(learning_rate=0.1)),
    "adabelief_nesterov": ("adabelief", dict(learning_rate=0.1, nesterov=True, eps=1e-8)),
    "adadelta": ("adadelta", dict(learning_rate=0.5)),
    "adadelta_decay": ("adadelta", dict(learning_rate=0.5, rho=0.8, weight_decay=0.01)),
    "adadelta_no_rate": ("adadelta", dict()),
    "adafactor": ("adafactor", dict(learning_rate=0.1)),
    "adafactor_options": ("adafactor", dict(learning_rate=0.05, decay_offset=-3, momentum=0.9,
                                            weight_decay_rate=0.01, clipping_threshold=None,
                                            multiply_by_parameter_scale=False)),
    "adafactor_schedule": ("adafactor", dict(learning_rate=_schedule, decay_rate=0.7)),
    "adamax": ("adamax", dict(learning_rate=0.1)),
    "adamaxw": ("adamaxw", dict(learning_rate=0.1, weight_decay=0.01)),
    "adan": ("adan", dict(learning_rate=0.1)),
    "adan_decay": ("adan", dict(learning_rate=0.05, b1=0.9, weight_decay=0.02, eps_root=0.0)),
    "amsgrad": ("amsgrad", dict(learning_rate=0.1)),
    "fromage": ("fromage", dict(learning_rate=0.1)),
    "fromage_schedule": ("fromage", dict(learning_rate=_halving)),
    "lamb": ("lamb", dict(learning_rate=0.1)),
    "lamb_decay": ("lamb", dict(learning_rate=0.1, weight_decay=0.01)),
    "lars": ("lars", dict(learning_rate=0.1)),
    "lars_options": ("lars", dict(learning_rate=0.1, weight_decay=0.01, trust_coefficient=0.01,
                                  eps=1e-6, nesterov=True)),
    "lars_unmasked": ("lars", dict(learning_rate=0.1, trust_ratio_mask=False,
                                   weight_decay_mask=False, weight_decay=0.5)),
    "lion": ("lion", dict(learning_rate=0.01)),
    "lion_schedule": ("lion", dict(learning_rate=_schedule, weight_decay=0.0)),
    "nadam": ("nadam", dict(learning_rate=0.1)),
    "nadamw": ("nadamw", dict(learning_rate=0.1, weight_decay=0.01)),
    "novograd": ("novograd", dict(learning_rate=0.1)),
    "novograd_decay": ("novograd", dict(learning_rate=0.1, weight_decay=0.01, eps_root=1e-8)),
    "optimistic_adam": ("optimistic_adam", dict(learning_rate=0.1)),
    "optimistic_adam_optimism": ("optimistic_adam", dict(learning_rate=0.1, optimism=0.3)),
    "optimistic_adam_v2": ("optimistic_adam_v2", dict(learning_rate=0.1, alpha=0.5, beta=2.0)),
    "optimistic_gradient_descent": ("optimistic_gradient_descent",
                                    dict(learning_rate=0.1, alpha=0.7, beta=0.4)),
    "radam": ("radam", dict(learning_rate=0.1)),
    "radam_rectified": ("radam", dict(learning_rate=0.1, b2=0.8, threshold=4.0)),
    "radam_nesterov": ("radam", dict(learning_rate=0.1, b2=0.8, threshold=4.0, nesterov=True)),
    "rprop": ("rprop", dict(learning_rate=0.1)),
    "rprop_bounds": ("rprop", dict(learning_rate=0.1, eta_plus=3.0, eta_minus=0.1,
                                   max_step_size=0.5, min_step_size=0.02)),
    "scale_by_learning_rate": ("scale_by_learning_rate", dict(learning_rate=0.3)),
    "scale_by_learning_rate_schedule": ("scale_by_learning_rate",
                                        dict(learning_rate=_schedule, flip_sign=False)),
    "scale_by_rprop": ("scale_by_rprop", dict(learning_rate=0.1)),
    "sign_sgd": ("sign_sgd", dict(learning_rate=0.1)),
    "sm3": ("sm3", dict(learning_rate=0.1)),
    "sm3_momentum": ("sm3", dict(learning_rate=0.1, momentum=0.5)),
    "yogi": ("yogi", dict(learning_rate=0.1)),
    "yogi_eps": ("yogi", dict(learning_rate=0.1, b1=0.8, eps=1e-6)),
}

NEW_RULES = {
    "adabelief", "adadelta", "adafactor", "adamax", "adamaxw", "adan", "amsgrad", "fromage",
    "lamb", "lars", "lion", "nadam", "nadamw", "noisy_sgd", "novograd", "optimistic_adam",
    "optimistic_adam_v2", "optimistic_gradient_descent", "radam", "rprop", "sign_sgd", "sm3",
    "yogi", "scale_by_learning_rate", "scale_by_rprop",
}


def _inputs(seed, shape, updates=5):
    rng = np.random.default_rng(seed)
    psi0 = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
    grads = [(0.1 * rng.standard_normal(shape)).astype(np.float32) for _ in range(updates)]
    # One gradient entry exactly 0, and one repeated with its sign flipped:
    # the accumulators may then be 0 and Rprop's sign test takes each branch.
    grads[0].flat[0] = 0.0
    grads[2].flat[1] = -grads[1].flat[1]
    return psi0, grads


def _run_both(name, kwargs, psi0, grads, check=True):
    """Step optax and the port from the same inputs; the largest difference
    of the parameters after each update."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        tx = getattr(optax, name)(**kwargs)
        optimizer = TO.get_optimizer(name, kwargs)
    jpsi = jnp.asarray(psi0)
    jstate = tx.init(jpsi)
    tpsi = torch.from_numpy(psi0)
    tstate = optimizer.init(tpsi)
    errs = []
    for g in grads:
        updates, jstate = tx.update(jnp.asarray(g), jstate, jpsi)
        jpsi = optax.apply_updates(jpsi, updates)
        tpsi, tstate = optimizer.update(torch.from_numpy(g), tstate, tpsi)
        assert tpsi.dtype == torch.float32 and tpsi.shape == psi0.shape
        errs.append(float(np.abs(tpsi.numpy() - np.asarray(jpsi)).max()))
    if check:
        assert max(errs) <= OPTIM_ATOL, errs
    return errs


def test_cases_cover_the_new_rules():
    """Every rule the port added has a case here, and every name the JAX
    package's CG builds with a learning rate is one the port builds."""
    assert {name for name, _ in CASES.values()} | {"noisy_sgd"} == NEW_RULES
    assert NEW_RULES | {"adam", "adamw", "sgd", "rmsprop", "adagrad"} == (
        set(TO.OPTIMIZERS) - {"lbfgs", "polyak_sgd"})


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax(case):
    name, kwargs = CASES[case]
    _run_both(name, kwargs, *_inputs(5, (7, 5)))


FACTOR_SHAPES = {
    "factored_128x192": (128, 192),
    "factored_192x128": (192, 128),
    "unfactored_96x192": (96, 192),
    "flat_2000": (2000,),
}


@pytest.mark.parametrize("shape", sorted(FACTOR_SHAPES))
@pytest.mark.parametrize("case", ["adafactor", "adafactor_options", "sm3", "sm3_momentum"])
def test_per_axis_state_matches_optax(case, shape):
    """Adafactor factors its second moment where both of the two largest
    sides are at least 128 (one accumulator per row and per column), else
    keeps one per element; SM3 keeps one accumulator per axis. Held on
    planes (``Hologram``, ``SpotHologram``, ``MultiplaneHologram``) and on
    the flat pixel vector (``CompressedSpotHologram``)."""
    name, kwargs = CASES[case]
    _run_both(name, kwargs, *_inputs(11, FACTOR_SHAPES[shape]))


def test_adafactor_state_is_factored_where_optax_factors():
    opt = TO.get_optimizer("adafactor", {"learning_rate": 0.1})
    (_, v_row, v_col, v), *_ = opt.init(torch.zeros(128, 192))
    assert v is None and v_row.shape == (128,) and v_col.shape == (192,)
    (_, v_row, v_col, v), *_ = opt.init(torch.zeros(96, 192))
    assert v_row is None and v.shape == (96, 192)
    (mu, nu), _ = TO.get_optimizer("sm3", {"learning_rate": 0.1}).init(torch.zeros(128, 192))
    assert [m.shape for m in mu] == [(128,), (192,)] and nu.shape == (128, 192)


@pytest.mark.parametrize("case", ["lamb", "lars_options", "fromage", "novograd"])
def test_norm_rules_fall_back_where_a_norm_is_zero(case):
    """A zero gradient or zero parameters: optax's trust ratio falls back
    to 1 and its norms stay finite; the port takes the same branch."""
    name, kwargs = CASES[case]
    psi0, grads = _inputs(3, (7, 5))
    _run_both(name, kwargs, psi0, [np.zeros_like(g) for g in grads[:2]] + grads[2:])
    _run_both(name, kwargs, np.zeros_like(psi0), grads)


# ----------------------------------------------------------------------
# noisy_sgd
# ----------------------------------------------------------------------


def _optax_noise(key, shape, n):
    """The standard normal draws optax's ``add_noise`` adds for ``key``:
    at ``eta`` 1 and ``gamma`` 0 its scale is exactly 1."""
    tx = optax.add_noise(1.0, 0.0, key)
    state = tx.init(jnp.zeros(shape, jnp.float32))
    out = []
    for _ in range(n):
        noise, state = tx.update(jnp.zeros(shape, jnp.float32), state)
        out.append(np.asarray(noise))
    return out


@pytest.mark.parametrize("kwargs", [dict(learning_rate=0.1, key=7),
                                    dict(learning_rate=_schedule, eta=0.3, gamma=0.8, key=3)],
                         ids=["constant", "schedule"])
def test_noisy_sgd_matches_optax_with_its_noise(kwargs, monkeypatch):
    """With optax's draws injected for the port's, ``noisy_sgd`` matches
    optax within 1e-6 (the noise scale ``sqrt(eta / count**gamma)`` in
    float32, then the learning rate)."""
    psi0, grads = _inputs(9, (7, 5))
    draws = iter(_optax_noise(kwargs["key"], psi0.shape, len(grads)))
    monkeypatch.setattr(TO, "_normal_like", lambda key, like: torch.tensor(next(draws)))
    _run_both("noisy_sgd", kwargs, psi0, grads)


def test_noisy_sgd_draws_its_noise_in_distribution():
    """The port's own noise over a 512^2 plane: mean 0 and variance
    ``lr**2 eta / count**gamma`` at each step (5 sigma of the sample
    moments), the same key giving the same draws and another key others."""
    shape, lr, eta, gamma = (512, 512), 0.5, 0.2, 0.55
    n = shape[0] * shape[1]
    opt = TO.get_optimizer("noisy_sgd", dict(learning_rate=lr, eta=eta, gamma=gamma, key=4))
    psi = torch.zeros(shape)
    state = opt.init(psi)
    steps = []
    for count in range(1, 4):
        new, state = opt.update(torch.zeros(shape), state, psi)
        step = (new - psi).double()
        psi = new
        var = lr**2 * eta / count**gamma
        assert abs(float(step.mean())) < 5 * np.sqrt(var / n)
        # The sample variance of n normal draws has a spread of var sqrt(2/n).
        assert abs(float(step.var()) - var) < 5 * var * np.sqrt(2 / n)
        steps.append(step)
    assert not torch.equal(steps[0], steps[1])
    again = TO.get_optimizer("noisy_sgd", dict(learning_rate=lr, eta=eta, gamma=gamma, key=4))
    first, _ = again.update(torch.zeros(shape), again.init(torch.zeros(shape)), torch.zeros(shape))
    assert torch.equal(first.double(), steps[0])
    other = TO.get_optimizer("noisy_sgd", dict(learning_rate=lr, eta=eta, gamma=gamma, key=5))
    first, _ = other.update(torch.zeros(shape), other.init(torch.zeros(shape)), torch.zeros(shape))
    assert not torch.equal(first.double(), steps[0])


def test_noisy_sgd_key_arguments_follow_optax():
    """``seed`` is optax's deprecated spelling of ``key``; both at once
    raise, neither warns and takes key 0; a key that is not an integer
    (a jax key has no meaning here) raises."""
    with pytest.warns(DeprecationWarning, match="seed"):
        by_seed = TO.get_optimizer("noisy_sgd", dict(learning_rate=0.1, seed=2))
    by_key = TO.get_optimizer("noisy_sgd", dict(learning_rate=0.1, key=2))
    psi, g = torch.ones(8, 8), torch.full((8, 8), 0.1)
    assert torch.equal(by_seed.update(g, by_seed.init(psi), psi)[0],
                       by_key.update(g, by_key.init(psi), psi)[0])
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError, match="Only one of seed"):
        TO.get_optimizer("noisy_sgd", dict(learning_rate=0.1, seed=2, key=2))
    with pytest.warns(UserWarning, match="Specifying a key"):
        TO.get_optimizer("noisy_sgd", dict(learning_rate=0.1))
    with pytest.raises(TypeError, match="integer seed"):
        TO.get_optimizer("noisy_sgd", dict(learning_rate=0.1, key=2.5))


# ----------------------------------------------------------------------
# The names, as the JAX package's ``getattr(optax, name)(**kwargs)``.
# ----------------------------------------------------------------------


def test_refusals_match_optax():
    """``optimistic_adam`` refuses a schedule, ``sm3`` a schedule (it
    negates its rate), as optax does; an argument optax does not take
    raises ``TypeError`` in both."""
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError, match="schedules"):
        TO.get_optimizer("optimistic_adam", {"learning_rate": _schedule})
    with pytest.raises(TypeError):
        optax.sm3(_schedule)
    with pytest.raises(TypeError):
        TO.get_optimizer("sm3", {"learning_rate": _schedule})
    for name in ("lion", "polyak_sgd"):
        with pytest.raises(TypeError):
            getattr(optax, name)(learning_rate=0.1, bogus=1)
        with pytest.raises(TypeError):
            TO.get_optimizer(name, {"learning_rate": 0.1, "bogus": 1})


@pytest.mark.parametrize("name", ["lbfgs", "polyak_sgd"])
def test_value_optimizers_raise_at_update_as_optax(name):
    """``lbfgs`` and ``polyak_sgd`` build, and their update raises optax's
    ``TypeError`` (they need the loss value, CG passes the gradient)."""
    kwargs = {"learning_rate": 0.1} if name == "lbfgs" else {}
    tx = getattr(optax, name)(**kwargs)
    with pytest.raises(TypeError, match="required keyword-only") as jax_err:
        tx.update(jnp.ones(3), tx.init(jnp.ones(3)), jnp.ones(3))
    opt = TO.get_optimizer(name, kwargs)
    with pytest.raises(TypeError, match="required keyword-only") as port_err:
        opt.update(torch.ones(3), opt.init(torch.ones(3)), torch.ones(3))
    assert str(port_err.value).split("update_fn() ")[1] == str(jax_err.value).split("update_fn() ")[1]


def test_building_blocks_are_optax_transforms_without_a_rate():
    """Each building block is one of optax's gradient transformations, none
    takes a learning rate, and each builds in the port as it builds in
    optax: with no argument, those with defaults build (``chain`` raises
    optax's ``ValueError``), the others raise ``TypeError`` in both
    (``tests/test_torch_optim_blocks.py`` steps each)."""
    import inspect

    for name in TO.BUILDING_BLOCKS:
        params = inspect.signature(getattr(optax, name)).parameters
        assert "learning_rate" not in params, name
        outcomes = []
        for build in (lambda: getattr(optax, name)(), lambda: TO.get_optimizer(name, {})):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                try:
                    build()
                    outcomes.append(None)
                except (TypeError, ValueError) as err:
                    outcomes.append(type(err))
        assert outcomes[0] == outcomes[1], (name, outcomes)


# ----------------------------------------------------------------------
# CG runs against slmsuite_tpu.
# ----------------------------------------------------------------------


CG_FLAGS = {
    "adafactor": ("adafactor", {"learning_rate": 0.05}),
    "lion": ("lion", {"lr": 0.01}),
    "lamb": ("lamb", {"learning_rate": 0.05}),
    "sm3": ("sm3", {"learning_rate": 0.5}),
}


@pytest.mark.parametrize("case", sorted(CG_FLAGS))
def test_hologram_cg_with_new_optimizers_matches_jax(case):
    """``Hologram.optimize("CG", optimizer=...)`` on a 64^2 farfield from
    the same seeded phase in both packages, 8 iterations: the loss at
    every iteration, the final efficiency and uniformity, psi."""
    (t, j), target = _hologram_pair(False)
    name, kwargs = CG_FLAGS[case]
    losses = {t: [], j: []}
    for holo in (t, j):
        holo.optimize("CG", maxiter=8, verbose=False, optimizer=name, optimizer_kwargs=kwargs,
                      callback=_losses(losses[holo]))
    assert losses[t][-1] < losses[t][0]
    _assert_runs_agree(t, j, losses[t], losses[j], target)
