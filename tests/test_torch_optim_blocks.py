"""
optax 0.2.6's 59 building blocks in the port (``slmsuite_torch/ops/optim.py``)
against optax on the CPU, as the JAX package's CG reaches them
(``getattr(optax, name)(**kwargs)``, stepped by ``update(grads, state,
psi)`` and ``optax.apply_updates``): each name built from one spec in both
libraries (an inner transform from the same spec in each), 5 updates from
the same seeded psi and gradients, the parameters within 1e-6 absolute after
every update (52 names); the seven that fail under CG in the reference fail
with its exception class in the port; a few compositions (``flatten`` of Adafactor,
``masked`` with a callable mask, ``inject_hyperparams`` of Adam as an inner
transform, ``apply_if_finite`` fed a nan gradient); no update reads a
tensor on the host; and short CG runs of ``SpotHologram``,
``CompressedSpotHologram`` and ``MultiplaneHologram`` with a leaf and a
combinator against the JAX package's, within ``tests/test_torch_cg.py``'s
bounds.

Shapes: a 128 x 192 plane, and the flat vector ``CompressedSpotHologram``
hands the rules whose result depends on the array's rank. The rules that
divide by a norm of the whole plane (the clipping and normalizing rules,
the trust ratio, NovoGrad, DoG, L-BFGS) are held at 7 x 5 as well as at
128 x 192 where their sums' rounding allows: torch and XLA's CPU backend
add a plane in different orders.
"""

import logging
import warnings

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import slmsuite_torch
from slmsuite_torch.ops import optim as TO
from test_torch_cg import (
    LOSS_ATOL,
    LOSS_RTOL,
    PSI_P99,
    T,
    J,
    _assert_runs_agree,
    _compressed_pair,
    _losses,
    _multiplane_pair,
    _psi_p99,
)

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


# ----------------------------------------------------------------------
# Specs, built in either library.
# ----------------------------------------------------------------------


class Tx:
    """A transform ``name(**kwargs)`` of either library (kwargs may hold
    specs)."""

    def __init__(self, name, **kwargs):
        self.name, self.kwargs = name, kwargs

    def build(self, lib):
        return getattr(lib, self.name)(**build(self.kwargs, lib))


class Factory:
    """The factory ``name`` itself (``inject_hyperparams``' argument)."""

    def __init__(self, name):
        self.name = name

    def build(self, lib):
        return getattr(lib, self.name)


class Injected:
    """``inject_hyperparams(name)(**kwargs)`` (or its deprecated twin)."""

    def __init__(self, name, wrapper="inject_hyperparams", **kwargs):
        self.name, self.wrapper, self.kwargs = name, wrapper, kwargs

    def build(self, lib):
        return getattr(lib, self.wrapper)(getattr(lib, self.name))(**build(self.kwargs, lib))


def build(value, lib):
    if isinstance(value, (Tx, Factory, Injected)):
        return value.build(lib)
    if isinstance(value, dict):
        return {k: build(v, lib) for k, v in value.items()}
    return value


def _schedule(count):
    return 0.3 * 0.5**count


def _down(count):
    return -0.2 / (1 + count)


ADAM = Tx("adam", learning_rate=0.1)

# case -> (name, kwargs); every block that runs under CG, with the options
# that change its rule. Combinators take a descending inner rule.
RUNS = {
    "adaptive_grad_clip": ("adaptive_grad_clip", dict(clipping=0.05)),
    "adaptive_grad_clip_axis": ("adaptive_grad_clip", dict(clipping=0.05, eps=0.5, axis=1)),
    "add_decayed_weights": ("add_decayed_weights", dict(weight_decay=0.01)),
    "add_decayed_weights_masked": ("add_decayed_weights", dict(
        weight_decay=lambda count: 0.02, mask=lambda p: p.ndim == 2)),
    "apply_every": ("apply_every", dict(k=3)),
    "apply_if_finite": ("apply_if_finite", dict(inner=ADAM, max_consecutive_errors=2)),
    "centralize": ("centralize", dict()),
    "clip": ("clip", dict(max_delta=0.05)),
    "clip_by_block_rms": ("clip_by_block_rms", dict(threshold=0.05)),
    "clip_by_global_norm": ("clip_by_global_norm", dict(max_norm=5.0)),
    "clip_by_global_norm_above": ("clip_by_global_norm", dict(max_norm=1e3)),
    "conditionally_mask": ("conditionally_mask", dict(
        inner=ADAM, should_transform_fn=lambda step: step % 2 == 0)),
    "conditionally_transform": ("conditionally_transform", dict(
        inner=Tx("sgd", learning_rate=0.5, momentum=0.9),
        should_transform_fn=lambda step: step < 3)),
    "ema": ("ema", dict(decay=0.9)),
    "ema_biased": ("ema", dict(decay=0.8, debias=False)),
    "flatten": ("flatten", dict(inner=Tx("adafactor", learning_rate=0.1))),
    "flatten_sm3": ("flatten", dict(inner=Tx("sm3", learning_rate=0.1))),
    "freeze": ("freeze", dict(mask=True)),
    "freeze_off": ("freeze", dict(mask=False)),
    "identity": ("identity", dict()),
    "keep_params_nonnegative": ("keep_params_nonnegative", dict()),
    "masked": ("masked", dict(inner=ADAM, mask=True)),
    "masked_callable": ("masked", dict(inner=ADAM, mask=lambda u: u.ndim == 2)),
    "masked_injected": ("masked", dict(inner=Injected("adam", learning_rate=0.1), mask=True)),
    "multi_transform": ("multi_transform", dict(
        transforms={"a": ADAM, "b": Tx("sgd", learning_rate=0.3)}, param_labels="b")),
    "named_chain": ("named_chain", dict()),
    "normalize_by_update_norm": ("normalize_by_update_norm", dict()),
    "normalize_by_update_norm_options": ("normalize_by_update_norm", dict(
        scale_factor=0.5, eps=1e-3)),
    "partition": ("partition", dict(
        transforms={"a": ADAM, "b": Tx("sgd", learning_rate=0.3)},
        param_labels=lambda p: "a")),
    "scale": ("scale", dict(step_size=-0.5)),
    "scale_by_adadelta": ("scale_by_adadelta", dict(rho=0.8, eps=1e-4)),
    "scale_by_adam": ("scale_by_adam", dict()),
    "scale_by_adam_nesterov": ("scale_by_adam", dict(b1=0.8, eps_root=1e-8, nesterov=True)),
    "scale_by_adamax": ("scale_by_adamax", dict()),
    "scale_by_adan": ("scale_by_adan", dict()),
    "scale_by_amsgrad": ("scale_by_amsgrad", dict()),
    "scale_by_belief": ("scale_by_belief", dict()),
    "scale_by_distance_over_gradients": ("scale_by_distance_over_gradients", dict()),
    "scale_by_distance_over_gradients_options": ("scale_by_distance_over_gradients", dict(
        reps_rel=1e-3, eps=1e-6, global_scale=2.0)),
    "scale_by_lbfgs": ("scale_by_lbfgs", dict()),
    "scale_by_lbfgs_short": ("scale_by_lbfgs", dict(memory_size=3, scale_init_precond=False)),
    "scale_by_lion": ("scale_by_lion", dict()),
    "scale_by_novograd": ("scale_by_novograd", dict()),
    "scale_by_novograd_decay": ("scale_by_novograd", dict(weight_decay=0.01, eps_root=1e-8)),
    "scale_by_optimistic_gradient": ("scale_by_optimistic_gradient", dict(alpha=0.5, beta=2.0)),
    "scale_by_param_block_norm": ("scale_by_param_block_norm", dict()),
    "scale_by_param_block_rms": ("scale_by_param_block_rms", dict()),
    "scale_by_radam": ("scale_by_radam", dict()),
    "scale_by_radam_rectified": ("scale_by_radam", dict(b2=0.8, threshold=4.0)),
    "scale_by_rms": ("scale_by_rms", dict()),
    "scale_by_rms_options": ("scale_by_rms", dict(decay=0.8, eps=1e-3, initial_scale=0.5,
                                                  eps_in_sqrt=False, bias_correction=True)),
    "scale_by_rss": ("scale_by_rss", dict()),
    "scale_by_schedule": ("scale_by_schedule", dict(step_size_fn=_down)),
    "scale_by_sign": ("scale_by_sign", dict()),
    "scale_by_sm3": ("scale_by_sm3", dict()),
    "scale_by_stddev": ("scale_by_stddev", dict(initial_scale=0.5)),
    "scale_by_stddev_options": ("scale_by_stddev", dict(decay=0.8, initial_scale=0.5,
                                                        bias_correction=True)),
    "scale_by_trust_ratio": ("scale_by_trust_ratio", dict()),
    "scale_by_trust_ratio_options": ("scale_by_trust_ratio", dict(
        min_norm=1.0, trust_coefficient=0.1, eps=1e-3)),
    "scale_by_yogi": ("scale_by_yogi", dict()),
    "selective_transform": ("selective_transform", dict(optimizer=ADAM, freeze_mask=False)),
    "selective_transform_frozen": ("selective_transform", dict(optimizer=ADAM, freeze_mask=True)),
    "set_to_zero": ("set_to_zero", dict()),
    "snapshot": ("snapshot", dict(measure_name="sq", measure=lambda u: (u * u).sum())),
    "stateless": ("stateless", dict(f=lambda u, p: -0.1 * u + 0.01 * p)),
    "stateless_with_tree_map": ("stateless_with_tree_map", dict(f=lambda u, p: -0.3 * u * p)),
    "trace": ("trace", dict(decay=0.9)),
    "trace_nesterov": ("trace", dict(decay=0.5, nesterov=True)),
    "with_extra_args_support": ("with_extra_args_support", dict(tx=ADAM)),
    "zero_nans": ("zero_nans", dict()),
}

# add_noise draws its noise from the port's own stream: held with optax's
# draws injected (test_add_noise_matches_optax_with_its_noise).
NOISE = {"add_noise": dict(eta=0.3, gamma=0.8, key=3)}

# name -> (kwargs, the stage that raises, the reference's exception class).
FAILS = {
    "chain": (dict(), "build", ValueError),
    "inject_hyperparams": (dict(inner_factory=Factory("adam")), "init", AttributeError),
    "inject_stateful_hyperparams": (dict(inner_factory=Factory("adam")), "init",
                                    AttributeError),
    "lookahead": (dict(fast_optimizer=Tx("sgd", learning_rate=0.1), sync_period=2,
                       slow_step_size=0.5), "update", AttributeError),
    "scale_by_backtracking_linesearch": (dict(max_backtracking_steps=5), "update", TypeError),
    "scale_by_polyak": (dict(), "update", TypeError),
    "scale_by_zoom_linesearch": (dict(max_linesearch_steps=5), "update", TypeError),
}

#: Rules whose result depends on the array's rank: held on the flat vector too.
RANKED = ("adaptive_grad_clip", "centralize", "clip_by_block_rms", "flatten", "flatten_sm3",
          "scale_by_param_block_norm", "scale_by_param_block_rms", "scale_by_sm3")

#: Rules that divide by a norm of the whole plane, held at 7 x 5 too.
NORMED = ("adaptive_grad_clip", "clip_by_global_norm", "normalize_by_update_norm",
          "normalize_by_update_norm_options", "scale_by_distance_over_gradients",
          "scale_by_distance_over_gradients_options", "scale_by_lbfgs", "scale_by_lbfgs_short",
          "scale_by_novograd", "scale_by_novograd_decay", "scale_by_param_block_norm",
          "scale_by_trust_ratio", "scale_by_trust_ratio_options")


#: Inputs that keep a case's parameters of order one (a block without a
#: rate steps psi by up to its own size): psi's scale, the gradients' scale,
#: or gradients of a quadratic of psi (L-BFGS's curvature pairs are then
#: those of a function, and its steps, added as CG adds them, stay finite).
INPUTS = {
    "scale_by_param_block_norm": dict(grad_scale=1e-3),
    "scale_by_trust_ratio": dict(psi_scale=0.1),
    "scale_by_distance_over_gradients": dict(grad_scale=1e-3),
    "scale_by_distance_over_gradients_options": dict(grad_scale=1e-3),
    "scale_by_lbfgs": dict(quadratic=True),
    "scale_by_lbfgs_short": dict(quadratic=True),
}


def _inputs(seed, shape, updates=5, psi_scale=1.0, grad_scale=1.0, quadratic=False):
    rng = np.random.default_rng(seed)
    psi0 = (psi_scale * rng.uniform(-np.pi, np.pi, shape)).astype(np.float32)
    grads = [(0.1 * grad_scale * rng.standard_normal(shape)).astype(np.float32)
             for _ in range(updates)]
    # One gradient entry exactly 0, and one repeated with its sign flipped.
    grads[0].flat[0] = 0.0
    grads[2].flat[1] = -grads[1].flat[1]
    if quadratic:
        # The gradient of -sum(a (psi - top)**2) / 2, top 1e-3 from psi0.
        a = rng.uniform(0.2, 1.0, shape).astype(np.float32)
        top = psi0 + (1e-3 * rng.standard_normal(shape)).astype(np.float32)
        grads = [lambda psi: (a * (top - psi)).astype(np.float32)] * updates
    return psi0, grads


def _case_inputs(case, seed, shape):
    return _inputs(seed, shape, **INPUTS.get(case, {}))


def _both(name, kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return (getattr(optax, name)(**build(kwargs, optax)),
                TO.get_optimizer(name, build(kwargs, TO)))


def _run_both(name, kwargs, psi0, grads):
    """Step optax and the port through the same gradients (or gradient
    functions of psi), each keeping its own state, each update taken from
    the reference's psi (so a last-bit difference of an update of order one
    does not compound through psi's rounding); the parameters after each
    update within OPTIM_ATOL, nan where the reference has nan."""
    tx, optimizer = _both(name, kwargs)
    jpsi = jnp.asarray(psi0)
    jstate = tx.init(jpsi)
    tstate = optimizer.init(torch.from_numpy(psi0))
    errs = []
    for g in grads:
        g = g(np.asarray(jpsi)) if callable(g) else g
        tpsi, tstate = optimizer.update(torch.from_numpy(g), tstate,
                                        torch.from_numpy(np.array(jpsi)))
        updates, jstate = tx.update(jnp.asarray(g), jstate, jpsi)
        jpsi = optax.apply_updates(jpsi, updates)
        assert tpsi.dtype == torch.float32 and tpsi.shape == psi0.shape
        got, ref = tpsi.numpy(), np.asarray(jpsi)
        nan = np.isnan(ref)
        np.testing.assert_array_equal(np.isnan(got), nan)
        errs.append(float(np.abs(got - ref)[~nan].max(initial=0.0)))
    assert max(errs) <= OPTIM_ATOL, errs
    return tstate, jstate


def test_the_59_names_are_optax_blocks():
    """The names the port builds without a learning rate are exactly
    optax's gradient transformations that take none (re-derived from
    optax's signatures), each with optax's parameter names; every one is
    a case here, run or failing, or ``add_noise``."""
    import inspect

    derived = set()
    for name in dir(optax):
        fn = getattr(optax, name)
        if name.startswith("_") or inspect.isclass(fn) or not callable(fn):
            continue
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            continue
        if "GradientTransformation" in str(sig.return_annotation) and name not in TO.OPTIMIZERS:
            derived.add(name)
    assert derived == set(TO.BUILDING_BLOCKS) and len(derived) == 59
    covered = {name for name, _ in RUNS.values()} | set(FAILS) | set(NOISE)
    assert covered == derived
    for name in derived:
        ours = list(inspect.signature(TO.BUILDING_BLOCKS[name]).parameters)
        theirs = list(inspect.signature(getattr(optax, name)).parameters)
        assert ours == theirs, name
    assert len({n for n, _ in RUNS.values()} | set(NOISE)) == 52 and len(FAILS) == 7


@pytest.mark.parametrize("case", sorted(RUNS))
def test_block_matches_optax(case):
    name, kwargs = RUNS[case]
    _run_both(name, kwargs, *_case_inputs(case, 5, (128, 192)))


@pytest.mark.parametrize("case", sorted(RANKED))
def test_ranked_block_matches_optax_on_the_flat_vector(case):
    """``CompressedSpotHologram`` hands the rules its flat pixel vector:
    ``centralize`` leaves it, ``flatten`` and SM3 keep one accumulator,
    the block norms take the whole vector."""
    name, kwargs = RUNS[case]
    _run_both(name, kwargs, *_case_inputs(case, 7, (2000,)))


@pytest.mark.parametrize("case", sorted(NORMED))
def test_normed_block_matches_optax_at_a_small_shape(case):
    name, kwargs = RUNS[case]
    _run_both(name, kwargs, *_case_inputs(case, 3, (7, 5)))


def _optax_noise(key, shape, n):
    tx = optax.add_noise(1.0, 0.0, key)
    state = tx.init(jnp.zeros(shape, jnp.float32))
    out = []
    for _ in range(n):
        noise, state = tx.update(jnp.zeros(shape, jnp.float32), state)
        out.append(np.asarray(noise))
    return out


def test_add_noise_matches_optax_with_its_noise(monkeypatch):
    """With optax's draws injected for the port's, ``add_noise`` matches
    optax within 1e-6 (the scale ``sqrt(eta / count**gamma)`` in float32)."""
    kwargs = NOISE["add_noise"]
    psi0, grads = _inputs(9, (128, 192))
    draws = iter(_optax_noise(kwargs["key"], psi0.shape, len(grads)))
    monkeypatch.setattr(TO, "_normal_like", lambda key, like: torch.tensor(next(draws)))
    _run_both("add_noise", kwargs, psi0, grads)


@pytest.mark.parametrize("name", sorted(FAILS))
def test_failing_blocks_raise_the_reference_class(name, caplog):
    """The seven names that CG cannot step in the reference raise the same
    exception class at the same stage in the port."""
    kwargs, stage, error = FAILS[name]
    psi, g = np.zeros((8, 8), np.float32), np.ones((8, 8), np.float32)
    for lib, arr in ((optax, jnp.asarray), (TO, torch.from_numpy)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            at = "build"
            try:
                if lib is optax:
                    tx = getattr(optax, name)(**build(kwargs, optax))
                else:
                    tx = TO.get_optimizer(name, build(kwargs, TO))
                at = "init"
                state = tx.init(arr(psi))
                at = "update"
                tx.update(arr(g), state, arr(psi))
            except error as err:
                assert at == stage, (lib.__name__, at, err)
            else:
                raise AssertionError(f"{lib.__name__}.{name} ran")
    if name == "lookahead":
        assert "has no attribute `fast`" in caplog.text


def test_value_blocks_name_the_missing_arguments():
    """The line searches and Polyak's step raise optax's message."""
    for name, kwargs in (("scale_by_polyak", {}),
                         ("scale_by_zoom_linesearch", dict(max_linesearch_steps=5)),
                         ("scale_by_backtracking_linesearch", dict(max_backtracking_steps=5))):
        tx, ours = _both(name, kwargs)
        with pytest.raises(TypeError) as jax_err:
            tx.update(jnp.ones(3), tx.init(jnp.ones(3)), jnp.ones(3))
        with pytest.raises(TypeError) as port_err:
            ours.update(torch.ones(3), ours.init(torch.ones(3)), torch.ones(3))
        assert str(port_err.value) == str(jax_err.value)


def test_chain_and_named_chain_of_port_transforms_match_optax():
    """``chain`` and ``named_chain`` (positional, so built directly and not
    through CG's keywords) of leaves and an optimizer."""
    psi0, grads = _inputs(13, (128, 192))
    specs = [Tx("clip_by_block_rms", threshold=0.05), Tx("scale_by_adam", b1=0.8),
             Tx("scale", step_size=-0.1)]
    pairs = [(optax.chain(*[s.build(optax) for s in specs]),
              TO.chain(*[s.build(TO) for s in specs])),
             (optax.named_chain(*[(s.name, s.build(optax)) for s in specs]),
              TO.named_chain(*[(s.name, s.build(TO)) for s in specs]))]
    for jtx, ttx in pairs:
        jpsi, tpsi = jnp.asarray(psi0), torch.from_numpy(psi0)
        js, ts = jtx.init(jpsi), ttx.init(tpsi)
        for g in grads:
            ju, js = jtx.update(jnp.asarray(g), js, jpsi)
            tu, ts = ttx.update(torch.from_numpy(g), ts, tpsi)
            jpsi, tpsi = optax.apply_updates(jpsi, ju), TO.apply_updates(tpsi, tu)
            np.testing.assert_allclose(tpsi.numpy(), np.asarray(jpsi), atol=OPTIM_ATOL, rtol=0)
    with pytest.raises(ValueError, match="unique names"):
        TO.named_chain(("a", TO.identity()), ("a", TO.identity()))


def test_lookahead_of_lookahead_params_matches_optax():
    """Outside CG, ``lookahead`` steps ``LookaheadParams`` as optax's does
    (a sync every 2 steps, the fast state reset at each)."""
    psi0, grads = _inputs(17, (7, 5))
    jtx = optax.lookahead(optax.adam(0.1), 2, 0.5, reset_state=True)
    ttx = TO.lookahead(TO.adam(0.1), 2, 0.5, reset_state=True)
    jp = optax.LookaheadParams.init_synced(jnp.asarray(psi0))
    tp = TO.LookaheadParams.init_synced(torch.from_numpy(psi0))
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        ju, js = jtx.update(jnp.asarray(g), js, jp)
        tu, ts = ttx.update(torch.from_numpy(g), ts, tp)
        jp = optax.apply_updates(jp, ju)
        tp = TO.LookaheadParams(*(TO.apply_updates(p, u) for p, u in zip(tp, tu)))
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=OPTIM_ATOL, rtol=0)


def test_inject_hyperparams_state_and_schedule_match_optax():
    """``inject_hyperparams(adam)`` keeps optax's state: the count, the
    numeric hyperparameters in float32, a schedule read at the count; an
    edited hyperparameter takes effect at the next step, as in optax."""
    psi0, grads = _inputs(19, (128, 192))
    jtx = optax.inject_hyperparams(optax.adam)(learning_rate=_schedule, b1=0.8)
    ttx = TO.inject_hyperparams(TO.adam)(learning_rate=_schedule, b1=0.8)
    jpsi, tpsi = jnp.asarray(psi0), torch.from_numpy(psi0)
    js, ts = jtx.init(jpsi), ttx.init(tpsi)
    assert set(ts.hyperparams) == set(js.hyperparams)
    for i, g in enumerate(grads):
        if i == 2:
            js.hyperparams["b2"] = jnp.asarray(0.9, jnp.float32)
            ts.hyperparams["b2"] = 0.9
        ju, js = jtx.update(jnp.asarray(g), js, jpsi)
        tu, ts = ttx.update(torch.from_numpy(g), ts, tpsi)
        jpsi, tpsi = optax.apply_updates(jpsi, ju), TO.apply_updates(tpsi, tu)
        np.testing.assert_allclose(tpsi.numpy(), np.asarray(jpsi), atol=OPTIM_ATOL, rtol=0)
        assert ts.count == int(js.count)
        for k, v in js.hyperparams.items():
            assert ts.hyperparams[k] == float(v), k
    with pytest.raises(ValueError, match="static_args"):
        TO.inject_hyperparams(TO.adam, static_args=("bogus",))


@pytest.mark.parametrize("at", [0, 2], ids=["first", "third"])
def test_apply_if_finite_fed_a_nan_gradient_matches_optax(at):
    """A nan in one gradient: both reject that update (zeros, the inner
    state kept, its count too) and count it; the next finite one steps
    with the inner rule's count where it was."""
    psi0, grads = _inputs(23, (128, 192))
    grads[at].flat[5] = np.nan
    kwargs = dict(inner=Tx("adam", learning_rate=0.1), max_consecutive_errors=2)
    tstate, jstate = _run_both("apply_if_finite", kwargs, psi0, grads)
    for key in ("notfinite_count", "last_finite", "total_notfinite"):
        assert int(getattr(tstate, key)) == int(getattr(jstate, key)), key
    assert int(tstate.inner_state[0][0]) == int(jstate.inner_state[0].count) == 4


def test_apply_if_finite_applies_past_max_consecutive_errors():
    """More than ``max_consecutive_errors`` non-finite updates in a row:
    the next is applied (and spreads its nan) in both."""
    psi0, grads = _inputs(29, (7, 5))
    for g in grads[:3]:
        g.flat[0] = np.inf
    kwargs = dict(inner=Tx("sgd", learning_rate=0.1), max_consecutive_errors=1)
    tx, ours = _both("apply_if_finite", kwargs)
    jpsi, tpsi = jnp.asarray(psi0), torch.from_numpy(psi0)
    js, ts = tx.init(jpsi), ours.init(tpsi)
    for g in grads:
        ju, js = tx.update(jnp.asarray(g), js, jpsi)
        jpsi = optax.apply_updates(jpsi, ju)
        tpsi, ts = ours.update(torch.from_numpy(g), ts, tpsi)
        np.testing.assert_array_equal(np.isfinite(tpsi.numpy()), np.isfinite(np.asarray(jpsi)))
    assert int(ts.total_notfinite) == int(js.total_notfinite) == 3


def test_zero_nans_fed_a_nan_gradient_matches_optax():
    psi0, grads = _inputs(31, (128, 192))
    grads[1].flat[7] = np.nan
    tstate, jstate = _run_both("zero_nans", {}, psi0, grads[:2])
    assert bool(tstate) == bool(jstate.found_nan) is True


def test_conditionally_transform_on_a_tensor_condition_selects_on_the_device():
    """A condition that is a tensor (not a host bool) takes both branches
    and selects, the inner count becoming a device tensor; the result is
    the host branch's."""
    psi0, grads = _inputs(37, (7, 5))
    host = TO.get_optimizer("conditionally_transform", dict(
        inner=TO.adam(0.1), should_transform_fn=lambda step: step < 3))
    device = TO.get_optimizer("conditionally_transform", dict(
        inner=TO.adam(0.1), should_transform_fn=lambda step: torch.as_tensor(step < 3)))
    a = b = torch.from_numpy(psi0)
    sa, sb = host.init(a), device.init(b)
    for g in grads:
        a, sa = host.update(torch.from_numpy(g), sa, a)
        b, sb = device.update(torch.from_numpy(g), sb, b)
        torch.testing.assert_close(b, a, atol=0, rtol=0)
    assert torch.is_tensor(sb[0][0][0]) and int(sb[0][0][0]) == sa[0][0][0] == 3


# ----------------------------------------------------------------------
# No update reads a tensor on the host.
# ----------------------------------------------------------------------


class _NoHostReads(TorchDispatchMode):
    """Refuses the ops through which a tensor's value reaches the host
    (``.item()``, ``float()``, ``bool()``) and through which host data
    becomes a tensor (``torch.tensor``, ``torch.as_tensor`` of a number):
    on the card each is a sync."""

    REFUSED = ("aten::_local_scalar_dense", "aten::is_nonzero", "aten::lift_fresh")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.name().split(".")[0] in self.REFUSED:
            raise AssertionError(f"host read: {func.name()}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", sorted(RUNS) + ["add_noise", "apply_if_finite_nan"])
def test_block_updates_read_no_tensor_on_the_host(case):
    """Every runnable block's ``init`` and 5 updates under a dispatch mode
    that refuses a tensor's value on the host; ``apply_if_finite`` also with
    a nan gradient (its device counters, and the inner count made a device
    tensor by the selection)."""
    if case == "add_noise":
        name, kwargs = "add_noise", NOISE["add_noise"]
    elif case == "apply_if_finite_nan":
        name, kwargs = "apply_if_finite", dict(inner=Tx("adafactor", learning_rate=0.1),
                                               max_consecutive_errors=1)
    else:
        name, kwargs = RUNS[case]
    psi0, grads = _inputs(41, (128, 192))
    if case == "apply_if_finite_nan":
        grads[1].flat[3] = np.nan
        grads[2].flat[3] = np.nan
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        opt = TO.get_optimizer(name, build(kwargs, TO))
    _guarded_steps(opt, psi0, grads)


def _guarded_steps(opt, psi0, grads):
    psi = torch.from_numpy(psi0)
    grads = [torch.from_numpy(g) for g in grads]
    with _NoHostReads():
        state = opt.init(psi)
        for g in grads:
            psi, state = opt.update(g, state, psi)
    assert psi.shape == psi0.shape


#: The optimizers' kwargs for the guard: a rate, and what changes the rule.
OPTIMIZER_KWARGS = {
    "fromage": dict(learning_rate=_schedule), "lars": dict(learning_rate=0.1, nesterov=True),
    "lbfgs": dict(learning_rate=0.1, linesearch=None), "noisy_sgd": dict(learning_rate=0.1, key=1),
    "rmsprop": dict(learning_rate=0.1, centered=True, momentum=0.9, bias_correction=True),
}


@pytest.mark.parametrize("name", sorted(set(TO.OPTIMIZERS) - {"polyak_sgd"}))
def test_optimizer_updates_read_no_tensor_on_the_host(name):
    """The optimizers that take a learning rate (G4's and G1-G3's), as the
    blocks: no update reads a tensor on the host."""
    kwargs = OPTIMIZER_KWARGS.get(name, dict(learning_rate=0.1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        opt = TO.get_optimizer(name, kwargs)
    _guarded_steps(opt, *_inputs(43, (128, 192)))


def test_lbfgs_without_a_line_search_matches_optax():
    """optax's ``lbfgs`` with ``linesearch=None`` steps (its rate, no line
    search): the port's chain steps as optax's."""
    for kwargs in (dict(linesearch=None), dict(learning_rate=0.5, memory_size=3,
                                                linesearch=None)):
        _run_both("lbfgs", kwargs, *_inputs(47, (128, 192), quadratic=True))


@pytest.mark.parametrize("read", [lambda: float(torch.ones(()).sum()),
                                  lambda: bool(torch.ones(()) > 0),
                                  lambda: torch.as_tensor(0.5, dtype=torch.float32)],
                         ids=["float", "bool", "upload"])
def test_the_guard_refuses_a_host_read(read):
    with pytest.raises(AssertionError, match="host read"), _NoHostReads():
        read()


# ----------------------------------------------------------------------
# CG runs against slmsuite_tpu.
# ----------------------------------------------------------------------

#: (hologram kind, case) -> (name, kwargs): for each class a leaf that
#: descends on its own and a combinator of a descending inner rule.
CG_RUNS = {
    ("spot", "scale_by_schedule"): ("scale_by_schedule", dict(step_size_fn=lambda c: -40.0)),
    ("spot", "apply_if_finite"): ("apply_if_finite", dict(inner=ADAM, max_consecutive_errors=2)),
    ("compressed", "scale"): ("scale", dict(step_size=-40.0)),
    ("compressed", "conditionally_transform"): ("conditionally_transform", dict(
        inner=Tx("adam", learning_rate=0.3), should_transform_fn=lambda step: step < 100)),
    ("multiplane", "scale"): ("scale", dict(step_size=-40.0)),
    ("multiplane", "masked_injected"): ("masked", dict(
        inner=Injected("adam", learning_rate=0.2), mask=lambda u: u.ndim == 2)),
}


def _spot_pair():
    rng = np.random.default_rng(7)
    vectors = np.array([(x, y) for y in range(40, 88, 12) for x in range(40, 88, 12)]).T
    phase = rng.uniform(-np.pi, np.pi, (128, 128)).astype(np.float32)
    pair = []
    for pkg in (T, J):
        holo = pkg.SpotHologram((128, 128), vectors, basis="knm")
        holo.reset_phase(phase.copy())
        pair.append(holo)
    return pair


@pytest.mark.parametrize("kind,case", sorted(CG_RUNS))
def test_cg_with_building_blocks_matches_jax(kind, case):
    """``optimize("CG", optimizer=<block>, optimizer_kwargs=...)`` with
    inner transforms built from each package's own library: the loss falls,
    and the runs agree as ``tests/test_torch_cg.py`` holds them."""
    name, kwargs = CG_RUNS[(kind, case)]
    t, j = {"spot": _spot_pair, "compressed": _compressed_pair,
            "multiplane": _multiplane_pair}[kind]()
    losses = {t: [], j: []}
    for holo, lib in ((t, TO), (j, optax)):
        holo.optimize("CG", maxiter=12, verbose=False, optimizer=name,
                      optimizer_kwargs=build(kwargs, lib), callback=_losses(losses[holo]))
    assert losses[t][-1] < losses[t][0], losses[t]
    if kind == "multiplane":
        assert t.iter == j.iter == 12
        np.testing.assert_allclose(losses[t], losses[j], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        assert _psi_p99(t.get_phase(), j.get_phase()) < PSI_P99
    else:
        _assert_runs_agree(t, j, losses[t], losses[j], np.asarray(j.target))


def test_lookahead_warns_in_the_port_as_optax_logs(caplog):
    with caplog.at_level(logging.WARNING):
        TO.lookahead(TO.sgd(0.1), 2, 0.5).init(torch.zeros(3))
    assert "has no attribute `fast`" in caplog.text
