"""
Gradient phase retrieval (``method="CG"``) of the port against
``slmsuite_tpu`` on the CPU: the differentiable transforms
(``ops/grad.py``), the optimizers (``ops/optim.py``, against optax), and
``optimize_cg`` of ``Hologram``, ``SpotHologram``, ``CompressedSpotHologram``
(on a bare SLM) and ``MultiplaneHologram``. Inputs come from
``numpy.random.default_rng(seed)`` and go to both packages; the JAX side
runs as its own tests run it on the CPU.

Tolerances, each stated where it is used:

- vector-Jacobian products: 1e-5 of the largest gradient (f32 transforms
  formed in another order);
- optimizers: 1e-6 absolute on the parameters after each of 5 updates;
- CG runs: the loss at every iteration within 1e-4 relative (plus 1e-9
  absolute), the final efficiency and uniformity within 1e-4 (the goldens'
  stats tolerance), psi (unfolded, modulo 2 pi, where the amplitude is not
  zero) within 5e-3 rad at the 99th percentile. Adam's first steps act on
  the sign of each gradient, so a pixel whose gradient is at round-off is
  stepped by +-lr in opposite directions by the two packages: psi is not
  held at every pixel. The targets are well-posed spot arrays and the runs
  short, as the JAX package's ``TestCG`` runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import slmsuite_torch
from slmsuite_torch.hardware.slms.simulated import SimulatedSLM as TSLM
from slmsuite_torch.holography import algorithms as T
from slmsuite_torch.holography.algorithms import _hologram as TH
from slmsuite_torch.ops import compressed as TC
from slmsuite_torch.ops import fft as TF
from slmsuite_torch.ops import grad as TG
from slmsuite_torch.ops import optim as TO
from slmsuite_torch.ops import propagation as TP
from slmsuite_torch.ops.stats import calculate_stats_numpy
from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM as JSLM
from slmsuite_tpu.holography import algorithms as J
from slmsuite_tpu.holography.algorithms import _hologram as JH
from slmsuite_tpu.ops import propagation as JP


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


VJP_RTOL = 1e-5
OPTIM_ATOL = 1e-6
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-9
STATS_ATOL = 1e-4
PSI_P99 = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    slmsuite_torch.set_default_device("cpu")
    yield
    slmsuite_torch.set_default_device("cuda")
    torch.set_num_threads(threads)


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _assert_close_to_max(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rtol, err


# ----------------------------------------------------------------------
# The differentiable transforms.
# ----------------------------------------------------------------------


def _vjp(fn, inputs, cotangents):
    """Outputs of ``fn(*inputs)`` and the gradients of ``<outputs,
    cotangents>`` with respect to the inputs."""
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    outputs = fn(*leaves)
    grads = torch.autograd.grad(outputs, leaves, [torch.from_numpy(c) for c in cotangents])
    return [o.detach().numpy() for o in outputs], [g.numpy() for g in grads]


@pytest.mark.parametrize("shape", [(64, 64), (128, 64)])
def test_fft2_vjp_matches_plain_autograd(shape):
    """``Fft2``'s forward is the dispatcher's and its backward ``ifft2``:
    the same outputs and gradients as autograd through the plain
    ``torch.fft`` version."""
    rng = np.random.default_rng(1)
    x, g = [_rand(rng, shape) for _ in range(2)], [_rand(rng, shape) for _ in range(2)]
    out, grads = _vjp(TG.Fft2.apply, x, g)
    ref_out, ref_grads = _vjp(TF._fft2, x, g)
    for got, ref in zip(out + grads, ref_out + ref_grads):
        _assert_close_to_max(got, ref, VJP_RTOL)


def test_fft2_backward_takes_an_expanded_gradient():
    """A loss such as ``sum`` hands the backward an expanded gradient;
    ``Fft2`` takes it (the kernels need it contiguous)."""
    rng = np.random.default_rng(2)
    x = [torch.from_numpy(_rand(rng, (64, 64))).requires_grad_(True) for _ in range(2)]
    re, im = TG.fft2(*x)
    (re.sum() + im.sum()).backward()
    y = [v.detach().clone().requires_grad_(True) for v in x]
    re, im = TF._fft2(*y)
    (re.sum() + im.sum()).backward()
    for a, b in zip(x, y):
        _assert_close_to_max(a.grad, b.grad, VJP_RTOL)


@pytest.mark.parametrize("D", [3, 16])
@pytest.mark.parametrize("N", [10, 300])
def test_compressed_overlap_vjp_matches_plain_autograd(D, N):
    """``CompressedOverlap``'s forward is the raw overlap and its backward
    ``farfield_to_nearfield``: the same outputs and gradients (in the
    nearfield) as autograd through the plain ``_nearfield_to_farfield_raw``."""
    rng = np.random.default_rng(3)
    P = 4096
    coeffs = torch.from_numpy(_rand(rng, (D, N), 3.0))
    basis = torch.from_numpy(_rand(rng, (D, P)))
    nf, g = [_rand(rng, P) for _ in range(2)], [_rand(rng, N) for _ in range(2)]
    out, grads = _vjp(lambda a, b: TG.CompressedOverlap.apply(a, b, coeffs, basis), nf, g)
    ref_out, ref_grads = _vjp(
        lambda a, b: TC._nearfield_to_farfield_raw(a, b, coeffs, basis), nf, g)
    for got, ref in zip(out + grads, ref_out + ref_grads):
        _assert_close_to_max(got, ref, VJP_RTOL)


def _hologram_loss_pair(padded):
    """The default CG loss of a Hologram as a function of the folded psi,
    in each package, and a seeded psi."""
    rng = np.random.default_rng(4)
    slm, shape = (64, 64), ((128, 128) if padded else (64, 64))
    target = np.zeros(shape, np.float32)
    target[rng.integers(8, shape[0] - 8, 12), rng.integers(8, shape[1] - 8, 12)] = 1.0
    kernel = _rand(rng, slm) if padded else None
    amp = 1 / 64.0

    def torch_loss(psi):
        farfield = TP.differentiable_farfield(
            psi, amp, shape, None if kernel is None else torch.from_numpy(kernel))
        return TH._default_cg_loss(farfield, torch.from_numpy(target))

    def jax_loss(psi):
        nearfield = JP.build_folded_nearfield(
            psi, jnp.float32(amp), shape, None if kernel is None else jnp.asarray(kernel))
        farfield = JP.unfold_farfield(JP.nearfield_to_farfield(nearfield))
        amp_ff = jnp.abs(farfield)
        amp_ff = amp_ff / jnp.sqrt(jnp.sum(jnp.square(amp_ff)))
        return jnp.mean(jnp.square(amp_ff - jnp.asarray(target)))

    return torch_loss, jax_loss, rng.uniform(-np.pi, np.pi, slm).astype(np.float32)


@pytest.mark.parametrize("padded", [False, True], ids=["64", "padded_128_kernel"])
def test_farfield_loss_gradient_matches_jax(padded):
    """The gradient of the default loss through the folded nearfield, the
    canvas window, ``Fft2`` and the unfold matches ``jax.value_and_grad``
    of the JAX package's composition."""
    torch_loss, jax_loss, psi = _hologram_loss_pair(padded)
    leaf = torch.from_numpy(psi).requires_grad_(True)
    value = torch_loss(leaf)
    (grad,) = torch.autograd.grad(value, leaf)
    j_value, j_grad = jax.value_and_grad(jax_loss)(jnp.asarray(psi))
    np.testing.assert_allclose(float(value.detach()), float(j_value), rtol=LOSS_RTOL)
    _assert_close_to_max(grad, np.asarray(j_grad), VJP_RTOL)


# ----------------------------------------------------------------------
# The optimizers against optax.
# ----------------------------------------------------------------------


def _schedule(count):
    return 0.1 * 0.5**count


OPTIMIZER_CASES = {
    "adam": ("adam", dict(learning_rate=0.1)),
    "adam_nesterov": ("adam", dict(learning_rate=0.1, nesterov=True)),
    "adam_eps_root": ("adam", dict(learning_rate=0.05, b1=0.8, b2=0.99, eps=1e-6,
                                   eps_root=1e-8)),
    "adam_schedule": ("adam", dict(learning_rate=_schedule)),
    "adamw": ("adamw", dict(learning_rate=0.1, weight_decay=0.01)),
    "adamw_nesterov": ("adamw", dict(learning_rate=0.1, nesterov=True)),
    "sgd": ("sgd", dict(learning_rate=0.3)),
    "sgd_momentum": ("sgd", dict(learning_rate=0.3, momentum=0.9)),
    "sgd_nesterov": ("sgd", dict(learning_rate=0.3, momentum=0.9, nesterov=True)),
    "sgd_schedule": ("sgd", dict(learning_rate=_schedule, momentum=0.5)),
    "rmsprop": ("rmsprop", dict(learning_rate=0.01)),
    "rmsprop_centered": ("rmsprop", dict(learning_rate=0.01, centered=True,
                                         initial_scale=0.5)),
    "rmsprop_eps_outside": ("rmsprop", dict(learning_rate=0.01, eps_in_sqrt=False,
                                            eps=1e-3)),
    "rmsprop_momentum": ("rmsprop", dict(learning_rate=0.01, decay=0.8, momentum=0.9,
                                         nesterov=True)),
    "rmsprop_bias_correction": ("rmsprop", dict(learning_rate=0.01, bias_correction=True)),
    "rmsprop_centered_bias_correction": ("rmsprop", dict(
        learning_rate=0.01, bias_correction=True, centered=True, initial_scale=0.5)),
    "adagrad": ("adagrad", dict(learning_rate=0.2)),
    "adagrad_zero_start": ("adagrad", dict(learning_rate=0.2, initial_accumulator_value=0.0,
                                           eps=1e-4)),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZER_CASES))
def test_optimizer_matches_optax(case):
    """Each rule of ``ops/optim.py`` against optax 0.2.6 over 5 updates from
    the same gradients: the parameters within 1e-6 after every update."""
    name, kwargs = OPTIMIZER_CASES[case]
    rng = np.random.default_rng(5)
    psi0 = rng.uniform(-np.pi, np.pi, (7, 5)).astype(np.float32)
    grads = [_rand(rng, (7, 5), 0.1) for _ in range(5)]
    # One gradient entry exactly 0: Adagrad's accumulator may then be 0.
    grads[0][0, 0] = 0.0

    tx = getattr(optax, name)(**kwargs)
    jpsi = jnp.asarray(psi0)
    jstate = tx.init(jpsi)
    optimizer = TO.get_optimizer(name, kwargs)
    tpsi = torch.from_numpy(psi0)
    tstate = optimizer.init(tpsi)
    for g in grads:
        updates, jstate = tx.update(jnp.asarray(g), jstate, jpsi)
        jpsi = optax.apply_updates(jpsi, updates)
        tpsi, tstate = optimizer.update(torch.from_numpy(g), tstate, tpsi)
        assert tpsi.dtype == torch.float32
        np.testing.assert_allclose(tpsi.numpy(), np.asarray(jpsi), atol=OPTIM_ATOL, rtol=0)


def test_losses_match_jax():
    """``ComplexMSELoss`` (both reductions), ``MaxUniformLoss`` (the
    Bessel-corrected std) and the default loss on one seeded complex
    farfield and a target with nan."""
    rng = np.random.default_rng(13)
    farfield = (_rand(rng, (4, 4)) + 1j * _rand(rng, (4, 4))).astype(np.complex64)
    target = np.abs(_rand(rng, (4, 4)))
    target[0, :2] = np.nan
    pairs = [(TH.ComplexMSELoss(r), JH.ComplexMSELoss(r)) for r in ("mean", "sum")]
    pairs.append((TH.MaxUniformLoss(), JH.MaxUniformLoss()))
    pairs.append((lambda f, t: TH._default_cg_loss(f, torch.nan_to_num(t)), pairs[0][1]))
    for tl, jl in pairs:
        got = float(tl(torch.from_numpy(farfield), torch.from_numpy(target)))
        np.testing.assert_allclose(got, float(jl(jnp.asarray(farfield), jnp.asarray(target))),
                                   rtol=1e-6)


def test_optimizer_names_and_aliases():
    """``lr`` is an alias of ``learning_rate`` and names are case-insensitive;
    ``lamb`` and ``lion`` run (on ``Hologram.optimize("CG")`` too); a name
    optax lacks raises ``AttributeError`` and ``lbfgs`` optax's
    ``TypeError`` at its update, as ``getattr(optax, name)(**kwargs)`` does
    in the JAX package; one of optax's building blocks builds and steps as
    optax's does."""
    a = TO.get_optimizer("SGD", {"lr": 0.5})
    b = TO.get_optimizer("sgd", {"learning_rate": 0.5})
    psi, g = torch.ones(3), torch.full((3,), 0.2)
    assert torch.equal(a.update(g, a.init(psi), psi)[0], b.update(g, b.init(psi), psi)[0])
    lamb = TO.get_optimizer("lamb", {"learning_rate": 0.1})
    assert not torch.equal(lamb.update(g, lamb.init(psi), psi)[0], psi)
    holo = T.Hologram(np.ones((64, 64)))
    holo.reset_phase(np.random.default_rng(2).uniform(-np.pi, np.pi, (64, 64)))
    holo.optimize("CG", maxiter=2, verbose=False, optimizer="lion")
    assert holo.iter == 2 and np.isfinite(holo.flags["loss_result"])
    with pytest.raises(AttributeError, match="has no attribute 'not_an_optimizer'"):
        TO.get_optimizer("not_an_optimizer", {"learning_rate": 0.1})
    with pytest.raises(AttributeError):
        getattr(optax, "not_an_optimizer")
    lbfgs = TO.get_optimizer("lbfgs", {"learning_rate": 0.1})
    with pytest.raises(TypeError, match="'value', 'grad', and 'value_fn'"):
        lbfgs.update(g, lbfgs.init(psi), psi)
    block, tx = TO.get_optimizer("scale_by_adam", {"b1": 0.8}), optax.scale_by_adam(b1=0.8)
    updates, _ = tx.update(jnp.asarray(g.numpy()), tx.init(jnp.asarray(psi.numpy())))
    np.testing.assert_allclose(block.update(g, block.init(psi), psi)[0].numpy(),
                               np.asarray(optax.apply_updates(jnp.asarray(psi.numpy()), updates)),
                               atol=OPTIM_ATOL, rtol=0)


# ----------------------------------------------------------------------
# CG runs against slmsuite_tpu.
# ----------------------------------------------------------------------


def _spot_target(shape, pitch=8, n=4):
    target = np.zeros(shape, np.float32)
    c0, c1 = shape[0] // 2, shape[1] // 2
    ys, xs = np.mgrid[0:n, 0:n] * pitch
    target[c0 - pitch * n // 2 + ys.ravel(), c1 - pitch * n // 2 + xs.ravel()] = 1.0
    return target


def _losses(holo_losses):
    """A callback that records each iteration's loss (and never stops)."""
    return lambda h: holo_losses.append(h.flags["loss_result"]) and False


def _psi_p99(t_phase, j_phase, amp=None):
    dp = np.abs(np.mod(np.asarray(t_phase, float) - np.asarray(j_phase, float) + np.pi,
                       2 * np.pi) - np.pi)
    if amp is not None and not np.isscalar(amp):
        dp = dp[np.asarray(amp).reshape(dp.shape) != 0]
    return float(np.quantile(dp, 0.99))


def _assert_runs_agree(t, j, t_losses, j_losses, target):
    assert t.iter == j.iter and len(t_losses) == len(j_losses) == t.iter
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    t_stats = calculate_stats_numpy(np.asarray(t.amp_ff), target, efficiency_compensation=False)
    j_stats = calculate_stats_numpy(np.asarray(j.amp_ff), target, efficiency_compensation=False)
    for key in ("efficiency", "uniformity"):
        assert abs(t_stats[key] - j_stats[key]) <= STATS_ATOL, (key, t_stats, j_stats)
    assert _psi_p99(t.phase, j.phase, t.amp) < PSI_P99


def _custom_loss_torch(farfield, target):
    amp = torch.abs(farfield)
    amp = amp / torch.sqrt(torch.sum(torch.square(amp)))
    return torch.sum(torch.abs(amp - torch.nan_to_num(target)))


def _custom_loss_jax(farfield, target):
    amp = jnp.abs(farfield)
    amp = amp / jnp.sqrt(jnp.sum(jnp.square(amp)))
    return jnp.sum(jnp.abs(amp - jnp.nan_to_num(target)))


LOSSES = {
    "default": (None, None),
    "mse_mean": (TH.ComplexMSELoss(), JH.ComplexMSELoss()),
    "mse_sum": (TH.ComplexMSELoss("sum"), JH.ComplexMSELoss("sum")),
    "max_uniform": (TH.MaxUniformLoss(), JH.MaxUniformLoss()),
    "custom": (_custom_loss_torch, _custom_loss_jax),
}


def _hologram_pair(padded):
    rng = np.random.default_rng(6)
    shape = (128, 128) if padded else (64, 64)
    kernel = rng.uniform(-1, 1, (64, 64)).astype(np.float32) if padded else None
    amp = rng.uniform(0.5, 1.0, (64, 64)).astype(np.float32) if padded else None
    phase = rng.uniform(-np.pi, np.pi, (64, 64)).astype(np.float32)
    target = _spot_target(shape)
    pair = []
    for pkg in (T, J):
        holo = pkg.Hologram(target, amp=amp, slm_shape=(64, 64), propagation_kernel=kernel)
        holo.reset_phase(phase.copy())
        pair.append(holo)
    return pair, target


@pytest.mark.parametrize("loss", sorted(LOSSES))
@pytest.mark.parametrize("padded", [False, True], ids=["64", "padded_128_kernel"])
def test_hologram_cg_matches_jax(padded, loss):
    """``Hologram`` CG (Adam, lr 0.1, 12 iterations) on a 64^2 farfield and
    on a 128^2 canvas holding a 64^2 SLM with an amplitude plane and a
    propagation kernel, with each loss: the loss at every iteration, the
    final efficiency and uniformity, psi at the 99th percentile."""
    (t, j), target = _hologram_pair(padded)
    losses = {}
    for holo, fn in zip((t, j), LOSSES[loss]):
        losses[holo] = []
        flags = {} if fn is None else {"loss": fn}
        holo.optimize("CG", maxiter=12, verbose=False, callback=_losses(losses[holo]), **flags)
    _assert_runs_agree(t, j, losses[t], losses[j], target)


OPTIMIZER_FLAGS = {
    "adamw": ("adamw", {"lr": 0.1, "weight_decay": 0.05}),
    "sgd_momentum": ("sgd", {"lr": 30.0, "momentum": 0.9}),
    "rmsprop": ("rmsprop", {"learning_rate": 0.02}),
    "adagrad": ("adagrad", {"learning_rate": 0.3}),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZER_FLAGS))
def test_hologram_cg_optimizer_flags_match_jax(case):
    """The ``optimizer`` and ``optimizer_kwargs`` flags (with the ``lr``
    alias) reach the same rule in both packages."""
    (t, j), target = _hologram_pair(False)
    name, kwargs = OPTIMIZER_FLAGS[case]
    losses = {t: [], j: []}
    for holo in (t, j):
        holo.optimize("CG", maxiter=10, verbose=False, optimizer=name,
                      optimizer_kwargs=dict(kwargs), callback=_losses(losses[holo]))
    _assert_runs_agree(t, j, losses[t], losses[j], target)


def test_spot_hologram_cg_matches_jax():
    """``SpotHologram`` in ``knm``: a 4x4 array on a 128^2 farfield."""
    rng = np.random.default_rng(7)
    vectors = np.array([(x, y) for y in range(40, 88, 12) for x in range(40, 88, 12)]).T
    phase = rng.uniform(-np.pi, np.pi, (128, 128)).astype(np.float32)
    pair, losses = [], []
    for pkg in (T, J):
        holo = pkg.SpotHologram((128, 128), vectors, basis="knm")
        holo.reset_phase(phase.copy())
        losses.append([])
        holo.optimize("CG", maxiter=15, verbose=False, callback=_losses(losses[-1]))
        pair.append(holo)
    _assert_runs_agree(*pair, *losses, np.asarray(pair[1].target))


def _compressed_pair(side=64, n=9, seed=8):
    rng = np.random.default_rng(seed)
    vectors = np.vstack([rng.uniform(-8e-3, 8e-3, (2, n)), rng.uniform(-2e-6, 2e-6, (1, n))])
    phase = rng.uniform(-np.pi, np.pi, (side, side)).astype(np.float32)
    pair = []
    for pkg, slm_cls in ((T, TSLM), (J, JSLM)):
        slm = slm_cls((side, side), pitch_um=(8, 8), wav_um=0.78)
        holo = pkg.CompressedSpotHologram(vectors, basis="kxy", cameraslm=slm)
        holo.reset_phase(phase.copy())
        pair.append(holo)
    return pair


@pytest.mark.parametrize("loss", ["default", "mse_sum", "custom"])
def test_compressed_cg_matches_jax(loss):
    """``CompressedSpotHologram`` on a bare 64^2 SLM, 9 spots in 3D (lr 0.3,
    20 iterations): its default loss normalizes the target."""
    t, j = _compressed_pair()
    losses = {t: [], j: []}
    for holo, fn in zip((t, j), LOSSES[loss]):
        flags = {} if fn is None else {"loss": fn}
        holo.optimize("CG", maxiter=20, verbose=False, callback=_losses(losses[holo]),
                      optimizer_kwargs={"learning_rate": 0.3}, **flags)
    _assert_runs_agree(t, j, losses[t], losses[j], np.asarray(j.target))


def _mp_children(pkg, B=2, shape=(64, 64)):
    """The JAX tests' two 64^2 children (``TestCGVariants._mp_children``)."""
    amp = np.ones(shape, np.float32)
    children = []
    for b in range(B):
        target = np.zeros(shape, np.float32)
        target[20 + 10 * b, 24 + 8 * b] = 1
        kernel = np.full(shape, 0.2 * b, np.float32)
        children.append(pkg.Hologram(target, amp=amp.copy(), slm_shape=shape,
                                     propagation_kernel=kernel))
    return children


def _multiplane_pair(weights=None):
    phase = np.random.default_rng(10).uniform(-np.pi, np.pi, (64, 64)).astype(np.float32)
    pair = []
    for pkg in (T, J):
        holo = pkg.MultiplaneHologram(_mp_children(pkg), weights=weights)
        holo.reset_phase(phase.copy())
        pair.append(holo)
    return pair


@pytest.mark.parametrize("weights", [None, [1.0, 3.0]], ids=["even", "weighted"])
def test_multiplane_cg_matches_jax(weights):
    """``MultiplaneHologram`` CG on the JAX tests' two children (lr 0.2, 15
    iterations): the plane-weighted loss at every iteration, the shared
    phase, and each child's phase and iteration after the run."""
    t, j = _multiplane_pair(weights)
    losses = {t: [], j: []}
    for holo in (t, j):
        holo.optimize("CG", maxiter=15, verbose=False, callback=_losses(losses[holo]),
                      optimizer_kwargs={"learning_rate": 0.2})
    assert t.iter == j.iter == 15
    np.testing.assert_allclose(losses[t], losses[j], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert _psi_p99(t.get_phase(), j.get_phase()) < PSI_P99
    for tc, jc in zip(t.holograms, j.holograms):
        assert tc.iter == jc.iter == 15
        assert _psi_p99(tc.get_phase(), jc.get_phase()) < PSI_P99
        np.testing.assert_array_equal(tc.get_phase(), t.get_phase())


# ----------------------------------------------------------------------
# Callbacks and stat groups.
# ----------------------------------------------------------------------


def _stop_at(k):
    return lambda h: h.iter == k


@pytest.mark.parametrize("kind", ["hologram", "compressed", "multiplane"])
def test_cg_callback_stops_like_jax(kind):
    """A callback returning True stops the loop before ``iter`` moves, with
    the phase of that iteration set; the same in both packages."""
    if kind == "hologram":
        (t, j), _ = _hologram_pair(True)
    elif kind == "compressed":
        t, j = _compressed_pair()
    else:
        t, j = _multiplane_pair()
    for holo in (t, j):
        holo.optimize("CG", maxiter=8, verbose=False, callback=_stop_at(3))
    assert t.iter == j.iter == 3
    np.testing.assert_allclose(t.flags["loss_result"], j.flags["loss_result"],
                               rtol=LOSS_RTOL)
    assert _psi_p99(t.phase, j.phase) < PSI_P99


@pytest.mark.parametrize("kind", ["hologram", "spot", "compressed"])
def test_cg_stat_groups_match_jax(kind):
    """With stat groups the loop records each iteration's stats, as the
    JAX package's does."""
    if kind == "compressed":
        t, j = _compressed_pair()
        groups = ["computational_spot"]
    elif kind == "spot":
        vectors = np.array([(x, y) for y in (24, 32, 40) for x in (20, 30, 44)]).T
        phase = np.random.default_rng(11).uniform(-np.pi, np.pi, (64, 64))
        t, j = (pkg.SpotHologram((64, 64), vectors, basis="knm") for pkg in (T, J))
        for holo in (t, j):
            holo.reset_phase(phase.copy())
        groups = ["computational", "computational_spot"]
    else:
        (t, j), _ = _hologram_pair(False)
        groups = ["computational"]
    for holo in (t, j):
        holo.optimize("CG", maxiter=6, verbose=False, stat_groups=groups)
    assert t.iter == j.iter == 6
    for group in groups:
        for key, series in j.stats["stats"][group].items():
            got = np.asarray(t.stats["stats"][group][key], float)
            assert got.shape == (6,), (group, key)
            np.testing.assert_allclose(got, np.asarray(series, float), atol=STATS_ATOL,
                                       rtol=1e-3, err_msg=f"{group} {key}")


# ----------------------------------------------------------------------
# Mirrors of the JAX package's TestCG and TestCGVariants, on the port.
# ----------------------------------------------------------------------


@pytest.fixture()
def spot_target():
    """``tests/holography/test_algorithms.py``'s 4x4 spot grid."""
    target = np.zeros((64, 64), dtype=np.float32)
    ys, xs = np.mgrid[20:44:8, 16:48:8]
    target[ys.ravel(), xs.ravel()] = 1.0
    return target, (48, 56)


def test_cg_converges(spot_target):
    target, slm_shape = spot_target
    holo = T.Hologram(target, slm_shape=slm_shape)
    holo.optimize(method="CG", maxiter=40, verbose=False, stat_groups=["computational"])
    eff = holo.stats["stats"]["computational"]["efficiency"]
    assert eff[-1] > 0.3
    assert holo.flags["loss_result"] < 1e-3


def test_cg_custom_loss(spot_target):
    target, slm_shape = spot_target
    holo = T.Hologram(target, slm_shape=slm_shape)
    holo.optimize(method="CG", maxiter=5, verbose=False, loss=_custom_loss_torch)
    assert "loss_result" in holo.flags


def test_cg_named_losses(spot_target):
    """``ComplexMSELoss()`` is the default loss; ``MaxUniformLoss`` runs to
    a finite loss; an unknown reduction raises."""
    target, slm_shape = spot_target
    results = {}
    for name, loss in ((None, None), ("mse", TH.ComplexMSELoss()),
                       ("uniform", TH.MaxUniformLoss())):
        holo = T.Hologram(target, slm_shape=slm_shape)
        holo.reset_phase(custom_phase=np.zeros(slm_shape, np.float32))
        kwargs = {} if loss is None else {"loss": loss}
        holo.optimize(method="CG", maxiter=5, verbose=False, **kwargs)
        results[name] = holo.flags["loss_result"]
    np.testing.assert_allclose(results["mse"], results[None], rtol=1e-5)
    assert np.isfinite(results["uniform"])
    with pytest.raises(ValueError, match="bogus"):
        TH.ComplexMSELoss(reduction="bogus")


def test_cg_verbose_runs_with_a_progress_bar(spot_target, capsys):
    """``verbose`` wraps the iterations in tqdm (imported only when asked
    for) and writes the loss into the bar's description."""
    pytest.importorskip("tqdm")
    target, slm_shape = spot_target
    holo = T.Hologram(target, slm_shape=slm_shape)
    holo.optimize(method="CG", maxiter=3, verbose=True, name="cg")
    assert holo.iter == 3 and "loss=" in capsys.readouterr().err


def _bare_slm():
    """The JAX tests' 512^2 SLM with its Gaussian source (their
    ``fourierslm_calibrated`` rig without the camera)."""
    slm = TSLM(resolution=(512, 512), pitch_um=(8, 8), wav_um=0.78)
    slm.set_source_analytic("gaussian2d", sim=True, x0=0, y0=0, a=1, c=0,
                            wx=0.35 * 512 * slm.pitch[0], wy=0.35 * 512 * slm.pitch[1])
    return slm


def test_compressed_cg_converges():
    rng = np.random.default_rng(12345)
    spots_kxy = rng.uniform(-0.01, 0.01, size=(2, 10))
    holo = T.CompressedSpotHologram(spots_kxy, basis="kxy", cameraslm=_bare_slm())
    holo.optimize("CG", maxiter=60, verbose=False, optimizer_kwargs={"learning_rate": 0.3})
    assert holo.flags["loss_result"] < 2e-4
    amps = holo.amp_ff / np.sqrt(np.sum(holo.amp_ff**2))
    target = holo.target / np.sqrt(np.sum(holo.target**2))
    assert np.max(np.abs(amps - target)) < 0.15


def test_compressed_cg_matches_gs_quality():
    rng = np.random.default_rng(12345)
    spots_kxy = rng.uniform(-0.008, 0.008, size=(2, 6))
    cg = T.CompressedSpotHologram(spots_kxy.copy(), basis="kxy", cameraslm=_bare_slm())
    cg.optimize("CG", maxiter=120, verbose=False, optimizer_kwargs={"learning_rate": 0.3})
    a = cg.amp_ff / np.sqrt(np.sum(cg.amp_ff**2))
    assert 1 - (np.max(a) - np.min(a)) / (np.max(a) + np.min(a)) > 0.7


def test_multiplane_cg_concentrates_each_plane():
    holo = T.MultiplaneHologram(_mp_children(T))
    holo.optimize("CG", maxiter=80, verbose=False, optimizer_kwargs={"learning_rate": 0.2})
    for child in holo.holograms:
        child._populate_results()
        amp_ff = np.asarray(child.amp_ff)
        i, j = np.unravel_index(np.argmax(np.nan_to_num(child.target)), child.target.shape)
        window = amp_ff[i - 2:i + 3, j - 2:j + 3]
        assert np.sum(window**2) / np.sum(amp_ff**2) > 0.05
