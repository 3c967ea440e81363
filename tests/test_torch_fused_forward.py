"""
``slmsuite_torch.ops.fft.wgs_fused_forward`` (the forward half of a psi
-> psi WGS step) against the JAX package on the CPU: its jnp twin
``_wgs_fused_forward_jnp`` and the Pallas kernel
``wgs_fused_forward_pallas`` in interpret mode, for the four rules, Kim's
select on and off, stats on and off, scalar and plane amplitude, at 256^2
and 128x256. Inputs come from ``numpy.random.default_rng(seed)`` and go
to both packages. The JAX farfield is in the four-step scrambled order,
so the farfield inputs are permuted on the way in and the port's
natural-order outputs on the way out.

Tolerances: planes 2e-5 abs plus 1e-5 relative (leonardo and kim raise
the weight of a spot that came out dim to tens of units, where one f32
ulp is already 4e-6; angles modulo 2 pi, where ``|F| > 1e-3 max |F|``:
elsewhere the angle of a round-off-sized value is arbitrary),
sums 1e-4 relative (plus 1e-6 abs for sums that cancel to ~0), maxs
1e-4 relative.

The kernel composition ``cuda_fft.wgs_fused_forward`` (``carry_entry``,
then ``cols_wgs_fwd`` with the post scale from the amplitude) runs here
on the kernels' plain versions and must equal the dispatcher's plain
version; a WGS loop made of ``wgs_fused_forward`` and ``ifft2_phase``
must equal ``wgs_fused_step`` iterated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slmsuite_torch.ops import cuda_fft
from slmsuite_torch.ops import fft as TF
from slmsuite_tpu.ops import fft as JF
from slmsuite_tpu.ops import pallas_fft as JPF


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


PLANE_ATOL, PLANE_RTOL = 2e-5, 1e-5
SUMS_RTOL, SUMS_ATOL = 1e-4, 1e-6
NEG_FILL = -3.0e38


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _inputs(shape, amp_kind, use_theta, apply_update, seed):
    """Seeded inputs of one forward half: numpy planes in natural order
    and the step scalars as a dict of floats."""
    H, W = shape
    rng = np.random.default_rng(seed)
    psi = rng.uniform(-3 * np.pi, 3 * np.pi, shape).astype(np.float32)
    target = np.zeros(shape, np.float32)
    target[rng.integers(0, H, 16), rng.integers(0, W, 16)] = rng.uniform(0.5, 1.5, 16)
    target /= np.sqrt((target**2).sum())
    weights = (target * rng.uniform(0.8, 1.2, shape)).astype(np.float32)
    phase_ff = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
    mask = (target != 0).astype(np.float32)
    if amp_kind == "scalar":
        amp = np.float32(1.0 / np.sqrt(H * W))
        fsum = float(amp) ** 2 * H * W
    else:
        amp = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        amp /= np.sqrt((amp**2).sum())
        fsum = float((amp.astype(np.float64) ** 2).sum())
    scalars = {
        "inv_prev_norm": 0.9,
        "apply_update": float(apply_update),
        "use_theta": float(use_theta),
        "feedback_exponent": 0.8,
        "feedback_factor": 0.2,
        "inv_fnorm": 1.0 / np.sqrt(fsum),
        "inv_tsum": 1.0 / float((target.astype(np.float64) ** 2).sum()),
        "inv_fsum": 1.0 / fsum,
    }
    return dict(psi=psi, amp=amp, weights=weights, phase_ff=phase_ff, target=target,
                mask=mask, scalars=scalars)


def _port(x, fn, *, rule, kim, stats_on):
    amp = float(x["amp"]) if np.ndim(x["amp"]) == 0 else _t(x["amp"])
    # The post lane is not read: the function derives it from amp.
    scal = TF.pack_scalars({"post": 123.0, **x["scalars"]})
    return fn(
        _t(x["psi"]), amp, _t(x["weights"]), _t(x["phase_ff"]) if kim else None,
        _t(x["target"]), _t(x["mask"]) if stats_on else None, scal,
        rule=rule, kim=kim, stats_on=stats_on,
    )


def _jax_args(x, scr, *, kim, stats_on):
    amp = jnp.float32(x["amp"]) if np.ndim(x["amp"]) == 0 else jnp.asarray(x["amp"])
    return (
        jnp.asarray(x["psi"]), amp, jnp.asarray(scr(x["weights"])),
        jnp.asarray(scr(x["phase_ff"])) if kim else None, jnp.asarray(scr(x["target"])),
        jnp.asarray(scr(x["mask"])) if stats_on else None,
        {k: jnp.float32(v) for k, v in x["scalars"].items()},
    )


def _scrambler(shape):
    ph, pw = JF.scramble_permutation_2d(shape)
    return lambda a: np.asarray(a)[ph][:, pw]


def _assert_forward(got, ref, scr, amp_ff, *, kim, stats_on):
    """The port's natural-order outputs against the JAX package's
    scrambled ones."""
    re, im, wout, pff, sums, maxs = got
    for name, g, r in (("re", re, ref[0]), ("im", im, ref[1]), ("weights", wout, ref[2])):
        np.testing.assert_allclose(scr(g.numpy()), np.asarray(r), atol=PLANE_ATOL,
                                   rtol=PLANE_RTOL, err_msg=name)
    if kim:
        on = scr(amp_ff) > 1e-3 * amp_ff.max()
        dphi = np.angle(np.exp(1j * (scr(pff.numpy()) - np.asarray(ref[3]))))
        assert np.abs(dphi[on]).max() < PLANE_ATOL
    else:
        assert pff is None and ref[3] is None
    assert sums.dtype == torch.float64 and maxs.dtype == torch.float32
    np.testing.assert_allclose(sums.numpy(), np.asarray(ref[4], np.float64),
                               rtol=SUMS_RTOL, atol=SUMS_ATOL)
    np.testing.assert_allclose(maxs.numpy(), np.asarray(ref[5]), rtol=SUMS_RTOL)
    if not stats_on:
        assert sums.numpy()[:3].tolist() == [0.0, 0.0, 0.0]
        np.testing.assert_allclose(sums.numpy()[3], float(torch.square(wout).sum()),
                                   rtol=1e-6)
        assert np.all(maxs.numpy() == np.float32(NEG_FILL))


def _pallas_interpret(*args, **kwargs):
    """``wgs_fused_forward_pallas`` in interpret mode (restored after)."""
    JPF._INTERPRET = True
    try:
        return JPF.wgs_fused_forward_pallas(*args, **kwargs)
    finally:
        JPF._INTERPRET = False


@pytest.mark.parametrize("shape", [(256, 256), (128, 256)], ids=["256x256", "128x256"])
@pytest.mark.parametrize("amp_kind", ["scalar", "plane"])
@pytest.mark.parametrize("stats_on", [True, False], ids=["stats", "nostats"])
@pytest.mark.parametrize("kim", [True, False], ids=["kim", "nokim"])
@pytest.mark.parametrize("rule", ["leonardo", "kim", "wu", "tanh"])
def test_fused_forward_matches_jax(rule, kim, stats_on, amp_kind, shape):
    """The plain ``wgs_fused_forward`` against the jnp twin and against
    the Pallas kernel in interpret mode, on the same inputs. With Kim the
    stored angle is selected (``use_theta`` 0); the other select is
    :meth:`test_kim_select_and_first_iteration`'s."""
    seed = sum(map(ord, f"{rule}{kim}{stats_on}{amp_kind}")) + shape[0]
    x = _inputs(shape, amp_kind, use_theta=not kim, apply_update=True, seed=seed)
    scr = _scrambler(shape)
    kw = dict(rule=rule, kim=kim, stats_on=stats_on)
    got = _port(x, TF.wgs_fused_forward, **kw)
    amp_ff = TF._fft2_polar_from_phase(
        _t(x["psi"]), float(x["amp"]) if np.ndim(x["amp"]) == 0 else _t(x["amp"])
    )[0].numpy()
    args = _jax_args(x, scr, kim=kim, stats_on=stats_on)
    _assert_forward(got, JF._wgs_fused_forward_jnp(*args, **kw), scr, amp_ff,
                    kim=kim, stats_on=stats_on)
    _assert_forward(got, _pallas_interpret(*args, **kw), scr, amp_ff,
                    kim=kim, stats_on=stats_on)


@pytest.mark.parametrize("use_theta", [True, False], ids=["theta", "stored"])
@pytest.mark.parametrize("apply_update", [True, False], ids=["update", "first"])
def test_kim_select_and_first_iteration(use_theta, apply_update):
    """Kim's two selects and the first iteration (``apply_update`` 0: the
    weights pass through unchanged) against the jnp twin."""
    shape = (128, 128)
    x = _inputs(shape, "scalar", use_theta, apply_update, seed=11)
    scr = _scrambler(shape)
    kw = dict(rule="kim", kim=True, stats_on=True)
    got = _port(x, TF.wgs_fused_forward, **kw)
    amp_ff = TF._fft2_polar_from_phase(_t(x["psi"]), float(x["amp"]))[0].numpy()
    ref = JF._wgs_fused_forward_jnp(*_jax_args(x, scr, kim=True, stats_on=True), **kw)
    _assert_forward(got, ref, scr, amp_ff, kim=True, stats_on=True)
    if not apply_update:
        assert torch.equal(got[2], _t(x["weights"]))
    if not use_theta:
        assert torch.equal(got[3], _t(x["phase_ff"]))


def test_zero_field_angle_is_zero():
    """A zero farfield gives the angle 0 (``atan2(0, 0) = 0``), so the
    constrained field is ``(w', 0)``."""
    shape = (64, 64)
    x = _inputs(shape, "plane", True, True, seed=3)
    x["amp"] = np.zeros(shape, np.float32)
    re, im, wout, pff, _, _ = _port(x, TF.wgs_fused_forward, rule="kim", kim=True,
                                    stats_on=True)
    assert torch.equal(pff, torch.zeros(shape))
    assert torch.equal(re, wout) and torch.equal(im, torch.zeros(shape))


@pytest.fixture
def plain_kernels(monkeypatch):
    """``cuda_fft``'s wrappers replaced by their plain versions, so that
    its compositions run on CPU tensors."""
    for name, plain in [
        ("carry_entry", TF._wgs_carry_entry), ("carry_exit", TF._wgs_carry_exit),
        ("cols_fft", TF._cols_fft), ("cols_wgs_fwd", TF._cols_wgs_fwd),
    ]:
        monkeypatch.setattr(cuda_fft, name, plain)


@pytest.mark.parametrize("amp_kind", ["scalar", "plane"])
@pytest.mark.parametrize("stats_on", [True, False], ids=["stats", "nostats"])
@pytest.mark.parametrize("rule, kim", [("kim", True), ("leonardo", False), ("wu", True),
                                       ("tanh", False)])
def test_kernel_composition_matches_plain(plain_kernels, rule, kim, stats_on, amp_kind):
    """``carry_entry`` then ``cols_wgs_fwd`` with the post scale set from
    the amplitude (a scalar amplitude rides in it), run on the kernels'
    plain versions, equals the dispatcher's plain version."""
    x = _inputs((64, 128), amp_kind, use_theta=False, apply_update=True, seed=21)
    kw = dict(rule=rule, kim=kim, stats_on=stats_on)
    got = _port(x, cuda_fft.wgs_fused_forward, **kw)
    ref = _port(x, TF._wgs_fused_forward, **kw)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=PLANE_ATOL, rtol=PLANE_RTOL)
    if kim:
        np.testing.assert_allclose(got[3].numpy(), ref[3].numpy(), atol=PLANE_ATOL)
    np.testing.assert_allclose(got[4].numpy(), ref[4].numpy(), rtol=SUMS_RTOL, atol=SUMS_ATOL)
    np.testing.assert_allclose(got[5].numpy(), ref[5].numpy(), rtol=SUMS_RTOL)


def _wgs_loop(step, x, iterations, fix_at):
    """``iterations`` of WGS-Kim from ``x`` with the step scalars formed
    as the engine's fused step forms them (the update on after the first
    iteration, the previous norm deferred, Kim's phase fixed from
    iteration ``fix_at`` on). ``step(psi, weights, pff, scal)`` returns
    ``(psi', weights', pff', sums, maxs)``."""
    psi, weights, pff = _t(x["psi"]), _t(x["weights"]), _t(x["phase_ff"])
    w_norm, rows = 1.0, []
    for it in range(iterations):
        scal = TF.pack_scalars({
            "post": 0.0, **x["scalars"], "inv_prev_norm": 1.0 / w_norm,
            "apply_update": float(it > 0), "use_theta": float(it < fix_at),
        })
        psi, weights, pff, sums, maxs = step(psi, weights, pff, scal)
        if it > 0:
            w_norm = float(torch.sqrt(sums[3]))
        rows.append(torch.cat([sums.to(torch.float32), maxs]))
    return psi, weights / w_norm, pff, torch.stack(rows)


def test_forward_plus_ifft2_phase_is_the_fused_step():
    """A WGS-Kim loop whose iteration is ``wgs_fused_forward`` then
    ``ifft2_phase`` equals ``wgs_fused_step`` iterated (psi 1e-4 rad
    modulo 2 pi, weights 1e-6, the stats rows 1e-5 relative)."""
    shape = (64, 64)
    x = _inputs(shape, "scalar", True, True, seed=5)
    amp = float(x["amp"])
    target, mask = _t(x["target"]), _t(x["mask"])
    kw = dict(rule="kim", kim=True, stats_on=True)

    def halves(psi, weights, pff, scal):
        re, im, wout, pff_out, sums, maxs = TF.wgs_fused_forward(
            psi, amp, weights, pff, target, mask, scal, **kw)
        return TF.ifft2_phase(re, im), wout, pff_out, sums, maxs

    def whole(psi, weights, pff, scal):
        return TF.wgs_fused_step(psi, amp, weights, pff, target, mask, scal, **kw)

    a = _wgs_loop(halves, x, 12, fix_at=6)
    b = _wgs_loop(whole, x, 12, fix_at=6)
    dpsi = np.angle(np.exp(1j * (a[0].numpy() - b[0].numpy())))
    assert np.abs(dpsi).max() < 1e-4
    np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), atol=1e-6)
    np.testing.assert_allclose(a[3].numpy(), b[3].numpy(), rtol=1e-5, atol=1e-7)
    # The weights moved: the loop is not the identity.
    assert float((a[1] - _t(x["weights"])).abs().max()) > 1e-3


def test_dispatcher_refuses_unsupported_cuda_shape():
    """The gate decides from device and shape alone: a CPU tensor takes
    the plain version whatever its shape."""
    x = _inputs((48, 80), "scalar", True, True, seed=2)
    out = _port(x, TF.wgs_fused_forward, rule="wu", kim=False, stats_on=False)
    assert out[0].shape == (48, 80) and out[3] is None
