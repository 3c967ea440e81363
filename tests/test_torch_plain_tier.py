"""
The plain tier: planes whose sides the CUDA kernels do not take (a side
that is not a multiple of 8 in [64, 8192]) run the plain PyTorch versions,
on the CPU and on the card, as the JAX package runs its einsum and
``jnp.fft`` tier where its Pallas kernels do not apply.

On the CPU: :meth:`slmsuite_torch.ops.fft.kernel_tier` on shapes inside and
outside the gate; the engine's choice of loop on the card
(:meth:`slmsuite_torch.ops.engine._carry_runs`: the carry loop only where
the kernels run); and holograms at 100x128 and at 1050x1440 (a Santec
SLM-100's panel at ``padding_order=0``) against ``slmsuite_tpu``, both on
the loop the CPU takes and on the natural step the card's plain tier takes,
at the tolerances of ``tests/test_torch_mixed_sides.py``.
"""

import numpy as np
import pytest
import torch

import slmsuite_torch
from slmsuite_torch.holography import algorithms as T
from slmsuite_torch.ops import engine as TE
from slmsuite_torch.ops import fft as TF
from slmsuite_tpu.holography import algorithms as J


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


#: The tolerances of tests/test_torch_mixed_sides.py.
ITERS = 10
PHASE_ATOL = 5e-4
WEIGHT_ATOL = 1e-5
STATS_ATOL, STATS_RTOL = 1e-4, 1e-3

SHAPES = [(100, 128), (1050, 1440)]


@pytest.mark.parametrize("shape,tier", [
    ((100, 128), "plain"), ((1050, 1440), "plain"), ((1021, 1024), "plain"),
    ((56, 64), "plain"), ((8200, 64), "plain"), ((96, 128), "kernels"),
    ((1056, 1440), "kernels"), ((8192, 8192), "kernels"), ((3, 100, 128), "plain"),
    ((3, 96, 128), "kernels"),
])
def test_kernel_tier_inside_and_outside_the_gate(shape, tier):
    """The tier comes from the device type and the shape alone: the CPU is
    always plain, CUDA takes the kernels where both sides do; rows read only
    the line and a multiple of 8 rows; other devices raise."""
    assert TF.kernel_tier("cuda", shape) == tier
    assert TF.kernel_tier("cpu", shape) == "plain"
    rows = "kernels" if TF.kernel_len_ok(shape[-1]) and shape[-2] % 8 == 0 else "plain"
    assert TF.kernel_tier("cuda", shape, rows=True) == rows
    with pytest.raises(NotImplementedError, match="CPU or on a CUDA device"):
        TF.kernel_tier("meta", shape)


def test_engine_runs_the_carry_loop_only_where_the_kernels_run():
    """On the card the carry loops run only where the kernels take the
    plane; the plain tier runs the natural step. The CPU keeps the carry
    loop, its plain versions standing in for the kernels."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for shape, on_card in (((128, 128), True), ((96, 128), True), ((100, 128), False),
                           ((1050, 1440), False)):
        config = TE.GSConfig(method="WGS-Kim", shape=shape, slm_shape=shape)
        mraf = TE.GSConfig(method="WGS-Leonardo", shape=shape, slm_shape=shape, mraf=True)
        assert TE._carry_runs(config, cuda) is on_card
        assert TE._carry_runs(mraf, cuda) is on_card
        assert TE._carry_runs(config, cpu) is True
        natural = TE.GSConfig(method="WGS-Nogrette", shape=shape, slm_shape=shape)
        assert TE._carry_runs(natural, cuda) is False


def _holo_stats(holo, group):
    record = holo.stats["stats"][group]
    return np.stack([record[k] for k in ("efficiency", "uniformity", "pkpk_err",
                                         "std_err")], axis=-1)


def _assert_stats(got, ref):
    np.testing.assert_allclose(got[..., :3], ref[..., :3],
                               atol=STATS_ATOL, rtol=STATS_RTOL, equal_nan=True)
    cancel = np.sqrt(np.finfo(np.float32).eps) * np.abs(1 - ref[..., 0])
    bad = np.abs(got[..., 3] - ref[..., 3]) > STATS_ATOL + STATS_RTOL * np.abs(ref[..., 3]) + cancel
    assert not bad.any(), (got[..., 3][bad], ref[..., 3][bad])


def _phase_err(a, b):
    dp = np.asarray(a) - np.asarray(b)
    dp = np.mod(dp - dp.flat[0] + np.pi, 2 * np.pi) - np.pi
    return np.abs(dp).max()


def _run(module, shape, method):
    """A 4x4 spot array on the SLM's own plane (``padding_order=0``), from
    one seeded phase."""
    holo = module.SpotHologram.make_rectangular_array(
        shape, array_shape=(4, 4), array_pitch=(11, 13), basis="knm")
    holo.reset_phase(custom_phase=np.random.default_rng(21).uniform(
        -np.pi, np.pi, shape).astype(np.float32))
    kw = dict(fix_phase_iteration=4) if method == "WGS-Kim" else {}
    holo.optimize(method, maxiter=ITERS, verbose=False, stat_groups=["computational"], **kw)
    return holo


@pytest.mark.parametrize("route", ["cpu_loop", "card_plain_tier"])
@pytest.mark.parametrize("method", ["GS", "WGS-Kim"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_tier_hologram_matches_jax(shape, method, route, monkeypatch):
    """The port's hologram at a shape outside the gate against the JAX
    package's: on the CPU's loop, and on the loop the card's plain tier
    takes (the natural step), selected here as the card selects it."""
    if route == "card_plain_tier":
        carry_runs = TE._carry_runs
        monkeypatch.setattr(TE, "_carry_runs",
                            lambda config, device: carry_runs(config, torch.device("cuda")))
    tholo, jholo = (_run(module, shape, method) for module in (T, J))
    _assert_stats(_holo_stats(tholo, "computational"), _holo_stats(jholo, "computational"))
    assert tholo.get_phase().shape == shape
    assert _phase_err(tholo.get_phase(), jholo.get_phase()) < PHASE_ATOL
    np.testing.assert_allclose(np.asarray(tholo.weights), np.asarray(jholo.weights),
                               atol=WEIGHT_ATOL)
