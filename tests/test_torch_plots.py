"""
The plots of the port against the JAX package's, on the CPU under
matplotlib's Agg backend: each axis' image data (``ax.images[k].get_array()``),
line data and limits, for the same state in both packages (a hologram
carried across with :mod:`slmsuite_torch.convert`, a seeded SLM or image).

The hologram plots read a farfield the two packages compute with their own
FFTs, so their image data are held at 1e-5 of the image's largest value;
everything else drawn from the same numpy arrays is held equal. Also here:
``MultiplaneHologram``'s plots and vortex removal, ``Hologram``'s memory
helpers against the JAX package's with an explicit budget, and the
``set_``/``get_mempool_limit`` pair without a CUDA device.
"""

import copy

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import slmsuite_torch  # noqa: E402
from slmsuite_torch import convert  # noqa: E402
from slmsuite_torch.hardware.cameras.simulated import SimulatedCamera as TCamera  # noqa: E402
from slmsuite_torch.hardware.slms.simulated import SimulatedSLM as TSLM  # noqa: E402
from slmsuite_torch.holography import algorithms as T  # noqa: E402
from slmsuite_torch.holography import analysis as tanalysis  # noqa: E402
from slmsuite_torch.holography.toolbox import phase as tphase  # noqa: E402
from slmsuite_tpu.hardware.cameras.simulated import SimulatedCamera as JCamera  # noqa: E402
from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM as JSLM  # noqa: E402
from slmsuite_tpu.holography import algorithms as J  # noqa: E402
from slmsuite_tpu.holography import analysis as janalysis  # noqa: E402
from slmsuite_tpu.holography.toolbox import phase as jphase  # noqa: E402

#: Farfield images computed by each package's own FFT: relative to the max.
FARFIELD_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it; no figure left
    open."""
    state = np.random.get_state()
    plt.close("all")
    yield
    plt.close("all")
    np.random.set_state(state)


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu():
    slmsuite_torch.set_default_device("cpu")
    yield
    slmsuite_torch.set_default_device("cuda")


def _axes_of(call):
    """Run ``call``; return the axes of every figure it drew, closing them."""
    plt.close("all")
    call()
    axes = [ax for n in plt.get_fignums() for ax in plt.figure(n).axes]
    plt.close("all")
    return axes


def _assert_axes(taxes, jaxes, image_rtol=0.0):
    assert len(taxes) == len(jaxes) and taxes
    for t, j in zip(taxes, jaxes):
        assert len(t.images) == len(j.images)
        for ti, ji in zip(t.images, j.images):
            a, b = np.ma.filled(ti.get_array(), np.nan), np.ma.filled(ji.get_array(), np.nan)
            assert a.shape == b.shape
            scale = np.nanmax(np.abs(b)) if np.isfinite(b).any() else 1.0
            np.testing.assert_allclose(a, b, rtol=0, atol=image_rtol * scale, equal_nan=True)
            np.testing.assert_allclose(ti.get_extent(), ji.get_extent(), rtol=1e-9)
        for tl, jl in zip(t.lines, j.lines):
            np.testing.assert_allclose(tl.get_xydata(), jl.get_xydata(), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(t.get_xlim(), j.get_xlim(), rtol=1e-6)
        np.testing.assert_allclose(t.get_ylim(), j.get_ylim(), rtol=1e-6)
        assert t.get_title() == j.get_title()


def _optimized(kind, shape=(64, 64)):
    """The JAX package's optimized hologram and the port's copy of it."""
    if kind == "spot":
        jholo = J.SpotHologram.make_rectangular_array(
            shape, array_shape=(3, 3), array_pitch=(9, 11), basis="knm")
    else:
        yy, xx = np.meshgrid(*(np.arange(s) - s / 2 for s in shape), indexing="ij")
        radius = np.hypot(xx, yy)
        target = np.where(np.abs(radius - 10) < 2, 1.0, 0.0).astype(np.float32)
        target[radius > 20] = np.nan
        jholo = J.Hologram(target, slm_shape=(shape[0] // 2, shape[1] // 2))
    jholo.reset_phase(custom_phase=np.random.default_rng(2).uniform(
        -np.pi, np.pi, jholo.slm_shape).astype(np.float32))
    kw = dict(mraf_factor=0.5) if kind == "mraf" else dict(fix_phase_iteration=3)
    jholo.optimize("WGS-Kim" if kind == "spot" else "WGS-Leonardo", maxiter=6, verbose=False,
                   stat_groups=["computational"], **kw)
    if kind != "spot":
        return convert.hologram_from_jax(jholo, device="cpu"), jholo
    tholo = convert.spot_hologram_from_jax(jholo, None, device="cpu")
    tholo.amp_ff = np.array(jholo.amp_ff)
    tholo.stats = copy.deepcopy(jholo.stats)
    return tholo, jholo


@pytest.mark.parametrize("kind", ["spot", "mraf"])
@pytest.mark.parametrize("kw", [dict(), dict(title="farfield phase", source="phase"),
                                dict(limits=((10, 50), (12, 40)), cbar=True)])
def test_plot_farfield_matches_jax(kind, kw):
    tholo, jholo = _optimized(kind)
    kw = dict(kw)
    if kw.pop("source", None) == "phase":
        kw["source"] = (tholo.phase_ff, jholo.phase_ff)
    args = [dict(kw), dict(kw)]
    if "source" in kw:
        args[0]["source"], args[1]["source"] = kw["source"]
    out = {}
    axes = [_axes_of(lambda h=h, a=a: out.setdefault(len(out), h.plot_farfield(**a)))
            for h, a in ((tholo, args[0]), (jholo, args[1]))]
    assert out[0] == out[1]
    _assert_axes(axes[0][:2], axes[1][:2], FARFIELD_RTOL)


@pytest.mark.parametrize("kw", [dict(), dict(padded=True, cbar=True, title="near")])
def test_plot_nearfield_matches_jax(kw):
    tholo, jholo = _optimized("mraf")
    _assert_axes(_axes_of(lambda: tholo.plot_nearfield(**kw)),
                 _axes_of(lambda: jholo.plot_nearfield(**kw)), 1e-6)


@pytest.mark.parametrize("kind", ["spot", "mraf"])
def test_plot_stats_matches_jax(kind):
    tholo, jholo = _optimized(kind)
    taxes = _axes_of(lambda: tholo.plot_stats())
    jaxes = _axes_of(lambda: jholo.plot_stats())
    _assert_axes(taxes, jaxes)
    for t, j in zip(taxes[0].collections, jaxes[0].collections):
        np.testing.assert_allclose(t.get_offsets(), j.get_offsets())


def test_plot_farfield_of_a_device_plane():
    """A tensor source reaches matplotlib through the one host conversion."""
    tholo, jholo = _optimized("spot")
    source = torch.as_tensor(np.asarray(jholo.amp_ff))
    _assert_axes(_axes_of(lambda: tholo.plot_farfield(source=source)),
                 _axes_of(lambda: jholo.plot_farfield(source=np.asarray(jholo.amp_ff))))


def test_multiplane_plots_and_vortices_match_jax():
    """``MultiplaneHologram.plot_farfield``/``plot_stats`` draw each
    child's; ``remove_vortices`` reaches each child (spot children skip it,
    as in the JAX package); ``Hologram._remove_vortices`` cleans the same
    farfield phase."""
    jkids = [J.SpotHologram.make_rectangular_array((64, 64), array_shape=(2, 2),
                                                   array_pitch=(8 + b, 9), basis="knm")
             for b in range(2)]
    np.random.seed(3)
    jmp = J.MultiplaneHologram(jkids)
    jmp.optimize("WGS-Kim", maxiter=4, verbose=False, stat_groups=["computational"])
    tmp = convert.multiplane_hologram_from_jax(jmp, device="cpu")
    for child, jchild in zip(tmp.holograms, jmp.holograms):
        child.amp_ff = np.array(jchild.amp_ff)
        child.stats = jchild.stats
    _assert_axes(_axes_of(lambda: tmp.plot_farfield()), _axes_of(lambda: jmp.plot_farfield()),
                 FARFIELD_RTOL)
    _assert_axes(_axes_of(lambda: tmp.plot_stats()), _axes_of(lambda: jmp.plot_stats()))
    tmp.remove_vortices()
    jmp.remove_vortices()
    tholo, jholo = _optimized("mraf")
    tholo._remove_vortices()
    jholo._remove_vortices()
    np.testing.assert_array_equal(np.asarray(tholo.phase_ff), np.asarray(jholo.phase_ff))


def test_take_plot_and_zernike_pyramid_match_jax():
    images = np.random.default_rng(7).uniform(0, 1, (5, 9, 11))
    for kw in (dict(), dict(separate_axes=True), dict(shape=(2, 3), cbar=False)):
        _assert_axes(_axes_of(lambda: tanalysis.take_plot(images, **kw)),
                     _axes_of(lambda: janalysis.take_plot(images, **kw)))
    taxes = _axes_of(lambda: tanalysis.take(images[0], [[3], [4]], 3, plot=True))
    jaxes = _axes_of(lambda: janalysis.take(images[0], [[3], [4]], 3, plot=True))
    _assert_axes(taxes, jaxes)
    grid = tuple(np.meshgrid(np.linspace(-1, 1, 24), np.linspace(-1, 1, 24)))
    _assert_axes(_axes_of(lambda: tphase.zernike_pyramid_plot(grid, 2)),
                 _axes_of(lambda: jphase.zernike_pyramid_plot(grid, 2)))


def _slms():
    out = []
    for cls in (TSLM, JSLM):
        slm = cls((64, 48), pitch_um=(8, 8), wav_um=0.78)
        slm.set_source_analytic("gaussian2d", sim=True, x0=0, y0=0, a=1, c=0,
                                wx=120.0, wy=90.0)
        slm.source["amplitude"] = np.array(slm.source["amplitude_sim"])
        slm.source["phase"] = np.linspace(0, 3, slm.shape[0] * slm.shape[1]).reshape(slm.shape)
        slm.fit_source_amplitude()
        slm.set_phase(np.random.default_rng(1).uniform(0, 6, slm.shape), settle=False)
        out.append(slm)
    return out


def test_slm_plots_and_helpers_match_jax(tmp_path):
    tslm, jslm = _slms()
    for kw in (dict(), dict(limits=0.5, title="phase"), dict(limits=((5, 40), (3, 30)))):
        _assert_axes(_axes_of(lambda: tslm.plot(**kw)), _axes_of(lambda: jslm.plot(**kw)))
    for kw in (dict(), dict(sim=True), dict(sim=True, power=True)):
        _assert_axes(_axes_of(lambda: tslm.plot_source(**kw)),
                     _axes_of(lambda: jslm.plot_source(**kw)))
    for slm in (tslm, jslm):
        slm.source["r2"] = np.linspace(0, 1, slm.shape[0] * slm.shape[1]).reshape(slm.shape)
        slm.source["r2_threshold"] = 0.5
    _assert_axes(_axes_of(lambda: tslm.plot_source()), _axes_of(lambda: jslm.plot_source()))
    assert tslm.get_source_radius() == jslm.get_source_radius()
    np.testing.assert_array_equal(tslm.get_source_center(), jslm.get_source_center())
    for slm in (tslm, jslm):
        slm.set_source_aperture(amplitude_center_pix=(30, 20), amplitude_radius=0.5,
                                amplitude_extent=(2, 3), amplitude_extent_radius=0.7)
    np.testing.assert_array_equal(tslm.grid[0], jslm.grid[0])
    np.testing.assert_array_equal(tslm.grid[1], jslm.grid[1])
    psf = tslm.get_point_spread_function_knm((96, 128), device="cpu")
    assert torch.is_tensor(psf) and psf.device == torch.device("cpu")
    np.testing.assert_allclose(psf.numpy(), jslm.get_point_spread_function_knm((96, 128)),
                               rtol=0, atol=1e-6 * float(psf.max()))
    path = tslm.save_phase(str(tmp_path))
    np.testing.assert_array_equal(tslm.load_phase(path, set_phase=False), tslm.phase)
    for setter in (tslm.set_input_trigger, tslm.set_output_trigger):
        with pytest.raises(NotImplementedError):
            setter(True)
    assert tslm.info(verbose=False) == jslm.info(verbose=False) == []
    assert tslm.test() is True


def test_camera_plot_and_test_match_jax():
    tslm, jslm = _slms()
    tcam = TCamera(tslm, (48, 40), device="cpu")
    jcam = JCamera(jslm, (48, 40))
    image = np.random.default_rng(9).integers(0, 255, (40, 48))
    for kw in (dict(), dict(limits=0.5, cbar=False), dict(limits=((5, 30), (4, 20)))):
        _assert_axes(_axes_of(lambda: tcam.plot(image, **kw)),
                     _axes_of(lambda: jcam.plot(image, **kw)))
    _axes_of(lambda: tcam.plot())
    assert tcam.test() is True
    with pytest.raises(NotImplementedError, match="item 12, part two"):
        tcam.live()


# ----------------------------------------------------------------------
# The memory helpers.
# ----------------------------------------------------------------------


@pytest.mark.parametrize("budget", [16e9, 80e9, 1e6])
@pytest.mark.parametrize("shape", [(2048, 2048), (8192, 8192), 65536, (100, 128)])
def test_memory_strategy_matches_jax(budget, shape):
    for spots in (False, True):
        assert T.Hologram.suggest_memory_strategy(shape, budget=budget, spots=spots) == \
            J.Hologram.suggest_memory_strategy(shape, budget=budget, spots=spots)
    tholo, jholo = T.Hologram(np.ones((64, 64)), device="cpu"), J.Hologram(np.ones((64, 64)))
    for path in ("fused", "natural"):
        assert tholo._calculate_memory_constrained_shape(budget=budget, path=path) == \
            jholo._calculate_memory_constrained_shape(budget=budget, path=path)


def test_mempool_limit_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert T.Hologram.get_mempool_limit() == -1
    with pytest.warns(UserWarning, match="no CUDA device"):
        T.Hologram.set_mempool_limit(fraction=0.5)
    with pytest.raises(RuntimeError, match="budget="):
        T.Hologram.suggest_memory_strategy((1024, 1024))
