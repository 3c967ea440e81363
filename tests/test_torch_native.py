"""
The port's native host helpers (``slmsuite_torch/native``) on the CPU:
``phase2gray`` (float64 phase to uint8 and uint16, float32 phase to
uint8), ``plm_electrode_map`` and ``plm_bitpack8`` bit for bit against
the numpy passes that run where no compiler is found and against the JAX
package's native functions, on the same seeded inputs; the SLM write path
takes the native route and leaves ``phase`` untouched; :data:`ROUTES`
counts the route; without a compiler the helpers warn and the numpy
passes give the same display; two processes that build the library at
once both load it.

The float32 kernel forms ``phase * factor`` in float32 (its factor
``-bitresolution / 2pi`` rounded to float32), so its numpy path is that
product, rounded; the SLM's numpy passes are float64, as its phase is.
"""

import json
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest

import slmsuite_torch
import slmsuite_tpu.native as JN
from slmsuite_torch import native as TN
from slmsuite_torch.hardware.slms import slm as TS
from slmsuite_torch.hardware.slms.simulated import SimulatedSLM as TSLM
from slmsuite_torch.hardware.slms.texasinstruments import PLM_MODELS
from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM as JSLM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


@pytest.fixture(autouse=True)
def _cpu():
    previous = slmsuite_torch.resolve_device(None)
    slmsuite_torch.set_default_device("cpu")
    yield
    slmsuite_torch.set_default_device(previous)


def _phase(shape, dtype=np.float64, seed=0, span=4 * np.pi):
    return np.random.default_rng(seed).uniform(-span, span, shape).astype(dtype)


def _numpy_f32(phase, bitresolution):
    """The float32 kernel's arithmetic in numpy: the product in float32,
    rounded half to even, less one, wrapped."""
    factor = np.float32(-np.float32(bitresolution) / np.float32(2 * np.pi))
    codes = np.rint(phase * factor).astype(np.int64) - 1
    return (codes & (bitresolution - 1)).astype(np.uint8)


@pytest.mark.parametrize("dtype, out_dtype, bitdepth", [
    (np.float64, np.uint8, 8), (np.float64, np.uint16, 10), (np.float64, np.uint16, 12),
    (np.float64, np.uint16, 16), (np.float32, np.uint8, 8), (np.float32, np.uint8, 6),
], ids=["f64_u8", "f64_u16_10bit", "f64_u16_12bit", "f64_u16_16bit", "f32_u8", "f32_u8_6bit"])
def test_phase2gray_matches_numpy_and_jax(dtype, out_dtype, bitdepth):
    phase = _phase((96, 160), dtype)
    keep = phase.copy()
    bitres = 2**bitdepth
    out, jout = np.zeros(phase.shape, out_dtype), np.zeros(phase.shape, out_dtype)
    TN.reset_routes()
    assert TN.phase2gray_native(phase, out, bitres)
    assert TN.ROUTES["phase2gray"] == {"native": 1, "numpy": 0}
    assert JN.phase2gray_native(phase, jout, bitres)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(phase, keep)
    if dtype == np.float32:
        np.testing.assert_array_equal(out, _numpy_f32(phase, bitres))


def _slm_numpy_route(slm_cls, phase, bitdepth, monkeypatch, module):
    """The display of an SLM's numpy passes (its native helper refused)."""
    monkeypatch.setattr(module, "phase2gray_native", lambda *args: False)
    slm = slm_cls(phase.shape[::-1], bitdepth=bitdepth)
    slm.set_phase(phase, settle=False)
    monkeypatch.undo()
    return slm.display.copy()


@pytest.mark.parametrize("bitdepth", [8, 12])
def test_slm_write_takes_the_native_route(bitdepth, monkeypatch):
    """``SLM.set_phase`` converts natively, counted in :data:`ROUTES`, with
    the display of the numpy passes (the port's and the JAX package's) and
    of the JAX package's native route, and leaves ``phase`` untouched."""
    phase = _phase((64, 96), seed=bitdepth)
    TN.reset_routes()
    slm = TSLM(phase.shape[::-1], bitdepth=bitdepth)
    slm.set_phase(phase, settle=False)
    assert TN.ROUTES["phase2gray"]["native"] >= 1 and TN.ROUTES["phase2gray"]["numpy"] == 0
    np.testing.assert_array_equal(slm.phase, phase)
    before = slm.phase.copy()
    display = slm._phase2gray(slm.phase)
    np.testing.assert_array_equal(slm.phase, before)
    np.testing.assert_array_equal(display, slm.display)

    jslm = JSLM(phase.shape[::-1], bitdepth=bitdepth)
    jslm.set_phase(phase, settle=False)
    np.testing.assert_array_equal(slm.display, jslm.display)
    np.testing.assert_array_equal(slm.display, _slm_numpy_route(TSLM, phase, bitdepth,
                                                                monkeypatch, TS))
    np.testing.assert_array_equal(slm.display, _slm_numpy_route(JSLM, phase, bitdepth,
                                                                monkeypatch, JN))


def test_unsupported_inputs_leave_the_work_to_numpy():
    """A bitresolution that is not a power of two, other dtypes or a
    strided array: False (the caller's numpy route), counted as numpy."""
    TN.reset_routes()
    phase = _phase((8, 8))
    assert not TN.phase2gray_native(phase, np.zeros((8, 8), np.uint8), 200)
    assert not TN.phase2gray_native(phase.astype(np.float32), np.zeros((8, 8), np.uint16), 256)
    assert not TN.phase2gray_native(phase[:, ::2], np.zeros((8, 4), np.uint8), 256)
    assert not TN.plm_bitpack8_native(np.zeros((7, 4, 4), np.uint8), np.zeros((4, 4), np.uint8))
    assert not TN.plm_electrode_map_native(np.zeros((4, 4), np.uint8),
                                           np.zeros((8, 7), np.uint8), np.zeros(256),
                                           [0, 1, 2, 3], False, False)
    assert TN.ROUTES == {"phase2gray": {"native": 0, "numpy": 3},
                         "plm_electrode_map": {"native": 0, "numpy": 1},
                         "plm_bitpack8": {"native": 0, "numpy": 1}}


def _numpy_electrode_map(display, lut, layout, flip_y, flip_x):
    """The driver's numpy passes (``PLM._electrode_map`` of the LUT)."""
    codes = lut[display]
    out = np.zeros((2 * display.shape[0], 2 * display.shape[1]), np.uint8)
    for dy in range(2):
        for dx in range(2):
            out[dy::2, dx::2] = ((codes >> layout[dy][dx]) & 1) * 255
    if flip_y:
        out = out[::-1, :]
    if flip_x:
        out = out[:, ::-1]
    return np.ascontiguousarray(out)


@pytest.mark.parametrize("model", sorted(PLM_MODELS))
def test_plm_electrode_map_matches_numpy_and_jax(model):
    """At each PLM model's own mirror count (``texas_instruments.yaml``)."""
    spec = PLM_MODELS[model]
    layout = spec["electrode_layout"]
    flip_y, flip_x = spec["data_flip"]
    rng = np.random.default_rng(len(model))
    lut = rng.integers(0, 16, 256).astype(np.uint8)
    display = rng.integers(0, 256, spec["shape"]).astype(np.uint8)
    flat = [layout[dy][dx] for dy in range(2) for dx in range(2)]
    out = np.empty((2 * display.shape[0], 2 * display.shape[1]), np.uint8)
    jout = np.empty_like(out)
    TN.reset_routes()
    assert TN.plm_electrode_map_native(display, out, lut, flat, flip_y, flip_x)
    assert TN.ROUTES["plm_electrode_map"] == {"native": 1, "numpy": 0}
    assert JN.plm_electrode_map_native(display, jout, lut, flat, flip_y, flip_x)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out, _numpy_electrode_map(display, lut, layout, flip_y, flip_x))


def test_plm_bitpack8_matches_numpy_and_jax():
    maps = np.random.default_rng(7).integers(0, 4, (8, 40, 56)).astype(np.uint8)
    out, jout = np.empty((40, 56), np.uint8), np.empty((40, 56), np.uint8)
    TN.reset_routes()
    assert TN.plm_bitpack8_native(maps, out)
    assert TN.ROUTES["plm_bitpack8"] == {"native": 1, "numpy": 0}
    assert JN.plm_bitpack8_native(maps, jout)
    np.testing.assert_array_equal(out, jout)
    shifts = np.arange(8, dtype=np.uint8)[:, None, None]
    np.testing.assert_array_equal(
        out, np.bitwise_or.reduce(np.left_shift(maps & 1, shifts), axis=0))


def test_library_is_built_under_build_keyed_on_the_source():
    path = TN.build("phase2gray")
    assert path.parent.parent == TN._BUILD_ROOT and path.parent.name.startswith("native-")
    assert path.name == "libphase2gray.so" and path.exists()
    other = TN.build("plm_pack")
    assert other.name == "libplm_pack.so" and other.parent != path.parent
    assert not any(p.suffix == ".so" for p in TN._HERE.iterdir())


_BUILD_SCRIPT = textwrap.dedent("""
    import json, os, sys, time, warnings
    from pathlib import Path
    import numpy as np
    from slmsuite_torch import native
    native._BUILD_ROOT = Path(sys.argv[1])
    go = Path(sys.argv[2])
    while not go.exists():
        time.sleep(0.005)
    phase = np.random.default_rng(3).uniform(-7, 7, (48, 64))
    out = np.zeros(phase.shape, np.uint8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        native.phase2gray_native(phase, out, 256)
    print(json.dumps({"routes": native.ROUTES["phase2gray"], "sum": int(out.sum()),
                      "warned": [str(w.message) for w in caught]}))
""")


def _run_building_processes(tmp_path, count, env=None):
    go = tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_SCRIPT, str(tmp_path / "build"),
                               str(go)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=dict(os.environ, PYTHONPATH=ROOT, **(env or {})))
             for _ in range(count)]
    go.touch()
    results = []
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


def test_two_processes_building_at_once_both_load(tmp_path):
    """Two processes build the library into the same fresh directory at
    the same moment: each writes its own temporary file and moves it into
    place, and both load a whole library and convert natively."""
    results = _run_building_processes(tmp_path, 2)
    expected = np.zeros((48, 64), np.uint8)
    assert JN.phase2gray_native(np.random.default_rng(3).uniform(-7, 7, (48, 64)), expected, 256)
    for result in results:
        assert result["routes"] == {"native": 1, "numpy": 0} and not result["warned"]
        assert result["sum"] == int(expected.sum())
    built = list((tmp_path / "build").glob("native-*/*"))
    assert [p.name for p in built] == ["libphase2gray.so"]


def test_without_a_compiler_the_numpy_route_is_taken_and_counted(tmp_path, monkeypatch):
    """No compiler: the helper warns once, returns False (counted as the
    numpy route), and the SLM's numpy passes give the native display."""
    (result,) = _run_building_processes(tmp_path, 1, env={"CC": str(tmp_path / "no-such-cc")})
    assert result["routes"] == {"native": 0, "numpy": 1}
    assert any("Native phase2gray unavailable" in w for w in result["warned"])
    phase = _phase((48, 64), seed=3, span=7)
    native_slm = TSLM((64, 48))
    native_slm.set_phase(phase, settle=False)
    monkeypatch.setattr(TN, "_LIBS", {})
    monkeypatch.setattr(TN, "_BUILD_ROOT", tmp_path / "other")
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    TN.reset_routes()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        slm = TSLM((64, 48))
        slm.set_phase(phase, settle=False)
    assert any("using numpy" in str(w.message) for w in caught)
    assert TN.ROUTES["phase2gray"]["native"] == 0 and TN.ROUTES["phase2gray"]["numpy"] >= 1
    np.testing.assert_array_equal(slm.display, native_slm.display)
