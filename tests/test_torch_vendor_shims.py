"""
The port's vendor drivers and screen-mirrored window against the JAX
package's on the CPU, on the cases of ``tests/hardware/test_vendor_shims.py``:
each case runs on both packages' functions with the same inputs and
asserts the same outputs (the PLM phase LUT, electrode map, bitpack and
model database; Meadowlark's DLL search, header detection, write arity,
telemetry gating and LUT locator; Hamamatsu's modes on a fake DLL;
Santec's status parse; the headless GL window on a fake pyglet). Every
port module imports without its SDK, which it imports only when hardware
is built, and every constructor raises as the JAX package's does.
"""

import importlib
import json
import os
import subprocess
import sys
import textwrap
import time
import warnings

import numpy as np
import pytest

from hardware.test_vendor_shims import _fake_gl_stack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("slmsuite_torch", "slmsuite_tpu")


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _both(rel):
    """The port's module ``slmsuite_torch.<rel>`` and the JAX package's."""
    return [importlib.import_module(f"{pkg}.{rel}") for pkg in PACKAGES]


DRIVERS = [
    "hardware._pyglet", "hardware.slms.template", "hardware.slms.screenmirrored",
    "hardware.slms.meadowlark", "hardware.slms.santec", "hardware.slms.hamamatsu",
    "hardware.slms.holoeye", "hardware.slms.texasinstruments", "hardware.slms.thorlabs",
    "hardware.cameras.template", "hardware.cameras.webcam", "hardware.cameras.flir",
    "hardware.cameras.basler", "hardware.cameras.alliedvision", "hardware.cameras.thorlabs",
    "hardware.cameras.xenics", "hardware.cameras.imagingsource", "hardware.cameras.mindvision",
    "hardware.cameras.pylablib", "hardware.cameras.instrumental", "hardware.cameras.mmcore",
    "hardware.cameras._viewer", "native",
]

SDK_MODULES = ["pyglet", "cv2", "hid", "vmbpy", "pypylon", "PySpin", "imagingcontrol4",
               "instrumental", "mvsdk", "pymmcore", "pylablib", "thorlabs_tsi_sdk", "holoeye",
               "ipywidgets", "IPython", "matplotlib"]


@pytest.mark.parametrize("rel", DRIVERS)
def test_port_module_imports(rel):
    port, _ = _both(rel)
    assert port.__name__ == f"slmsuite_torch.{rel}"


def test_port_modules_import_no_sdk():
    """Importing every driver of the port, in a fresh process, imports no
    SDK, no window toolkit and no OpenCV (installed here or not)."""
    script = textwrap.dedent(f"""
        import importlib, json, sys
        before = set(sys.modules)
        for rel in {DRIVERS!r}:
            importlib.import_module("slmsuite_torch." + rel)
        added = {{m.split(".")[0] for m in set(sys.modules) - before}}
        print(json.dumps(sorted(added & set({SDK_MODULES!r}))))
    """)
    done = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert done.returncode == 0, done.stderr
    assert json.loads(done.stdout.strip().splitlines()[-1]) == []


CONSTRUCTORS = {
    "AlliedVision": ("hardware.cameras.alliedvision", "AlliedVision", ()),
    "Basler": ("hardware.cameras.basler", "Basler", ()),
    "FLIR": ("hardware.cameras.flir", "FLIR", ()),
    "ImagingSource": ("hardware.cameras.imagingsource", "ImagingSource", ()),
    "Instrumental": ("hardware.cameras.instrumental", "Instrumental", ()),
    "MindVision": ("hardware.cameras.mindvision", "MindVision", ()),
    "MMCore": ("hardware.cameras.mmcore", "MMCore", ()),
    "PyLabLib": ("hardware.cameras.pylablib", "PyLabLib", (None,)),
    "ThorCam": ("hardware.cameras.thorlabs", "ThorCam", ()),
    "Cheetah640": ("hardware.cameras.xenics", "Cheetah640", ()),
    "Webcam_missing_file": ("hardware.cameras.webcam", "Webcam", ("/nonexistent/video.avi",)),
    "Hamamatsu": ("hardware.slms.hamamatsu", "Hamamatsu", ()),
    "Holoeye": ("hardware.slms.holoeye", "Holoeye", ()),
    "Meadowlark": ("hardware.slms.meadowlark", "Meadowlark", ()),
    "Santec": ("hardware.slms.santec", "Santec", ()),
    "ScreenMirrored": ("hardware.slms.screenmirrored", "ScreenMirrored", (0,)),
    "PLM": ("hardware.slms.texasinstruments", "PLM", (0,)),
    "DLPC900": ("hardware.slms.texasinstruments", "DLPC900", ()),
    "Thorlabs_SLM": ("hardware.slms.thorlabs", "Thorlabs", (0,)),
}


def _error_of(fn):
    try:
        fn()
    except (ImportError, OSError, RuntimeError) as err:
        return type(err), str(err)
    return None


@pytest.mark.parametrize("case", sorted(CONSTRUCTORS))
def test_constructor_raises_as_jax_without_its_sdk(case, capsys):
    """No SDK, DLL or window toolkit here: each constructor raises the
    JAX package's exception with its message (an ``ImportError`` where
    a Python SDK is missing)."""
    rel, name, args = CONSTRUCTORS[case]
    errors = [_error_of(lambda m=m: getattr(m, name)(*args, verbose=False)
                        if name not in ("DLPC900", "PyLabLib", "Webcam") else
                        getattr(m, name)(*args))
              for m in _both(rel)]
    assert errors[0] is not None and errors[0] == errors[1], errors


def test_webcam_without_opencv_raises_import_error(monkeypatch):
    from slmsuite_torch.hardware.cameras import webcam

    monkeypatch.setattr(webcam, "cv2", None)
    monkeypatch.setattr(webcam, "_optional_import", lambda name: None)
    with pytest.raises(ImportError, match="OpenCV"):
        webcam.Webcam(0, verbose=False)
    with pytest.raises(ImportError, match="OpenCV"):
        webcam.Webcam.info(verbose=False)


def test_templates_build_as_in_jax(capsys):
    """The two templates construct in both packages, to the same state."""
    for rel in ("hardware.cameras.template", "hardware.slms.template"):
        objs = [m.Template() for m in _both(rel)]
        assert objs[0].shape == objs[1].shape and objs[0].name == objs[1].name


def test_thorlabs_slm_is_screenmirrored():
    from slmsuite_torch.hardware.slms.screenmirrored import ScreenMirrored
    from slmsuite_torch.hardware.slms.thorlabs import Thorlabs

    assert Thorlabs is ScreenMirrored


# ----------------------------------------------------------------------
# Texas Instruments PLM.
# ----------------------------------------------------------------------


def _plms(model="p67", wav_um=0.633, wav_design_um=None):
    """A PLM shell in each package, without hardware or video."""
    plms = []
    for ti in _both("hardware.slms.texasinstruments"):
        plm = object.__new__(ti.PLM)
        plm.model = ti.PLM_MODELS[model]
        plm.plm_shape = tuple(plm.model["shape"])
        plm._init_quantize_lut(wav_um, wav_design_um or wav_um)
        plms.append(plm)
    return plms


def test_plm_model_db_matches_jax():
    t, j = _both("hardware.slms.texasinstruments")
    assert t.PLM_MODELS == j.PLM_MODELS
    assert t.PLM.get_model_list() == j.PLM.get_model_list()
    for model in t.PLM.get_model_list():
        spec = t.PLM.load_model_config(model)
        assert spec == j.PLM.load_model_config(model)
        assert len(spec["displacement_ratios"]) == 16
        assert sorted(spec["memory_lut"]) == list(range(16))
    for m in (t, j):
        with pytest.raises(ValueError, match="not found"):
            m.PLM.load_model_config("not-a-model")


@pytest.mark.parametrize("model, wav_um, wav_design_um", [
    ("p67", 0.633, None), ("p47", 0.633, None), ("p67", 1.266, 0.633), ("p47", 0.532, 0.633),
])
def test_plm_quantize_lut_matches_jax(model, wav_um, wav_design_um):
    t, j = _plms(model, wav_um, wav_design_um)
    np.testing.assert_array_equal(t._gray_to_code, j._gray_to_code)
    memory_lut = list(t.model["memory_lut"])
    assert t._gray_to_code.shape == (256,) and t._gray_to_code.max() <= 15
    assert t._gray_to_code[0] == memory_lut[0]
    states = [memory_lut.index(code) for code in t._gray_to_code]
    if wav_design_um is None:
        assert np.sum(np.diff(states) < 0) <= 1
    elif wav_um == 2 * wav_design_um:
        assert states[128] == 15


@pytest.mark.parametrize("model", ["p47", "p67"])
def test_plm_electrode_map_matches_jax(model):
    t, j = _plms(model)
    codes = np.random.default_rng(0).integers(0, 16, size=(8, 12)).astype(np.uint8)
    codes[0, 0] = 0b1010
    bitmap = t._electrode_map(codes)
    np.testing.assert_array_equal(bitmap, j._electrode_map(codes))
    popcount = np.array([bin(c).count("1") for c in codes.ravel()])
    assert bitmap.shape == (16, 24) and bitmap.sum() // 255 == popcount.sum()
    flip_y, flip_x = t.model["data_flip"]
    raw = bitmap[::-1] if flip_y else bitmap
    raw = raw[:, ::-1] if flip_x else raw
    layout = t.model["electrode_layout"]
    for dy in range(2):
        for dx in range(2):
            assert raw[dy, dx] == 255 * ((0b1010 >> layout[dy][dx]) & 1)


@pytest.mark.parametrize("model", ["p47", "p67"])
def test_plm_pack_frame_matches_jax(model):
    """``_pack_frame`` (the native one-pass packing) against the JAX
    package's and against the numpy passes of ``_electrode_map``."""
    t, j = _plms(model)
    display = np.random.default_rng(2).integers(0, 256, (32, 56)).astype(np.uint8)
    fused = t._pack_frame(display)
    np.testing.assert_array_equal(fused, j._pack_frame(display))
    np.testing.assert_array_equal(fused, t._electrode_map(t._gray_to_code[display]))


@pytest.mark.parametrize("count", [8, 24])
def test_plm_bitpack_matches_jax(count):
    t, j = _both("hardware.slms.texasinstruments")
    rng = np.random.default_rng(count)
    maps = [rng.integers(0, 2, (16, 12), dtype=np.uint8) for _ in range(count)]
    packed = t.PLM.bitpack(maps)
    np.testing.assert_array_equal(packed, j.PLM.bitpack(maps))
    assert packed.shape == (count // 8, 16, 12) and packed.dtype == np.uint8
    for k, bm in enumerate(maps):
        np.testing.assert_array_equal((packed[k // 8] >> (k % 8)) & 1, bm)
    for m in (t, j):
        with pytest.raises(ValueError, match="8 or 24"):
            m.PLM.bitpack(maps[:7])


# ----------------------------------------------------------------------
# Meadowlark.
# ----------------------------------------------------------------------


def test_meadowlark_find_dll_matches_jax(tmp_path):
    t, j = _both("hardware.slms.meadowlark")
    for m in (t, j):
        with pytest.raises(FileNotFoundError):
            m._find_dll(str(tmp_path))
    nested = tmp_path / "SDK" / "sub"
    nested.mkdir(parents=True)
    (nested / "Blink_C_wrapper.dll").write_bytes(b"")
    kit = tmp_path / "Cal Kit"
    kit.mkdir()
    (kit / "Blink_C_wrapper.dll").write_bytes(b"")
    assert t._find_dll(str(tmp_path)) == j._find_dll(str(tmp_path)) == str(
        nested / "Blink_C_wrapper.dll")


@pytest.mark.parametrize("create_sig, write_sig, expect", [
    ("void Create_SDK()", "void Write_image(unsigned char* data, unsigned int is8)", "hdmi"),
    ("void Create_SDK(unsigned int python)",
     "void Write_image(unsigned char* d, unsigned int is8)", "hdmi"),
    ("void Create_SDK(unsigned int* n, int* ok)",
     "int Write_image(int board, unsigned char* d, unsigned int timeout)", "pcie_modern_3"),
    ("void Create_SDK(unsigned int* n, int* ok)",
     "int Write_image(int b, unsigned char* d, bool wt, bool fi, bool op, unsigned int t)",
     "pcie_modern_6"),
    ("void Create_SDK(unsigned int* n, int* ok)",
     "int Write_image(int b, unsigned char* d, unsigned int sz, bool wt, bool fi, bool op, "
     "bool orf, unsigned int t)", "pcie_modern_8"),
    ("void Create_SDK(unsigned int bd, unsigned int* n, bool* ok, bool nem, bool ram, bool gpu, "
     "unsigned int mt, int lut)",
     "int Write_image(int b, unsigned char* d, unsigned int sz, bool wt, bool fi, bool op, "
     "bool orf, unsigned int t)", "pcie_legacy"),
], ids=["hdmi", "hdmi_python", "modern_3", "modern_6", "modern_8", "legacy"])
def test_meadowlark_header_detection_matches_jax(tmp_path, create_sig, write_sig, expect):
    dll = tmp_path / "Blink_C_wrapper.dll"
    dll.write_bytes(b"")
    (tmp_path / "Blink_C_wrapper.h").write_text(create_sig + ";\n" + write_sig + ";\n")
    t, j = _both("hardware.slms.meadowlark")
    assert t._parse_sdk_header(str(dll)) == j._parse_sdk_header(str(dll)) is not None
    assert t._detect_variant(str(dll), lib=object()) == j._detect_variant(
        str(dll), lib=object()) == expect


def test_meadowlark_absent_header_falls_back_by_symbols(tmp_path):
    dll = tmp_path / "Blink_C_wrapper.dll"
    dll.write_bytes(b"")

    class HdmiLib:
        Get_Width = staticmethod(lambda: 1920)

    class ModernLib:
        Get_image_width = staticmethod(lambda b: 1920)
        Get_last_error_message = staticmethod(lambda: b"")

    got = []
    for m in _both("hardware.slms.meadowlark"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            got.append((m._detect_variant(str(dll), HdmiLib()),
                        m._detect_variant(str(dll), ModernLib())))
    assert got[0] == got[1] == ("hdmi", "pcie_modern_6")


def _bare_meadowlark(m, variant, lib):
    slm = m.Meadowlark.__new__(m.Meadowlark)
    slm.sdk_variant = variant
    slm.sdk_interface = "hdmi" if variant == "hdmi" else "pcie"
    slm.slm_number = 1
    slm.slm_lib = lib
    slm.bitdepth = 8
    return slm


@pytest.mark.parametrize("variant, n_args", [
    ("pcie_modern_3", 3), ("pcie_modern_6", 6), ("pcie_modern_8", 8), ("pcie_legacy", 8),
    ("hdmi", 2), ("hdmi_three_argument", 3),
])
def test_meadowlark_write_arity_matches_jax(variant, n_args):
    """``_set_phase_hw`` calls ``Write_image`` with the arity of the
    detected SDK generation (the (0, 3) HDMI header trace: the board-first
    3-argument revision), and the same arguments in both packages."""
    calls = []
    for m in _both("hardware.slms.meadowlark"):
        record = {}

        class FakeLib:
            def Write_image(self, *args):
                record["write"] = [a.value if hasattr(a, "value") else
                                   np.ctypeslib.as_array(a, (16,)).tolist()
                                   if hasattr(a, "contents") else a for a in args]
                return 1

            def ImageWriteComplete(self, *args):
                record["complete"] = len(args)
                return 1

        hdmi3 = variant == "hdmi_three_argument"
        slm = _bare_meadowlark(m, "hdmi" if hdmi3 else variant, FakeLib())
        prior = dict(m.Meadowlark._trace)
        if hdmi3:
            m.Meadowlark._trace["hdmi"] = (0, 3)
        try:
            m.Meadowlark._set_phase_hw(slm, np.arange(16, dtype=np.uint8).reshape(4, 4))
        finally:
            m.Meadowlark._trace = prior
        assert len(record["write"]) == n_args
        if not variant.startswith("hdmi"):
            assert record["complete"] == 2
        calls.append(record)
    assert calls[0] == calls[1]


def test_meadowlark_close_refcounts_shared_sdk():
    """Two boards share one SDK handle; ``Delete_SDK`` runs when the last
    board closes, once, in both packages."""
    for m in _both("hardware.slms.meadowlark"):
        M = m.Meadowlark
        calls = []

        class FakeLib:
            def Delete_SDK(self):
                calls.append("delete")

        lib, variant = FakeLib(), "pcie_modern_6"
        prior = (dict(M._lib_cache), dict(M._refcount), dict(M._board_count))
        M._lib_cache[variant] = lib
        M._refcount[variant] = 2
        try:
            boards = [_bare_meadowlark(m, variant, lib) for _ in range(2)]
            boards[0].close()
            assert calls == [] and M._refcount[variant] == 1
            boards[1].close()
            boards[1].close()
            assert calls == ["delete"] and variant not in M._lib_cache
        finally:
            M._lib_cache, M._refcount, M._board_count = prior


def test_meadowlark_tables_match_jax():
    t, j = _both("hardware.slms.meadowlark")
    assert t.SDK_VARIANTS == j.SDK_VARIANTS
    assert t.sdk_feature_table() == j.sdk_feature_table()
    table = t.sdk_feature_table()
    assert table["get_temperature"] == {"hdmi": True, "pcie": True, "legacy_pcie": False}
    assert table["blink_version"]["legacy_pcie"] == "<=1.1.4.867"


def test_meadowlark_telemetry_and_trigger_gating_match_jax():
    """The legacy SDK has no telemetry (``NotImplementedError``); modern
    PCIe reads the coverglass by ``Get_cover_voltage``; ``on_refresh``
    is honoured only by the 8-argument SDK (the legacy one warns)."""
    import ctypes

    for m in _both("hardware.slms.meadowlark"):
        legacy = _bare_meadowlark(m, "pcie_legacy", object())
        with pytest.raises(NotImplementedError):
            legacy.get_temperature()
        with pytest.raises(NotImplementedError):
            legacy.get_coverglass_voltage()
        calls = []

        def fn(board):
            calls.append(int(board.value))
            return 3.5

        fn.restype = None
        lib = type("L", (), {"Get_cover_voltage": staticmethod(fn)})
        assert _bare_meadowlark(m, "pcie_modern_3", lib).get_coverglass_voltage() == 3.5
        assert calls == [1] and fn.restype is ctypes.c_double
        slm8 = _bare_meadowlark(m, "pcie_modern_8", object())
        slm8._output_pulse_refresh = False
        slm8.set_output_trigger(on=True, on_refresh=True)
        assert slm8._output_pulse_refresh is True
        legacy._output_pulse_refresh = False
        with pytest.warns(UserWarning, match="on_refresh"):
            legacy.set_output_trigger(on=True, on_refresh=True)
        assert legacy._output_pulse_refresh is False


@pytest.mark.parametrize("case", ["single", "dimensions", "most_recent", "recursive", "empty"])
def test_meadowlark_lut_locator_matches_jax(tmp_path, case):
    kwargs = {}
    if case == "single":
        (tmp_path / "a.lut").write_text("x")
    elif case == "dimensions":
        (tmp_path / "slm1234_at532_1920x1152.lut").write_text("x")
        (tmp_path / "slm5678_at532_1024x1024.lut").write_text("x")
        kwargs = {"slm_shape": (1152, 1920)}
    elif case == "most_recent":
        (tmp_path / "old.lut").write_text("x")
        os.utime(tmp_path / "old.lut", (time.time() - 10, time.time() - 10))
        (tmp_path / "new.lut").write_text("x")
    elif case == "recursive":
        (tmp_path / "LUT").mkdir()
        (tmp_path / "LUT" / "slm9_at780.lut").write_text("x")
    chosen = []
    for m in _both("hardware.slms.meadowlark"):
        if case == "empty":
            with pytest.raises(FileNotFoundError):
                m.Meadowlark._locate_lut_file(tmp_path)
            continue
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            chosen.append(m.Meadowlark._locate_lut_file(tmp_path, **kwargs))
        assert any("most recent" in str(w.message) for w in caught) == (case == "most_recent")
    if case != "empty":
        assert chosen[0] == chosen[1]
        assert chosen[0].endswith({"single": "a.lut", "dimensions": "1920x1152.lut",
                                   "most_recent": "new.lut",
                                   "recursive": "slm9_at780.lut"}[case])


# ----------------------------------------------------------------------
# Hamamatsu, on a fake DLL.
# ----------------------------------------------------------------------


class _FakeHamamatsuLib:
    def __init__(self, start_mode=1):
        self.mode = start_mode
        self.calls = []
        self.frames = {}
        self.displayed = None

    def Open_Dev(self, ids_ref, size):
        ids_ref._obj[0] = 7
        return 1

    def Close_Dev(self, ids_ref, size):
        self.calls.append("close")
        return 1

    def Check_HeadSerial(self, bid, serial_ref, size):
        serial_ref._obj.value = 12345
        return 1

    def Mode_Check(self, bid, mode_ref):
        mode_ref._obj.value = self.mode
        return 1

    def Mode_Select(self, bid, mode):
        self.mode = mode.value
        self.calls.append(("mode", mode.value))
        return 1

    def Reboot(self, bid):
        self.calls.append("reboot")
        return 1

    def Write_FMemArray(self, bid, ptr, size, w, h, slot):
        self.frames[slot.value] = (w.value, h.value, size.value)
        return 1

    def Change_DispSlot(self, bid, slot):
        self.displayed = slot.value
        return 1


@pytest.mark.parametrize("start_mode", [1, 0], ids=["usb", "dvi"])
def test_hamamatsu_modes_match_jax(monkeypatch, start_mode):
    """Built on a fake DLL: USB mode uploads the first frame to slot 0; DVI
    mode switches to USB and reboots; ``set_mode`` validates; a slot
    number selects the slot written and shown."""
    runs, slms = [], []  # Both SLMs kept open: a closed one calls Close_Dev.
    for m in _both("hardware.slms.hamamatsu"):
        lib = _FakeHamamatsuLib(start_mode)
        monkeypatch.setattr(m, "_load_dll", lambda dll_path=None, lib=lib: lib)
        slm = m.Hamamatsu(resolution=(64, 32), verbose=False)
        slms.append(slm)
        assert slm.serial == 12345 and slm.get_mode() == 1
        with pytest.raises(ValueError):
            slm.set_mode(3)
        slm._set_phase_hw(np.zeros((32, 64), np.uint8), slot_number=2)
        runs.append((lib.calls, lib.frames, lib.displayed))
    assert runs[0] == runs[1]
    calls, frames, displayed = runs[0]
    assert frames[0] == (64, 32, 64 * 32) and displayed == 2
    assert ("reboot" in calls) == (start_mode == 0)


# ----------------------------------------------------------------------
# Santec.
# ----------------------------------------------------------------------


def test_santec_status_parse_matches_jax():
    t, j = _both("hardware.slms.santec")
    assert t.SLM_STATUS_DICT == j.SLM_STATUS_DICT
    for code in t.SLM_STATUS_DICT:
        results = []
        for m in (t, j):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                results.append((m.Santec._parse_status(code, raise_error=False),
                                [str(w.message) for w in caught]))
            if code != 0:
                with pytest.raises(RuntimeError, match=m.SLM_STATUS_DICT[code][0]):
                    m.Santec._parse_status(code)
        assert results[0] == results[1]
    assert t.Santec._parse_status(0) == (0, "SLM_OK", "All good!")
    for m in (t, j):
        with pytest.raises(ValueError):
            m.Santec._parse_status(42424)


# ----------------------------------------------------------------------
# The screen-mirrored window, on a fake GL stack.
# ----------------------------------------------------------------------


def test_screenmirrored_requires_pyglet():
    """pyglet is not installed: the port's module imported it not, and
    the constructor raises the JAX package's ``ImportError``."""
    from slmsuite_torch.hardware import _pyglet as P
    from slmsuite_torch.hardware.slms.screenmirrored import ScreenMirrored

    if P._optional_import("pyglet") is None:
        with pytest.raises(ImportError, match="pyglet is required"):
            ScreenMirrored(0)
        with pytest.raises(ImportError, match="pyglet is required"):
            ScreenMirrored.info()


@pytest.mark.parametrize("gl_version, mode", [((4, 6), "modern"), ((2, 1), "legacy")])
def test_slm_window_headless_matches_jax(monkeypatch, gl_version, mode):
    """Both GL pipelines run end to end on a fake GL stack in both
    packages, with the same staging buffer, quad and GL call sequence."""
    runs = []
    for P in _both("hardware._pyglet"):
        fake_pyglet, fake_gl, screen, calls = _fake_gl_stack(gl_version)
        monkeypatch.setattr(P, "pyglet", fake_pyglet)
        monkeypatch.setattr(P, "gl", fake_gl)
        window = P.SLMWindow((32, 48), screen)
        assert window.gl_mode == mode
        display = (np.arange(32 * 48) % 256).astype(np.uint8).reshape(32, 48)
        window.render(display)
        np.testing.assert_array_equal(window.buffer[..., 0], display)
        np.testing.assert_array_equal(window.buffer[..., 3], 255)
        with pytest.raises(ValueError):
            window.render(np.zeros((8, 8), np.uint8))
        window.close()
        assert window.window.closed
        quad = None if mode == "modern" else np.array(window._quad, np.float32)
        runs.append((window.buffer.copy(), list(calls), quad))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]
    if mode == "legacy":
        np.testing.assert_array_equal(runs[0][2], runs[1][2])


def test_window_manager_multi_window(monkeypatch):
    """Two windows on their own render threads in the port; shutdown
    reaps both (each join bounded)."""
    from slmsuite_torch.hardware import _pyglet as P

    fake_pyglet, fake_gl, screen, _ = _fake_gl_stack((4, 6))
    monkeypatch.setattr(P, "pyglet", fake_pyglet)
    monkeypatch.setattr(P, "gl", fake_gl)
    manager = P.WindowManager()
    a = manager.create_window((16, 16), screen, caption="A")
    b = manager.create_window((16, 16), screen, caption="B")
    assert a is not b and a.window is not None and b.window is not None
    a.render(np.full((16, 16), 7, np.uint8))
    b.render(np.full((16, 16), 9, np.uint8))
    assert int(a.window.buffer[0, 0, 0]) == 7 and int(b.window.buffer[0, 0, 0]) == 9
    manager.shutdown()
    for _ in range(200):
        if not manager._threads and a.window.window.closed and b.window.window.closed:
            break
        time.sleep(0.01)
    assert not manager._threads and a.window.window.closed and b.window.window.closed
