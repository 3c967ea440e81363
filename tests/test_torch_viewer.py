"""
The port's live camera viewer (``slmsuite_torch/hardware/cameras/_viewer.py``)
against the JAX package's on the CPU, headless: ``parse_frame`` gives the
same RGB array and the same PNG bytes, byte for byte, for the same frame
and state, for every case of ``tests/hardware/test_viewer.py``'s
``TestParseFrame`` and their combinations, and for a torch-tensor frame;
the widget shell, built on stub widgets that record what they are given,
holds the same state and renders the same bytes as the JAX package's; and
``Camera.live`` drives the port's ``SimulatedCamera``. No test starts an
asyncio loop or shows a widget.
"""

import sys
import types

import numpy as np
import pytest
import torch

import slmsuite_torch
from slmsuite_torch.hardware.cameras import _viewer as TV
from slmsuite_torch.hardware.cameras.simulated import SimulatedCamera
from slmsuite_torch.hardware.slms.simulated import SimulatedSLM
from slmsuite_tpu.hardware.cameras import _viewer as JV

PNG_MAGIC = b"\x89PNG"


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _gradient(shape=(32, 48), peak=1000):
    return np.linspace(0, peak, shape[0] * shape[1]).reshape(shape)


def _spot(shape=(32, 32), at=(8, 20), peak=1000.0):
    img = np.zeros(shape)
    img[at] = peak
    return img


def _speckle(shape=(40, 56), seed=1):
    rng = np.random.default_rng(seed)
    img = rng.exponential(200.0, shape)
    img[10:14, 30:35] += 3000.0
    return img


FRAMES = {"gradient": _gradient, "spot": _spot, "speckle": _speckle}

STATES = {
    "basic": {"range": (0, 1000)},
    "range_clip": {"range": (500, 1000)},
    "empty_range": {"range": (700, 700)},
    "log": {"range": (0, 1000), "log": True},
    "scale_up": {"range": (0, 1000), "scale": 2.0},
    "scale_down": {"range": (0, 1000), "scale": 0.5},
    "center_crosshair": {"range": (0, 1000), "center_crosshair": True},
    "centroid_crosshair": {"range": (0, 1000), "centroid_crosshair": True},
    "turbo": {"range": (0, 1000), "cmap": "turbo"},
    "default_cmap": {"range": (0, 1000), "cmap": "default"},
    "everything_up": {"range": (10, 900), "log": True, "cmap": "viridis", "scale": 4.0,
                      "center_crosshair": True, "centroid_crosshair": True},
    "everything_down": {"range": (0, 3000), "cmap": "magma", "scale": 0.25,
                        "center_crosshair": True, "centroid_crosshair": True},
}


@pytest.mark.parametrize("state", sorted(STATES))
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_parse_frame_matches_jax(frame, state):
    img = FRAMES[frame]()
    t_png, t_rgb = TV.parse_frame(img.copy(), dict(STATES[state]))
    j_png, j_rgb = JV.parse_frame(img.copy(), dict(STATES[state]))
    assert t_png.startswith(PNG_MAGIC)
    assert t_rgb.dtype == np.uint8 and t_rgb.shape == j_rgb.shape
    np.testing.assert_array_equal(t_rgb, j_rgb)
    assert t_png == j_png


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_parse_frame_takes_a_tensor(dtype):
    """A tensor frame renders as its numpy array does in the JAX package."""
    img = _speckle()
    state = {"range": (0, 3000), "centroid_crosshair": True, "scale": 2.0}
    t_png, t_rgb = TV.parse_frame(torch.from_numpy(img).to(dtype), dict(state))
    j_png, j_rgb = JV.parse_frame(torch.from_numpy(img).to(dtype).numpy(), dict(state))
    np.testing.assert_array_equal(t_rgb, j_rgb)
    assert t_png == j_png


def test_parse_frame_properties():
    """What ``TestParseFrame`` checks, on the port's renderer."""
    png, rgb = TV.parse_frame(_gradient(), {"range": (0, 1000)})
    assert png.startswith(PNG_MAGIC) and rgb.shape == (32, 48, 3)
    assert rgb[0, 0, 0] < 10 and rgb[-1, -1, 0] > 245
    assert np.all(TV.parse_frame(_gradient(), {"range": (500, 1000)})[1][0] == 0)
    assert TV.parse_frame(_gradient(), {"range": (0, 1000), "scale": 2.0})[1].shape == (64, 96, 3)
    assert TV.parse_frame(_gradient(), {"range": (0, 1000), "scale": 0.5})[1].shape == (16, 24, 3)
    _, rgb = TV.parse_frame(_spot(), {"range": (0, 1000), "centroid_crosshair": True})
    assert np.argmax(rgb[..., 0].sum(axis=0)) == 20


# ----------------------------------------------------------------------
# The widget shell, on stub widgets.
# ----------------------------------------------------------------------


class _Widget:
    """A stand-in for an ipywidgets control: keeps ``value``, calls its
    observers when the value changes and its click handlers on ``click``."""

    def __init__(self, value=None, **kwargs):
        self.__dict__["_observers"] = []
        self.__dict__["_clicks"] = []
        self.__dict__["kwargs"] = kwargs
        self.__dict__["closed"] = False
        self.__dict__["value"] = value

    def __setattr__(self, key, value):
        old = self.__dict__.get(key)
        self.__dict__[key] = value
        if key == "value" and value != old:
            for fn in self._observers:
                fn({"name": "value", "old": old, "new": value})

    def observe(self, fn, names=None):
        self._observers.append(fn)

    def on_click(self, fn):
        self._clicks.append(fn)

    def click(self):
        for fn in self._clicks:
            fn(self)

    def close(self):
        self.__dict__["closed"] = True

    def clear_output(self, wait=False):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False


@pytest.fixture
def stub_widgets(monkeypatch):
    """``ipywidgets`` and ``IPython.display`` replaced by stubs: widgets
    that record their values, a ``display`` that records what it is
    given."""
    widgets = types.ModuleType("ipywidgets")
    for name in ("HTML", "Button", "Checkbox", "Dropdown", "FloatLogSlider", "HBox",
                 "IntRangeSlider", "Layout", "Output", "ToggleButton", "VBox", "Image"):
        setattr(widgets, name, type(name, (_Widget,), {}))
    display = types.ModuleType("IPython.display")
    display.shown = []
    display.display = display.shown.append
    monkeypatch.setitem(sys.modules, "ipywidgets", widgets)
    monkeypatch.setitem(sys.modules, "IPython.display", display)
    monkeypatch.setitem(sys.modules, "ipyevents", None)
    return display


class _FrameCamera:
    """The little of a camera the shell reads: one fixed frame."""

    name = "frames"
    bitresolution = 12

    def __init__(self, frame):
        self.frame = frame
        self.calls = 0

    def get_image(self):
        self.calls += 1
        return self.frame


SHELL_KWARGS = {
    "defaults": {},
    "options": dict(min=40, max=10, log=True, cmap="turbo", scale=3.0, crosshair=True,
                    centroid=True),
    "cmap_flags": dict(cmap=True, cmap_options=["magma", "gray"]),
}


@pytest.mark.parametrize("kwargs", sorted(SHELL_KWARGS))
def test_viewer_shell_matches_jax(kwargs, stub_widgets):
    """Both packages' shells, built on the same stubs from the same frame:
    the same state, first image, autorange, control updates and clicks."""
    frame = _speckle().astype(np.uint16)
    viewers = [pkg._CameraViewer(_FrameCamera(frame), **SHELL_KWARGS[kwargs])
               for pkg in (TV, JV)]
    t, j = viewers
    assert t.state == j.state
    assert bytes(t.image.value) == bytes(j.image.value) and t.image.value.startswith(PNG_MAGIC)
    assert sorted(t.widgets) == sorted(j.widgets)
    for v in viewers:
        v.widgets["autorange"].click()
        v.widgets["log"].value = not v.state["log"]
        v.widgets["scale"].value = 2.0
    assert t.state == j.state and t.state["range"] == (int(frame.min()), int(frame.max()))
    assert t.image.value == j.image.value
    np.testing.assert_array_equal(t.on_click({"x": 10, "y": 6}), j.on_click({"x": 10, "y": 6}))
    for v in viewers:
        v.close()
        assert v.state["live"] is False and v.task is None
        assert all(w.closed for w in v.widgets.values()) and v.image.closed
    assert len(stub_widgets.shown) == 4  # Each shell's panel and image.


def test_viewer_renders_a_tensor_frame_once_on_the_host(stub_widgets):
    frame = torch.from_numpy(_speckle()).to(torch.float32)
    viewer = TV._CameraViewer(_FrameCamera(frame), widgets=False)
    assert isinstance(viewer.prev_img, np.ndarray)
    np.testing.assert_array_equal(viewer.prev_img, frame.numpy())
    _, rgb = TV.parse_frame(frame.numpy(), viewer.state)
    assert viewer.image.value == TV.parse_frame(frame.numpy(), viewer.state)[0]
    assert rgb.shape == (40, 56, 3)


@pytest.fixture
def camera():
    previous = slmsuite_torch.resolve_device(None)
    slmsuite_torch.set_default_device("cpu")
    slm = SimulatedSLM((64, 64), pitch_um=(8, 8), wav_um=0.78)
    slm.set_phase(np.random.default_rng(0).uniform(-np.pi, np.pi, (64, 64)), settle=False)
    cam = SimulatedCamera(slm, resolution=(64, 64), pitch_um=(5.5, 5.5))
    cam.set_exposure(1.0)
    yield cam
    slmsuite_torch.set_default_device(previous)


def test_camera_live_drives_the_simulated_camera(camera, stub_widgets):
    """``live()`` toggles a viewer that shows the camera's first frame and
    then every frame ``get_image`` grabs; ``live(False)`` closes it; an
    unknown backend raises as in the JAX package."""
    camera.live(min=0, max=4095)
    viewer = camera.viewer
    assert isinstance(viewer, TV._CameraViewer)
    first = camera.last_image
    np.testing.assert_array_equal(viewer.prev_img, first)
    assert viewer.image.value == TV.parse_frame(first, viewer.state)[0]

    camera._slm.set_phase(np.zeros((64, 64)), settle=False)
    img = camera.get_image()
    assert not np.array_equal(img, first)
    np.testing.assert_array_equal(viewer.prev_img, img)
    assert viewer.image.value == TV.parse_frame(img, viewer.state)[0]
    averaged = camera.get_image(averaging=2)
    np.testing.assert_array_equal(viewer.prev_img, averaged / 2)

    camera.live(True)  # A new viewer replaces the old one.
    assert camera.viewer is not viewer and viewer.image.closed
    camera.live()  # Toggled off.
    assert camera.viewer is None
    camera.live(False)
    assert camera.viewer is None
    with pytest.raises(ValueError, match="Unsupported live"):
        camera.live(backend="qt")
