"""
Jupyter live camera viewer.

An :mod:`ipywidgets`-based monitor that renders every frame flowing
through :meth:`.Camera.get_image`; toggling its *Live* button starts an
:mod:`asyncio` polling loop on the notebook's event loop, so monitoring
interleaves with (and is preempted by) user cell execution.

The pure frame-rendering pipeline (:func:`parse_frame`) is separated
from the widget shell so it is testable headless: range clip, optional
log scaling, colormap, power-of-two zoom, and center/centroid
crosshairs.

The port's copy of :mod:`slmsuite_tpu.hardware.cameras._viewer`: the
centroid crosshair uses the port's :mod:`slmsuite_torch.holography.analysis`,
and a frame may be a torch tensor on any device, copied to the host once
(:func:`~slmsuite_torch.misc.host.as_numpy`). ``ipywidgets`` and
``IPython`` are imported only when a viewer is built. Used by
:meth:`.Camera.live`.
"""

import asyncio
import io

import numpy as np

from slmsuite_torch.misc.host import as_numpy

_DEFAULT_CMAPS = [
    "gray", "turbo", "viridis", "plasma", "inferno", "magma", "cividis",
    "Blues",
]


def _encode_png(rgb):
    """uint8 RGB array -> PNG bytes."""
    try:
        import cv2

        ok, encoded = cv2.imencode(".png", rgb[..., ::-1])  # RGB -> BGR.
        if ok:
            return encoded.tobytes()
    except ImportError:
        pass
    from PIL import Image as PILImage

    buffer = io.BytesIO()
    PILImage.fromarray(rgb).save(buffer, format="png")
    return buffer.getvalue()


def parse_frame(img, state):
    """
    Render a camera frame (a numpy array or a torch tensor) to PNG bytes
    according to the viewer ``state``:
    ``range`` (clip limits), ``log`` (log10 intensity), ``cmap``
    (matplotlib name or ``"gray"``), ``scale`` (power-of-two zoom;
    downscale before the heavy steps, upscale after),
    ``center_crosshair`` and ``centroid_crosshair``.

    Returns ``(png_bytes, rgb_array)``.
    """
    import matplotlib
    from scipy.ndimage import zoom

    img = np.asarray(as_numpy(img), dtype=float)
    scale = float(state.get("scale", 1.0))

    # Downscale early: every later step then costs scale^2 less.
    if scale < 1:
        img = zoom(img, scale, order=1)

    if state.get("centroid_crosshair"):
        from slmsuite_torch.holography.analysis import (
            image_positions,
            image_remove_field,
        )

        clean = image_remove_field(img[None, ...], deviations=None)
        center = np.squeeze(image_positions(clean))
        cx, cy = np.rint(
            (center + np.flip(img.shape) / 2) * (scale if scale > 1 else 1)
        ).astype(int)

    lo, hi = state.get("range", (0.0, 1.0))
    if hi <= lo:
        hi = lo + 1
    img = np.clip(img, lo, hi) - lo
    span = hi - lo

    if state.get("log"):
        normalized = np.log10(np.clip(img, 1, None)) / np.log10(span + 1)
    else:
        normalized = img / span

    cmap = state.get("cmap", "gray")
    if cmap in ("default", "grayscale"):
        cmap = "gray"
    colormap = matplotlib.colormaps[cmap]
    rgb = (colormap(np.clip(normalized, 0, 1))[..., :3] * 255).astype(np.uint8)

    if scale > 1:
        rgb = zoom(rgb, (scale, scale, 1), order=0)

    # Crosshairs: centroid inverts color; center uses mid-gray inversion.
    if state.get("centroid_crosshair"):
        cx = int(np.clip(cx, 0, rgb.shape[1] - 1))
        cy = int(np.clip(cy, 0, rgb.shape[0] - 1))
        rgb[:, cx, :] = 255 - rgb[:, cx, :]
        rgb[cy, :, :] = 255 - rgb[cy, :, :]
    if state.get("center_crosshair"):
        rgb[:, rgb.shape[1] // 2, :] = 127 - rgb[:, rgb.shape[1] // 2, :]
        rgb[rgb.shape[0] // 2, :, :] = 127 - rgb[rgb.shape[0] // 2, :, :]

    return _encode_png(rgb), rgb


class _CameraViewer:
    """Widget bundle monitoring one :class:`.Camera`."""

    def __init__(
        self,
        cam,
        widgets=True,
        backend="ipython",
        live=False,
        min=None,
        max=None,
        log=False,
        cmap="gray",
        cmap_options=None,
        scale=1.0,
        crosshair=False,
        centroid=False,
        poll_s=0.01,
    ):
        self.cam = cam
        self.backend = backend
        self.poll_s = float(poll_s)
        self.task = None
        self.prev_img = None
        self._closed = False

        if min is None:
            min = 0
        if max is None:
            max = cam.bitresolution - 1
        lo, hi = sorted((min, max))

        if cmap is True:
            cmap = "default"
        if cmap is False:
            cmap = "grayscale"

        self.state = {
            "backend": backend,
            "live": bool(live),
            "range": (lo, hi),
            "log": bool(log),
            "cmap": cmap,
            "scale": float(2 ** np.round(np.log2(scale))),
            "cmap_options": list(cmap_options or _DEFAULT_CMAPS),
            "center_crosshair": bool(crosshair),
            "centroid_crosshair": bool(centroid),
        }

        self.widgets = {}
        if widgets:
            self.init_widgets()
        self.init_image()

    # ------------------------------------------------------------------
    # Rendering.
    # ------------------------------------------------------------------

    def parse(self, img=None):
        """Render ``img`` (or the last frame) to PNG bytes; a tensor is
        copied to the host once and kept as the last frame."""
        if img is not None:
            self.prev_img = as_numpy(img)
        if self.prev_img is None:
            return None
        png, _ = parse_frame(self.prev_img, self.state)
        return png

    def render(self, img=None):
        """Parse + push into the image widget (errors go to the output
        widget rather than killing the asyncio loop)."""
        if self._closed:
            return
        try:
            value = self.parse(img)
            if value is not None:
                self.image.value = value
        except Exception as err:
            out = self.widgets.get("output")
            if out is not None:
                with out:
                    print(str(err))
            else:
                raise

    # ------------------------------------------------------------------
    # Widget callbacks.
    # ------------------------------------------------------------------

    def update(self, event=None):
        """Pull every control's value into ``state`` and re-render."""
        out = self.widgets.get("output")
        if out is not None:
            out.clear_output(wait=True)
        for key in (
            "range", "log", "cmap", "scale",
            "center_crosshair", "centroid_crosshair",
        ):
            if key in self.widgets:
                self.state[key] = self.widgets[key].value
        self.render()

    def autorange(self, event=None):
        """Set the color range to the last frame's min/max."""
        if self.prev_img is not None:
            limits = (int(np.min(self.prev_img)), int(np.max(self.prev_img)))
            self.state["range"] = limits
            if "range" in self.widgets:
                self.widgets["range"].value = limits
        self.render()

    def on_click(self, event):
        """Print the clicked camera-pixel coordinate."""
        coord = np.array([event["x"], event["y"]])
        pixel = np.round(coord / self.state["scale"]).astype(int)
        out = self.widgets.get("output")
        if out is not None:
            with out:
                out.clear_output(wait=True)
                print(pixel)
        return pixel

    def live(self, event=None):
        """Start/stop the asyncio polling task per the Live toggle."""
        state = self.state["live"] = bool(self.widgets["live"].value)
        if self.task is not None:
            self.task.cancel()
            self.task = None
        if state:
            self.task = asyncio.ensure_future(self.live_loop())

    async def live_loop(self):
        """Poll frames while live; ``get_image`` calls back into render."""
        while self.state["live"] and not self._closed:
            try:
                self.cam.get_image()
            except Exception:
                self.state["live"] = False
                if "live" in self.widgets:
                    self.widgets["live"].value = False
                raise
            await asyncio.sleep(self.poll_s)

    # ------------------------------------------------------------------
    # Construction.
    # ------------------------------------------------------------------

    def init_image(self):
        """Grab one frame and display it as the image widget."""
        from IPython.display import display
        from ipywidgets import Image

        self.image = Image(value=self.parse(self.cam.get_image()) or b"",
                           format="png")
        # ipywidgets.Image has no native click events; wire through
        # ipyevents when available (assigning an ``on_click`` attribute
        # would be a silent no-op).
        try:
            from ipyevents import Event

            self._click_events = Event(source=self.image,
                                       watched_events=["click"])

            def _on_dom_click(event):
                self.on_click(
                    {"x": event.get("relativeX"), "y": event.get("relativeY")}
                )

            self._click_events.on_dom_event(_on_dom_click)
        except ImportError:
            pass  # Click-to-pixel needs ipyevents; viewer works without.
        display(self.image)

    def init_widgets(self):
        """Build the control panel (range/autorange/log/cmap/scale/
        crosshairs/live) and wire the observers."""
        from IPython.display import display
        from ipywidgets import (
            HTML, Button, Checkbox, Dropdown, FloatLogSlider, HBox,
            IntRangeSlider, Layout, Output, ToggleButton, VBox,
        )

        item = Layout(width="auto")
        self.widgets = {
            "name": HTML(
                value=f"<b>{self.cam.name}</b>", description="Viewing",
                layout=item,
            ),
            "live": ToggleButton(
                value=self.state["live"], description="Live", layout=item,
            ),
            "range": IntRangeSlider(
                value=self.state["range"], min=0,
                max=self.cam.bitresolution - 1, step=1,
                description="Range", layout=Layout(width="70%"),
            ),
            "autorange": Button(description="AutoRange", layout=item),
            "log": Checkbox(
                value=self.state["log"], description="Logarithmic",
                layout=item,
            ),
            "center_crosshair": Checkbox(
                value=self.state["center_crosshair"],
                description="Center Crosshair", layout=item,
            ),
            "centroid_crosshair": Checkbox(
                value=self.state["centroid_crosshair"],
                description="Centroid Crosshair", layout=item,
            ),
            "cmap": Dropdown(
                options=self.state["cmap_options"],
                value=self.state["cmap"]
                if self.state["cmap"] in self.state["cmap_options"]
                else self.state["cmap_options"][0],
                description="Colormap", layout=item,
            ),
            "scale": FloatLogSlider(
                value=self.state["scale"], base=2, min=-3, max=3, step=1,
                description="Scale", layout=item,
            ),
            "output": Output(),
        }

        for key, widget in self.widgets.items():
            if key == "autorange":
                widget.on_click(self.autorange)
            elif key == "live":
                widget.observe(self.live, "value")
            elif key not in ("name", "output"):
                widget.observe(self.update, "value")

        self.widgets["layout"] = HBox([
            VBox(
                [
                    HBox([self.widgets["name"]]),
                    HBox([
                        self.widgets["cmap"], self.widgets["log"],
                        self.widgets["center_crosshair"],
                        self.widgets["centroid_crosshair"],
                    ]),
                    HBox([self.widgets["range"]]),
                    self.widgets["output"],
                ],
                layout=Layout(width="70%"),
            ),
            VBox(
                [
                    self.widgets["live"], self.widgets["scale"],
                    self.widgets["autorange"],
                ],
                layout=Layout(width="30%"),
            ),
        ])
        display(self.widgets["layout"])

    def close(self):
        """Stop the live loop and remove the widgets."""
        self._closed = True
        self.state["live"] = False
        if self.task is not None:
            self.task.cancel()
            self.task = None
        for widget in self.widgets.values():
            try:
                widget.close()
            except Exception:
                pass
        if getattr(self, "image", None) is not None:
            self.image.close()
