"""
Windowing backend for :class:`~slmsuite_torch.hardware.slms.screenmirrored.ScreenMirrored`.

OpenGL contexts are thread-affine, so each SLM window lives on a dedicated
render thread (:class:`WindowThread`) that owns the :mod:`pyglet` window and
services a submit queue; callers hand it work and receive
:class:`concurrent.futures.Future` handles. :class:`WindowManager` is the
process-wide registry that creates/destroys these threads and tears them
down at interpreter exit.

Parity: reference ``slmsuite/hardware/_pyglet.py`` (``_Window``,
``_WindowThread``, ``_WindowManager``, ``get_pyglet_display``).

:mod:`pyglet` is imported lazily and guarded, on the first window or
screen query (:func:`require_pyglet`), never when this module is imported:
it imports cleanly on headless machines without it, and instantiating a
window raises a clear error instead.
"""

import atexit
import queue
import threading
from concurrent.futures import Future

import numpy as np

from slmsuite_torch.hardware import _optional_import

# pyglet and its GL bindings, imported by require_pyglet() on first use.
pyglet = None
gl = None


def require_pyglet():
    """Import :mod:`pyglet` on first use; raise a helpful error if it is
    unavailable."""
    global pyglet, gl
    if pyglet is None:
        pyglet, gl = _optional_import("pyglet"), _optional_import("pyglet.gl")
    if pyglet is None:
        raise ImportError(
            "pyglet is required for screen-mirrored SLM display. "
            "Install it with `pip install pyglet`."
        )


def get_display():
    """
    Return the default pyglet display, across pyglet API generations
    (``pyglet.display`` in 2.x, ``pyglet.canvas`` in 1.x).
    """
    require_pyglet()
    if hasattr(pyglet, "display") and hasattr(pyglet.display, "get_display"):
        return pyglet.display.get_display()
    return pyglet.canvas.get_display()


def get_screens():
    """Return the list of physical screens attached to the default display."""
    return get_display().get_screens()


class SLMWindow:
    """
    Borderless window covering one screen, displaying integer phase data.

    The window swallows all user input (an SLM "monitor" must never react
    to stray clicks or keystrokes) and redraws the last-written frame on
    expose. Frames are written into one persistent RGBA texture
    (``glTexSubImage2D``) rather than re-creating an image each flip.

    Two GL pipelines are supported, detected at construction:

    - **GL 3.0+** (pyglet >= 2): the default blit shader with a
      triangle-strip quad.
    - **GL 2.x** (pyglet 1.x / legacy drivers): fixed-function pipeline —
      power-of-two-padded texture, interleaved ``T4F_V4F`` vertex array,
      ``GL_QUADS``.

    Must only be used from the thread that created it (GL thread affinity);
    :class:`WindowThread` enforces this.
    """

    def __init__(self, shape, screen, caption="SLM"):
        require_pyglet()
        import ctypes

        self._ctypes = ctypes
        self.shape = tuple(shape)  # (height, width)

        self.window = pyglet.window.Window(
            width=screen.width,
            height=screen.height,
            screen=screen,
            caption=caption,
            style=getattr(
                pyglet.window.Window, "WINDOW_STYLE_BORDERLESS", "borderless"
            ),
            vsync=True,
            visible=True,
        )
        self.window.set_location(screen.x, screen.y)
        self.window.set_mouse_visible(False)

        # Swallow every input event so the OS never routes interaction
        # (focus changes, accidental close) to the SLM surface.
        for event in (
            "on_mouse_press", "on_mouse_release", "on_mouse_motion",
            "on_mouse_drag", "on_key_press", "on_key_release", "on_close",
        ):
            self.window.push_handlers(**{event: self._swallow})
        self.window.push_handlers(on_expose=self._on_expose)

        # Persistent RGBA staging buffer; the alpha plane stays opaque.
        h, w = self.shape
        self.buffer = np.zeros((h, w, 4), dtype=np.uint8)
        self.buffer[:, :, 3] = 255
        self._cbuffer = (gl.GLubyte * self.buffer.size).from_buffer(self.buffer)

        self.window.switch_to()
        self._setup_context()
        self._draw()

    @staticmethod
    def _swallow(*args, **kwargs):
        return True  # pyglet.event.EVENT_HANDLED

    def _on_expose(self):
        self._draw()
        return True

    # ------------------------------------------------------------------
    # GL pipeline.
    # ------------------------------------------------------------------

    def _gl_version(self, major, minor=0):
        try:
            return gl.gl_info.have_version(major, minor)
        except Exception:
            return gl.base.gl_info.have_version(major, minor)

    def _make_texture(self, tex_shape):
        """Allocate a persistent RGBA8 texture with nearest filtering."""
        ctypes = self._ctypes
        texture = gl.GLuint()
        gl.glGenTextures(1, ctypes.byref(texture))
        gl.glBindTexture(gl.GL_TEXTURE_2D, texture.value)
        gl.glTexParameteri(
            gl.GL_TEXTURE_2D, gl.GL_TEXTURE_MAG_FILTER, gl.GL_NEAREST
        )
        gl.glTexParameteri(
            gl.GL_TEXTURE_2D, gl.GL_TEXTURE_MIN_FILTER, gl.GL_NEAREST
        )
        gl.glTexImage2D(
            gl.GL_TEXTURE_2D, 0, gl.GL_RGBA8,
            tex_shape[1], tex_shape[0],
            0, gl.GL_RGBA, gl.GL_UNSIGNED_BYTE, None,
        )
        return texture

    def _setup_context(self):
        """Build the pipeline for the detected GL generation."""
        h, w = self.shape

        if self._gl_version(3, 0):
            self.gl_mode = "modern"
            self.texture = self._make_texture((h, w))

            # Default blit shader + a quad in window pixels; texture v=0
            # maps to the quad's top so buffer row 0 displays at the top.
            self.shader = pyglet.graphics.get_default_blit_shader()
            self.shader.use()
            self.vertex_list = self.shader.vertex_list(
                4, gl.GL_TRIANGLE_STRIP,
                position=("f", [
                    0.0, float(h), 0.0,
                    0.0, 0.0, 0.0,
                    float(w), float(h), 0.0,
                    float(w), 0.0, 0.0,
                ]),
                tex_coords=("f", [
                    0.0, 0.0, 0.0,
                    0.0, 1.0, 0.0,
                    1.0, 0.0, 0.0,
                    1.0, 1.0, 0.0,
                ]),
            )
            gl.glBindTexture(gl.GL_TEXTURE_2D, 0)
            gl.glFlush()
        elif self._gl_version(2, 0):
            self.gl_mode = "legacy"
            # Fixed-function GL: textures must be power-of-two padded.
            tex_shape = tuple(int(2 ** np.ceil(np.log2(s))) for s in self.shape)
            self._tex_ratio = (h / tex_shape[0], w / tex_shape[1])

            proj = pyglet.window.Projection2D()
            proj.set(w, h, w, h)

            gl.glEnable(gl.GL_TEXTURE_2D)
            self.texture = self._make_texture(tex_shape)

            # Interleaved tex/vertex array for a single quad; the texture
            # coordinates stop at the unpadded extent. GL's ortho is
            # bottom-up, so buffer row 0 (texture v=0) must land on the
            # window TOP (y = h) to match the modern path's orientation.
            x2, y2 = float(w), float(h)
            ub, vb = self._tex_ratio[1], self._tex_ratio[0]
            self._quad = (gl.GLfloat * 32)(
                0.0, vb, 0.0, 1.0,    0.0, 0.0, 0.0, 1.0,
                ub, vb, 0.0, 1.0,     x2, 0.0, 0.0, 1.0,
                ub, 0.0, 0.0, 1.0,    x2, y2, 0.0, 1.0,
                0.0, 0.0, 0.0, 1.0,   0.0, y2, 0.0, 1.0,
            )
            gl.glBindTexture(gl.GL_TEXTURE_2D, 0)
            gl.glFlush()
        else:
            raise RuntimeError("Could not find a compatible GL context.")

    def render(self, display):
        """Write ``display`` (uint8, :attr:`shape`) into the staging
        buffer, upload it to the texture, and flip."""
        display = np.ascontiguousarray(display, dtype=np.uint8)
        if display.shape != self.shape:
            raise ValueError(
                f"Display shape {display.shape} != window data shape {self.shape}."
            )
        # Grayscale -> RGB planes of the persistent RGBA buffer.
        self.buffer[:, :, 0] = display
        self.buffer[:, :, 1] = display
        self.buffer[:, :, 2] = display
        self._draw()

    def _draw(self):
        h, w = self.shape
        self.window.switch_to()

        gl.glBindTexture(gl.GL_TEXTURE_2D, self.texture.value)
        gl.glTexSubImage2D(
            gl.GL_TEXTURE_2D, 0, 0, 0, w, h,
            gl.GL_RGBA, gl.GL_UNSIGNED_BYTE, self._cbuffer,
        )

        if self.gl_mode == "modern":
            self.shader.use()
            gl.glActiveTexture(gl.GL_TEXTURE0)
            self.vertex_list.draw(gl.GL_TRIANGLE_STRIP)
        else:
            gl.glEnable(gl.GL_TEXTURE_2D)
            gl.glPushClientAttrib(gl.GL_CLIENT_VERTEX_ARRAY_BIT)
            gl.glInterleavedArrays(gl.GL_T4F_V4F, 0, self._quad)
            gl.glDrawArrays(gl.GL_QUADS, 0, 4)
            gl.glPopClientAttrib()

        # With vsync this blocks until the frame is actually displayed —
        # exactly the synchronization an SLM write wants.
        self.window.flip()
        self.window.dispatch_events()

    def close(self):
        self.window.close()


class WindowThread(threading.Thread):
    """
    Dedicated render thread owning one :class:`SLMWindow`.

    Work is submitted with :meth:`submit` and returns a
    :class:`~concurrent.futures.Future`; the loop alternates between
    servicing the queue and dispatching pyglet events.
    """

    _POLL_S = 0.005

    def __init__(self, shape, screen, caption="SLM", manager=None):
        super().__init__(daemon=True, name=f"slm-window-{caption}")
        self._args = (shape, screen, caption)
        self._queue = queue.Queue()
        self._manager = manager
        self._ready = threading.Event()
        self._startup_error = None
        self.window = None
        self._closing = False

        self.start()
        self._ready.wait()
        if self._startup_error is not None:
            raise self._startup_error

    def run(self):
        try:
            self.window = SLMWindow(*self._args)
        except Exception as err:  # Surface construction errors to the caller.
            self._startup_error = err
            self._ready.set()
            return
        self._ready.set()

        while not self._closing:
            try:
                future, func, args, kwargs = self._queue.get(timeout=self._POLL_S)
            except queue.Empty:
                self.window.window.dispatch_events()
                continue
            if not future.set_running_or_notify_cancel():
                continue
            try:
                future.set_result(func(*args, **kwargs))
            except Exception as err:
                future.set_exception(err)

        self.window.close()
        if self._manager is not None:
            self._manager.remove_thread(self)

    def submit(self, func, *args, **kwargs):
        """Schedule ``func(*args, **kwargs)`` on the render thread."""
        future = Future()
        self._queue.put((future, func, args, kwargs))
        return future

    def render(self, display, block=True):
        """Render ``display`` on the window; optionally wait for the flip."""
        future = self.submit(lambda: self.window.render(display))
        if block:
            future.result()
        return future

    def close(self):
        self._closing = True
        if threading.current_thread() is not self:
            self.join(timeout=2)


class WindowManager:
    """Process-wide registry of :class:`WindowThread` instances."""

    _instance = None
    _lock = threading.Lock()

    @classmethod
    def get_instance(cls):
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
                atexit.register(cls._instance.shutdown)
            return cls._instance

    def __init__(self):
        self._threads = []

    def create_window(self, shape, screen, caption="SLM"):
        thread = WindowThread(shape, screen, caption, manager=self)
        self._threads.append(thread)
        return thread

    def remove_thread(self, thread):
        if thread in self._threads:
            self._threads.remove(thread)

    def shutdown(self):
        for thread in list(self._threads):
            thread.close()
        self._threads = []
