"""
SLM driven through a video output: the phase pattern is displayed on a
monitor-like device (most consumer and many scientific SLMs enumerate as
a second screen).

Parity: reference ``slmsuite/hardware/slms/screenmirrored.py``
(``ScreenMirrored``).
"""

import numpy as np

from slmsuite_torch.hardware._pyglet import WindowManager, get_screens, require_pyglet
from slmsuite_torch.hardware.slms.slm import SLM


class ScreenMirrored(SLM):
    """
    Wraps a screen-mirrored SLM: phase data is written by rendering a
    grayscale image to a chosen monitor, full-screen and borderless, via
    :mod:`pyglet`. Rendering happens on a dedicated thread (see
    :mod:`slmsuite_torch.hardware._pyglet`), so :meth:`_set_phase_hw` can
    return before the buffer flip when ``block=False``.

    Use :meth:`info` to enumerate attached screens and pick
    ``display_number``. The SLM's pixel grid is taken to be exactly the
    screen's resolution.

    Caution
    ~~~~~~~
    Operating-system color management (gamma ramps, night-light modes)
    corrupts the phase-to-gray mapping; disable it for the SLM output.
    Only 8-bit output is currently supported.
    """

    def __init__(
        self,
        display_number,
        bitdepth=8,
        verbose=True,
        wav_um=1,
        pitch_um=(8, 8),
        **kwargs,
    ):
        """
        Parameters
        ----------
        display_number : int
            Index of the screen to mirror to (see :meth:`info`).
        bitdepth : int
            Bits of grayscale depth. Only 8 is currently supported.
        verbose : bool
            Print connection progress.
        wav_um, pitch_um
            Design wavelength and pixel pitch, passed to :meth:`.SLM.__init__`.
        **kwargs
            Passed to :meth:`.SLM.__init__`.
        """
        require_pyglet()
        if bitdepth != 8:
            raise ValueError(
                "ScreenMirrored currently supports 8-bit displays only; "
                "16-bit RG-packed output is not yet implemented."
            )

        screens = get_screens()
        if not (0 <= display_number < len(screens)):
            raise ValueError(
                f"Display {display_number} not found; "
                f"{len(screens)} screen(s) attached. See ScreenMirrored.info()."
            )
        screen = screens[display_number]

        if verbose:
            print(f"Initializing screen {display_number} "
                  f"({screen.width}x{screen.height})... ", end="")

        shape = (screen.height, screen.width)
        self.window_thread = WindowManager.get_instance().create_window(
            shape, screen, caption=f"SLM {display_number}"
        )

        if verbose:
            print("success")

        super().__init__(
            (screen.width, screen.height),
            bitdepth=bitdepth,
            name=f"ScreenMirrored_{display_number}",
            wav_um=wav_um,
            pitch_um=pitch_um,
            **kwargs,
        )

        self.set_phase(None)

    def _set_phase_hw(self, display, block=True):
        """Render the integer phase image on the mirrored screen."""
        self.window_thread.render(np.asarray(display, dtype=np.uint8), block=block)

    def close(self):
        """Destroy the window and stop its render thread."""
        if getattr(self, "window_thread", None) is not None:
            self.window_thread.close()
            self.window_thread = None

    @staticmethod
    def info(verbose=True):
        """
        Enumerate attached screens.

        Returns
        -------
        list of (int, (int, int, int, int))
            ``(index, (x, y, width, height))`` per screen.
        """
        require_pyglet()
        screens = get_screens()
        entries = [
            (i, (s.x, s.y, s.width, s.height)) for i, s in enumerate(screens)
        ]
        if verbose:
            print("Attached screens:")
            for i, (x, y, w, h) in entries:
                main = " (main)" if (x, y) == (0, 0) else ""
                print(f"  {i}: {w}x{h} at ({x}, {y}){main}")
        return entries
