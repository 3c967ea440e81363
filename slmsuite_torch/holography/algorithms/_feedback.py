r"""
:class:`FeedbackHologram` (port of
:mod:`slmsuite_tpu.holography.algorithms._feedback`): a hologram that
knows its hardware. ``cameraslm`` is None, a bare SLM (taken for its shape
and source amplitude) or a CameraSLM, whose camera :meth:`measure` images
the current phase with. Feedback from camera *images* (``target_ij``,
``ijcam_to_knmslm``, ``"experimental"`` weighting) needs the stepwise host
loop and raises :class:`NotImplementedError` (ROADMAP.md queue 1, item 6).
"""

import numpy as np

from slmsuite_torch.holography.algorithms._hologram import Hologram


class FeedbackHologram(Hologram):
    """
    Hologram with hardware access for feedback.

    Attributes
    ----------
    cameraslm : CameraSLM OR None
        Hardware access for experimental feedback (a bare SLM is taken for
        its shape and source, and leaves this None, as in the JAX package).
    target_ij : numpy.ndarray OR None
        Target amplitude in the camera basis.
    img_ij, img_knm : numpy.ndarray OR None
        Cached amplitude feedback images.
    """

    def __init__(self, shape, target_ij=None, cameraslm=None, **kwargs):
        """Initialize a feedback hologram of computational ``shape``."""
        if target_ij is not None:
            raise NotImplementedError(
                "Camera-basis image targets (target_ij) come with the stepwise "
                "host loop (ROADMAP.md queue 1, item 6)."
            )
        self.cameraslm = cameraslm
        if cameraslm is not None:
            if hasattr(cameraslm, "slm") and hasattr(cameraslm, "cam"):
                slm = cameraslm.slm
            elif hasattr(cameraslm, "shape") and hasattr(cameraslm, "grid"):
                slm = cameraslm
                self.cameraslm = None
            else:
                raise ValueError("Expected a CameraSLM or SLM for cameraslm.")
            kwargs["amp"] = slm._get_source_amplitude()
            kwargs.setdefault("slm_shape", tuple(slm.shape))
        super().__init__(target=shape, **kwargs)

        self.img_ij = None
        self.img_knm = None
        self.target_ij = None

    def _engine_feedback(self):
        feedback = self.flags.get("feedback", "computational")
        if feedback == "computational":
            return feedback
        raise NotImplementedError(
            f"Feedback '{feedback}' needs the stepwise host loop "
            "(ROADMAP.md queue 1, item 6)."
        )

    def ijcam_to_knmslm(self, *args, **kwargs):
        """A camera-basis image resampled into the computational basis."""
        raise NotImplementedError(
            "ijcam_to_knmslm comes with the stepwise host loop "
            "(ROADMAP.md queue 1, item 6)."
        )

    def measure(self, basis="ij"):
        """
        Ensure a feedback image is cached: write the hologram's phase to
        the SLM, settle, grab a camera image, and store its amplitude
        (the square root) in :attr:`img_ij`.
        """
        if basis == "knm":
            self.ijcam_to_knmslm()
        if basis != "ij":
            raise ValueError(f"Unrecognized basis '{basis}'. Options: 'ij', 'knm'.")
        if self.cameraslm is None:
            raise RuntimeError("measure() requires a cameraslm.")
        if self.img_ij is None:
            self.cameraslm.slm.set_phase(
                self.get_phase(include_propagation=True), settle=True
            )
            self.cameraslm.cam.flush()
            self.img_ij = np.sqrt(
                np.asarray(self.cameraslm.cam.get_image(), dtype=self.dtype)
            )
            self.img_knm = None

    def _midloop_cleaning(self):
        self.img_ij = None
        self.img_knm = None
