r"""
:class:`FeedbackHologram` (port of
:mod:`slmsuite_tpu.holography.algorithms._feedback`), reduced to what
:class:`SpotHologram` needs without hardware: ``cameraslm=None`` and
computational feedback. Camera-in-the-loop feedback comes with the
simulated-rig slice (ROADMAP.md queue 1, item 9).
"""

from slmsuite_torch.holography.algorithms._hologram import Hologram


class FeedbackHologram(Hologram):
    """
    Hologram with (for now, only computational) feedback.

    Attributes
    ----------
    cameraslm : None
        Hardware access for experimental feedback (not ported yet).
    target_ij : numpy.ndarray OR None
        Target amplitude in the camera basis.
    img_ij, img_knm : numpy.ndarray OR None
        Cached amplitude feedback images.
    """

    def __init__(self, shape, target_ij=None, cameraslm=None, **kwargs):
        """Initialize a feedback hologram of computational ``shape``."""
        if cameraslm is not None or target_ij is not None:
            raise NotImplementedError(
                "Camera feedback (cameraslm, target_ij) comes with the "
                "simulated-rig slice (ROADMAP.md queue 1, item 9)."
            )
        self.cameraslm = None
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
            "(ROADMAP.md queue 1, items 6 and 9)."
        )
