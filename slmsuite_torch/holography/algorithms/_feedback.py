r"""
:class:`FeedbackHologram` (port of
:mod:`slmsuite_tpu.holography.algorithms._feedback`), reduced to what the
spot holograms need without a camera: computational feedback, with
``cameraslm`` None or a bare SLM (its shape and source amplitude).
Camera-in-the-loop feedback and CameraSLMs come with the simulated-rig
slice (ROADMAP.md queue 1, item 9).
"""

from slmsuite_torch.holography.algorithms._hologram import Hologram


class FeedbackHologram(Hologram):
    """
    Hologram with (for now, only computational) feedback.

    Attributes
    ----------
    cameraslm : None
        Hardware access for experimental feedback (a bare SLM is taken for
        its shape and source, and leaves this None, as in the JAX package).
    target_ij : numpy.ndarray OR None
        Target amplitude in the camera basis.
    img_ij, img_knm : numpy.ndarray OR None
        Cached amplitude feedback images.
    """

    def __init__(self, shape, target_ij=None, cameraslm=None, **kwargs):
        """Initialize a feedback hologram of computational ``shape``."""
        if target_ij is not None or (
            hasattr(cameraslm, "slm") and hasattr(cameraslm, "cam")
        ):
            raise NotImplementedError(
                "Camera feedback (a CameraSLM, target_ij) comes with the "
                "simulated-rig slice (ROADMAP.md queue 1, item 9)."
            )
        self.cameraslm = None
        if cameraslm is not None:
            if not (hasattr(cameraslm, "shape") and hasattr(cameraslm, "grid")):
                raise ValueError("Expected a CameraSLM or SLM for cameraslm.")
            kwargs["amp"] = cameraslm._get_source_amplitude()
            kwargs.setdefault("slm_shape", tuple(cameraslm.shape))
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
