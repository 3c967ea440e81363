r"""
:class:`FeedbackHologram` (port of
:mod:`slmsuite_tpu.holography.algorithms._feedback`): a hologram that
knows its hardware. ``cameraslm`` is None, a bare SLM (taken for its shape
and source amplitude) or a CameraSLM, whose camera :meth:`measure` images
the current phase with. A Fourier-calibrated CameraSLM takes a target in
the camera basis (``target_ij``, resampled into the computational basis by
:meth:`ijcam_to_knmslm`), and ``"experimental"`` feedback weights the
farfield by the camera's image; both run the stepwise host loop. The
resampling and the camera run on the host (``scipy.ndimage``), the
transforms and the weight update on the device.
"""

import numpy as np
import torch

from slmsuite_torch.holography import toolbox
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
        Cached amplitude feedback images in the camera and computational
        bases.
    """

    def __init__(self, shape, target_ij=None, cameraslm=None, null_region=None,
                 null_region_radius_frac=None, **kwargs):
        """
        Initialize a feedback hologram of computational ``shape``. With a
        Fourier-calibrated ``cameraslm``, ``target_ij`` (a camera-basis
        image) becomes the target through :meth:`update_target`, with its
        ``null_region`` and ``null_region_radius_frac``.
        """
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
        self.target_ij = None if target_ij is None else np.asarray(target_ij, self.dtype)

        if self.cameraslm is not None and "fourier" in self.cameraslm.calibrations:
            # The camera's corners in the computational basis (for plots).
            cam_shape = self.cameraslm.cam.shape
            corners = np.array([
                [0, 0], [0, cam_shape[0] - 1], [cam_shape[1] - 1, cam_shape[0] - 1],
                [cam_shape[1] - 1, 0], [0, 0],
            ]).T
            points_kxy = self.cameraslm.ijcam_to_kxyslm(toolbox.format_2vectors(corners))
            self._cam_points = toolbox.convert_vector(
                points_kxy, "kxy", "knm", hardware=self.cameraslm.slm, shape=self.shape
            )
            if target_ij is not None:
                self.update_target(
                    target_ij, null_region, null_region_radius_frac, reset_weights=True
                )
        else:
            self._cam_points = None

    def _engine_feedback(self):
        """Feedback measured on the hardware updates the weights on the host
        between iterations (the engine's ``"external"`` mode)."""
        feedback = self.flags.get("feedback", "computational")
        if feedback == "computational":
            return feedback
        return "external"

    # ------------------------------------------------------------------
    # Basis transformation.
    # ------------------------------------------------------------------

    def ijcam_to_knmslm(self, img, out=None, blur_ij=None, order=3):
        """
        A camera-basis image resampled into the computational basis: the
        composite affine (the knm -> kxy scaling, then the Fourier
        calibration's kxy -> ij), a Gaussian blur of ``blur_ij`` camera
        pixels first (the ``blur_ij`` flag by default), nan outside the
        camera, and unit norm.
        """
        from scipy.ndimage import affine_transform, gaussian_filter

        if self.cameraslm is None:
            raise RuntimeError("ijcam_to_knmslm requires a cameraslm.")
        if "fourier" not in self.cameraslm.calibrations:
            raise RuntimeError("ijcam_to_knmslm requires a Fourier calibration.")

        # knm -> kxy is a diagonal scaling about the knm center.
        conversion = toolbox.convert_vector(
            (1, 1), "knm", "kxy", hardware=self.cameraslm.slm, shape=self.shape
        ) - toolbox.convert_vector(
            (0, 0), "knm", "kxy", hardware=self.cameraslm.slm, shape=self.shape
        )
        M1 = np.diag(np.squeeze(conversion))
        b1 = M1 @ (-toolbox.format_2vectors(np.flip(np.squeeze(self.shape)) / 2))

        fourier = self.cameraslm.calibrations["fourier"]
        M2 = np.array(fourier["M"], copy=True)
        b2 = np.array(fourier["b"], copy=True)
        if "a" in fourier:
            b2 = b2 - M2 @ fourier["a"]

        # The composite knm -> ij, in (row, col) order for scipy.
        M = np.flip(np.flip(M2 @ M1, axis=0), axis=1)
        b = np.flip(np.squeeze(M2 @ b1 + b2))

        if blur_ij is None:
            blur_ij = self.flags.get("blur_ij", 0)

        img = np.asarray(img, dtype=float)
        if blur_ij > 0:
            img = gaussian_filter(img, (blur_ij, blur_ij), truncate=2)
        img = np.abs(img)

        target = np.abs(affine_transform(
            input=img, matrix=M, offset=b, output_shape=self.shape, order=order,
            mode="constant", cval=np.nan,
        ))
        norm = Hologram._norm(target)
        if norm == 0:
            raise ValueError(
                "No power in hologram. Maybe target_ij is out of range of knm space?"
            )
        target = (target / norm).astype(self.dtype)

        if out is not None:
            np.copyto(out, target)
            return out
        return target

    # ------------------------------------------------------------------
    # Measurement.
    # ------------------------------------------------------------------

    def measure(self, basis="ij"):
        """
        Ensure a feedback image is cached: write the hologram's phase to
        the SLM, settle, grab a camera image, and store its amplitude
        (the square root) in :attr:`img_ij` and, for ``basis="knm"``,
        resampled into :attr:`img_knm`.
        """
        if basis not in ("ij", "knm"):
            raise ValueError(f"Unrecognized basis '{basis}'. Options: 'ij', 'knm'.")
        if self.img_ij is None:
            if self.cameraslm is None:
                raise RuntimeError("measure() requires a cameraslm.")
            self.cameraslm.slm.set_phase(
                self.get_phase(include_propagation=True), settle=True
            )
            self.cameraslm.cam.flush()
            self.img_ij = np.asarray(self.cameraslm.cam.get_image(), dtype=self.dtype)
            if basis == "knm":
                self.img_knm = np.sqrt(self.ijcam_to_knmslm(self.img_ij, out=self.img_knm))
            else:
                self.img_knm = None
            self.img_ij = np.sqrt(self.img_ij)
        elif basis == "knm" and self.img_knm is None:
            self.img_knm = np.sqrt(self.ijcam_to_knmslm(np.square(self.img_ij)))

    def _midloop_cleaning(self):
        self.img_ij = None
        self.img_knm = None

    # ------------------------------------------------------------------
    # Target update.
    # ------------------------------------------------------------------

    def update_target(self, new_target_ij, null_region=None, null_region_radius_frac=None,
                      reset_weights=False):
        """
        Set a new camera-basis target: resampled into the computational
        basis, nan (free) outside the camera's field, except that it is 0
        there everywhere when ``null_region_radius_frac`` is None or >= 1,
        and else in ``null_region`` (a boolean plane, or none) and outside
        the ellipse of that fraction of the plane.
        """
        self.target_ij = np.asarray(new_target_ij, self.dtype)
        self.target = self.ijcam_to_knmslm(new_target_ij, order=0)

        undefined = np.isnan(self.target)
        if null_region_radius_frac is None:
            null_region_radius_frac = 1

        if null_region_radius_frac < 1:
            if null_region is None:
                null_region = np.zeros(self.shape, dtype=bool)
            xg, yg = np.meshgrid(
                np.linspace(-1, 1, null_region.shape[1]),
                np.linspace(-1, 1, null_region.shape[0]),
            )
            null_region[np.square(xg) + np.square(yg) > null_region_radius_frac**2] = True
            self.target[np.logical_and(undefined, null_region)] = 0
        else:
            self.target[undefined] = 0

        if reset_weights:
            self.reset_weights()

    def refine_offset(self, img, basis="kxy"):
        """Not implemented for image holograms, as in the JAX package."""
        raise NotImplementedError()

    # ------------------------------------------------------------------
    # Weighting and stats.
    # ------------------------------------------------------------------

    def _update_weights(self):
        feedback = self.flags["feedback"]
        if feedback == "computational":
            super()._update_weights()
        elif feedback == "experimental":
            self.measure("knm")
            self.weights = self._updated_weights(
                torch.as_tensor(self.img_knm, dtype=torch.float32, device=self.device),
                self._target_device(),
            )

    def _populate_stats(self, stats, stat_groups):
        super()._populate_stats(stats, stat_groups)
        raw = bool(self.flags.get("raw_stats"))
        if "experimental_knm" in stat_groups:
            self.measure("knm")
            stats["experimental_knm"] = self._calculate_stats(
                self.img_knm, np.asarray(self.target), efficiency_compensation=True, raw=raw
            )
        if "experimental_ij" in stat_groups or "experimental" in stat_groups:
            self.measure("ij")
            stats["experimental_ij"] = self._calculate_stats(
                self.img_ij, self.target_ij, efficiency_compensation=True, raw=raw
            )
