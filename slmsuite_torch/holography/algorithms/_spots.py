r"""
Optical focus arrays (port of :mod:`slmsuite_tpu.holography.algorithms._spots`):
:class:`SpotHologram` (DFT grid based) and :class:`CompressedSpotHologram`
(grid-free, in a Zernike basis).

:class:`SpotHologram` covers spots given in the computational ``"knm"``
basis, in ``"kxy"`` (with an SLM or CameraSLM) or in camera pixels
``"ij"`` (with a Fourier-calibrated CameraSLM), on padded or unpadded
farfields, with MRAF null regions (``null_vectors``, ``null_radius``,
``null_region``, ``null_region_radius_frac``), optimized on the device
engine with ``computational`` or spot-integrated ``computational_spot``
feedback, or with ``experimental_spot`` feedback from a simulated rig's
camera, measured inside the loop on the device. A rig the device
measurement does not model (real hardware, noise, averaging, an
orientation transform), amplitudes the user measures elsewhere
(``"external_spot"``) and callbacks run the stepwise host loop.
:meth:`refine_offset` centers the spots on their camera windows.

:class:`CompressedSpotHologram` takes a bare SLM or a CameraSLM (whose
Fourier calibration gives the spots' camera positions ``spot_ij`` and
integration width) and runs the compressed engine
(:mod:`slmsuite_torch.ops.compressed`) with ``computational_spot``
feedback; callbacks, ``"external_spot"`` and ``"experimental_spot"``
(camera) feedback, camera stats and MRAF with ``zero_factor`` run its
host-paced loop (:meth:`CompressedSpotHologram._stepwise_compressed`) on
the same transforms; ``"CG"`` differentiates through
:class:`slmsuite_torch.ops.grad.CompressedOverlap` (the ``n2f`` kernel
forward, ``f2n`` backward). ``optimize(mesh=...)`` cuts the pixels over the
mesh (:mod:`slmsuite_torch.parallel.compressed`).
"""

import dataclasses
import os
import warnings

import numpy as np
import torch

from slmsuite_torch.holography import analysis, toolbox
from slmsuite_torch.holography.algorithms._feedback import FeedbackHologram
from slmsuite_torch.holography.algorithms._hologram import (
    Hologram,
    _default_cg_loss,
    _download,
    _upload,
)
from slmsuite_torch.holography.toolbox import REAL_TYPES, format_2vectors
from slmsuite_torch.holography.toolbox import phase as _tphase
from slmsuite_torch.misc import profile as _profile
from slmsuite_torch.misc.host import as_numpy
from slmsuite_torch.ops import compressed as _comp
from slmsuite_torch.ops import engine as _engine
from slmsuite_torch.ops import grad as _grad
from slmsuite_torch.ops import propagation as _prop
from slmsuite_torch.ops.weights import update_weights_generic

class _AbstractSpotHologram(FeedbackHologram):
    """Shared spot logic: no vortex removal, the simulated rig's
    measurement on the device, and the camera and external spot
    statistics."""

    #: Subclasses whose psi is a (slm_shape) folded DFT phase opt in to
    #: the simulated rig's device measurement (the compressed hologram's
    #: psi has no fold).
    _sim_fast_path = False

    #: The last one-shot device measurement (cleared by
    #: :meth:`_midloop_cleaning`).
    _sim_powers_value = None

    def remove_vortices(self):
        """Spot holograms do not need to consider vortices."""

    def _midloop_cleaning(self):
        super()._midloop_cleaning()
        self._sim_powers_value = None

    # ------------------------------------------------------------------
    # The simulated rig's closed loop on the device.
    # ------------------------------------------------------------------

    def _sim_engine_inputs(self):
        """
        Whether the rig qualifies for the device measurement
        :meth:`slmsuite_torch.ops.engine.sim_measure_spots`, and its
        ingredients: ``(consts, statics)``, the device tensors that do not
        change in the loop and the static keyword arguments (without the
        dynamic ``sim_scale``). None when the rig does not qualify: real
        hardware, a noise model, an orientation transform, averaging or
        HDR, a bit depth that is no power of two, or an integration window
        off the frame.
        """
        if not self._sim_fast_path:
            return None
        cs = self.cameraslm
        if cs is None or not hasattr(cs, "cam") or not hasattr(cs, "slm"):
            return None
        from slmsuite_torch.hardware.cameras.simulated import SimulatedCamera
        from slmsuite_torch.hardware.slms.simulated import SimulatedSLM

        cam, slm = cs.cam, cs.slm
        if not (isinstance(cam, SimulatedCamera) and isinstance(slm, SimulatedSLM)):
            return None
        if cam.noise is not None or cam.averaging is not None or cam.hdr is not None:
            return None
        if slm.phase_scaling != 1 or (slm.bitresolution & (slm.bitresolution - 1)):
            return None
        if not getattr(cam, "_interpolate", False) or not hasattr(cam, "_hologram"):
            return None
        probe = np.arange(6, dtype=float).reshape(2, 3)
        if not np.array_equal(cam.transform(probe), probe):
            return None
        if getattr(self, "spot_ij", None) is None or self.spot_integration_width_ij is None:
            return None

        # The key: identity and content fingerprint of every input array.
        # Identity alone misses an in-place edit (a wavefront calibration
        # updates ``slm.source["phase"]`` in place), and a freed array's
        # address can be taken by its replacement, so the cache entry also
        # holds the keyed arrays.
        keyed_arrays = (
            self.spot_ij, cam.knm_cam,
            slm.source.get("amplitude_sim"), slm.source.get("phase_sim"),
            slm.source.get("phase"), self.propagation_kernel,
        )
        key = tuple(
            (id(a), self._host_fingerprint(a)) for a in keyed_arrays
        ) + (int(self.spot_integration_width_ij), str(self.device))
        cached = getattr(self, "_sim_inputs_cache", None)
        if cached is not None and cached[0] == key:
            return cached[2]

        slm_shape = tuple(slm.shape)
        # Unfold the hologram's folded phase, fold for the camera's canvas.
        y0h, _, x0h, _ = _prop.pad_window_slices(tuple(self.shape), slm_shape)
        cb_holo = _prop.checkerboard(slm_shape, (y0h, x0h))
        shape_padded = tuple(int(v) for v in cam.shape_padded)
        y0c, _, x0c, _ = _prop.pad_window_slices(shape_padded, slm_shape)
        cb_cam = _prop.checkerboard(slm_shape, (y0c, x0c))

        # One sum before quantization (minus the hologram's fold, plus the
        # propagation kernel and the hardware correction) and one after
        # (the simulated aberration plus the camera canvas's fold).
        pre = -np.asarray(cb_holo, np.float32)
        if self.propagation_kernel is not None:
            pre = pre + np.asarray(self.propagation_kernel, np.float32)
        correction = slm.source.get("phase")
        if correction is not None:
            pre = pre + np.asarray(correction, np.float32)
        post = np.asarray(slm.source["phase_sim"], np.float32) + np.asarray(
            cb_cam, np.float32
        )

        flat_cam, valid_cam = cam._sample_maps()

        # Spot windows: the index math of `analysis.take` (floored anchors,
        # floored centered edges). A window off the frame disqualifies the
        # rig (the host path would raise there).
        width = int(self.spot_integration_width_ij)
        vectors = np.floor(np.asarray(self.spot_ij)).astype(int)
        edge = np.floor(analysis._coordinates(width, True)).astype(int)
        rx, ry = np.meshgrid(edge, edge)
        ix = rx.ravel()[None, :] + vectors[0][:, None]
        iy = ry.ravel()[None, :] + vectors[1][:, None]
        cam_shape = tuple(cam.shape)
        if (
            (ix < 0).any() or (ix >= cam_shape[1]).any()
            or (iy < 0).any() or (iy >= cam_shape[0]).any()
        ):
            return None

        def dev(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

        consts = {
            "sim_pre": dev(pre),
            "sim_post": dev(post),
            "sim_amp": dev(np.asarray(slm.source["amplitude_sim"], np.float32)),
            "sim_flat_cam": dev(flat_cam.ravel(), torch.int64),
            "sim_valid_cam": dev(valid_cam.ravel()),
            "sim_spot_flat": dev(iy * cam_shape[1] + ix, torch.int64),
        }
        statics = {
            "bitres": float(slm.bitresolution),
            "cam_sat": float(cam.bitresolution - 1),
            # The host camera casts counts to its dtype.
            "truncates": bool(np.issubdtype(np.dtype(cam.dtype), np.integer)),
            "shape_padded": shape_padded,
        }
        self._sim_inputs_cache = (key, keyed_arrays, (consts, statics))
        return consts, statics

    def _sim_scale(self):
        """The simulated camera's exposure scaling (a 0-d device tensor)."""
        cam = self.cameraslm.cam
        return torch.tensor(
            float(np.float32(cam.exposure_s * cam.gain)), dtype=torch.float32,
            device=self.device,
        )

    def _sim_composite(self):
        """``run(psi) -> (spot powers, total)`` on the device, or None when
        the rig does not qualify (see :meth:`_sim_engine_inputs`)."""
        inputs = self._sim_engine_inputs()
        if inputs is None:
            return None
        consts, statics = inputs

        def run(psi):
            return _engine.sim_measure_spots(
                psi, {**consts, "sim_scale": self._sim_scale()}, **statics
            )

        return run

    def _sim_spot_powers(self):
        """
        The simulated rig's measurement of the current phase in one device
        pass: ``(spot_powers (N,), total)`` on the host, or None when the
        rig does not qualify. Unlike :meth:`measure` it does not write the
        phase to the SLM's display.
        """
        if self._sim_powers_value is not None:
            return self._sim_powers_value
        run = self._sim_composite()
        if run is None:
            return None
        spots, total = run(type(self)._psi.device(self, self.device))
        packed = torch.cat([spots, total[None]]).cpu().numpy()
        self._sim_powers_value = (packed[:-1], float(packed[-1]))
        return self._sim_powers_value

    def refine_offset(self, img=None, basis="kxy", force_affine=True, plot=False):
        """
        Hone the spot positions toward their targets: the centroid of each
        spot's background-removed camera window (``img``, or a measurement
        of the current phase), optionally through the affine fit of all
        of them (``force_affine``), shifts the k-space targets (``basis``
        ``"kxy"`` or ``"knm"``, which resets the weights of a
        :class:`SpotHologram` and moves the tilt and focus coefficients of
        a :class:`CompressedSpotHologram`) or the camera windows
        (``"ij"``); None shifts nothing. ``plot`` shows the image with the
        refined positions. Returns the ``(2, N)`` shifts in camera pixels.
        """
        if self.spot_integration_width_ij is None:
            raise ValueError(
                "hologram.spot_integration_width_ij must be set to use refine_offset()."
            )

        if img is None:
            self.measure(basis="ij")
            img = self.img_ij

        regions = analysis.take(
            img, self.spot_ij, self.spot_integration_width_ij, centered=True, integrate=False
        )
        regions = analysis.image_remove_field(regions, deviations=None, out=regions)
        shift_vectors = analysis.image_positions(regions)

        if force_affine:
            affine = analysis.fit_affine(
                self.spot_ij[[0, 1]], self.spot_ij[[0, 1]] + shift_vectors
            )
            shift_vectors = (
                affine["M"] @ self.spot_ij[[0, 1]] + affine["b"]
            ) - self.spot_ij[[0, 1]]

        if plot:
            import matplotlib.pyplot as plt

            plt.imshow(as_numpy(img))
            sv = self.spot_ij[[0, 1]] + shift_vectors
            plt.scatter(sv[0, :], sv[1, :], s=200, fc="none", ec="r")
            plt.title("Refine Offset")
            plt.show()

        if basis is None:
            return shift_vectors
        if basis in ("kxy", "knm"):
            self.spot_kxy = self.spot_kxy.astype(float)
            self.spot_kxy[[0, 1]] = self.spot_kxy[[0, 1]] - (
                self.cameraslm.ijcam_to_kxyslm(shift_vectors)
                - self.cameraslm.ijcam_to_kxyslm((0, 0))
            )
            if getattr(self, "spot_knm", None) is not None:
                self.spot_knm = toolbox.convert_vector(
                    self.spot_kxy, "kxy", "knm", hardware=self.cameraslm.slm,
                    shape=self.shape,
                )
                self.set_target(reset_weights=True)
            if hasattr(self, "spot_zernike"):
                self.spot_zernike[self.zernike_basis_cartesian, :] = toolbox.convert_vector(
                    self.spot_kxy, "kxy", "zernike", hardware=self.cameraslm.slm,
                    shape=self.shape,
                )
        elif basis == "ij":
            self.spot_ij = self.spot_ij + shift_vectors
        else:
            raise ValueError(f"Unrecognized basis '{basis}'.")
        return shift_vectors

    def _populate_stats(self, stats, stat_groups):
        super()._populate_stats(stats, stat_groups)
        if "experimental_spot" in stat_groups:
            fast = self._sim_spot_powers()
            if fast is not None:
                pwr_feedback, total = fast
            else:
                self.measure(basis="ij")
                pwr_img = np.square(self.img_ij)
                pwr_feedback = analysis.take(
                    pwr_img, self.spot_ij, self.spot_integration_width_ij,
                    centered=True, integrate=True,
                )
                total = np.sum(pwr_img)
            stats["experimental_spot"] = self._calculate_stats(
                np.sqrt(pwr_feedback),
                self.spot_amp,
                efficiency_compensation=False,
                total=total,
                raw=bool(self.flags.get("raw_stats")),
            )
        if "external_spot" in stat_groups:
            pwr_feedback = np.square(np.asarray(self.external_spot_amp, dtype=self.dtype))
            stats["external_spot"] = self._calculate_stats(
                np.sqrt(pwr_feedback),
                self.spot_amp,
                efficiency_compensation=False,
                total=np.sum(pwr_feedback),
                raw=bool(self.flags.get("raw_stats")),
            )


class SpotHologram(_AbstractSpotHologram):
    """
    DFT-based optical focus arrays: N spots tracked in the ``"knm"``
    (computational), ``"kxy"`` (normalized k-space) and ``"ij"`` (camera)
    bases, with per-spot amplitude targets and spot-integrated feedback.
    """

    _sim_fast_path = True

    def __init__(
        self,
        shape,
        spot_vectors,
        basis="kxy",
        spot_amp=None,
        cameraslm=None,
        null_vectors=None,
        null_radius=None,
        null_region=None,
        null_region_radius_frac=None,
        **kwargs,
    ):
        """
        Initialize a spot hologram from ``(2, N)`` spot vectors in the
        given ``basis``: ``"kxy"`` (the default; needs a ``cameraslm`` or
        SLM), ``"knm"`` (computational pixels) or ``"ij"`` (camera pixels;
        needs a Fourier-calibrated ``cameraslm``). ``null_vectors`` (in
        ``basis``) make the target's background free (MRAF), with zero
        discs of ``null_radius`` around them and the spots (a quarter of
        the smallest distance by default); ``null_region`` (a boolean
        plane, in the ``"knm"`` or ``"ij"`` basis) and
        ``null_region_radius_frac`` (outside that fraction of the plane's
        ellipse) mark zero regions.
        """
        vectors = format_2vectors(spot_vectors)
        N = vectors.shape[1]

        if spot_amp is not None:
            self.spot_amp = np.ravel(spot_amp)
            if len(self.spot_amp) != N:
                raise ValueError("spot_amp must have the same length as the spots.")
        else:
            self.spot_amp = np.full(N, 1.0 / np.sqrt(N))
        self.external_spot_amp = np.copy(self.spot_amp)

        if null_vectors is not None:
            null_vectors = format_2vectors(null_vectors)
        self.null_knm = None
        self.null_radius_knm = None
        self.null_region_knm = None

        calibrated = "fourier" in getattr(cameraslm, "calibrations", {})
        if basis is None or basis == "knm":
            self.spot_knm = vectors
            if cameraslm is not None:
                self.spot_kxy = toolbox.convert_vector(
                    self.spot_knm, "knm", "kxy", hardware=cameraslm, shape=shape
                )
                self.spot_ij = cameraslm.kxyslm_to_ijcam(self.spot_kxy) if calibrated else None
            else:
                self.spot_kxy = None
                self.spot_ij = None
            self.null_knm = null_vectors
            self.null_radius_knm = null_radius
            self.null_region_knm = null_region
        elif basis == "kxy":
            if cameraslm is None:
                raise ValueError("A cameraslm (or SLM) is needed to interpret kxy.")
            self.spot_kxy = vectors
            self.spot_ij = cameraslm.kxyslm_to_ijcam(vectors) if calibrated else None
            self.spot_knm = toolbox.convert_vector(
                vectors, "kxy", "knm", hardware=cameraslm, shape=shape
            )
        elif basis == "ij":
            if cameraslm is None or not calibrated:
                raise ValueError("A Fourier-calibrated cameraslm is needed for ij.")
            self.spot_ij = vectors
            self.spot_kxy = cameraslm.ijcam_to_kxyslm(vectors)
            self.spot_knm = toolbox.convert_vector(
                vectors, "ij", "knm", hardware=cameraslm, shape=shape
            )
        else:
            raise ValueError(f"Unrecognized basis for spots '{basis}'.")

        if basis in ("ij", "kxy") and null_vectors is not None:
            self.null_knm = toolbox.convert_vector(
                null_vectors, basis, "knm", hardware=cameraslm, shape=shape
            )
            if null_radius is not None:
                self.null_radius_knm = toolbox.convert_radius(
                    null_radius, basis, "knm", hardware=cameraslm, shape=shape
                )

        # Point spread functions and integration widths.
        if cameraslm is not None and hasattr(cameraslm, "slm"):
            psf_kxy = np.mean(cameraslm.slm.get_spot_radius_kxy())
            psf_knm = toolbox.convert_radius(psf_kxy, "kxy", "knm", cameraslm.slm, shape)
            psf_ij = toolbox.convert_radius(psf_kxy, "kxy", "ij", cameraslm, shape)
        else:
            psf_knm = 0
            psf_ij = np.nan
        psf_knm = 0 if np.isnan(psf_knm) else psf_knm
        psf_ij = 0 if np.isnan(psf_ij) else psf_ij

        # Integration width: 10x the psf clipped to [3, spot spacing / 1.5]
        # and made odd.
        N_psf, min_psf = 10, 3
        dist_knm = np.max([toolbox.smallest_distance(self.spot_knm) / 1.5, min_psf])
        width = np.clip(N_psf * psf_knm, min_psf, dist_knm)
        self.spot_integration_width_knm = int(2 * np.floor(width / 2) + 1)

        if self.spot_ij is not None:
            dist_ij = np.max([toolbox.smallest_distance(self.spot_ij) / 1.5, min_psf])
            width = np.clip(N_psf * psf_ij, min_psf, dist_ij)
            self.spot_integration_width_ij = int(2 * np.floor(width / 2) + 1)
        else:
            self.spot_integration_width_ij = None

        if (
            np.any(self.spot_knm[0] < 0)
            or np.any(self.spot_knm[1] < 0)
            or np.any(self.spot_knm[0] >= shape[1])
            or np.any(self.spot_knm[1] >= shape[0])
        ):
            raise ValueError(
                f"Spots outside SLM computational space bounds!\n"
                f"Spots:\n{self.spot_knm}\nBounds: {shape}"
            )

        if self.spot_ij is not None:
            cam_shape = cameraslm.cam.shape
            half = self.spot_integration_width_ij / 2
            if (
                np.any(self.spot_ij[0] < half)
                or np.any(self.spot_ij[1] < half)
                or np.any(self.spot_ij[0] >= cam_shape[1] - half)
                or np.any(self.spot_ij[1] >= cam_shape[0] - half)
            ):
                raise ValueError(
                    f"Spots outside camera bounds!\nSpots:\n{self.spot_ij}\n"
                    f"Bounds: {cam_shape}"
                )

        if self.null_knm is not None:
            if self.null_radius_knm is None:
                all_spots = np.hstack((self.null_knm, self.spot_knm))
                self.null_radius_knm = toolbox.smallest_distance(all_spots) / 4
            self.null_radius_knm = int(np.ceil(self.null_radius_knm))

        super().__init__(shape, target_ij=None, cameraslm=cameraslm, **kwargs)

        if basis == "ij" and null_region is not None:
            self.null_region_knm = self.ijcam_to_knmslm(null_region, order=0) != 0
        if null_region_radius_frac is not None:
            if self.null_region_knm is None:
                self.null_region_knm = np.zeros(self.shape, dtype=bool)
            xg, yg = np.meshgrid(
                np.linspace(-1, 1, self.null_region_knm.shape[1]),
                np.linspace(-1, 1, self.null_region_knm.shape[0]),
            )
            self.null_region_knm[
                np.square(xg) + np.square(yg) > null_region_radius_frac**2
            ] = True

        self.set_target(reset_weights=True)

    def __len__(self):
        """Number of spots."""
        return self.spot_knm.shape[1]

    @staticmethod
    def make_rectangular_array(
        shape,
        array_shape,
        array_pitch,
        array_center=None,
        basis="knm",
        orientation_check=False,
        **kwargs,
    ):
        """
        A rectangular array of ``array_shape`` spots at ``array_pitch``
        spacing about ``array_center`` (the zeroth order in ``basis`` by
        default). ``orientation_check`` removes the last two spots.
        """
        if isinstance(array_shape, REAL_TYPES):
            array_shape = (int(array_shape), int(array_shape))
        if isinstance(array_pitch, REAL_TYPES):
            array_pitch = (array_pitch, array_pitch)
        if array_center is None:
            if basis == "knm":
                array_center = (shape[1] / 2.0, shape[0] / 2.0)
            elif basis == "kxy":
                array_center = (0, 0)
            elif basis == "ij":
                cameraslm = kwargs.get("cameraslm")
                if cameraslm is None or "fourier" not in cameraslm.calibrations:
                    raise ValueError("A Fourier-calibrated cameraslm is needed for ij.")
                array_center = toolbox.convert_vector(
                    (0, 0), "kxy", "ij", hardware=cameraslm
                )

        x_edge, y_edge = (
            (np.arange(array_shape[a]) - (array_shape[a] - 1) / 2.0) * array_pitch[a]
            + array_center[a]
            for a in (0, 1)
        )

        x_grid, y_grid = np.meshgrid(x_edge, y_edge)
        x_list, y_list = x_grid.ravel(), y_grid.ravel()

        if orientation_check and len(x_list) > 2:
            x_list = x_list[:-2]
            y_list = y_list[:-2]

        return SpotHologram(
            shape, np.vstack((x_list, y_list)), basis=basis, spot_amp=None, **kwargs
        )

    def _set_target_spots(self, reset_weights=False):
        """Scatter the spot amplitudes (and the null regions) into the
        target plane."""
        self.spot_knm_rounded = np.rint(self.spot_knm).astype(int)

        if self.cameraslm is not None:
            self.spot_kxy_rounded = toolbox.convert_vector(
                self.spot_knm_rounded, "knm", "kxy",
                hardware=self.cameraslm.slm, shape=self.shape,
            )
            if "fourier" in self.cameraslm.calibrations:
                self.spot_ij_rounded = self.cameraslm.kxyslm_to_ijcam(self.spot_kxy_rounded)
            else:
                self.spot_ij_rounded = None
        else:
            self.spot_kxy_rounded = None
            self.spot_ij_rounded = None

        if self.target is None:
            self.target = np.zeros(self.shape, dtype=self.dtype)

        # MRAF (a nan background) comes only with null vectors; a null
        # region alone leaves the zero fill, as in the JAX package.
        if self.null_knm is None:
            self.target.fill(0)
        else:
            self.target.fill(np.nan)
            if self.null_region_knm is not None:
                self.target[self.null_region_knm] = 0
            all_spots = np.hstack((self.null_knm, self.spot_knm))
            w = int(2 * self.null_radius_knm + 1)
            for ii in range(all_spots.shape[1]):
                toolbox.imprint(
                    self.target,
                    (np.rint(all_spots[0, ii]), w, np.rint(all_spots[1, ii]), w),
                    0, centered=True, circular=True,
                )
        self.target[self.spot_knm_rounded[1, :], self.spot_knm_rounded[0, :]] = self.spot_amp
        self.target /= Hologram._norm(self.target)
        # Edited in place: a sampled fingerprint could miss the change.
        self.__dict__.get("_dev_cache", {}).pop("target", None)

        if reset_weights:
            self.reset_weights()

    def set_target(self, new_target=None, reset_weights=False, plot=False):
        """Update the target from the current :attr:`spot_knm` positions.
        ``plot`` is taken for the signature's sake and draws nothing, as in
        the JAX package."""
        del new_target, plot  # The target is derived from the spot positions.
        self._set_target_spots(reset_weights=reset_weights)

    # ------------------------------------------------------------------
    # Engine hooks: spot feedback inside the loop.
    # ------------------------------------------------------------------

    @property
    def _spot_single_px(self):
        return tuple(self.shape) == tuple(self.slm_shape)

    def _engine_feedback(self):
        feedback = self.flags.get("feedback", "computational")
        if feedback in ("computational", "computational_spot"):
            return feedback
        if feedback == "experimental_spot" and self._sim_engine_inputs() is not None:
            # A simulated rig that the device measurement models exactly:
            # the whole camera-in-the-loop iteration runs on the device.
            return "experimental_spot_sim"
        return "external_spot"  # The host loop updates the weights.

    def _device_stat_groups(self):
        allowed = {"computational", "computational_spot"}
        if self._sim_engine_inputs() is not None:
            allowed.add("experimental_spot")
        return tuple(g for g in self.flags.get("stat_groups", []) if g in allowed)

    def _stats_pending_groups(self):
        pending = super()._stats_pending_groups()
        if self._sim_engine_inputs() is not None:
            # The loop computes the measured spot stats on the device.
            pending = [g for g in pending if g != "experimental_spot"]
        return pending

    def _amend_config(self, config):
        config = super()._amend_config(config)
        if _engine._needs_sim_measure(config):
            _, statics = self._sim_engine_inputs()
            config = dataclasses.replace(
                config,
                sim_bitres=statics["bitres"],
                sim_cam_sat=statics["cam_sat"],
                sim_truncates=statics["truncates"],
                sim_shape_padded=tuple(statics["shape_padded"]),
            )
        return config

    def _extend_consts(self, consts, config):
        needs_spots = (
            config.feedback == "computational_spot"
            or "computational_spot" in config.stat_groups
        )
        needs_sim = _engine._needs_sim_measure(config)
        if not (needs_spots or needs_sim):
            return
        # Gather maps: stats use the raw (floored) spot positions, weight
        # updates the rounded spot pixels.
        flat_idx, _ = _engine.spot_gather_indices(
            np.floor(self.spot_knm).astype(int),
            self.spot_integration_width_knm, self.shape,
        )
        weight_flat_idx, center_idx = _engine.spot_gather_indices(
            self.spot_knm_rounded, self.spot_integration_width_knm, self.shape
        )

        def index(x):
            return torch.as_tensor(x, dtype=torch.int64, device=self.device)

        consts["spot_flat_idx"] = index(flat_idx)
        consts["spot_weight_flat_idx"] = index(weight_flat_idx)
        consts["spot_center_idx"] = index(center_idx)
        consts["spot_amp"] = torch.as_tensor(
            np.asarray(self.spot_amp, np.float32), device=self.device
        )
        if needs_sim:
            sim_consts, _ = self._sim_engine_inputs()
            consts.update(sim_consts)
            consts["sim_scale"] = self._sim_scale()

    # ------------------------------------------------------------------
    # The host loop's weighting and stats.
    # ------------------------------------------------------------------

    def _update_weights(self):
        """The spot weights from the computed (``computational_spot``),
        camera-measured (``experimental_spot``) or given (``external_spot``)
        spot amplitudes; only the ``(N,)`` feedback crosses to the device,
        where the weights are updated at the rounded spot pixels."""
        feedback = self.flags["feedback"]
        if feedback == "experimental":
            warnings.warn(
                "SpotHologram feedback 'experimental' is interpreted as 'experimental_spot'"
            )
            feedback = self.flags["feedback"] = "experimental_spot"

        if feedback == "computational":
            super()._update_weights()
            return

        if feedback == "computational_spot":
            amp_feedback = np.sqrt(analysis.take(
                np.square(np.asarray(self.amp_ff)), self.spot_knm_rounded,
                self.spot_integration_width_knm, centered=True, integrate=True,
            ))
        elif feedback == "experimental_spot":
            fast = self._sim_spot_powers()
            if fast is not None:
                amp_feedback = np.sqrt(fast[0])
            else:
                self.measure(basis="ij")
                amp_feedback = np.sqrt(analysis.take(
                    np.square(np.asarray(self.img_ij, dtype=self.dtype)), self.spot_ij,
                    self.spot_integration_width_ij, centered=True, integrate=True,
                ))
        elif feedback == "external_spot":
            amp_feedback = self.external_spot_amp
        else:
            raise ValueError(f"Feedback '{feedback}' not recognized.")

        def dev(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        rows, cols = self.spot_knm_rounded[1, :], self.spot_knm_rounded[0, :]
        center = torch.as_tensor(rows * self.shape[1] + cols, device=self.device)
        weights = type(self).weights.device(self, self.device).clone(
            memory_format=torch.contiguous_format)
        flat = weights.view(-1)
        flat[center] = update_weights_generic(
            flat[center], dev(amp_feedback), dev(self.spot_amp), self.flags["method"],
            self.flags.get("feedback_exponent", 0.8), self.flags.get("feedback_factor", 0.1),
        )
        self.weights = weights

    def _populate_stats(self, stats, stat_groups):
        super()._populate_stats(stats, stat_groups)
        if "computational_spot" in stat_groups:
            amp_ff = np.asarray(self.amp_ff)
            if tuple(self.shape) == tuple(self.slm_shape):
                feedback = amp_ff[self.spot_knm_rounded[1, :], self.spot_knm_rounded[0, :]]
                total = np.sum(np.square(amp_ff))
            else:
                pwr_ff = np.square(amp_ff)
                feedback = np.sqrt(analysis.take(
                    pwr_ff, self.spot_knm, self.spot_integration_width_knm,
                    centered=True, integrate=True,
                ))
                total = np.sum(pwr_ff)
            stats["computational_spot"] = self._calculate_stats(
                feedback, self.spot_amp, efficiency_compensation=False, total=total,
                raw=bool(self.flags.get("raw_stats")),
            )


class CompressedSpotHologram(_AbstractSpotHologram):
    r"""
    Grid-free spot holography: the farfield is a length-``N`` complex
    vector, and the near/far transform is an explicit kernel in which each
    spot carries its own Zernike coefficients (3D position and
    aberrations). The loop runs on :mod:`slmsuite_torch.ops.compressed`:
    the CUDA kernels for a CUDA device, the plain versions for the CPU.

    Attributes
    ----------
    spot_zernike : numpy.ndarray
        ``(D, N)`` spot coefficients in the Zernike basis.
    zernike_basis : numpy.ndarray
        ANSI indices of the basis (``-1`` is the vortex waveplate).
    spot_kxy : numpy.ndarray
        ``(2, N)`` or ``(3, N)`` spot positions in ``"kxy"``.
    spot_ij : numpy.ndarray OR None
        Camera-basis positions (with a Fourier-calibrated CameraSLM).
    spot_integration_width_ij : int OR None
        The odd width of each spot's camera window: twice the camera-basis
        PSF radius, clipped to [3, the smallest spot distance / 1.5].
    """

    @_profile.spanned("hologram.init")
    def __init__(self, spot_vectors, basis="kxy", spot_amp=None, cameraslm=None, cuda=None,
                 **kwargs):
        """
        Initialize from ``(D, N)`` spot vectors in basis ``"kxy"`` (or
        another unit of :meth:`toolbox.convert_vector`: ``"ij"`` with a
        Fourier-calibrated CameraSLM), ``"zernike"``, or an explicit list
        of ANSI indices. ``cameraslm`` is an SLM or a CameraSLM, whose
        Fourier calibration places the spots on the camera (and raises for
        spots off it). ``cuda`` is kept for the JAX package's signature: the
        device decides the route (the kernels on a CUDA device, the plain
        versions on the CPU), and a ``cuda`` that contradicts it raises.
        """
        if cameraslm is None:
            raise ValueError("cameraslm must be passed.")

        spot_vectors = toolbox.format_vectors(spot_vectors, handle_dimension="pass")
        D, N = spot_vectors.shape
        if N == 0:
            raise ValueError("CompressedSpotHologram requires at least one spot.")

        if spot_amp is not None:
            self.spot_amp = np.asarray(spot_amp).ravel()
            if self.spot_amp.size != N:
                raise ValueError("spot_amp must have the same length as the spots.")
        else:
            self.spot_amp = np.full(N, 1.0 / np.sqrt(N))

        if isinstance(basis, str):
            self.zernike_basis = _tphase._zernike_indices_parse(None, D)
        else:
            self.zernike_basis = np.ravel(basis)
            basis = "zernike"
            if len(self.zernike_basis) != D:
                raise ValueError("zernike_basis must match the spot dimension.")
            if 0 in self.zernike_basis:
                warnings.warn(
                    "Found ANSI index '0' (piston) in the zernike_basis; "
                    "spot phase is controlled externally."
                )

        if not np.any(self.zernike_basis == 2) or not np.any(self.zernike_basis == 1):
            raise ValueError("Compressed basis must include x, y (ANSI indices 2, 1)")
        cartesian = [np.argwhere(self.zernike_basis == 2)[0],
                     np.argwhere(self.zernike_basis == 1)[0]]
        if np.any(self.zernike_basis == 4):
            cartesian.append(np.argwhere(self.zernike_basis == 4)[0])
        self.zernike_basis_cartesian = np.squeeze(cartesian)

        if basis == "zernike":
            self.spot_zernike = np.array(spot_vectors, dtype=float)
            self.spot_kxy = toolbox.convert_vector(
                spot_vectors[self.zernike_basis_cartesian, :], "zernike", "kxy",
                hardware=cameraslm,
            )
        else:
            self.spot_zernike = toolbox.convert_vector(
                spot_vectors, basis, "zernike", hardware=cameraslm
            )
            self.spot_kxy = toolbox.convert_vector(spot_vectors, basis, "kxy",
                                                   hardware=cameraslm)

        # A CameraSLM bounds the spots laterally by its SLM's farfield and,
        # when Fourier calibrated, places them on the camera.
        self.spot_ij = None
        psf_ij = 0
        if hasattr(cameraslm, "slm"):
            kmax = 1.0 / np.min(cameraslm.slm.pitch) / 2.0
            if np.any(np.abs(self.spot_kxy[:2, :]) > 1.1 * kmax):
                raise ValueError("Spots laterally outside the bounds of the farfield")
            if "fourier" in getattr(cameraslm, "calibrations", {}):
                self.spot_ij = cameraslm.kxyslm_to_ijcam(self.spot_kxy)
                psf_kxy = np.mean(cameraslm.slm.get_spot_radius_kxy())
                psf_ij = toolbox.convert_radius(psf_kxy, "kxy", "ij", cameraslm)
                if np.isnan(psf_ij):
                    psf_ij = 0

        self.spot_integration_width_ij = None
        if self.spot_ij is not None:
            min_psf = 3
            dist_ij = np.max([toolbox.smallest_distance(self.spot_ij) / 1.5, min_psf])
            if psf_ij > dist_ij:
                warnings.warn("The expected camera spot psf is too large; clipping.")
            width = np.clip(2 * psf_ij, 3, dist_ij)
            self.spot_integration_width_ij = int(2 * np.floor(width / 2) + 1)

            cam_shape = cameraslm.cam.shape
            half = self.spot_integration_width_ij / 2
            if (
                np.any(self.spot_ij[0] < half)
                or np.any(self.spot_ij[1] < half)
                or np.any(self.spot_ij[0] >= cam_shape[1] - half)
                or np.any(self.spot_ij[1] >= cam_shape[0] - half)
            ):
                raise ValueError(
                    f"Spots outside camera bounds!\nSpots:\n{self.spot_ij}\n"
                    f"Bounds: {cam_shape}"
                )

        super().__init__(shape=None, target_ij=None, cameraslm=cameraslm, **kwargs)
        self.shape = self.slm_shape

        self.set_target(new_target=self.spot_amp, reset_weights=True)
        self.reset()

        self.external_spot_amp = np.copy(self.spot_amp)

        slm = cameraslm.slm if hasattr(cameraslm, "slm") else cameraslm
        self._basis = _comp.build_zernike_basis(self.zernike_basis, slm)
        on_card = self.device.type == "cuda"
        if cuda is not None and bool(cuda) != on_card:
            raise ValueError(
                f"cuda={cuda} contradicts the device {self.device}: the device "
                "decides whether the CUDA kernels run."
            )
        self.cuda = on_card

    def __len__(self):
        return int(self.spot_amp.size)

    def get_padded_shape(self, *args, **kwargs):
        """Compressed holograms have no DFT grid and need no padding."""
        raise NameError(
            "CompressedSpotHologram does not use a DFT grid and does not need padding."
        )

    # ------------------------------------------------------------------
    # Target management.
    # ------------------------------------------------------------------

    def _set_target(self, new_target, reset_weights=False):
        if not hasattr(self, "spot_amp"):
            self.target = None
            return
        self.set_target(new_target, reset_weights)

    def set_target(self, new_target=None, reset_weights=False):
        """Set the ``(N,)`` spot-amplitude target (cleans and normalizes;
        nan marks an MRAF noise spot)."""
        if new_target is None:
            self.target = np.asarray(self.spot_amp, dtype=self.dtype)
        else:
            new_target = np.squeeze(np.asarray(new_target).ravel())
            if new_target.shape != (len(self),):
                raise ValueError("Target must have one amplitude per spot.")
            self.target = np.array(new_target, dtype=self.dtype)
            self.spot_amp = np.array(new_target, dtype=self.dtype)

        self.target = np.abs(self.target)
        self.target = self.target / Hologram._norm(self.target)

        if reset_weights:
            self.reset_weights()

    # ------------------------------------------------------------------
    # The phase is stored directly (no fold), flat on the device after a run.
    # ------------------------------------------------------------------

    @property
    def phase(self):
        psi = self._psi
        if psi is None:
            return None
        return np.asarray(psi, dtype=self.dtype).reshape(self.slm_shape)

    @phase.setter
    def phase(self, value):
        self._psi = None if value is None else np.asarray(value, dtype=self.dtype)

    @property
    def phase_ff(self):
        """(N,) farfield spot phases."""
        return self._phase_ff_folded

    @phase_ff.setter
    def phase_ff(self, value):
        self._phase_ff_folded = None if value is None else np.asarray(value)

    @property
    def farfield(self):
        """(N,) complex spot farfield."""
        if self.amp_ff is None:
            return None
        return np.asarray(self.amp_ff) * np.exp(1j * np.asarray(self._phase_ff_folded))

    def get_farfield(self, *args, **kwargs):
        """(N,) complex spot farfield from the current phase."""
        self._populate_results()
        return self.farfield

    # ------------------------------------------------------------------
    # Engine integration.
    # ------------------------------------------------------------------

    def _kernel_cache_enabled(self):
        """Whether the loop streams the cos/sin cache instead of recomputing
        the sincos: when the cache fits ``SLMSUITE_TORCH_COMPRESSED_CACHE_MB``
        (default 4096; ``0`` disables) and the spots fit ``fused_iter_cached``'s
        shared memory (:meth:`slmsuite_torch.ops.compressed.fused_iter_cached_ok`;
        past it the recomputing loop runs, on the CPU as on the card); off
        under a mesh (the pixel-sharded engine recomputes on each shard)."""
        if self._mesh is not None:
            return False
        try:
            budget_mb = float(os.environ.get("SLMSUITE_TORCH_COMPRESSED_CACHE_MB", 4096))
        except ValueError:
            budget_mb = 4096.0
        return _comp.fused_iter_cached_ok(len(self)) and _comp.kernel_cache_bytes(
            len(self), int(np.prod(self.slm_shape))) <= budget_mb * 1e6

    def _compressed_config(self, kernel_cache=False):
        return _comp.CompressedGSConfig(
            method=self.flags["method"],
            n_pixels=int(np.prod(self.slm_shape)),
            n_spots=len(self),
            stat_groups=tuple(
                g for g in self.flags.get("stat_groups", []) if g == "computational_spot"
            ),
            kim_efficiency_trigger=(
                "Kim" in self.flags["method"]
                and self.flags.get("fix_phase_efficiency") is not None
            ),
            mraf=self._mraf_enabled(),
            kernel_cache=kernel_cache,
        )

    def _compressed_consts(self, kernel_cache=False):
        device = self.device

        def dev(x, dtype=torch.float32):
            return _upload(np.asarray(x), device, dtype)

        held = self.__dict__.setdefault("_dev_scalars", {})

        def scalar(key, value, dtype=torch.float32):
            """A 0-d device constant, uploaded again only when its value
            changes: a call of the host loop then moves no constant."""
            token = repr((value, dtype))
            if key not in held or held[key][0] != token:
                held[key] = (token, dev(value, dtype))
            return held[key][1]

        amp = self.amp
        if np.isscalar(amp) or np.ndim(amp) == 0:
            amp_flat = float(amp)
        else:
            amp_flat = self._dev_const("amp", amp, lambda a: dev(np.ravel(a)))

        def target_pair(t):
            clean = np.nan_to_num(np.asarray(t, np.float32))
            return dev(clean), dev(clean != 0, torch.bool)

        target, stat_mask = self._dev_const("target", self.target, target_pair)
        consts = {
            "amp": amp_flat,
            "coeffs": self._dev_const("coeffs", self.spot_zernike, dev),
            "basis": self._dev_const("basis", self._basis, dev),
            "target": target,
            "stat_mask": stat_mask,
            "feedback_exponent": scalar("feedback_exponent",
                                        self.flags.get("feedback_exponent", 0.8)),
            "feedback_factor": scalar("feedback_factor", self.flags.get("feedback_factor", 0.1)),
            "fix_phase_iteration": scalar("fix_phase_iteration",
                                          self.flags.get("fix_phase_iteration", 10), torch.int32),
            "fix_phase_efficiency": scalar("fix_phase_efficiency",
                                           self.flags.get("fix_phase_efficiency") or np.nan),
        }
        if self._mraf_enabled():
            # nan spot_amp: noise spots (amplitude freedom); zeros: null spots.
            def masks(t):
                t = np.asarray(t, float)
                return (dev(~np.isnan(t) & (np.nan_to_num(t) > 0), torch.bool),
                        dev(np.isnan(t), torch.bool))

            consts["signal_mask"], consts["noise_mask"] = self._dev_const(
                "mraf_masks", self.target, masks)
            mraf_factor = self.flags.get("mraf_factor")
            consts["mraf_k"] = scalar("mraf_k", 1.0 if mraf_factor is None else mraf_factor)
        if kernel_cache:
            consts["kc_tiles"], consts["ks_tiles"] = self._kernel_cache_tiles(
                consts["coeffs"], consts["basis"]
            )
        return consts

    def _kernel_cache_tiles(self, coeffs_dev, basis_dev):
        """The device cos/sin cache, rebuilt only when the spot coefficients
        or the basis change (identity and fingerprint of both)."""
        spots, basis = self.spot_zernike, self._basis
        fp = (self._host_fingerprint(spots), self._host_fingerprint(basis))
        cached = self.__dict__.get("_kcache")
        if cached is not None and cached[0] is spots and cached[1] is basis and cached[2] == fp:
            return cached[3]
        tiles = _comp.build_kernel_cache(coeffs_dev, basis_dev)
        self._kcache = (spots, basis, fp, tiles)
        return tiles

    def _compressed_state(self):
        """The engine's state from the hologram (resident tensors are used
        as they are)."""
        device = self.device
        phase_ff = type(self)._phase_ff_folded.device(self, device)
        return _comp.CompressedGSState(
            psi=type(self)._psi.device(self, device).reshape(-1),
            weights=torch.nan_to_num(type(self).weights.device(self, device)),
            phase_ff=(phase_ff if phase_ff is not None
                      else torch.zeros(len(self), dtype=torch.float32, device=device)),
            fixed_phase=_upload(bool(self.flags.get("fixed_phase", False)), device),
            unfixed_streak=torch.zeros((), dtype=torch.int32, device=device),
            iteration=_upload(self.iter, device, torch.int32),
        )

    def optimize_gs(self, maxiter, callback, verbose=True, name=None):
        """Compressed GS/WGS on the engine, in chunks (progress reporting
        between chunks when ``verbose``), with one packed download at the
        end; a callback, ``"external_spot"`` or ``"experimental_spot"``
        feedback, host stats (the camera's among them) or MRAF with
        ``zero_factor`` (whose complex zero weights the engine does not
        carry) take the host-paced loop, one :meth:`_stepwise_compressed`
        per iteration."""
        if isinstance(maxiter, range):
            maxiter = len(maxiter)

        feedback = self.flags.get("feedback", "computational")
        if feedback == "computational":
            feedback = self.flags["feedback"] = "computational_spot"
        if feedback == "experimental":
            warnings.warn(
                "CompressedSpotHologram feedback 'experimental' is interpreted "
                "as 'experimental_spot'"
            )
            feedback = self.flags["feedback"] = "experimental_spot"

        host_loop = (
            callback is not None
            or bool(self._stats_pending_groups())
            or feedback in ("experimental_spot", "external_spot")
            or (bool(self.flags.get("zero_factor", 0)) and self._mraf_enabled())
        )
        if host_loop:
            self._warn_mesh_host_loop()
        with _profile.span("gs.setup"):
            config = self._compressed_config(
                kernel_cache=not host_loop and self._kernel_cache_enabled()
            )
            consts = self._compressed_consts(kernel_cache=config.kernel_cache)
            state = self._compressed_state()
        start_iter = self.iter
        progress = self._progress(maxiter, verbose, name)

        if host_loop:
            with _profile.span("gs.loop"):
                for _ in range(maxiter):
                    with _profile.span("gs.iter"):
                        state = self._stepwise_compressed(state, consts, config, callback)
                    if progress is not None:
                        progress.update(1)
                    if self._break_requested:
                        break
            if progress is not None:
                progress.close()
            with _profile.span("gs.finalize"):
                self._sync_compressed_state(state)
                self._populate_results()
            return

        mesh = self._mesh
        if mesh is not None and config.n_pixels % mesh.size:
            warnings.warn(
                f"mesh-sharded compressed optimization unavailable "
                f"(pixel count {config.n_pixels} must divide the "
                f"mesh ({mesh.size})); running on a single device."
            )
            mesh = None
        if mesh is not None:
            from slmsuite_torch.parallel.compressed import (
                run_sharded_compressed_gs,
                shard_compressed_consts,
            )

            axis = mesh.axis_names[0]
            shards = shard_compressed_consts(consts, mesh, axis)
        chunk = maxiter if not verbose else max(1, int(np.ceil(maxiter / 10)))
        all_stats = []
        remaining = maxiter
        while remaining > 0:
            n = min(chunk, remaining)
            if mesh is not None:
                state, stats = run_sharded_compressed_gs(config, state, shards, mesh, n, axis)
            else:
                state, stats = _comp.run_compressed_gs(config, state, consts, n)
            all_stats.append(stats)
            remaining -= n
            if progress is not None:
                progress.update(n)
        if progress is not None:
            progress.close()

        with _profile.span("gs.finalize"):
            self._finalize_scan_fused(state, all_stats, config, consts, start_iter)

    #: The evolving complex zero weights of the null spots (``zero_factor``
    #: MRAF in the host loop); kept across calls, as in the JAX package.
    _zero_weights_c = None

    def _stepwise_compressed(self, state, consts, config, callback):
        """
        One host-paced compressed iteration: the entry transform
        (:meth:`slmsuite_torch.ops.compressed.nearfield_to_farfield`, kernel
        ``n2f``) on the device and one download of the spot farfield and
        weights; the callback, stats and weight update on the host (a
        camera measures the iteration's phase, which the hologram adopts
        first); the
        constraint (with the per-spot MRAF mix and the ``zero_factor``
        weights) and the exit transform (:meth:`~slmsuite_torch.ops.
        compressed.farfield_to_nearfield`, kernel ``f2n``) on the device.
        Returns the next state (the same state when the callback stops).
        """
        self._break_requested = False
        N = len(self)
        ff_re, ff_im = _comp.nearfield_to_farfield(
            *_comp.nearfield(state.psi, consts["amp"]), consts["coeffs"], consts["basis"]
        )
        packed = _download(torch.cat([
            ff_re, ff_im, state.weights.to(torch.float32),
            state.iteration.to(torch.float32)[None],
        ]))
        ff_re_h, ff_im_h = packed[:N], packed[N:2 * N]
        self.amp_ff = np.sqrt(ff_re_h**2 + ff_im_h**2)
        theta = np.arctan2(ff_im_h, ff_re_h)
        # The phase the camera measures is this iteration's (the JAX
        # package's loop measures the phase the hologram held when
        # optimize() began).
        self._psi = state.psi.reshape(self.slm_shape)
        self._midloop_cleaning()
        self.weights = packed[2 * N:3 * N].copy()
        self.iter = int(packed[3 * N])

        if callback is not None and callback(self):
            self._break_requested = True
            return state
        self._update_stats(self.flags["stat_groups"])

        was_not_fixed = not self.flags.get("fixed_phase", False)
        if "WGS" in self.flags["method"] and self.iter > 0:
            self._update_weights()
            self._kim_decision_host()
        if was_not_fixed or not type(self)._phase_ff_folded.is_set(self):
            self._phase_ff_folded = theta

        def dev(x):
            return _upload(np.asarray(x, np.float32), self.device)

        weights = dev(np.nan_to_num(np.asarray(self.weights, np.float32)))
        phase_ff = dev(self._phase_ff_folded)
        ffp_re, ffp_im = weights * torch.cos(phase_ff), weights * torch.sin(phase_ff)
        if config.mraf:
            zero_re = zero_im = None
            zf = float(self.flags.get("zero_factor", 0) or 0)
            if zf:
                target = np.asarray(self.target, float)
                null = ~np.isnan(target) & ~(np.nan_to_num(target) > 0)
                if self._zero_weights_c is None:
                    self._zero_weights_c = np.zeros(N, np.complex64)
                fz = ff_re_h + 1j * ff_im_h
                self._zero_weights_c -= np.where(null, zf * np.abs(fz) * fz, 0).astype(
                    np.complex64)
                zero_re, zero_im = dev(self._zero_weights_c.real), dev(self._zero_weights_c.imag)
            ffp_re, ffp_im = _comp.apply_compressed_mraf_mix(
                ffp_re, ffp_im, ff_re, ff_im, consts, zero_re=zero_re, zero_im=zero_im
            )
        nfp_re, nfp_im = _comp.farfield_to_nearfield(
            ffp_re, ffp_im, consts["coeffs"], consts["basis"]
        )
        return _comp.CompressedGSState(
            psi=torch.atan2(nfp_im, nfp_re),
            weights=weights,
            phase_ff=phase_ff,
            fixed_phase=_upload(bool(self.flags.get("fixed_phase", False)), self.device),
            unfixed_streak=state.unfixed_streak,
            iteration=state.iteration + 1,
        )

    def _sync_compressed_state(self, state):
        """Adopt the host loop's final state (psi stays on the device; one
        download for the rest)."""
        N = len(self)
        packed = _download(torch.cat([
            state.weights.to(torch.float32), state.phase_ff.to(torch.float32),
            torch.stack([state.fixed_phase.to(torch.float32),
                         state.iteration.to(torch.float32)]),
        ]))
        self._psi = state.psi.reshape(self.slm_shape)
        self.weights = packed[:N].copy()
        self._phase_ff_folded = packed[N:2 * N].copy()
        self.flags["fixed_phase"] = self._final_fixed_phase = bool(packed[2 * N])
        self.iter = int(packed[2 * N + 1])

    def _finalize_scan_fused(self, state, all_stats, config, consts, start_iter):
        """Adopt the final state, the farfield of the final phase and the
        stats with ONE download: everything small is packed into one f32
        vector on the device. The phase stays on the device."""
        N = len(self)
        nf_re, nf_im = _comp.nearfield(state.psi, consts["amp"])
        ff_re, ff_im = _comp.nearfield_to_farfield(nf_re, nf_im, consts["coeffs"],
                                                   consts["basis"])
        stats = torch.cat(all_stats) if all_stats else None
        packed = _download(torch.cat([
            state.weights.to(torch.float32),
            torch.atan2(ff_im, ff_re),
            torch.sqrt(ff_re**2 + ff_im**2),
            torch.stack([state.fixed_phase.to(torch.float32),
                         state.iteration.to(torch.float32)]),
            *([] if stats is None else [stats.reshape(-1)]),
        ]))

        self._psi = state.psi.reshape(self.slm_shape)
        self.weights = packed[:N].copy()
        self._phase_ff_folded = packed[N:2 * N].copy()
        self._farfield_folded = None
        self.amp_ff = packed[2 * N:3 * N].copy()
        self.flags["fixed_phase"] = bool(packed[3 * N])
        self._final_fixed_phase = bool(packed[3 * N])
        self.iter = int(packed[3 * N + 1])
        if config.stat_groups and stats is not None:
            self._record_scan_stats(packed[3 * N + 2:].reshape(tuple(stats.shape)),
                                    start_iter)

    def _populate_results(self):
        """The (N,) farfield amplitude and phase of the current phase."""
        consts = self._compressed_consts()
        psi = type(self)._psi.device(self, self.device).reshape(-1)
        ff_re, ff_im = _comp.nearfield_to_farfield(
            *_comp.nearfield(psi, consts["amp"]), consts["coeffs"], consts["basis"]
        )
        self._farfield_folded = None
        self.amp_ff = _download(torch.sqrt(ff_re**2 + ff_im**2))
        self._phase_ff_folded = _download(torch.atan2(ff_im, ff_re))

    def _get_target_moments_knm_norm(self):
        """First/second moments of the spot ensemble in normalized knm
        (the quadratic initial phase; slmsuite_tpu _spots.py:1561)."""
        target = np.nan_to_num(np.asarray(self.target, dtype=float))
        target = target.reshape(1, -1, 1)

        spot_knm_norm = toolbox.convert_vector(
            self.spot_kxy[:2, :],
            from_units="kxy",
            to_units="knm",
            hardware=self.cameraslm,
            shape=(1, 1),
        )
        grid = (
            spot_knm_norm[0, :].reshape(-1, 1) - 0.5,
            spot_knm_norm[1, :].reshape(-1, 1) - 0.5,
        )
        center = analysis.image_positions(target, grid=grid, nansum=True)
        std = np.sqrt(
            analysis.image_variances(target, centers=center, grid=grid, nansum=True)[:2, 0]
        )
        return np.squeeze(center), np.squeeze(std)

    def _cg_objective(self):
        """``(psi, loss_from_psi)`` of gradient phase retrieval on the flat
        SLM phase through the compressed near->far transform
        (``slmsuite_tpu``'s ``optimize_cg``): ``nf = amp (cos psi, sin
        psi)``, :meth:`slmsuite_torch.ops.grad.compressed_farfield` (the
        ``n2f`` kernel forward, ``f2n`` backward, then the unit norm), then
        the loss against the unit-norm target. The default loss is the mean
        squared error of the unit-power spot amplitudes."""
        consts = self._compressed_consts()
        amp, coeffs, basis = consts["amp"], consts["coeffs"], consts["basis"]
        target = self._dev_const("cg_target", self.target, lambda t: _upload(
            np.asarray(t, np.float32), self.device))
        target = target / torch.sqrt(torch.sum(torch.square(target)))
        loss = self.flags.get("loss")
        if loss is None:
            loss = _default_cg_loss

        def loss_from_psi(psi):
            ff_re, ff_im = _grad.compressed_farfield(
                amp * torch.cos(psi), amp * torch.sin(psi), coeffs, basis)
            return loss(torch.complex(ff_re, ff_im), target)

        return type(self)._psi.device(self, self.device).reshape(-1), loss_from_psi

    def _adopt_cg_psi(self, psi):
        self._psi = psi.reshape(self.slm_shape)

    # ------------------------------------------------------------------
    # Weighting and stats.
    # ------------------------------------------------------------------

    def _update_weights(self):
        """The host loop's weight update (on the host: ``(N,)`` vectors)
        from the computed (``computational_spot``), given
        (``external_spot``) or measured (``experimental_spot``: the power
        in each spot's camera window) spot amplitudes."""
        feedback = self.flags["feedback"]
        if feedback == "computational":
            feedback = self.flags["feedback"] = "computational_spot"
        if feedback == "experimental":
            feedback = self.flags["feedback"] = "experimental_spot"

        if feedback == "computational_spot":
            amp_feedback = self.amp_ff
        elif feedback == "external_spot":
            amp_feedback = self.external_spot_amp
        elif feedback == "experimental_spot":
            self.measure(basis="ij")
            amp_feedback = np.sqrt(analysis.take(
                np.square(np.asarray(self.img_ij, dtype=self.dtype)), self.spot_ij,
                self.spot_integration_width_ij, centered=True, integrate=True,
            ))
        else:
            raise ValueError(f"Feedback '{feedback}' not recognized.")

        def host(x):
            return torch.as_tensor(np.nan_to_num(np.asarray(x, np.float32)))

        self.weights = update_weights_generic(
            host(self.weights), torch.as_tensor(np.asarray(amp_feedback, np.float32)),
            host(self.target), self.flags["method"],
            self.flags.get("feedback_exponent", 0.8), self.flags.get("feedback_factor", 0.1),
        ).numpy()

    def _populate_stats(self, stats, stat_groups):
        if "computational_spot" in stat_groups and self.amp_ff is not None:
            stats["computational_spot"] = self._calculate_stats(
                np.asarray(self.amp_ff),
                np.nan_to_num(np.asarray(self.target)),
                efficiency_compensation=False,
                raw=bool(self.flags.get("raw_stats")),
            )
        _AbstractSpotHologram._populate_stats(self, stats, stat_groups)
