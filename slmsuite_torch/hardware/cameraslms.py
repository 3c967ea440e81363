r"""
A camera paired with an SLM, and the Fourier calibration between them
(port of :mod:`slmsuite_tpu.hardware.cameraslms`).

:class:`FourierSLM` carries the ``"fourier"`` calibration (the affine
between the SLM's k-space and camera pixels): measured by projecting a
spot grid (:meth:`FourierSLM.fourier_calibrate`, which detects the grid
with OpenCV) or set analytically
(:meth:`FourierSLM.fourier_calibrate_analytic`), with the transforms and
the derived optics built on it, and HDF5 save and load. The wavefront,
pixel and settle calibrations, ``simulate()`` and ``load()`` are not
copied yet and raise :class:`NotImplementedError` (ROADMAP.md queue 1,
item 9).
"""

import os
import warnings

import numpy as np

from slmsuite_torch import __version__
from slmsuite_torch.hardware import _Picklable
from slmsuite_torch.hardware.cameras.simulated import SimulatedCamera
from slmsuite_torch.holography import analysis, toolbox
from slmsuite_torch.holography.algorithms import SpotHologram
from slmsuite_torch.holography.toolbox import format_2vectors, format_vectors
from slmsuite_torch.misc.files import generate_path, latest_path, load_h5, save_h5
from slmsuite_torch.misc.math import REAL_TYPES


class CameraSLM(_Picklable):
    """
    A :class:`Camera` and an :class:`SLM` paired for closed-loop feedback,
    with magnification ``mag`` between the camera and experiment planes.
    """

    _pickle = ["name", "cam", "slm", "mag"]
    _pickle_data = []

    def __init__(self, cam, slm, mag=1):
        if not hasattr(cam, "get_image"):
            raise ValueError(f"Expected Camera to be passed as cam. Found {type(cam)}")
        self.cam = cam
        if not hasattr(slm, "set_phase"):
            raise ValueError(f"Expected SLM to be passed as slm. Found {type(slm)}")
        self.slm = slm

        self.name = self.cam.name + "-" + self.slm.name
        self.mag = float(mag)
        self.calibrations = {}

    def close(self):
        """Close both pieces of hardware."""
        try:
            self.cam.close()
        finally:
            self.slm.close()


def _not_ported(name):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"FourierSLM.{name} is not ported yet (ROADMAP.md queue 1, item 9)."
        )

    method.__name__ = name
    method.__doc__ = f"``{name}`` of the JAX package; not ported yet."
    return method


class FourierSLM(CameraSLM):
    r"""
    An SLM and a camera separated by a Fourier transform, with the
    ``"fourier"`` calibration (the affine kxy <-> ij).
    """

    _pickle = ["name", "cam", "slm", "mag"]
    _pickle_data = ["calibrations"]

    simulate = _not_ported("simulate")
    load = _not_ported("load")
    settle_calibrate = _not_ported("settle_calibrate")
    settle_calibration_process = _not_ported("settle_calibration_process")
    pixel_calibrate = _not_ported("pixel_calibrate")
    pixel_calibration_process = _not_ported("pixel_calibration_process")
    wavefront_calibrate = _not_ported("wavefront_calibrate")
    wavefront_calibrate_zernike = _not_ported("wavefront_calibrate_zernike")
    wavefront_calibrate_superpixel = _not_ported("wavefront_calibrate_superpixel")
    wavefront_calibration_points = _not_ported("wavefront_calibration_points")
    wavefront_calibration_superpixel_process = _not_ported(
        "wavefront_calibration_superpixel_process"
    )
    wavefront_calibration_superpixel_window = _not_ported(
        "wavefront_calibration_superpixel_window"
    )
    wavefront_calibrate_zernike_smooth = _not_ported("wavefront_calibrate_zernike_smooth")
    pixel_kernel = _not_ported("pixel_kernel")
    write_calibration = _not_ported("write_calibration")
    read_calibration = _not_ported("read_calibration")

    # ------------------------------------------------------------------
    # Calibration bookkeeping.
    # ------------------------------------------------------------------

    def name_calibration(self, calibration_type):
        """``"{name}-{type}-calibration"``."""
        return f"{self.name}-{calibration_type}-calibration"

    def save_calibration(self, calibration_type, path=".", name=None):
        """Save one calibration dict to ``path/name_#####.h5``; returns the path."""
        if calibration_type not in self.calibrations:
            raise ValueError(
                f"Could not find calibration '{calibration_type}'. Options: "
                + str(list(self.calibrations.keys()))
            )
        if name is None:
            name = self.name_calibration(calibration_type)
        file_path = generate_path(path, name, extension="h5")
        save_h5(file_path, self.calibrations[calibration_type])
        return file_path

    def load_calibration(self, calibration_type, file_path=None):
        """Load a calibration (the latest autosaved one by default); returns
        the path."""
        if file_path is None:
            path = os.path.abspath(".")
            if len(calibration_type) > 4 and calibration_type.endswith(".h5"):
                file_path = calibration_type
                split = file_path.split("-")
                if len(split) > 3 and "calibration_" in split[-1]:
                    calibration_type = split[-2]
                else:
                    raise ValueError(f"Could not parse calibration type from '{file_path}'.")
            else:
                name = self.name_calibration(calibration_type)
                file_path = latest_path(path, name, extension="h5")
            if file_path is None:
                raise FileNotFoundError(
                    f"Unable to find a calibration file like\n{os.path.join(path, name)}"
                )

        self.calibrations[calibration_type] = cal = load_h5(file_path)
        cal_ver = cal.get("__version__", "an unknown version")
        if cal_ver != __version__:
            warnings.warn(
                f"You are using slmsuite_torch {__version__}, but the calibration "
                f"in '{file_path}' was created in {cal_ver}."
            )
        return file_path

    def _get_calibration_metadata(self):
        return self.pickle(attributes=False, metadata=True)

    # ------------------------------------------------------------------
    # Fourier calibration.
    # ------------------------------------------------------------------

    def fourier_calibrate(
        self,
        array_shape=10,
        array_pitch=10,
        array_center=None,
        plot=False,
        autofocus=False,
        autoexposure=False,
        **kwargs,
    ):
        """
        Calibrate the kxy -> ij affine: project a WGS spot grid (``"knm"``
        units, two spots left out to fix the orientation), detect it with
        :meth:`analysis.blob_array_detect` (OpenCV), and scale the
        array-index affine into k-space.
        """
        if isinstance(array_shape, REAL_TYPES):
            array_shape = [int(array_shape), int(array_shape)]
        if isinstance(array_pitch, REAL_TYPES):
            array_pitch = [array_pitch, array_pitch]
        if np.any(np.array(array_pitch) <= 0):
            raise ValueError("array_pitch must be positive.")

        try:
            hologram = self.fourier_grid_project(
                array_shape=array_shape,
                array_pitch=array_pitch,
                array_center=array_center,
                **kwargs,
            )
        except Exception as e:
            warnings.warn(
                "fourier_calibrate failed during array holography. Try reducing "
                "array_pitch/array_shape or checking SLM parameters."
            )
            raise e

        # The center really projected (rounding compensated; the first two
        # points are skipped to balance the two left out at the end).
        array_center = np.mean(hologram.spot_kxy_rounded[:, 2:], axis=1)

        self.cam.flush()

        if autofocus or isinstance(autofocus, dict):
            if autoexposure or isinstance(autoexposure, dict):
                self.cam.autoexposure(**(autoexposure if isinstance(autoexposure, dict) else {}))
            self.cam.autofocus(plot=plot, **(autofocus if isinstance(autofocus, dict) else {}))

        if autoexposure or isinstance(autoexposure, dict):
            self.cam.autoexposure(**(autoexposure if isinstance(autoexposure, dict) else {}))

        img = self.cam.get_image()

        try:
            orientation = analysis.blob_array_detect(img, array_shape, plot=plot)
        except Exception as e:
            warnings.warn("fourier_calibrate failed during array detection and fitting.")
            raise e

        a = format_2vectors(array_center)
        M = np.array(orientation["M"])
        b = format_2vectors(orientation["b"])

        # Scale the array-index affine into kxy.
        scaling = (
            self.slm.pitch * np.flip(np.squeeze(hologram.shape)) / np.squeeze(array_pitch)
        )
        M = np.array(
            [
                [M[0, 0] * scaling[0], M[0, 1] * scaling[1]],
                [M[1, 0] * scaling[0], M[1, 1] * scaling[1]],
            ]
        )

        self.calibrations["fourier"] = {"M": M, "b": b, "a": a}
        self.calibrations["fourier"].update(self._get_calibration_metadata())
        return self.calibrations["fourier"]

    def fourier_grid_project(self, array_shape=10, array_pitch=10, array_center=None,
                             **kwargs):
        """
        Optimize the calibration spot grid and write it to the SLM; returns
        the :class:`SpotHologram`. The hologram lives on the camera's
        device when it has one.
        """
        if not np.all(np.isclose(array_pitch, np.rint(array_pitch))):
            warnings.warn("array_pitch is non-integer")

        shape = SpotHologram.get_padded_shape(self, padding_order=1, square_padding=True)
        hologram = SpotHologram.make_rectangular_array(
            shape,
            array_shape=array_shape,
            array_pitch=array_pitch,
            array_center=(
                None
                if array_center is None
                else format_2vectors(array_center)
                + format_2vectors((shape[1] / 2.0, shape[0] / 2.0))
            ),
            basis="knm",
            orientation_check=True,
            cameraslm=self,
            device=getattr(self.cam, "device", None),
        )

        kwargs.setdefault("maxiter", 10)
        for key in kwargs:
            if key not in [
                "method", "maxiter", "verbose", "callback", "feedback",
                "stat_groups", "name", "fixed_phase", "raw_stats", "blur_ij",
            ]:
                warnings.warn(f"Unexpected argument '{key}' passed to fourier_grid_project().")

        hologram.optimize(**kwargs)
        self.slm.set_phase(hologram.get_phase(), settle=True)
        return hologram

    def fourier_calibrate_analytic(self, M, b):
        """Set the Fourier calibration directly from a known affine."""
        M = np.squeeze(M)
        if np.any(np.array(M.shape) != (2, 2)):
            raise ValueError("Expected a 2x2 matrix for M.")
        self.calibrations["fourier"] = {
            "M": M,
            "b": format_2vectors(b),
            "a": format_2vectors([0, 0]),
        }
        self.calibrations["fourier"].update(self._get_calibration_metadata())

        if hasattr(self.cam, "set_affine") and not hasattr(self.cam, "M"):
            self.cam.set_affine(M, format_2vectors(b))
        return self.calibrations["fourier"]

    def fourier_calibration_build(self, f_eff, units="norm", theta=0, shear_angle=0,
                                  offset=None):
        """An analytic ``(M, b)`` from the optical train's parameters."""
        if offset is None:
            offset = np.flip(self.cam.shape) / 2
        return SimulatedCamera._build_affine(
            f_eff,
            units=units,
            theta=theta,
            shear_angle=shear_angle,
            offset=offset,
            cam_pitch_um=self.cam.pitch_um,
            wav_um=self.slm.wav_um,
        )

    # ------------------------------------------------------------------
    # kxy <-> ij transforms.
    # ------------------------------------------------------------------

    def _kxyslm_to_ijcam_depth(self, kxy_depth):
        """Focal power -> camera-plane depth (pixels)."""
        f_eff = np.mean(self.get_effective_focal_length("norm"))
        cam_pitch_um = np.nan if self.cam.pitch_um is None else np.mean(self.cam.pitch_um)
        return kxy_depth * (self.slm.wav_um * f_eff * f_eff / cam_pitch_um)

    def _ijcam_to_kxyslm_depth(self, ij_depth):
        """Camera-plane depth (pixels) -> focal power."""
        f_eff = np.mean(self.get_effective_focal_length("norm"))
        cam_pitch_um = np.nan if self.cam.pitch_um is None else np.mean(self.cam.pitch_um)
        return ij_depth * (cam_pitch_um / (self.slm.wav_um * f_eff * f_eff))

    def kxyslm_to_ijcam(self, kxy):
        r"""
        kxy -> camera pixels: :math:`\vec{y} = M(\vec{x} - \vec{a}) + \vec{b}`
        (a third row is depth, through the effective focal length).
        """
        if "fourier" not in self.calibrations:
            raise RuntimeError("Fourier calibration must exist to be used.")
        self._check_fourier_calibration_stale()

        kxy = format_vectors(kxy, handle_dimension="pass")
        ij = (
            self.calibrations["fourier"]["M"]
            @ (kxy[:2, :] - self.calibrations["fourier"]["a"])
            + self.calibrations["fourier"]["b"]
        )
        if kxy.shape[0] == 3:
            return np.vstack((ij, self._kxyslm_to_ijcam_depth(kxy[[2], :])))
        return ij

    def ijcam_to_kxyslm(self, ij):
        r"""
        Camera pixels -> kxy:
        :math:`\vec{x} = M^{-1}(\vec{y} - \vec{b}) + \vec{a}`.
        """
        if "fourier" not in self.calibrations:
            raise RuntimeError("Fourier calibration must exist to be used.")
        self._check_fourier_calibration_stale()

        ij = format_vectors(ij, handle_dimension="pass")
        kxy = (
            np.linalg.inv(self.calibrations["fourier"]["M"])
            @ (ij[:2, :] - self.calibrations["fourier"]["b"])
            + self.calibrations["fourier"]["a"]
        )
        if ij.shape[0] == 3:
            return np.vstack((kxy, self._ijcam_to_kxyslm_depth(ij[[2], :])))
        return kxy

    def _check_fourier_calibration_stale(self):
        """Warn if the wavefront calibration is newer than the Fourier one."""
        try:
            cals = self.calibrations
            if "wavefront_superpixel" in cals and "fourier" in cals:
                if (
                    cals["wavefront_superpixel"]["__timestamp__"]
                    > cals["fourier"]["__timestamp__"]
                ):
                    warnings.warn(
                        "The wavefront calibration is newer than the Fourier "
                        "calibration. The Fourier calibration may be stale."
                    )
        except Exception:
            pass

    # ------------------------------------------------------------------
    # Derived optics.
    # ------------------------------------------------------------------

    def get_farfield_spot_size(self, slm_size=None, basis="kxy"):
        """
        Diffraction-limited farfield spot size for a blazed SLM patch of
        ``slm_size`` (the source's extent by default).
        """
        if slm_size is None:
            psf_kxy = self.slm.get_spot_radius_kxy()
            slm_size = (1 / psf_kxy, 1 / psf_kxy)
        elif isinstance(slm_size, REAL_TYPES):
            slm_size = (slm_size, slm_size)

        if basis == "kxy":
            return (1 / slm_size[0], 1 / slm_size[1])
        if basis == "ij":
            M = self.calibrations["fourier"]["M"]
            size_kxy = np.linalg.inv(M / np.sqrt(np.abs(np.linalg.det(M)))) @ np.array(
                (1 / slm_size[0], 1 / slm_size[1])
            )
            return np.abs(self.kxyslm_to_ijcam([0, 0]) - self.kxyslm_to_ijcam(size_kxy))
        raise ValueError(f'Unrecognized basis "{basis}".')

    def get_effective_focal_length(self, units="norm"):
        """
        The scalar effective focal length of the Fourier calibration,
        ``sqrt(|det M|)``, in ``units`` (``"ij"``, ``"norm"`` or a length).
        """
        if "fourier" not in self.calibrations:
            raise RuntimeError("Fourier calibration must exist to be used.")

        f_eff = np.sqrt(np.abs(np.linalg.det(self.calibrations["fourier"]["M"])))

        if units != "ij" and self.cam.pitch_um is None:
            warnings.warn(f"cam.pitch_um must be set to use units '{units}'")
            return np.nan

        if units == "ij":
            pass
        elif units == "norm":
            f_eff = f_eff * np.array(self.cam.pitch_um) / self.slm.wav_um
        elif units in toolbox.LENGTH_FACTORS:
            f_eff = f_eff * np.array(self.cam.pitch_um) / toolbox.LENGTH_FACTORS[units]
        else:
            raise ValueError(f"Unit '{units}' not recognized as a length.")
        return f_eff
