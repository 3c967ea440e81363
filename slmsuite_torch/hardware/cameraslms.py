r"""
A camera paired with an SLM, and the calibrations between them (port of
:mod:`slmsuite_tpu.hardware.cameraslms`).

:class:`FourierSLM` carries the ``"fourier"`` calibration (the affine
between the SLM's k-space and camera pixels): measured by projecting a
spot grid (:meth:`FourierSLM.fourier_calibrate`, which detects the grid
with OpenCV) or set analytically
(:meth:`FourierSLM.fourier_calibrate_analytic`), with the transforms and
the derived optics built on it, and HDF5 save and load. A calibrated rig
clones into simulated hardware (:meth:`FourierSLM.simulate`, and
:meth:`FourierSLM.load` from a file). The Zernike wavefront calibration
(:meth:`FourierSLM.wavefront_calibrate_zernike`) projects a
:class:`~slmsuite_torch.holography.algorithms.CompressedSpotHologram` at
the points of :meth:`FourierSLM.wavefront_calibration_points` and sweeps
each Zernike term per spot. The superpixel wavefront, pixel and settle
calibrations and the plots are not copied yet and raise
:class:`NotImplementedError` (ROADMAP.md queue 1, items 9 and 12).
"""

import copy
import os
import warnings

import numpy as np
from scipy import optimize

from slmsuite_torch import __version__
from slmsuite_torch.hardware import _Picklable
from slmsuite_torch.hardware.cameras.simulated import SimulatedCamera
from slmsuite_torch.hardware.slms.simulated import SimulatedSLM
from slmsuite_torch.holography import analysis, toolbox
from slmsuite_torch.holography.algorithms import CompressedSpotHologram, SpotHologram
from slmsuite_torch.holography.toolbox import format_2vectors, format_vectors
from slmsuite_torch.holography.toolbox.phase import _zernike_indices_parse, zernike
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


def _no_plots(where):
    raise NotImplementedError(
        f"{where}: the calibration plots are not ported yet (ROADMAP.md queue 1, item 12)."
    )


def _progress(iterable, desc):
    """``iterable`` behind a tqdm bar when tqdm is installed, else as it is."""
    try:
        from tqdm.auto import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, desc=desc, position=0, leave=False)


class FourierSLM(CameraSLM):
    r"""
    An SLM and a camera separated by a Fourier transform, with the
    ``"fourier"`` calibration (the affine kxy <-> ij).
    """

    _pickle = ["name", "cam", "slm", "mag"]
    _pickle_data = ["calibrations"]

    settle_calibrate = _not_ported("settle_calibrate")
    settle_calibration_process = _not_ported("settle_calibration_process")
    pixel_calibrate = _not_ported("pixel_calibrate")
    pixel_calibration_process = _not_ported("pixel_calibration_process")
    wavefront_calibrate_superpixel = _not_ported("wavefront_calibrate_superpixel")
    wavefront_calibration_superpixel_process = _not_ported(
        "wavefront_calibration_superpixel_process"
    )
    wavefront_calibration_superpixel_window = _not_ported(
        "wavefront_calibration_superpixel_window"
    )
    pixel_kernel = _not_ported("pixel_kernel")
    write_calibration = _not_ported("write_calibration")
    read_calibration = _not_ported("read_calibration")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # Calibration point window size relative to the spot radius.
        self._wavefront_calibration_window_multiplier = 4

    # ------------------------------------------------------------------
    # Simulated clones.
    # ------------------------------------------------------------------

    def simulate(self):
        """
        Clone this Fourier-calibrated rig into simulated hardware with the
        same calibrations: a :class:`SimulatedSLM` of the same geometry,
        source, bit depth and wavelengths, and a :class:`SimulatedCamera`
        (on this camera's device) whose affine is the calibration's, with
        the array-center offset folded in: the camera takes ``ij = M kxy +
        b`` and the calibration ``ij = M (kxy - a) + b``, so ``b' = b -
        M a``.
        """
        if "fourier" not in self.calibrations:
            raise ValueError("Cannot simulate() a FourierSLM without a Fourier calibration.")

        slm_sim = SimulatedSLM(
            self.slm.shape[::-1],
            source=self.slm.source,
            bitdepth=self.slm.bitdepth,
            name=self.slm.name + "_sim",
            wav_um=self.slm.wav_um,
            wav_design_um=self.slm.wav_design_um,
            pitch_um=self.slm.pitch_um,
        )
        M, a, b = self._fourier_affine()
        cam_sim = SimulatedCamera(
            slm_sim,
            resolution=self.cam.shape[::-1],
            M=M,
            b=b - M @ a,
            bitdepth=self.cam.bitdepth,
            averaging=self.cam.averaging,
            hdr=self.cam.hdr,
            pitch_um=self.cam.pitch_um,
            name=self.cam.name + "_sim",
            device=getattr(self.cam, "device", None),
        )
        cam_sim.transform = copy.copy(self.cam.transform)

        fs_sim = FourierSLM(cam_sim, slm_sim)
        fs_sim.calibrations = copy.deepcopy(self.calibrations)
        fs_sim._wavefront_calibration_window_multiplier = (
            self._wavefront_calibration_window_multiplier
        )
        return fs_sim

    def _fourier_affine(self, fourier=None):
        """``(M, a, b)`` of the Fourier calibration as float arrays (``a``
        zero when it is missing)."""
        fourier = self.calibrations["fourier"] if fourier is None else fourier
        M = np.array(fourier["M"], float)
        a = np.array(fourier.get("a", [[0.0], [0.0]]), float).reshape(2, 1)
        b = np.array(fourier["b"], float).reshape(2, 1)
        return M, a, b

    @staticmethod
    def load(file_path, device=None):
        """
        A simulated rig from a pickled FourierSLM file (:meth:`save`, or a
        calibration file of :meth:`save_calibration`): the SLM's shape,
        pitch, wavelengths, bit depth and name, the camera's shape, bit
        depth, pitch and name, the magnification, and, where the file
        holds them, the calibrations, with the simulated camera's affine
        wired to the Fourier calibration as :meth:`simulate` does. The
        camera runs on ``device`` (the package default when None).
        """
        return FourierSLM._from_pickle(load_h5(file_path), device, f"file {file_path}")

    @staticmethod
    def _from_pickle(data, device=None, what="the data"):
        """:meth:`load`'s rig from the dictionary a file holds (that of
        :meth:`pickle` with metadata)."""
        if "__meta__" not in data:
            raise ValueError(f"Cannot interpret {what} without field '__meta__'.")
        meta = data["__meta__"]
        for field in ("cam", "slm"):
            if field not in meta:
                raise ValueError(f"Cannot interpret {what} without metadata field '{field}'.")

        slm_kwargs = {
            key: meta["slm"][key]
            for key in ("wav_um", "wav_design_um", "bitdepth", "name")
            if key in meta["slm"]
        }
        slm = SimulatedSLM(
            resolution=np.flip(meta["slm"]["shape"]),
            pitch_um=meta["slm"]["pitch_um"],
            **slm_kwargs,
        )
        cam = SimulatedCamera(
            slm=slm,
            resolution=np.flip(meta["cam"]["shape"]),
            bitdepth=meta["cam"]["bitdepth"],
            pitch_um=meta["cam"]["pitch_um"],
            name=meta["cam"]["name"],
            device=device,
        )
        fs = FourierSLM(cam, slm, mag=meta["mag"])
        fs.name = meta["name"]
        if "calibrations" in meta and isinstance(meta["calibrations"], dict):
            fs.calibrations = meta["calibrations"]
            fourier = fs.calibrations.get("fourier")
            if fourier is not None and "M" in fourier:
                M, a, b = fs._fourier_affine(fourier)
                cam.set_affine(M=M, b=b - M @ a)
        return fs

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

    # ------------------------------------------------------------------
    # Wavefront calibration.
    # ------------------------------------------------------------------

    def wavefront_calibrate(self, *args, method=None, **kwargs):
        """
        :meth:`wavefront_calibrate_superpixel` (the default ``method``, not
        ported yet) or :meth:`wavefront_calibrate_zernike` (``"zernike"``).
        """
        if method is None:
            method = "superpixel"
        if method == "superpixel":
            for deprecated in ("interference_point", "calibration_point"):
                if deprecated in kwargs:
                    warnings.warn(f"'{deprecated}' is deprecated; use 'calibration_points'.")
                    kwargs["calibration_points"] = kwargs.pop(deprecated)
            return self.wavefront_calibrate_superpixel(*args, **kwargs)
        if method == "zernike":
            return self.wavefront_calibrate_zernike(*args, **kwargs)
        raise ValueError(f"Wavefront calibration method '{method}' not recognized.")

    @staticmethod
    def _wavefront_calibrate_zernike_default_metric(images):
        """The spot areas (moment-matrix determinants) of a stack of spot
        images: smaller is better, so the calibration minimizes aberration."""
        variances = analysis.image_variances(images)
        return analysis.image_areas(variances)

    def _wavefront_calibrate_zernike_plot_raw(self, calibration_points=None, index=0):
        """The raw-data plot of the Zernike calibration (not ported yet)."""
        _no_plots("_wavefront_calibrate_zernike_plot_raw")

    def wavefront_calibrate_zernike(
        self,
        calibration_points=None,
        zernike_indices=9,
        perturbation=1,
        callback=None,
        metric=None,
        global_correction=False,
        optimize_focus=True,
        optimize_position=True,
        optimize_weights=True,
        plot=0,
    ):
        r"""
        Wavefront calibration by scanning and subtracting Zernike terms,
        spot by spot. A :class:`CompressedSpotHologram` projects spots at
        the calibration points in the basis ``zernike_indices``,
        re-optimized with 3 GS iterations each tick (the compressed
        kernels). Optionally its weights are equalized first by WGS-Kim
        with ``experimental_spot`` feedback (``optimize_weights``: True
        for 10 iterations, or a count) and its spots centered on their
        camera windows (:meth:`~slmsuite_torch.holography.algorithms.
        CompressedSpotHologram.refine_offset`, ``optimize_position``,
        affine with ``global_correction``). Then, per Zernike term (piston
        and tilts skipped, focus too unless ``optimize_focus``), the SLM
        shows the hologram plus each ``perturbation`` times the term; the
        camera's ``callback`` (by default: the background-removed spot
        windows, normalized, through ``metric``, the spot area by default)
        is fit per spot by a parabola, whose minimum (``global_correction``:
        their mean) is added to that spot's coefficient.

        ``calibration_points`` are ``(D, N)`` points in the ``"zernike"``
        basis, a count (laid out by :meth:`wavefront_calibration_points`),
        or None to resume the stored ``"wavefront_zernike"`` calibration
        (100 points if there is none). ``perturbation`` is a sweep, or a
        scalar ``p`` for 11 points in ``[-p, p]``; 0 or None projects the
        hologram and returns it. ``plot`` above 0 is not ported (item 12).
        Returns the ``"wavefront_zernike"`` calibration dict: the initial
        and corrected points, the indices, the last sweep's results, the
        camera points and window width, the metric before each term and
        after the last, and the weights.
        """
        if plot > 0:
            _no_plots("wavefront_calibrate_zernike(plot > 0)")

        def sweep_term(sweep, term, pattern, callback, desc=None):
            sweep = np.ravel(sweep)
            result = None
            width = None
            iterable = list(enumerate(sweep))
            if plot >= 0:
                iterable = _progress(iterable, desc)
            for i, x in iterable:
                phase = pattern + x * term
                self.slm.set_phase(phase, settle=True, phase_correct=False)
                this_result = np.array(callback())
                if result is None:
                    width = len(this_result)
                    result = np.full((len(sweep), width), np.nan, dtype=this_result.dtype)
                if len(this_result) != width:
                    raise RuntimeError("Callback changed its return length mid-sweep.")
                result[i, :] = this_result
            return result

        def fit_term(sweep, result):
            """The parabola's minimum per spot (clipped to the sweep)."""
            ddy = np.diff(result, n=2, axis=0)
            a0 = 0.5 * np.mean(ddy, axis=0) / np.square(np.mean(np.diff(sweep)))
            c0 = np.min(result, axis=0)
            x0 = sweep[np.argmin(result, axis=0)]

            def parabola(x, x0, a, c):
                return c + a * np.square(x - x0)

            x = np.zeros(result.shape[1])
            for i in range(result.shape[1]):
                guess = (x0[i], max(a0[i], 1e-30), c0[i])
                try:
                    popt, _ = optimize.curve_fit(
                        parabola, sweep, result[:, i], ftol=1e-5, p0=guess,
                        bounds=([-np.inf, 0, -np.inf], [np.inf, np.inf, np.inf]),
                    )
                except Exception:
                    popt = guess
                x[i] = popt[0]
            return np.clip(x, np.min(sweep), np.max(sweep))

        # The points, or the stored calibration to resume.
        calibration_points_ij = None
        metric_stats = []
        weights = None
        spot_integration_width_ij = None

        if calibration_points is None:
            if "wavefront_zernike" in self.calibrations:
                dat = self.calibrations["wavefront_zernike"]
                calibration_points = np.copy(dat["corrected_spots"])
                calibration_points_ij = np.copy(dat["calibration_points_ij"])
                spot_integration_width_ij = int(dat["spot_integration_width_ij"])
                if zernike_indices is None:
                    zernike_indices = np.copy(dat["zernike_indices"])
                else:
                    zernike_indices = _zernike_indices_parse(
                        zernike_indices, calibration_points.shape[0], smaller_okay=True
                    )
                    stored = np.copy(dat["zernike_indices"])
                    if len(zernike_indices) < len(stored) or not np.all(
                        zernike_indices[: len(stored)] == stored
                    ):
                        raise ValueError(
                            f"Requested indices {zernike_indices} are not compatible "
                            f"with stored indices {stored}."
                        )
                metric_stats = list(dat.get("metric_stats", []))
                weights = dat.get("weights")
            else:
                calibration_points = 100

        if np.isscalar(calibration_points):
            pitch = np.sqrt(np.prod(self.cam.shape) / calibration_points)
            calibration_points = self.wavefront_calibration_points(pitch)
            calibration_points = toolbox.convert_vector(
                calibration_points, "ij", "zernike", hardware=self
            )

        calibration_points = format_vectors(np.copy(calibration_points),
                                            handle_dimension="pass")
        zernike_indices = _zernike_indices_parse(
            zernike_indices, calibration_points.shape[0], smaller_okay=True
        )
        dp = len(zernike_indices) - calibration_points.shape[0]
        if dp:
            calibration_points = np.pad(calibration_points, ((0, dp), (0, 0)))

        initial_points = calibration_points.copy()

        # The calibration hologram, on the camera's device.
        hologram = CompressedSpotHologram(
            spot_vectors=calibration_points,
            basis=zernike_indices,
            cameraslm=self,
            device=getattr(self.cam, "device", None),
        )
        if weights is not None:
            hologram.set_weights(np.asarray(weights))
        if calibration_points_ij is None:
            calibration_points_ij = hologram.spot_ij
        else:
            hologram.spot_ij = calibration_points_ij

        max_window = toolbox.smallest_distance(calibration_points_ij)
        max_width = int(2 * np.ceil(np.min((0.5 * max_window, 51)) / 2) + 1)
        if spot_integration_width_ij is None:
            spot_integration_width_ij = max_width
        else:
            spot_integration_width_ij = min(int(spot_integration_width_ij), max_width)
        hologram.spot_integration_width_ij = spot_integration_width_ij

        if callback is None:

            def default_callback():
                img = self.cam.get_image()
                images = analysis.take(
                    img, calibration_points_ij, spot_integration_width_ij, clip=True
                ).astype(float)
                images = analysis.image_remove_field(images)
                images[np.isnan(images)] = 0
                total = np.sum(images)
                if total > 0:
                    images = images / total  # Remove laser noise.
                if metric is None:
                    return FourierSLM._wavefront_calibrate_zernike_default_metric(images)
                return metric(images)

            callback = default_callback

        def tick():
            """Re-optimize the hologram at the current coefficients."""
            hologram.spot_zernike = calibration_points
            hologram.optimize("GS", maxiter=3, verbose=0)
            return hologram.get_phase()

        # The JAX package documents a None perturbation as "project and
        # return", as here.
        hologram.optimize("GS", maxiter=3, verbose=0, stat_groups=["computational_spot"])

        if optimize_weights:
            maxiter = 10 if isinstance(optimize_weights, bool) else int(optimize_weights)
            if maxiter < 1:
                raise ValueError("optimize_weights must be True, False, or a positive integer.")
            hologram.optimize(
                "WGS-Kim",
                feedback="experimental_spot",
                maxiter=maxiter,
                verbose=plot >= 0,
                name="optimize_weights",
                stat_groups=["computational_spot", "experimental_spot"],
            )
            if "wavefront_zernike" in self.calibrations:
                self.calibrations["wavefront_zernike"]["weights"] = hologram.get_weights()

        no_perturbation = (
            perturbation is None
            or (np.isscalar(perturbation) and perturbation <= 0)
            or (not np.isscalar(perturbation) and len(np.ravel(perturbation)) == 0)
        )
        if no_perturbation:
            self.slm.set_phase(tick(), settle=True, phase_correct=False)
            self.cam.flush()
            self.cam.get_image()
            return hologram

        if np.isscalar(perturbation):
            perturbation = np.linspace(-perturbation, perturbation, 11, endpoint=True)
        else:
            perturbation = np.ravel(perturbation)

        if optimize_position:
            # Written as every measurement below is (settled, no stored
            # correction), so that the refined targets describe the optical
            # state the sweeps measure.
            self.slm.set_phase(tick(), settle=True, phase_correct=False)
            hologram.refine_offset(img=None, basis="kxy", force_affine=global_correction)
            calibration_points = hologram.spot_zernike

        # One sweep per Zernike term.
        result = None
        self.cam.flush()
        for j, i in enumerate(zernike_indices):
            if i in (0, 2, 1) or (i == 4 and not optimize_focus):
                continue  # Piston and tilts (and focus unless asked).

            pattern = tick()
            self.slm.set_phase(pattern, settle=True, phase_correct=False)
            metric_stats.append(callback())

            term = zernike(self.slm, i, use_mask=False)
            result = sweep_term(perturbation, term, pattern, callback, f"Z_{i}")
            correction = fit_term(perturbation, result)

            if global_correction:
                correction = np.mean(correction)
            calibration_points[j, :] += correction

        pattern = tick()
        self.slm.set_phase(pattern, settle=True, phase_correct=False)
        metric_stats.append(callback())

        self.calibrations["wavefront_zernike"] = {
            "initial_points": initial_points,
            "zernike_indices": zernike_indices,
            "corrected_spots": calibration_points,
            "last_result": result,
            "calibration_points_ij": calibration_points_ij,
            "spot_integration_width_ij": spot_integration_width_ij,
            "metric_stats": metric_stats,
            "weights": hologram.get_weights(),
        }
        self.calibrations["wavefront_zernike"].update(self._get_calibration_metadata())

        del hologram
        return self.calibrations["wavefront_zernike"]

    def wavefront_calibrate_zernike_smooth(self, smoothing=0.25, smoothing_xy=0.25,
                                           smoothing_z=None, plot=False):
        """
        The stored Zernike calibration's corrected coefficients, smoothed
        over each point's Delaunay neighbors (edges longer than 1.5 times
        the median left out): the tilts average their residual from the
        Fourier calibration's expectation (``smoothing_xy``), the higher
        terms the coefficients themselves (``smoothing``). Returns the
        ``(D, N)`` coefficients. ``plot`` is not ported (item 12).
        """
        from scipy.spatial import Delaunay

        if plot:
            _no_plots("wavefront_calibrate_zernike_smooth(plot=True)")
        if smoothing < 0 or smoothing > 1:
            raise ValueError("Smoothing factor must be between 0 and 1.")
        if smoothing_xy < 0 or smoothing_xy > 1:
            raise ValueError("Smoothing factor must be between 0 and 1.")
        if smoothing_z is not None:
            raise RuntimeError("Zernike z-smoothing not yet implemented.")

        dat = self.calibrations["wavefront_zernike"]
        indices = np.asarray(dat["zernike_indices"])
        rows = np.arange(len(indices))
        to_smooth = rows[indices > 2]
        x_smooth = rows[indices == 2]
        y_smooth = rows[indices == 1]

        vectors = np.asarray(dat["corrected_spots"])
        final = np.zeros_like(vectors)

        points_ij = np.asarray(dat["calibration_points_ij"])
        base_xy = toolbox.convert_vector(points_ij, "ij", "zernike", hardware=self)

        points = points_ij[:2, :].T
        tri = Delaunay(points)
        edges = np.array([
            (t[a], t[b]) for t in tri.simplices for a, b in [(0, 1), (1, 2), (2, 0)]
        ])
        edges = np.unique(np.sort(edges, axis=1), axis=0)
        lens = np.linalg.norm(points[edges[:, 0]] - points[edges[:, 1]], axis=1)
        max_len = 1.5 * np.median(lens)
        simplices = np.array([
            t for t in tri.simplices
            if all(
                np.linalg.norm(points[[t[a]]] - points[[t[b]]]) <= max_len
                for a, b in [(0, 1), (1, 2), (2, 0)]
            )
        ])

        for i in range(points_ij.shape[1]):
            neighbors = set()
            for simplex in simplices:
                if i in simplex:
                    neighbors.update(simplex)
            neighbors.discard(i)
            count = max(len(neighbors), 1)
            if not neighbors:
                # An isolated point keeps its coefficients.
                final[x_smooth, i] = vectors[x_smooth, i]
                final[y_smooth, i] = vectors[y_smooth, i]
                final[to_smooth, i] = vectors[to_smooth, i]
                continue

            final[x_smooth, i] = (1 - smoothing_xy) * (
                vectors[x_smooth, i] - base_xy[0, i]
            ) + base_xy[0, i]
            final[y_smooth, i] = (1 - smoothing_xy) * (
                vectors[y_smooth, i] - base_xy[1, i]
            ) + base_xy[1, i]
            for n in neighbors:
                final[x_smooth, i] += smoothing_xy * (vectors[x_smooth, n] - base_xy[0, n]) / count
                final[y_smooth, i] += smoothing_xy * (vectors[y_smooth, n] - base_xy[1, n]) / count

            final[to_smooth, i] = (1 - smoothing) * vectors[to_smooth, i]
            for n in neighbors:
                final[to_smooth, i] += smoothing * vectors[to_smooth, n] / count

        return final

    def wavefront_calibration_points(
        self,
        pitch,
        field_exclusion=None,
        field_point=(0, 0),
        field_point_units="kxy",
        avoid_points=None,
        avoid_mirrors=True,
        avoid_nyquist=True,
        plot=False,
    ):
        """
        A grid of camera points to calibrate at, ``pitch`` apart: off the
        0th and the +-1st and +-2nd orders of the field blaze
        (``field_point``) by ``field_exclusion`` (default ``pitch``) and
        off ``avoid_points``, placed so that the -1st-order mirrors fall
        between points (``avoid_mirrors``), and within the first Nyquist
        zone (``avoid_nyquist``). Returns ``(2, N)`` ``"ij"`` points sorted
        by their distance from the 0th order. ``plot`` is not ported (item
        12).
        """
        if plot:
            _no_plots("wavefront_calibration_points(plot=True)")
        field_point = toolbox.convert_vector(
            format_2vectors(field_point), field_point_units, "ij", hardware=self
        )
        field_point = np.rint(format_2vectors(field_point)).astype(int)

        if field_exclusion is None:
            field_exclusion = pitch
        if not np.isscalar(field_exclusion):
            field_exclusion = np.mean(field_exclusion)

        zeroth_order = np.rint(self.kxyslm_to_ijcam([0, 0])).astype(int)

        plane = format_2vectors(self.cam.shape[::-1])
        grid = np.ceil(plane / pitch - 0.5)
        spacing = np.floor(plane / (grid + (0.5 if avoid_mirrors else 0))).astype(int)
        if avoid_mirrors:
            base_point = spacing * (np.remainder(zeroth_order / spacing - 0.5, 1) + 0.25)
        else:
            base_point = spacing / 2

        calibration_points = toolbox.fit_3pt(
            base_point, (spacing[0, 0], 0), (0, spacing[1, 0]),
            np.squeeze(grid).astype(int), x1=None, x2=None,
        )

        if avoid_nyquist:
            points_knm = toolbox.convert_vector(
                calibration_points, "ij", "knm", hardware=self, shape=[1, 1]
            )
            outside = (
                (points_knm[0] < 0) + (points_knm[1] < 0)
                + (points_knm[0] > 1) + (points_knm[1] > 1)
            ) > 0
            calibration_points = np.delete(calibration_points, outside, axis=1)

        distance = np.sum(np.square(calibration_points - zeroth_order), axis=0)
        calibration_points = calibration_points[:, np.argsort(distance)]

        # Away from the diffraction orders and the points to avoid.
        dorder = field_point - zeroth_order
        order_points = np.hstack([zeroth_order + dorder * i for i in range(-2, 3)])
        if avoid_points is None:
            avoid_points = order_points
        else:
            avoid_points = np.hstack((format_2vectors(avoid_points), order_points))

        for i in range(avoid_points.shape[1]):
            point = avoid_points[:, [i]]
            distance = np.sum(np.square(calibration_points - point), axis=0)
            calibration_points = np.delete(
                calibration_points, distance < field_exclusion**2, axis=1
            )

        if calibration_points.shape[1] == 0:
            raise ValueError(
                f"No calibration points survive the exclusion rules at "
                f"pitch={pitch:.0f} (field_exclusion={field_exclusion:.0f} "
                f"removes everything near the 0th/field orders on a "
                f"{tuple(self.cam.shape)} camera). Use a smaller pitch (more "
                f"points) or pass a smaller field_exclusion."
            )
        return calibration_points
