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
each Zernike term per spot. The superpixel wavefront calibration
(:meth:`FourierSLM.wavefront_calibrate_superpixel`, the default method)
interferes each superpixel of the SLM with a reference superpixel at a
camera point; :meth:`FourierSLM.wavefront_calibration_superpixel_process`
turns its raw data into ``slm.source["phase"]`` and ``["amplitude"]``,
with the image operations on the rig's device
(:mod:`slmsuite_torch.holography.analysis._cv`, no OpenCV). The settle and
pixel calibrations are here too, and every calibration's plots
(matplotlib imported inside each; tensors reach it through
:meth:`slmsuite_torch.misc.host.as_numpy`).
"""

import copy
import itertools
import os
import time
import warnings

import numpy as np
import torch
from scipy import optimize

from slmsuite_torch import __version__, resolve_device
from slmsuite_torch.hardware import _Picklable
from slmsuite_torch.hardware.cameras.simulated import SimulatedCamera
from slmsuite_torch.hardware.slms.simulated import SimulatedSLM
from slmsuite_torch.holography import analysis, toolbox
from slmsuite_torch.holography.algorithms import CompressedSpotHologram, SpotHologram
from slmsuite_torch.holography.analysis import _cv
from slmsuite_torch.holography.analysis.fitfunctions import _sinc2d_centered, _sinc2d_nomod, cos
from slmsuite_torch.holography.toolbox import format_2vectors, format_vectors
from slmsuite_torch.holography.toolbox.phase import (
    _zernike_indices_parse,
    binary,
    blaze,
    zernike,
)
from slmsuite_torch.misc.files import generate_path, latest_path, load_h5, save_h5
from slmsuite_torch.misc.host import as_numpy
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

    def plot(self, phase=None, image=None, title="", **kwargs):
        """Plot the SLM phase (``phase``, or the SLM's; a phase of the SLM's
        shape is displayed first when no ``image`` is given) beside the
        camera image (``image``, or a new one). Returns the axes."""
        import matplotlib.pyplot as plt

        if image is None and phase is not None and np.shape(phase) == self.slm.shape:
            self.slm.set_phase(phase, **kwargs)
        if phase is None:
            phase = self.slm.phase
        if image is None:
            image = self.cam.get_image()

        fig, axs = plt.subplots(1, 2, figsize=(14, 6))
        axs[0].imshow(np.mod(as_numpy(phase), 2 * np.pi), cmap="twilight", vmin=0, vmax=2 * np.pi)
        axs[0].set_title("SLM Phase")
        axs[1].imshow(as_numpy(image))
        axs[1].set_title("Camera Image")
        fig.suptitle(title)
        plt.show()
        return axs


class NearfieldSLM(CameraSLM):
    """
    **(NotImplemented)** An SLM imaged (not Fourier-transformed) onto a
    camera: a stub that raises, as in the JAX package.
    """

    def __init__(self, cam, slm, mag=None):
        super().__init__(cam, slm, 1 if mag is None else mag)
        raise NotImplementedError()


def _plot_labeled_rects(ax, points, labels, colors, width, height):
    """Annotate ``ax`` with labeled rectangles centered on ``points``: the
    superpixel and window markers of the superpixel calibration's plots."""
    import matplotlib.pyplot as plt

    for point, label, color in zip(points, labels, colors):
        ax.add_patch(plt.Rectangle(
            (float(point[0] - width / 2), float(point[1] - height / 2)),
            float(width), float(height), ec=color, fc="none",
        ))
        ax.annotate(label, (point[0], point[1]), c=color, size="x-small",
                    ha="center", va="center")


def _progress(iterable, desc):
    """``iterable`` behind a tqdm bar when tqdm is installed, else as it is."""
    try:
        from tqdm.auto import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, desc=desc, position=0, leave=False)


def _blaze_offset(grid, vector, offset=0):
    """A blaze plus a constant phase offset (the superpixel imprint)."""
    return blaze(grid=grid, vector=vector) + offset


def _build_superpixel_schedule(slm_supershape, exclude_superpixels,
                               reference_superpixels, phase_steps):
    """
    The conflict-free superpixel measurement schedule: ``(num_points,
    num_measurements)`` global superpixel indices, ``-1`` for an idle
    slot. Each row cycles through every active superpixel but that row's
    reference.

    The rotation is offset by the reference's position in the active
    list, as the JAX package does (upstream takes its global index, which
    agrees only when nothing is excluded: with exclusion margins it skips
    an interior superpixel and schedules the reference itself).
    """
    num_superpixels = int(np.prod(slm_supershape))
    num_points = len(reference_superpixels)
    index_image = np.reshape(np.arange(num_superpixels, dtype=int), slm_supershape)
    active_superpixels = index_image[~exclude_superpixels].ravel()
    num_active_superpixels = len(active_superpixels)
    num_measurements = num_active_superpixels + (
        (2 * num_points - 2) if phase_steps is not None else 0
    )

    ref_active = np.searchsorted(active_superpixels, reference_superpixels)
    scheduling = np.zeros((num_points, num_measurements), dtype=int)
    scheduling[:, : num_active_superpixels - 1] = np.mod(
        np.repeat(
            np.arange(num_active_superpixels - 1, dtype=int)[np.newaxis, :] + 1,
            num_points,
            axis=0,
        )
        + np.repeat(ref_active[:, np.newaxis], num_active_superpixels - 1, axis=1),
        num_active_superpixels,
    )
    scheduling = active_superpixels[scheduling]
    scheduling[:, num_active_superpixels - 1:] = -1

    if phase_steps is not None:
        # Evict the slots that would overwrite another point's reference;
        # reseat the displaced targets in the padding columns.
        for i in range(num_points):
            reference_index = reference_superpixels[i]
            conflicts = scheduling == reference_index
            conflict_indices = np.array(np.where(conflicts))
            for j in range(int(np.sum(conflicts))):
                c_index = conflict_indices[:, j]
                displaced = scheduling[i, c_index[1]]
                scheduling[i, c_index[1]] = -1
                if displaced != -1:
                    for k in range(num_active_superpixels - 1, num_measurements + 1):
                        if k == num_measurements:
                            raise RuntimeError("Calibration scheduling failed.")
                        if (
                            scheduling[i, k] == -1
                            and not np.any(scheduling[:, k] == reference_index)
                            and not np.any(scheduling[:, k] == displaced)
                        ):
                            scheduling[i, k] = displaced
                            break

    empty = np.all(scheduling == -1, axis=0)
    return scheduling[:, ~empty]


def _patch_from_neighbors(matrix, yx):
    """Replace ``matrix[yx]`` in place by the mean of its finite
    8-neighbors (0 when none): the reference superpixel's own reading is
    undefined or contaminated by construction."""
    y, x = yx
    window = matrix[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2].astype(float).copy()
    window[y - max(y - 1, 0), x - max(x - 1, 0)] = np.nan  # The center.
    finite = np.isfinite(window)
    matrix[y, x] = window[finite].sum() / max(finite.sum(), 1)


def _detect_noise_floor(power, normalization, untrusted):
    """
    A uniform noise floor in the untrusted superpixels' powers: when they
    cluster tightly (median within half a global std of their minimum)
    below the normalization's minimum, that minimum is camera background,
    not signal. Returns the floor or None.
    """
    if not untrusted.any():
        return None
    below = power[untrusted]
    if not np.any(np.isfinite(below)):
        return None
    floor = np.nanmin(below)
    spread = np.nanstd(power)
    if (
        spread > 0
        and (np.nanmedian(below) - floor) / spread < 0.5
        and floor < np.nanmin(normalization)
    ):
        return floor
    return None


def _propagate_affine_phase(kx, ky, offset, trusted, ref, scale):
    """
    Fill the untrusted superpixels' ``(kx, ky, offset)`` by breadth-first
    propagation from the trusted set.

    Each trusted fringe fit is an affine phase model anchored at the
    reference: ``phi(n) = offset + d(n) . k`` with ``d(n) = scale * (n -
    ref)`` (``scale = 2pi * pitch * superpixel_size`` per axis). Untrusted
    superpixels resolve in layers: the gradient is the mean of the
    resolved 4-neighbors' gradients, the offset the circular mean of the
    neighbors' models at this superpixel, re-anchored with that gradient.
    Untrusted islands with no trusted neighbor stay zero. Returns the
    filled ``(kx, ky, offset)`` (the inputs are not modified).
    """
    kx = np.array(kx, dtype=float)
    ky = np.array(ky, dtype=float)
    offset = np.array(offset, dtype=float)
    resolved = np.array(trusted, dtype=bool)

    NY, NX = kx.shape
    dx = scale[0] * (np.arange(NX)[None, :] - ref[1])
    dy = scale[1] * (np.arange(NY)[:, None] - ref[0])
    dx, dy = np.broadcast_arrays(dx, dy)

    def shifted(matrix, ay, ax, fill=0.0):
        out = np.full_like(np.asarray(matrix, float), fill)
        src_y = slice(max(ay, 0), NY + min(ay, 0))
        src_x = slice(max(ax, 0), NX + min(ax, 0))
        dst_y = slice(max(-ay, 0), NY + min(-ay, 0))
        dst_x = slice(max(-ax, 0), NX + min(-ax, 0))
        out[dst_y, dst_x] = matrix[src_y, src_x]
        return out

    while not resolved.all():
        count = np.zeros_like(kx)
        kx_sum = np.zeros_like(kx)
        ky_sum = np.zeros_like(ky)
        phasor = np.zeros(kx.shape, dtype=complex)

        for ay, ax in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            ok = shifted(resolved, ay, ax, fill=False).astype(bool)
            count += ok
            kx_nb = shifted(kx, ay, ax)
            ky_nb = shifted(ky, ay, ax)
            kx_sum += np.where(ok, kx_nb, 0.0)
            ky_sum += np.where(ok, ky_nb, 0.0)
            # The neighbor's model at this superpixel.
            predicted = shifted(offset, ay, ax) + dx * kx_nb + dy * ky_nb
            phasor += np.where(ok, np.exp(1j * predicted), 0)

        frontier = ~resolved & (count > 0)
        if not frontier.any():
            break

        n = np.maximum(count, 1)
        kx = np.where(frontier, kx_sum / n, kx)
        ky = np.where(frontier, ky_sum / n, ky)
        mean_phase = np.mod(np.angle(phasor), 2 * np.pi)
        offset = np.where(frontier, mean_phase - (dx * kx + dy * ky), offset)
        resolved |= frontier

    return kx, ky, offset


class FourierSLM(CameraSLM):
    r"""
    An SLM and a camera separated by a Fourier transform, with the
    ``"fourier"`` calibration (the affine kxy <-> ij).
    """

    _pickle = ["name", "cam", "slm", "mag"]
    _pickle_data = ["calibrations"]

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

    def write_calibration(self, calibration_type, path, name):
        """The deprecated alias of :meth:`save_calibration` (it warns)."""
        warnings.warn("write_calibration is deprecated; use save_calibration.")
        self.save_calibration(calibration_type, path, name)

    def read_calibration(self, calibration_type, file_path=None):
        """The deprecated alias of :meth:`load_calibration` (it warns)."""
        warnings.warn("read_calibration is deprecated; use load_calibration.")
        self.load_calibration(calibration_type, file_path)

    def _get_calibration_metadata(self):
        return self.pickle(attributes=False, metadata=True)

    # ------------------------------------------------------------------
    # Settle calibration.
    # ------------------------------------------------------------------

    def settle_calibrate(self, vector=(0.005, 0.005), size=None, times=None, settle_time_s=1):
        r"""
        The SLM's response in time: clear the SLM, wait ``settle_time_s``,
        write a blaze toward ``vector`` and integrate its 1st-order spot
        (``size`` pixels square, 16 spot radii by default) after each
        delay of ``times`` (21 in [0, 1] s by default, or a count), then
        :meth:`settle_calibration_process`. Returns the ``"settle"``
        calibration.
        """
        point = self.kxyslm_to_ijcam(vector)
        pattern = blaze(grid=self.slm, vector=vector)

        if size is None:
            size = 16 * toolbox.convert_radius(
                self.slm.get_spot_radius_kxy(), to_units="ij", hardware=self
            )
        size = int(size)

        if times is None:
            times = 21
        if np.isscalar(times):
            times = np.linspace(0, 1, int(times), endpoint=True)
        times = np.ravel(times)

        if settle_time_s is None:
            settle_time_s = self.slm.settle_time_s
        settle_time_s = float(settle_time_s)

        results = []
        for t in _progress(times, "settle_calibrate"):
            self.cam.flush()
            self.slm.set_phase(None, settle=False, phase_correct=False)
            time.sleep(settle_time_s)
            self.slm.set_phase(pattern, settle=False, phase_correct=False)
            time.sleep(t)
            image = self.cam.get_image()
            results.append(analysis.take(image, point, size, centered=True, integrate=True))

        self.calibrations["settle"] = {"times": times, "data": np.array(results)}
        self.calibrations["settle"].update(self._get_calibration_metadata())
        self.settle_calibration_process(plot=False)
        return self.calibrations["settle"]

    def settle_calibration_process(self, plot=True):
        r"""
        Fit a step and an exponential to the settle data: the suggested
        settle time is the communication time plus 4 times the 1/e
        relaxation time. ``plot`` shows the data and the fit. Returns the
        fitted times.
        """
        times = np.asarray(self.calibrations["settle"]["times"])
        results = np.squeeze(np.asarray(self.calibrations["settle"]["data"]))

        def exponential_jump(x, x0, a, b, c):
            return (c - a * np.exp(-(x - x0) / b)) * np.heaviside(x - x0, 0)

        guess = (np.max(times) / 2, np.max(results), np.max(times), np.max(results))
        params, _ = optimize.curve_fit(
            exponential_jump, times, results, p0=guess, maxfev=10000
        )
        x0, a, b, c = params

        processed = {
            "settle_time": x0 + 4 * b,
            "relax_time": b,
            "communication_time": x0,
        }
        self.calibrations["settle"].update(processed)

        if plot:
            import matplotlib.pyplot as plt

            x_interp = np.linspace(times.min(), times.max(), 100)
            plt.plot(times, results, "k.", label="data")
            plt.plot(x_interp, exponential_jump(x_interp, *params), "r--", label="fit")
            plt.xlabel("Time [sec]")
            plt.ylabel("Signal [a.u.]")
            plt.title(
                f"Communication: {1e3 * processed['communication_time']:.0f} ms; "
                f"1/e relax: {1e3 * processed['relax_time']:.0f} ms; "
                f"suggested settle: {1e3 * processed['settle_time']:.0f} ms"
            )
            plt.legend()
            plt.show()
        return processed

    # ------------------------------------------------------------------
    # Pixel calibration.
    # ------------------------------------------------------------------

    def pixel_calibrate(self, levels=2, periods=2, orders=3, window=None, field_period=10):
        r"""
        The pixels' crosstalk and phase response through binary gratings:
        for each direction, period, level ``a`` and level ``b``, write the
        raw integer grating (past ``phase2gray``; inside ``window`` on a
        field grating of ``field_period``, when given) and integrate every
        diffraction order of ``orders`` into a ``(2, P, N, N, M)`` array.
        :meth:`pixel_calibration_process` fits the phase response.
        """
        if np.isscalar(levels):
            if levels < 1:
                levels = 1
            levels = 2 ** (np.ceil(np.log2(levels)))
            if levels > self.slm.bitresolution:
                warnings.warn("Requested more levels than available. Rounding down.")
                levels = self.slm.bitresolution
            levels = np.arange(levels) * (self.slm.bitresolution / levels)
        levels = np.mod(levels, self.slm.bitresolution).astype(self.slm.display.dtype)
        N = len(levels)

        if np.isscalar(periods):
            raise NotImplementedError("Pass an explicit list of even periods.")
        periods = 2 * (np.array(periods).astype(int) // 2)
        P = len(periods)
        if len(np.unique(periods)) != len(periods):
            raise RuntimeError(f"Repeated periods in {periods}")
        if np.any(periods <= 0):
            raise ValueError("period should not be negative.")

        if np.isscalar(orders):
            orders = np.arange(-int(orders), int(orders) + 1)
        orders = np.asarray(orders).astype(int)
        M = len(orders)
        if 1 not in orders:
            raise ValueError("1st order must be included.")

        data = np.zeros((2, P, N, N, M))

        # Grating vectors along x, then y.
        vectors_freq = np.zeros((2, 2 * P))
        vectors_freq[0, :P] = vectors_freq[1, P:] = np.reciprocal(periods.astype(float))
        vectors_kxy = toolbox.convert_vector(vectors_freq, "freq", "norm", hardware=self)

        field_freq = np.zeros((2, 2))
        field_freq[0, 0] = field_freq[1, 1] = 1 / float(field_period)
        field_kxy = toolbox.convert_vector(field_freq, "freq", "norm", hardware=self)
        field_hi, field_lo = np.array([self.slm.bitresolution / 2, 0]).astype(
            self.slm.display.dtype
        )
        field_ij = toolbox.convert_vector(field_freq, "freq", "ij", hardware=self)

        vectors_ij = self.kxyslm_to_ijcam(vectors_kxy)
        center = self.kxyslm_to_ijcam((0, 0))
        dorder = vectors_ij - center
        dfield = field_ij - center
        order_ij = [center + orders * dorder[:, [i]] for i in range(2 * P)]

        # Absolute offsets: under a flipped or rotated affine the signed
        # maximum collapses to ~0.
        integration_size = int(
            np.ceil(np.min([
                np.min(np.max(np.abs(dorder), axis=1)),
                np.min(np.max(np.abs(dfield), axis=1)),
            ]))
        )

        sweep = itertools.product((0, 1), range(P), range(N), range(N))
        for i, j, k, l in _progress(list(sweep), "pixel_calibrate"):
            vector = vectors_kxy[:, i * P + j]
            if window is None:
                phase = binary(self.slm, vector=vector, a=levels[k], b=levels[l])
            else:
                phase = binary(grid=self.slm, vector=field_kxy[:, i], a=field_hi, b=field_lo)
                toolbox.imprint(
                    phase, window=window, function=binary, grid=self.slm,
                    vector=vector, a=levels[k], b=levels[l],
                )

            # The raw integer write skips phase2gray.
            self.slm.set_phase(
                phase.astype(self.slm.display.dtype), phase_correct=False, settle=True
            )
            data[i, j, k, l, :] = analysis.take(
                images=self.cam.get_image(),
                vectors=order_ij[i * P + j],
                size=integration_size,
                integrate=True,
            ).astype(float)

        self.calibrations["pixel"] = {
            "levels": levels,
            "periods": periods,
            "orders": orders,
            "data": data,
        }
        self.calibrations["pixel"].update(self._get_calibration_metadata())
        return self.calibrations["pixel"]

    @staticmethod
    def pixel_kernel(x, a1_pix=0.1, a2_pix=0.1, n1=1, n2=1):
        r"""
        The asymmetric-exponential pixel-crosstalk kernel
        :math:`K(x) = \exp(-|x/\alpha|^{n})`, with its own
        :math:`(\alpha, n)` on each side, normalized to unit sum.
        """
        x = np.asarray(x, dtype=float)
        kernel = np.where(
            x >= 0,
            np.exp(-np.power(np.abs(x) / a1_pix, n1)),
            np.exp(-np.power(np.abs(x) / a2_pix, n2)),
        )
        kernel[len(kernel) // 2] = 1
        return kernel / np.sum(kernel)

    def pixel_calibration_process(self, fit=True, plot=False):
        r"""
        Process the raw pixel-calibration data. With ``fit``, the SLM's
        phase response :math:`\phi(\ell)` at the measured levels from the
        binary grating's first-order power :math:`P_{ab} \propto
        \sin^2((\phi_a - \phi_b) / 2)`, by a joint least-squares over the
        ``(N, N)`` power matrix (averaged over directions, periods and the
        +-1 orders); stored as ``calibrations["pixel"]["phase_fit"]``
        (``levels``, ``phase`` with ``phase[0] = 0``, ``amplitude``,
        ``rmse``). ``plot`` shows each period's first-order power matrix.
        Returns the calibration.
        """
        cal = self.calibrations["pixel"]

        if fit:
            data = np.asarray(cal["data"])  # (2, P, N, N, M)
            orders = np.asarray(cal["orders"])
            picks = [int(np.where(orders == 1)[0][0])]
            if np.any(orders == -1):
                picks.append(int(np.where(orders == -1)[0][0]))
            power = data[:, :, :, :, picks].mean(axis=(0, 1, -1))  # (N, N)

            # Symmetrize and remove the zero-contrast (diagonal) baseline.
            power = 0.5 * (power + power.T)
            power = np.clip(power - np.median(np.diag(power)), 0, None)

            levels = np.asarray(cal["levels"], dtype=float)
            # Start at the ideal linear response of the bit depth.
            phase_init = 2 * np.pi * levels / self.slm.bitresolution
            scale_init = max(float(power.max()), 1e-12)

            def residuals(params):
                phase = np.concatenate([[0.0], params[:-1]])
                scale = np.exp(params[-1])
                model = scale * np.square(np.sin(0.5 * (phase[:, None] - phase[None, :])))
                return (model - power).ravel()

            solution = optimize.least_squares(
                residuals,
                np.concatenate([phase_init[1:] - phase_init[0], [np.log(scale_init)]]),
            )
            cal["phase_fit"] = {
                "levels": levels,
                "phase": np.concatenate([[0.0], solution.x[:-1]]),
                "amplitude": float(np.exp(solution.x[-1])),
                "rmse": float(np.sqrt(np.mean(np.square(solution.fun)))),
            }

        if plot:
            import matplotlib.pyplot as plt

            data = np.asarray(cal["data"])
            order_index = int(np.where(np.asarray(cal["orders"]) == 1)[0][0])
            fig, axs = plt.subplots(2, len(cal["periods"]), figsize=(4 * len(cal["periods"]), 8))
            # One period gives subplots of shape (2,).
            axs = np.array(axs).reshape(2, -1)
            for i in (0, 1):
                for j in range(len(cal["periods"])):
                    axs[i, j].imshow(data[i, j, :, :, order_index])
                    axs[i, j].set_title(f"{'x' if i == 0 else 'y'} period {cal['periods'][j]}")
            plt.show()
        return cal

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

        if plot > 1:
            hologram.plot_farfield()
            hologram.plot_nearfield()

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
        """Raw-data diagnostic for the Zernike wavefront calibration:
        scatter of the per-point aberration correction for one Zernike
        term over the camera plane (ref ``cameraslms.py:2041-2063``)."""
        import matplotlib.pyplot as plt

        dat = self.calibrations["wavefront_zernike"]
        if calibration_points is None:
            calibration_points = np.copy(dat["corrected_spots"])
        points_ij = np.asarray(dat["calibration_points_ij"])
        zernike_indices = np.asarray(dat["zernike_indices"])

        aberration = np.asarray(calibration_points)[index, :]
        lim = np.max(np.abs(aberration)) or 1

        plt.scatter(points_ij[0, :], points_ij[1, :], c=aberration, cmap="seismic")
        plt.gca().invert_yaxis()
        cbar = plt.colorbar()
        cbar.ax.set_ylabel("Aberration Correction [rad]")
        plt.clim(-lim, lim)
        plt.title(f"Zernike $Z_{{{zernike_indices[index]}}}$")

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
        hologram and returns it. ``plot`` above 0 shows each term's sweep
        and fit, the calibration points, and (with no perturbation) the
        camera's status image; 2 and above, the spots' tiles and the
        refined offsets too; below 0, no progress bars.
        Returns the ``"wavefront_zernike"`` calibration dict: the initial
        and corrected points, the indices, the last sweep's results, the
        camera points and window width, the metric before each term and
        after the last, and the weights.
        """
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

        def fit_term(sweep, result, term_index):
            """The parabola's minimum per spot (clipped to the sweep)."""
            ddy = np.diff(result, n=2, axis=0)
            a0 = 0.5 * np.mean(ddy, axis=0) / np.square(np.mean(np.diff(sweep)))
            c0 = np.min(result, axis=0)
            x0 = sweep[np.argmin(result, axis=0)]

            def parabola(x, x0, a, c):
                return c + a * np.square(x - x0)

            x = np.zeros(result.shape[1])
            dx = np.zeros(result.shape[1])
            for i in range(result.shape[1]):
                guess = (x0[i], max(a0[i], 1e-30), c0[i])
                try:
                    popt, pcov = optimize.curve_fit(
                        parabola, sweep, result[:, i], ftol=1e-5, p0=guess,
                        bounds=([-np.inf, 0, -np.inf], [np.inf, np.inf, np.inf]),
                    )
                    perr = np.sqrt(np.diag(pcov))
                except Exception:
                    popt = guess
                    perr = np.zeros(3)
                x[i] = popt[0]
                dx[i] = perr[0]
            x = np.clip(x, np.min(sweep), np.max(sweep))

            if plot > 0:
                import matplotlib.pyplot as plt

                shown = result - np.min(result, axis=0, keepdims=True)
                shown = shown / np.maximum(np.max(shown, axis=0, keepdims=True), 1e-30)
                plt.imshow(
                    shown,
                    interpolation="none",
                    extent=[-0.5, result.shape[1] - 0.5, np.max(sweep), np.min(sweep)],
                )
                plt.errorbar(np.arange(result.shape[1]), x, yerr=dx, c="r", marker=".",
                             linestyle="none")
                plt.gca().set_aspect("auto")
                plt.title("Zernike $Z_{" + str(term_index) + "}$")
                plt.xlabel("Calibration Point [#]")
                plt.ylabel("Perturbation [rad]")
                plt.show()
            return x

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
            calibration_points = self.wavefront_calibration_points(pitch, plot=plot > 0)
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
            img = self.cam.get_image()
            if plot > 0:
                # The status: the whole frame with an overexposure check, and
                # each spot's tile at plot >= 2.
                import matplotlib.pyplot as plt

                spots = analysis.take(
                    img, hologram.spot_ij, hologram.spot_integration_width_ij,
                    centered=True, integrate=False,
                )
                peak = np.max(spots)
                if peak >= self.cam.bitresolution - 1:
                    warnings.warn("Image is overexposed.")
                elif peak > 0.5 * self.cam.bitresolution:
                    warnings.warn(
                        f"Image might become overexposed during optimization "
                        f"({peak}/{self.cam.bitresolution - 1})."
                    )
                self.cam.plot(img, title="Zernike Calibration Status")
                if plot >= 2:
                    plt.figure(figsize=(12, 12))
                    analysis.take_plot(spots, separate_axes=False)
                    plt.title("Zernike Calibration Status (Zoom)")
                    plt.show()
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
            hologram.refine_offset(img=None, basis="kxy", force_affine=global_correction,
                                   plot=plot > 1)
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
            correction = fit_term(perturbation, result, i)

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
        ``(D, N)`` coefficients. ``plot`` draws the points and the
        neighbor graph the averaging walks.
        """
        from scipy.spatial import Delaunay

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

        if plot:
            import matplotlib.pyplot as plt

            plt.scatter(*points_ij[:2], c="r", zorder=10)

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

            if plot:
                for n in neighbors:
                    plt.plot([points_ij[0, n], points_ij[0, i]],
                             [points_ij[1, n], points_ij[1, i]], c="k", linewidth=1)

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

        if plot:
            plt.gca().invert_yaxis()
            plt.title("Nearest Neighbor Smoothing")

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
        by their distance from the 0th order. ``plot`` shows the points
        (blue) and the points avoided (red).
        """
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

        if plot:
            import matplotlib.pyplot as plt

            plt.scatter(calibration_points[0, :], calibration_points[1, :], c="b")
            plt.scatter(avoid_points[0, :], avoid_points[1, :], c="r")
            plt.xlim([0, self.cam.shape[1]])
            plt.ylim([self.cam.shape[0], 0])
            plt.show()

        return calibration_points

    # ------------------------------------------------------------------
    # Superpixel wavefront calibration.
    # ------------------------------------------------------------------

    def wavefront_calibration_superpixel_window(self, superpixel_size):
        """
        The interference window (camera pixels) of a superpixel of
        ``superpixel_size`` SLM pixels: its farfield spot size, rounded,
        times the window multiplier.
        """
        interference_size = np.rint(
            np.array(self.get_farfield_spot_size(superpixel_size * self.slm.pitch, basis="ij"))
        ).astype(int)
        return self._wavefront_calibration_window_multiplier * interference_size

    def _wavefront_calibration_superpixel_plot_raw(
        self, index=0, r2_threshold=0, phase_detail=True
    ):
        """
        Raw-data diagnostic for the superpixel wavefront calibration
        (ref ``cameraslms.py:3984-4094``): the calibration point's camera
        location, the measured per-superpixel fringe phase, and either
        the phase derivatives (``phase_detail``) or the measured power
        and fit r². ``index=None`` plots all calibration points' camera
        locations instead.
        """
        import matplotlib.pyplot as plt

        plt.figure(figsize=(16, 8))
        data = self.calibrations["wavefront_superpixel"]

        if index is None:
            coords = np.asarray(data["calibration_points"])
            plt.subplot(1, 4, 1)
            plt.scatter(coords[0, :], coords[1, :], c="r")
            for i in range(coords.shape[1]):
                plt.annotate(str(i), (coords[0, i], coords[1, i]))
            plt.title("Calibration Points")
            plt.xlabel("Camera $x$ [pix]")
            plt.ylabel("Camera $y$ [pix]")
            plt.xlim([0, self.cam.shape[1]])
            plt.ylim([0, self.cam.shape[0]])
            plt.gca().set_aspect(1)
            return

        coord = np.asarray(data["calibration_points"])[:, index]
        phase = np.array(data["phase"][index], dtype=float)
        kx = np.array(data["kx"][index], dtype=float)
        ky = np.array(data["ky"][index], dtype=float)
        with np.errstate(divide="ignore", invalid="ignore"):
            power = np.asarray(data["power"][index], dtype=float) / np.asarray(
                data["normalization"][index], dtype=float
            )
        r2 = np.array(data["r2_fit"][index], dtype=float)

        below = r2 < r2_threshold
        for matrix in (phase, kx, ky, power):
            matrix[below] = np.nan

        kscale = np.nanmax(
            [np.nanmax(np.abs(kx), initial=0), np.nanmax(np.abs(ky), initial=0)]
        ) or 1

        plt.subplot(1, 4, 1)
        plt.scatter(coord[0], coord[1], c="r")
        plt.annotate(str(index), (coord[0], coord[1]))
        plt.title(f"Calibration Point {index}")
        plt.xlabel("Camera $x$ [pix]")
        plt.ylabel("Camera $y$ [pix]")
        plt.xlim([0, self.cam.shape[1]])
        plt.ylim([0, self.cam.shape[0]])
        plt.gca().set_aspect(1)

        plt.subplot(1, 4, 2)
        plt.imshow(phase, clim=(0, 2 * np.pi), cmap="twilight", interpolation="none")
        plt.title(r"Phase Correction $\phi$")
        plt.xticks([])
        plt.yticks([])

        plt.subplot(1, 4, 3)
        if phase_detail:
            plt.imshow(kx, clim=(-kscale, kscale), cmap="twilight", interpolation="none")
            plt.title(r"$k_x \propto \partial\phi/\partial x$")
        else:
            plt.imshow(power)
            plt.title("Measured Beam Power")
        plt.xticks([])
        plt.yticks([])

        plt.subplot(1, 4, 4)
        if phase_detail:
            plt.imshow(ky, clim=(-kscale, kscale), cmap="twilight", interpolation="none")
            plt.title(r"$k_y \propto \partial\phi/\partial y$")
        else:
            plt.imshow(r2, clim=(0, 1))
            plt.title("$R^2$")
        plt.xticks([])
        plt.yticks([])

        plt.show()

    def wavefront_calibrate_superpixel(
        self,
        calibration_points=None,
        superpixel_size=50,
        reference_superpixels=None,
        exclude_superpixels=(0, 0),
        test_index=None,
        field_point=(0, 0),
        field_point_units="kxy",
        phase_steps=1,
        fresh_calibration=True,
        measure_background=False,
        corrected_amplitude=False,
        plot=0,
    ):
        r"""
        Superpixel wavefront calibration (Čižmár's interference method,
        doi:10.1038/nphoton.2010.85): a reference superpixel and each test
        superpixel blaze to the same camera point, and their fringes give
        the test superpixel's phase offset, local blaze gradient ``(kx,
        ky)``, amplitude and fit r². Several calibration points run at
        once through a conflict-free schedule
        (:meth:`_build_superpixel_schedule`). Every measurement is a frame
        of the camera: on the simulated rig, a farfield on the ported FFT
        kernels.

        ``calibration_points`` are ``"ij"`` points (None: the layout of
        :meth:`wavefront_calibration_points` at 1.5 windows). The SLM is
        cut into ``superpixel_size`` squares; ``reference_superpixels``
        (``(2, N)`` superpixel coordinates; default, those nearest the SLM's
        center), ``exclude_superpixels`` (margins ``(x, y)`` or a boolean
        image of the superpixel grid). ``test_index`` measures one
        schedule column and returns its result. The unused field blazes
        to ``field_point`` (in ``field_point_units``). ``phase_steps``: 1
        fits the single-shot fringe image, N > 1 fits a cosine to N
        stepped phases, None measures the amplitude only.
        ``fresh_calibration`` drops the stored correction while measuring;
        ``measure_background`` measures each window with the superpixels
        off; ``corrected_amplitude`` measures the power with the measured
        blaze corrected. ``plot`` 0 shows progress bars (when tqdm is
        installed), -1 nothing; 1 and above also each fit, 2 and above each
        measurement's SLM phase and camera frame with the labeled windows.

        Returns the raw ``"wavefront_superpixel"`` calibration;
        :meth:`wavefront_calibration_superpixel_process` makes the
        correction.
        """
        from slmsuite_torch.holography.toolbox import imprint, smallest_distance

        superpixel_size = int(superpixel_size)
        slm_supershape = tuple(np.ceil(np.array(self.slm.shape) / superpixel_size).astype(int))
        num_superpixels = slm_supershape[0] * slm_supershape[1]

        interference_window = self.wavefront_calibration_superpixel_window(
            superpixel_size
        ).ravel()
        interference_size = interference_window / self._wavefront_calibration_window_multiplier
        interference_window = (interference_window // 2) * 2 + 1
        interference_size = (interference_size // 2) * 2 + 1

        def index2coord(index):
            return format_2vectors(
                np.stack((index % slm_supershape[1], index // slm_supershape[1]), axis=0)
            )

        def coord2index(coord):
            coord = np.array(coord)
            return coord[1, :] * slm_supershape[1] + coord[0, :]

        # Exclusions.
        exclude_superpixels = np.array(exclude_superpixels)
        if exclude_superpixels.shape == slm_supershape:
            exclude_superpixels = exclude_superpixels != 0
        elif exclude_superpixels.size == 2:
            margin = exclude_superpixels.astype(int)
            exclude_superpixels = np.zeros(slm_supershape, dtype=bool)
            if margin[0]:
                exclude_superpixels[:, : margin[0]] = True
                exclude_superpixels[:, slm_supershape[1] - margin[0]:] = True
            if margin[1]:
                exclude_superpixels[: margin[1], :] = True
                exclude_superpixels[slm_supershape[0] - margin[1]:, :] = True
        else:
            raise ValueError("Did not recognize type for exclude_superpixels")

        # Calibration points.
        if calibration_points is None:
            calibration_points = self.wavefront_calibration_points(
                1.5 * np.max(interference_window),
                np.max(interference_window),
                field_point,
                field_point_units,
                plot=False,
            )
        calibration_points = np.rint(format_2vectors(calibration_points)).astype(int)
        num_points = calibration_points.shape[1]

        base_point = np.rint(self.kxyslm_to_ijcam([0, 0])).astype(int)

        if field_point_units != "ij":
            field_blaze = toolbox.convert_vector(
                format_2vectors(field_point), field_point_units, "kxy", hardware=self.slm
            )
            field_point = self.kxyslm_to_ijcam(field_blaze)
        else:
            field_blaze = toolbox.convert_vector(field_point, "ij", "kxy", hardware=self)
        field_point = np.rint(format_2vectors(field_point)).astype(int)

        if "fourier" not in self.calibrations:
            raise RuntimeError("Fourier calibration must be done before wavefront calibration.")
        calibration_blazes = self.ijcam_to_kxyslm(calibration_points)
        reference_blazes = calibration_blazes.copy()

        # The reference superpixels default to those nearest the SLM's center.
        if reference_superpixels is None:
            all_coords = index2coord(np.arange(num_superpixels))
            distance = np.sum(
                np.square(all_coords - format_2vectors(slm_supershape[::-1]) / 2), axis=0
            )
            reference_superpixels = np.argsort(distance)[:num_points]
        else:
            reference_superpixels = coord2index(
                np.rint(format_2vectors(reference_superpixels)).astype(int)
            )

        reference_superpixels_coords = index2coord(reference_superpixels)
        reference_image = np.zeros(slm_supershape, dtype=bool)
        reference_image.ravel()[reference_superpixels] = True
        if np.any(np.logical_and(reference_image, exclude_superpixels)):
            raise ValueError("reference_superpixels out of range of calibration.")

        scheduling = _build_superpixel_schedule(
            slm_supershape, exclude_superpixels, reference_superpixels, phase_steps
        )
        num_measurements = scheduling.shape[1]

        # Geometry.
        if num_points > 1:
            calibration_distance = smallest_distance(calibration_points, "euclidean")
            if np.max(interference_window) > calibration_distance:
                message = (
                    f"Requested calibration points are too close together: minimum "
                    f"distance {calibration_distance} pix < window {interference_window} pix."
                )
                if test_index is None:
                    raise ValueError(message)
                warnings.warn(message)

        dorder = field_point - base_point
        order_distance = np.inf
        for order in range(-5, 5):
            order_distance = min(
                order_distance,
                smallest_distance(
                    np.hstack((calibration_points, base_point + order * dorder)), "euclidean"
                ),
            )
        if np.mean(interference_window) > order_distance:
            warnings.warn(
                "Calibration point(s) are close to field diffractive orders; "
                "consider moving the calibration regions."
            )

        reflections = 2 * base_point - calibration_points
        reflection_distance = smallest_distance(
            np.hstack((calibration_points, reflections)), "euclidean"
        )
        if np.mean(interference_window) / 2 > reflection_distance:
            warnings.warn(
                "Calibration points are close to their own -1st orders; consider "
                "avoid_mirrors in wavefront_calibration_points."
            )

        amplitude = self.slm._get_source_amplitude()
        phase = self.slm._get_source_phase()
        if fresh_calibration:
            self.slm.source.pop("amplitude", None)
            self.slm.source.pop("phase", None)
            self.slm.source.pop("r2", None)

        if phase_steps is not None:
            if not np.isclose(phase_steps, int(phase_steps)):
                raise ValueError(f"Expected integer phase_steps. Received {phase_steps}.")
            phase_steps = int(phase_steps)
            if phase_steps <= 0:
                raise ValueError(f"Expected positive phase_steps. Received {phase_steps}.")

        verbose = plot >= 0
        plot_fits = plot >= 1

        calibration_dict = {
            "__version__": __version__,
            "__time__": time.time(),
            "calibration_points": calibration_points,
            "superpixel_size": superpixel_size,
            "slm_supershape": slm_supershape,
            "reference_superpixels": reference_superpixels,
            "phase_steps": phase_steps,
            "interference_size": interference_size,
            "interference_window": interference_window,
            "previous_phase_correction": (
                False if "phase" not in self.slm.source else np.copy(self.slm.source["phase"])
            ),
            "scheduling": scheduling,
        }
        keys = [
            "power", "normalization", "background", "phase", "kx", "ky",
            "amp_fit", "contrast_fit", "r2_fit",
        ]
        for key in keys:
            calibration_dict[key] = np.full((num_points,) + slm_supershape, np.nan,
                                            dtype=np.float32)

        # The field's blaze, under every pattern (computed once).
        field_pattern = blaze(self.slm, field_blaze)

        def superpixels(
            schedule=None,
            reference_phase=None,
            target_phase=None,
            reference_blaze=reference_blazes,
            target_blaze=calibration_blazes,
            phase_baselines=None,
        ):
            """Project the field with the reference (and target) superpixels
            blazed to their points; returns the camera's frame."""
            matrix = field_pattern.copy()

            if reference_phase is not None:
                for i in range(num_points):
                    if schedule is None or schedule[i] != -1:
                        imprint(
                            matrix,
                            np.array([
                                reference_superpixels_coords[0, i], 1,
                                reference_superpixels_coords[1, i], 1,
                            ]) * superpixel_size,
                            _blaze_offset,
                            self.slm,
                            vector=reference_blaze[:, [i]],
                            offset=reference_phase,
                        )

            if target_phase is not None and schedule is not None:
                target_coords = index2coord(schedule)
                for i in range(num_points):
                    if schedule[i] != -1:
                        baseline = 0 if phase_baselines is None else phase_baselines[i]
                        imprint(
                            matrix,
                            np.array([target_coords[0, i], 1, target_coords[1, i], 1])
                            * superpixel_size,
                            _blaze_offset,
                            self.slm,
                            vector=target_blaze[:, [i]],
                            offset=baseline + (
                                target_phase if np.isscalar(target_phase) else target_phase[i]
                            ),
                        )

            self.slm.set_phase(matrix, settle=True)
            self.cam.flush()
            return self.cam.get_image()

        def fit_phase(phases, intensities, plot_this=False):
            """The stepped cosine fit: ``(phase, amplitude, r2, contrast)``."""
            guess = [
                phases[np.argmax(intensities)],
                np.max(intensities) - np.min(intensities),
                np.min(intensities),
            ]
            try:
                popt, _ = optimize.curve_fit(cos, phases, intensities, p0=guess)
            except BaseException:
                warnings.warn("Curve fitting failed; nulling response from this superpixel.")
                return 0, 0, 0, 0

            best_phase = popt[0]
            amp = popt[1]
            contrast = popt[1] / (popt[1] + popt[2]) if popt[1] + popt[2] != 0 else 0
            ss_res = np.sum((intensities - cos(phases, *popt)) ** 2)
            ss_tot = np.sum((intensities - np.mean(intensities)) ** 2)
            r2 = 1 - (ss_res / ss_tot) if ss_tot > 0 else 0

            if plot_this:
                import matplotlib.pyplot as plt

                plt.scatter(phases / np.pi, intensities, color="k", label="Data")
                phases_fine = np.linspace(0, 2 * np.pi, 100)
                plt.plot(phases_fine / np.pi, cos(phases_fine, *popt), "k-", label="Fit")
                plt.plot(phases_fine / np.pi, cos(phases_fine, *guess), "k--", label="Guess")
                plt.plot(best_phase / np.pi, popt[1] + popt[2], "xr", label="Phase")
                plt.legend(loc="best")
                plt.title(f"Interference ($R^2$={r2:.3f})")
                plt.grid()
                plt.xlim([0, 2])
                plt.xlabel(r"$\phi$ $[\pi]$")
                plt.ylabel("Signal")
                plt.show()
            return best_phase, amp, r2, contrast

        def fit_phase_image(img, dsuperpixel):
            """The single-shot fit of the fringe image: ``(phase,
            amplitude, r2, contrast)``."""
            xy = np.meshgrid(
                *[
                    np.arange(-(img.shape[1 - a] - 1) / 2, +(img.shape[1 - a] - 1) / 2 + 0.5)
                    for a in range(2)
                ]
            )
            xyr = [g.ravel() for g in xy]

            M = self.calibrations["fourier"]["M"]
            M_norm = M / np.sqrt(np.abs(np.linalg.det(M)))
            dsuperpixel = np.squeeze(M_norm @ format_2vectors(dsuperpixel))

            d = float(np.amin(img))
            c = 0
            a = float(np.amax(img)) - c
            R = float(np.mean(img.shape)) / 4

            guess = [
                R, a, 0, c, d,
                8 * np.pi * dsuperpixel[0] / img.shape[1],
                8 * np.pi * dsuperpixel[1] / img.shape[0],
            ]
            dk = 8 * np.pi * np.max(slm_supershape) / np.min(img.shape)
            lb = [0.9 * R, 0, -4 * np.pi, 0, 0, guess[5] - dk, guess[6] - dk]
            ub = [1.1 * R, 2 * a + 1e-9, 4 * np.pi, a + 1e-9, a + 1e-9,
                  guess[5] + dk, guess[6] + dk]

            # A coarse phase guess by overlap.
            differences = []
            phases = np.arange(20) * 2 * np.pi / 20
            for trial in phases:
                guess[2] = trial
                differences.append(np.sum(np.square(img - _sinc2d_centered(xy, *guess))))
            guess[2] = phases[int(np.argmin(differences))]

            try:
                popt, _ = optimize.curve_fit(
                    _sinc2d_centered, xyr, img.ravel().astype(float), p0=guess,
                    bounds=(lb, ub),
                )
            except BaseException:
                return [np.nan, np.nan, 0, np.nan]

            best_phase = popt[2]
            amp = np.abs(popt[1])
            denominator = np.abs(popt[1]) + np.abs(popt[3])
            contrast = np.abs(popt[1]) / denominator if denominator != 0 else 0

            popt_nomod = np.copy(popt)
            popt_nomod[3] += popt_nomod[1] / 2
            popt_nomod[1] = 0
            img0 = img - _sinc2d_centered(xy, *popt_nomod)
            fit0 = _sinc2d_centered(xy, *popt) - _sinc2d_centered(xy, *popt_nomod)
            ss_res = np.sum((img0 - fit0) ** 2)
            ss_tot = np.sum((img0 - np.mean(img0)) ** 2)
            r2 = 1 - (ss_res / ss_tot) if ss_tot > 0 else 0

            if plot_fits:
                import matplotlib.pyplot as plt

                _, axs = plt.subplots(1, 3, figsize=(20, 10))
                axs[0].imshow(img)
                axs[1].imshow(_sinc2d_centered(xy, *guess))
                axs[2].imshow(_sinc2d_centered(xy, *popt))
                for a, fit_title in enumerate(["Image", "Guess", "Fit"]):
                    axs[a].set_title(fit_title)
                plt.show()

            return (np.mod(-best_phase, 2 * np.pi), amp, r2, contrast)

        def take_interference_regions(img, integrate=True):
            return analysis.take(
                img, calibration_points, interference_window, clip=True, integrate=integrate
            )

        def find_centers(img):
            """The interference spots' centers (camera pixels), by a sinc²
            fit of each window."""
            imgs = take_interference_regions(img, integrate=False)
            centers = analysis.image_positions(imgs)
            a = np.nanmax(imgs, axis=(1, 2))
            R = np.mean(imgs.shape[1:]) / 4
            guess = np.transpose(
                np.vstack((centers, np.full_like(a, R), a, np.full_like(a, 0)))
            )
            result = analysis.image_fit(np.nan_to_num(imgs), function=_sinc2d_nomod,
                                        guess=guess)
            return result[:, 1:3].T + calibration_points

        def plot_labeled(schedule, img, title="", focus=0):
            """The SLM phase with the labeled reference and test superpixels,
            the log-scaled camera frame with the diffraction orders and the
            labeled windows, and a zoom on the focused window."""
            import matplotlib.pyplot as plt

            fig, axs = plt.subplots(1, 3, figsize=(16, 4))

            axs[0].imshow(
                np.mod(as_numpy(self.slm.phase), 2 * np.pi),
                cmap="twilight", interpolation="none",
            )
            center = np.array([superpixel_size / 2, superpixel_size / 2])
            points, labels, colors = [], [], []
            for i in range(num_points):
                if schedule is not None and schedule[i] == -1:
                    continue
                points.append(
                    reference_superpixels_coords[:, i] * superpixel_size
                    + center
                )
                labels.append(str(i) if num_points > 1 else "Reference\nSuperpixel")
                colors.append((1 if i == focus else 0.5, 0.2, 0))
                if schedule is not None:
                    points.append(
                        (index2coord(schedule)[:, i] * superpixel_size
                         + center).ravel()
                    )
                    labels.append(str(i) if num_points > 1 else "Test\nSuperpixel")
                    colors.append((1 if i == focus else 0.5, 0, 0.2))
            _plot_labeled_rects(
                axs[0], points, labels, colors, superpixel_size, superpixel_size
            )
            axs[0].set_title("SLM Phase")

            if img is not None:
                im = axs[1].imshow(np.log10(as_numpy(img).astype(float) + 0.1))
                im.set_clim(0, np.log10(self.cam.bitresolution))
            dpoint = field_point - base_point
            points = [(base_point + n * dpoint).ravel() for n in range(-2, 3)]
            labels = ["-2nd", "-1st", "0th", "1st", "2nd"]
            colors = ["b"] * 5
            focus_point = None
            for i in range(num_points):
                if schedule is not None and schedule[i] == -1:
                    continue
                points.append(calibration_points[:, i])
                labels.append(str(i) if num_points > 1 else "Calibration\nPoint")
                colors.append((1 if i == focus else 0.5, 0, 0))
                if i == focus:
                    focus_point = calibration_points[:, i]
            wh, hh = (int(v) for v in interference_window)
            _plot_labeled_rects(axs[1], points, labels, colors, wh, hh)
            axs[1].set_title("Camera Result")

            if img is not None:
                im = axs[2].imshow(np.log10(as_numpy(img).astype(float) + 0.1))
                im.set_clim(0, np.log10(self.cam.bitresolution))
                step = 2 if self.cam.bitdepth > 10 else 1
                bitres_list = np.power(
                    2, np.arange(0, self.cam.bitdepth + 1, step), dtype=int
                )
                cbar = fig.colorbar(im, ax=axs[2])
                cbar.ax.set_yticks(np.log10(bitres_list))
                cbar.ax.set_yticklabels(bitres_list)
            if focus_point is None:
                focus_point = base_point.ravel()
            axs[2].scatter([focus_point[0]], [focus_point[1]], 5, "r", "*")
            axs[2].set_xlim(focus_point[0] - wh / 2, focus_point[0] + wh / 2)
            axs[2].set_ylim(focus_point[1] + hh / 2, focus_point[1] - hh / 2)
            for spine in axs[2].spines.values():
                spine.set_color("r")
                spine.set_linewidth(1.5)
            axs[2].set_title(title)

            plt.show()

        nans = [np.nan] * num_points

        def measure(schedule):
            """One schedule column: a value of each key for each point."""
            if measure_background:
                back = take_interference_regions(superpixels(schedule, None, None))
            else:
                back = nans

            norm = take_interference_regions(superpixels(schedule, 0, None))

            position_image = superpixels(schedule, None, 0)
            if plot > 1:
                plot_labeled(schedule, position_image, title="Test Point")
            if phase_steps is None and not corrected_amplitude:
                return {
                    "power": take_interference_regions(position_image),
                    "normalization": norm, "background": back,
                    "phase": nans, "kx": nans, "ky": nans,
                    "amp_fit": nans, "contrast_fit": nans, "r2_fit": nans,
                }

            found_centers = find_centers(position_image)
            blaze_differences = self.ijcam_to_kxyslm(found_centers) - calibration_blazes
            target_blaze_fixed = calibration_blazes - blaze_differences

            if corrected_amplitude:
                pwr = take_interference_regions(
                    superpixels(schedule, None, 0, target_blaze=target_blaze_fixed)
                )
            else:
                pwr = take_interference_regions(position_image)

            if phase_steps is None:
                return {
                    "power": pwr, "normalization": norm, "background": back,
                    "phase": nans,
                    "kx": -blaze_differences[0, :], "ky": -blaze_differences[1, :],
                    "amp_fit": nans, "contrast_fit": nans, "r2_fit": nans,
                }

            results = []
            if phase_steps == 1:
                result_img = superpixels(schedule, 0, 0, target_blaze=target_blaze_fixed)
                if plot > 1:
                    plot_labeled(schedule, result_img, title="Interference")
                cropped = take_interference_regions(result_img, integrate=False)
                coord_difference = index2coord(schedule) - index2coord(reference_superpixels)
                results = [
                    (
                        fit_phase_image(np.nan_to_num(cropped[i]), coord_difference[:, i])
                        if schedule[i] != -1
                        else [np.nan] * 4
                    )
                    for i in range(num_points)
                ]
            else:
                phases = np.linspace(0, 2 * np.pi, phase_steps, endpoint=False)
                iresults = []
                trials = _progress(phases, "phase_measurement") if verbose else phases
                for trial in trials:
                    interference_image = superpixels(
                        schedule, 0, trial, target_blaze=target_blaze_fixed
                    )
                    iresults.append([
                        interference_image[calibration_points[1, i], calibration_points[0, i]]
                        for i in range(num_points)
                    ])
                iresults = np.array(iresults)
                for i in range(num_points):
                    results.append(fit_phase(phases, iresults[:, i], plot_this=plot_fits))

            results = np.array(results)
            return {
                "power": pwr, "normalization": norm, "background": back,
                "phase": results[:, 0],
                "kx": -blaze_differences[0, :], "ky": -blaze_differences[1, :],
                "amp_fit": results[:, 1], "contrast_fit": results[:, 3],
                "r2_fit": results[:, 2],
            }

        # Correct the reference blazes by the measured centers.
        base_image = superpixels(None, 0, None)
        found_centers = find_centers(base_image)
        reference_blaze_differences = self.ijcam_to_kxyslm(found_centers) - reference_blazes
        np.subtract(reference_blazes, reference_blaze_differences, out=reference_blazes)

        if test_index is not None:
            result = measure(scheduling[:, test_index])
            self.slm.source["amplitude"] = amplitude
            self.slm.source["phase"] = phase
            return result

        measurements = range(num_measurements)
        if plot > -1:
            measurements = _progress(measurements, "calibration")

        for n in measurements:
            schedule = scheduling[:, n]
            measurement = measure(schedule)
            coords = index2coord(schedule)
            for i in range(num_points):
                if schedule[i] != -1:
                    for key in measurement:
                        result = measurement[key]
                        if np.size(result) > 1:
                            result = result[i]
                        elif not np.isscalar(result):
                            result = np.squeeze(result)
                        calibration_dict[key][i, coords[1, i], coords[0, i]] = result

        self.calibrations["wavefront_superpixel"] = calibration_dict
        self.calibrations["wavefront_superpixel"].update(self._get_calibration_metadata())
        return calibration_dict

    def wavefront_calibration_superpixel_process(
        self,
        index=0,
        smooth=True,
        r2_threshold=0.9,
        remove_vortices=False,
        remove_blaze=True,
        remove_background=True,
        apply=True,
        plot=False,
    ):
        """
        The usable source phase and amplitude from the raw superpixel data
        of calibration point ``index`` (a multi-point calibration is first
        cut to the single-point r001 form; a stored ``"wavefront"`` r001
        calibration is read as it is): see
        :meth:`_process_superpixel_calibration`. Writes ``slm.source``
        (``"phase"``, ``"amplitude"``, ``"r2"``) when ``apply``.
        ``plot`` shows the result (:meth:`SLM.plot_source`).
        """
        if "wavefront_superpixel" in self.calibrations:
            data = self.calibrations["wavefront_superpixel"]
        elif "wavefront" in self.calibrations:
            data = self.calibrations["wavefront"]
        else:
            raise RuntimeError("Could not find wavefront calibration.")
        if len(data) == 0:
            raise RuntimeError("No raw wavefront data to process.")

        if "__version__" not in data:
            data["__version__"] = "0.0.1"

        if data["__version__"] != "0.0.1":
            # Flatten a (multi-point) calibration into the r001 single-point form.
            slm_supershape = tuple(np.asarray(data["slm_supershape"]).astype(int))
            reference = np.asarray(data["reference_superpixels"]).astype(int)[index]
            correction = {
                "NX": slm_supershape[1],
                "NY": slm_supershape[0],
                "nxref": int(reference % slm_supershape[1]),
                "nyref": int(reference // slm_supershape[1]),
                "superpixel_size": data["superpixel_size"],
                "interference_point": np.asarray(data["calibration_points"])[:, index],
                "interference_size": data["interference_size"],
                "previous_phase_correction": data.get("previous_phase_correction", False),
            }
            for key in [
                "power", "normalization", "background", "phase", "kx", "ky",
                "amp_fit", "contrast_fit", "r2_fit",
            ]:
                correction[key] = np.asarray(data[key])[index]
            data = correction

        wavefront_calibration = self._process_superpixel_calibration(
            data,
            smooth=smooth,
            r2_threshold=r2_threshold,
            remove_vortices=remove_vortices,
            remove_blaze=remove_blaze,
            remove_background=remove_background,
            apply=apply,
        )
        if plot:
            self.slm.plot_source(source=wavefront_calibration)
        return wavefront_calibration

    def _process_superpixel_calibration(
        self,
        data,
        smooth=True,
        r2_threshold=0.9,
        remove_vortices=False,
        remove_blaze=True,
        remove_background=True,
        apply=True,
    ):
        """
        The single-point processing:

        1. the trust map, from the fringe fit's r² (the reference trusted);
        2. the amplitude: the reference's reading patched from its
           neighbors, a uniform noise floor removed when detected,
           ``(power - background) / (normalization - background)``, cubic
           upsampling, a Gaussian blur of ``4 superpixel_size + 1`` taps
           (``smooth``), the square root;
        3. the wavefront: each superpixel's affine model ``(offset, kx,
           ky)`` anchored at the reference, the untrusted ones filled by
           :meth:`_propagate_affine_phase`, expanded to the SLM's pixels,
           smoothed ``smooth`` times (``True``: 16) in the complex domain
           by a blur of ``2 (superpixel_size // 4) + 1`` taps (vortices
           removed half way with ``remove_vortices``), then the global
           blaze removed (``remove_blaze``) and the wraps reduced, with the
           correction that was on during the measurement added back.

        The upsampling, the blurs and the expansion run in float64 on the
        rig's device (:mod:`slmsuite_torch.holography.analysis._cv`, which
        reproduces OpenCV); the fills and the phase-image operations on the
        host. The camera records the fringe phase modulo 2pi per
        superpixel, so every mean of phases here is circular.
        """
        if smooth is True:
            smooth = 16
        smooth = int(smooth)
        if smooth < 0:
            raise ValueError("Smoothing iterations must be a non-negative integer.")
        r2_threshold = float(r2_threshold)

        supershape = (int(data["NY"]), int(data["NX"]))
        ref = (int(data["nyref"]), int(data["nxref"]))
        superpixel_size = int(data["superpixel_size"])
        H, W = self.slm.shape
        device = resolve_device(getattr(self.cam, "device", None))

        def dev(matrix):
            return torch.as_tensor(np.asarray(matrix, dtype=np.float64), device=device)

        def upsample(matrix, interpolation):
            """Superpixel grid -> SLM pixels (cropped to the SLM), on the device."""
            full = _cv.resize(
                dev(matrix),
                (superpixel_size * supershape[1], superpixel_size * supershape[0]),
                interpolation,
            )
            return full[:H, :W]

        # The trust map. The reference never interferes with itself, so it
        # has no fit: it is trusted (its phase is 0 by definition).
        r2 = np.nan_to_num(np.asarray(data["r2_fit"], dtype=float))
        r2[ref] = 1
        trusted = r2 >= r2_threshold
        r2_map = upsample(r2, _cv.INTER_NEAREST).cpu().numpy()

        # The amplitude. The reference's own power reading is contaminated
        # (it was always on): patch it from its neighbors.
        power = np.asarray(data["power"], dtype=float).copy()
        # Clamp to the largest finite reading (nanmax would return inf).
        finite = power[np.isfinite(power)]
        power[np.isinf(power)] = finite.max() if finite.size else 0.0
        normalization = np.asarray(data["normalization"], dtype=float).copy()
        background = np.nan_to_num(np.asarray(data["background"], dtype=float))
        for matrix in (power, normalization, background):
            _patch_from_neighbors(matrix, ref)

        if remove_background and not background.any():
            floor = _detect_noise_floor(power, normalization, ~trusted)
            if floor is not None:
                warnings.warn("Noise floor detected; removing this background.")
                background[:] = floor

        with np.errstate(divide="ignore", invalid="ignore"):
            power_norm = (power - background) / (normalization - background)
        power_norm[~np.isfinite(power_norm)] = 0
        np.clip(power_norm, 0, None, out=power_norm)

        power_map = upsample(power_norm, _cv.INTER_CUBIC)
        power_map = torch.where(torch.isfinite(power_map), power_map, 0.0).clamp(min=0)
        if smooth:
            power_map = _cv.gaussian_blur(power_map, 4 * superpixel_size + 1)

        amplitude = torch.sqrt(power_map)
        if amplitude.max() > 0:
            amplitude = amplitude / amplitude.max()
        amplitude = amplitude.cpu().numpy()
        power_map = power_map.cpu().numpy()

        # The wavefront. Patch the reference's fit from its neighbors (the
        # phase circularly), then fill the untrusted region.
        kx = np.nan_to_num(np.asarray(data["kx"], dtype=float))
        ky = np.nan_to_num(np.asarray(data["ky"], dtype=float))
        fringe = np.nan_to_num(np.asarray(data["phase"], dtype=float))
        re, im = np.cos(fringe), np.sin(fringe)
        for matrix in (re, im, kx, ky):
            _patch_from_neighbors(matrix, ref)
        offset = np.arctan2(im, re) + np.pi  # [0, 2pi)

        kx = np.where(trusted, kx, 0.0)
        ky = np.where(trusted, ky, 0.0)
        offset = np.where(trusted, offset, 0.0)
        kx, ky, offset = _propagate_affine_phase(
            kx, ky, offset, trusted, ref,
            2 * np.pi * superpixel_size * np.asarray(self.slm.pitch),
        )

        # Expand to the SLM's pixels: phase = 2pi (kx X + ky Y) + offset
        # with each superpixel's (kx, ky, offset), as imprinting a blaze
        # into every superpixel would.
        x_grid, y_grid = self.slm.grid
        phase = (
            2 * np.pi * upsample(kx, _cv.INTER_NEAREST) * dev(x_grid)
            + 2 * np.pi * upsample(ky, _cv.INTER_NEAREST) * dev(y_grid)
            + upsample(offset, _cv.INTER_NEAREST)
        )

        # Smoothing in the complex domain (wrap-safe).
        if smooth:
            ksize = 2 * (superpixel_size // 4) + 1
            for i in _progress(range(smooth), "smooth"):
                re = _cv.gaussian_blur(torch.cos(phase), ksize)
                im = _cv.gaussian_blur(torch.sin(phase), ksize)
                phase = torch.atan2(im, re) + np.pi
                if remove_vortices and i == smooth // 2:
                    phase = dev(analysis.image_remove_vortices(phase.cpu().numpy()))
        else:
            phase = torch.atan2(torch.sin(phase), torch.cos(phase)) + np.pi
        phase = phase.cpu().numpy()

        if remove_blaze:
            phase = analysis.image_remove_blaze(phase, mask=power_map)
        phase = analysis.image_reduce_wraps(phase, mask=power_map)

        previous = data.get("previous_phase_correction", None)
        if previous is not None and np.ndim(previous) > 0:
            phase = phase + np.asarray(previous)

        wavefront_calibration = {
            "phase": phase,
            "amplitude": amplitude,
            "r2": r2_map,
            "r2_threshold": r2_threshold,
        }

        if apply:
            self.slm.source.update(wavefront_calibration)

        return wavefront_calibration
