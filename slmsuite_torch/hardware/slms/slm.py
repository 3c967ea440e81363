r"""
The spatial light modulator interface: the part of
:mod:`slmsuite_tpu.hardware.slms.slm` that the compressed spot hologram
and the simulated rig need (numpy only). It holds the SLM's geometry
(shape, pitch, wavelength, the normalized coordinate grid), its source
(measured or simulated illumination, and the fit of a measured amplitude,
which re-centres the grid on it), the host-side write path
(:meth:`SLM.set_phase`, grayscale conversion into :attr:`SLM.display`),
saving and loading phases, the source's aperture and plots, the expected
point spread function (a tensor on a device) and the self-test.
"""

import inspect
import time
import warnings
from abc import ABC, abstractmethod

import numpy as np

from slmsuite_torch.hardware import _Picklable
from slmsuite_torch.holography import analysis, toolbox
from slmsuite_torch.holography.analysis import fitfunctions
from slmsuite_torch.misc.files import generate_path, latest_path, load_h5, save_h5
from slmsuite_torch.misc.host import as_numpy
from slmsuite_torch.misc.math import REAL_TYPES


class SLM(_Picklable, ABC):
    r"""
    Abstract spatial light modulator.

    Attributes
    ----------
    name : str
    shape : (int, int)
        ``(height, width)`` in pixels.
    bitdepth, bitresolution : int
        Pixel well depth in bits; ``2**bitdepth``.
    settle_time_s : float
        Delay after a write when ``settle`` is set.
    pitch_um, pitch : numpy.ndarray
        Pixel pitch in microns, and in wavelengths.
    wav_um, wav_design_um, phase_scaling : float
        Operating and design wavelengths, and their ratio.
    grid : [numpy.ndarray, numpy.ndarray]
        Normalized (wavelength-unit) coordinate meshgrids, centered.
    source : dict
        Measured or simulated source properties.
    phase, display : numpy.ndarray
        Last written phase (radians) and its quantized hardware data.
    """

    _pickle = [
        "name",
        "shape",
        "bitdepth",
        "bitresolution",
        "pitch_um",
        "pitch",
        "settle_time_s",
        "wav_um",
        "wav_design_um",
        "phase_scaling",
    ]
    _pickle_data = ["source", "phase", "display"]

    @abstractmethod
    def __init__(
        self,
        resolution,
        bitdepth=8,
        name="SLM",
        wav_um=1,
        wav_design_um=None,
        pitch_um=(8, 8),
        settle_time_s=0.3,
    ):
        """``resolution`` is ``(width, height)``, the opposite of the numpy
        order kept in :attr:`shape`."""
        self.name = str(name)
        width, height = resolution
        self.shape = (int(height), int(width))

        self.wav_um = float(wav_um)
        self.wav_design_um = float(wav_um if wav_design_um is None else wav_design_um)
        self.phase_scaling = self.wav_um / self.wav_design_um

        self.bitdepth = int(bitdepth)
        self.settle_time_s = float(settle_time_s)

        if isinstance(pitch_um, REAL_TYPES):
            pitch_um = [pitch_um, pitch_um]
        pitch_um = np.squeeze(pitch_um)
        if len(pitch_um) != 2 or np.any(pitch_um <= 0):
            raise ValueError("Expected positive (float, float) for pitch_um")
        self.pitch_um = np.array([float(pitch_um[0]), float(pitch_um[1])])
        self.pitch = self.pitch_um / self.wav_um

        xpix = (width - 1) * np.linspace(-0.5, 0.5, width)
        ypix = (height - 1) * np.linspace(-0.5, 0.5, height)
        self.grid = list(np.meshgrid(self.pitch[0] * xpix, self.pitch[1] * ypix))

        self.source = {}

        self.dtype = np.dtype(np.uint8 if self.bitdepth <= 8 else np.uint16)
        self.phase = np.zeros(self.shape)
        self.display = np.zeros(self.shape, dtype=self.dtype)

        hw_args = inspect.signature(self._set_phase_hw).parameters.keys()
        self._set_phase_hw_block = "block" in hw_args
        self._set_phase_hw_execute = "execute" in hw_args

        self.phase_correct = True
        self.settle = False

    @property
    def bitresolution(self):
        return 2**self.bitdepth

    @abstractmethod
    def close(self):
        """Close the SLM and free hardware resources."""

    @abstractmethod
    def _set_phase_hw(self, display):
        """Low-level write of integer ``display`` data to the hardware."""

    def write(self, phase, phase_correct=True, settle=False, **kwargs):
        """Backwards-compatible alias of :meth:`set_phase` (it warns, as the
        JAX package's does)."""
        warnings.warn("SLM.write is a backwards-compatible alias of SLM.set_phase.")
        return self.set_phase(phase, phase_correct, settle, **kwargs)

    def set_phase(self, phase, phase_correct=None, settle=None, execute=None, block=None,
                  **kwargs):
        r"""
        Clean, convert and write ``phase`` to the SLM; returns
        :attr:`display`. ``None`` zeroes the phase; a hologram's phase is
        taken with ``get_phase()``; larger arrays are center-cropped;
        integers of the display type are written as they are. Float phase
        changes sign in the conversion (increasing value = decreasing
        phase delay). ``phase_correct`` adds ``source["phase"]``;
        ``settle`` sleeps :attr:`settle_time_s` after the write.
        """
        if execute is None:
            execute = True
        elif self._set_phase_hw_execute:
            kwargs["execute"] = bool(execute)
        else:
            raise ValueError("This SLM does not support the execute argument in set_phase.")

        if block is None:
            block = True
        elif self._set_phase_hw_block:
            kwargs["block"] = bool(block)
        else:
            raise ValueError("This SLM does not support the block argument in set_phase.")

        if hasattr(phase, "get_phase"):
            phase = phase.get_phase()

        if phase is None:
            self.phase.fill(0)
        else:
            phase = np.asarray(phase)

        if phase is not None and np.issubdtype(phase.dtype, np.integer):
            if phase.dtype != self.display.dtype:
                raise TypeError(
                    f"Unexpected integer type {phase.dtype}. Expected {self.display.dtype}."
                )
            if np.any(phase >= self.bitresolution):
                raise TypeError(
                    f"Integer data must be within the bitdepth ({self.bitdepth}-bit) of the SLM."
                )
            if phase.shape != self.shape:
                np.copyto(self.display, toolbox.unpad(phase, self.shape))
            else:
                np.copyto(self.display, phase)
            self.phase = 2 * np.pi - self.display * (
                2 * np.pi / self.phase_scaling / self.bitresolution
            )
        else:
            if phase is not None:
                if phase.shape != self.shape:
                    np.copyto(self.phase, toolbox.unpad(phase, self.shape))
                else:
                    np.copyto(self.phase, phase)
            if phase_correct is None:
                phase_correct = self.phase_correct
            if phase_correct and "phase" in self.source:
                self.phase += np.asarray(self.source["phase"])
            self.display = self._phase2gray(self.phase, out=self.display)

        if execute:
            self._set_phase_hw(self.display, **kwargs)

        if settle is None:
            settle = self.settle
        if execute and settle:
            time.sleep(self.settle_time_s)

        return self.display

    def _phase2gray(self, phase, out=None):
        r"""
        Radians to bitdepth-scaled integers. When ``phase_scaling == 1``
        ``phase`` is left untouched (as the JAX package's native
        conversion leaves it) and a bitwise modulo wraps a power-of-two
        bitresolution; otherwise ``phase`` is wrapped in place with
        ``np.mod``, with the over- and under-range handling of
        ``phase_scaling != 1``.
        """
        if out is None:
            out = np.zeros(self.shape, dtype=self.dtype)

        if self.phase_scaling == 1:
            factor = -(self.bitresolution / 2 / np.pi)
            scaled = phase * factor

            # Shift everything negative so the cast rounds one way.
            maximum = np.amax(scaled)
            if maximum >= 0:
                toshift = self.bitresolution * 2 * float(np.ceil(maximum / self.bitresolution))
                scaled -= toshift

            np.rint(scaled, out=scaled)
            np.copyto(out, scaled, casting="unsafe")

            out -= 1
            if self.bitresolution & (self.bitresolution - 1) == 0:
                np.bitwise_and(out, int(self.bitresolution - 1), out=out)
            else:
                np.mod(out, self.bitresolution, out=out)
        else:
            factor = -(self.bitresolution * self.phase_scaling / 2 / np.pi)
            phase *= factor

            if np.amin(phase) <= -self.bitresolution or np.amax(phase) > 0:
                phase -= 1
                np.mod(phase, self.bitresolution * self.phase_scaling, out=phase)
                phase += self.bitresolution * (1 - self.phase_scaling)
                if self.phase_scaling > 1:
                    phase[phase < 0] = self.bitresolution - 1
            else:
                phase += self.bitresolution - 1

            np.copyto(out, phase, casting="unsafe")
            phase *= 1 / factor

        return out

    def set_source_analytic(self, fit_function="gaussian2d", units="norm", phase_offset=0,
                            sim=False, **kwargs):
        """
        Set the amplitude and phase of :attr:`source` from an analytic
        ``fit_function`` (a name in
        :mod:`slmsuite_torch.holography.analysis.fitfunctions` or a
        callable of ``(xy, **kwargs)``) evaluated on the grid in
        ``units`` (``"norm"``, ``"frac"`` or a length). ``sim=True`` sets
        the simulation's ground-truth keys instead.
        """
        if units == "norm":
            scaling = (1, 1)
        elif units == "frac":
            scaling = [g.max() - g.min() for g in self.grid]
        elif units in toolbox.LENGTH_FACTORS:
            factor = toolbox.LENGTH_FACTORS[units]
            scaling = [factor / self.wav_um, factor / self.wav_um]
        else:
            raise RuntimeError(f"Did not recognize units '{units}'")

        xy = [g / s for g, s in zip(self.grid, scaling)]

        if len(kwargs) == 0 and fit_function == "gaussian2d":
            w = np.min([np.amax(xy[0]), np.amax(xy[1])]) / 2
            kwargs = {"x0": 0, "y0": 0, "a": 1, "c": 0, "wx": w, "wy": w}

        if isinstance(fit_function, str):
            fit_function = getattr(fitfunctions, fit_function)

        source = fit_function(xy, **kwargs)
        self.source["amplitude_sim" if sim else "amplitude"] = np.abs(source)
        self.source["phase_sim" if sim else "phase"] = np.angle(source) + phase_offset
        return self.source

    def fit_source_amplitude(self, method="moments", extent_threshold=0.1, force=True):
        """
        Scalar source parameters (center pixel, amplitude radius, extent),
        from ``source["amplitude"]`` by its moments (``"moments"``) or a 2D
        Gaussian fit (``"fit"``), re-centring :attr:`grid` on the source in
        place; without a measured amplitude, from the SLM's geometry: the
        grid center, a quarter of the smaller side and the grid's extent.
        The grid is a host array: what is built from it (a compressed
        hologram's Zernike basis) is built anew by the next object that
        reads it.
        """
        if "amplitude_center_pix" in self.source and not force:
            return

        center_grid = np.array(
            [np.argmin(np.abs(self.grid[0][0, :])), np.argmin(np.abs(self.grid[1][:, 0]))]
        )

        if "amplitude" not in self.source:
            self.source["amplitude_center_pix"] = center_grid
            self.source["amplitude_radius"] = 0.25 * np.min(
                (self.shape[1] * self.pitch[0], self.shape[0] * self.pitch[1])
            )
            self.source["amplitude_extent"] = np.array(
                [np.max(np.abs(self.grid[0])), np.max(np.abs(self.grid[1]))]
            )
            self.source["amplitude_extent_radius"] = np.sqrt(
                np.amax(np.square(self.grid[0]) + np.square(self.grid[1]))
            )
            return

        amp = np.abs(self.source["amplitude"])
        if extent_threshold > 1:
            raise RuntimeError("extent_threshold cannot exceed 1 (100%).")

        if method == "fit":
            result = analysis.image_fit(amp)
            center = np.array([result[0, 1], result[0, 2]])
            std = np.array([result[0, 5], result[0, 6]])
        else:
            center = analysis.image_positions(np.square(amp))
            std = np.sqrt(2 * analysis.image_variances(np.square(amp), centers=center)[:2])
            center = np.squeeze(center)

        center = center + np.flip(self.shape) / 2

        self.source["amplitude_center_pix"] = center
        self.source["amplitude_radius"] = np.mean(self.pitch * np.squeeze(std))

        dcenter = center_grid - center
        self.grid[0] += dcenter[0] * self.pitch[0]
        self.grid[1] += dcenter[1] * self.pitch[1]

        extent_mask = amp > (extent_threshold * np.amax(amp))
        self.source["amplitude_extent"] = np.array(
            [
                np.max(np.abs(self.grid[0][extent_mask])),
                np.max(np.abs(self.grid[1][extent_mask])),
            ]
        )
        self.source["amplitude_extent_radius"] = np.sqrt(
            np.amax(
                np.square(self.grid[0][extent_mask]) + np.square(self.grid[1][extent_mask])
            )
        )

    def get_source_zernike_scaling(self):
        """Zernike aperture scaling from the source radius."""
        self.fit_source_amplitude(force=False)
        return np.reciprocal(2 * self.source["amplitude_radius"])

    def _get_source_amplitude(self):
        """Source amplitude; uniform if unmeasured."""
        if "amplitude" in self.source:
            return self.source["amplitude"]
        return np.ones(self.shape)

    def _get_source_phase(self):
        """Source phase; flat if unmeasured."""
        if "phase" in self.source:
            return self.source["phase"]
        return np.zeros(self.shape)

    def get_spot_radius_kxy(self):
        """Expected farfield spot standard-deviation radius in kxy units."""
        self.fit_source_amplitude(force=False)
        rad_freq = np.reciprocal(self.source["amplitude_radius"] / np.mean(self.pitch))
        psf_kxy = toolbox.convert_vector(
            [rad_freq, rad_freq], "freq", "kxy", hardware=self, shape=self.shape
        )
        return np.mean(psf_kxy)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _format_phase_hw(self, phase):
        """Default hardware formatting: grayscale conversion into :attr:`display`."""
        return self._phase2gray(phase, out=self.display)

    @staticmethod
    def info(verbose=True):
        """Discover connected devices; base class has none."""
        if verbose:
            print("SLM.info() is unimplemented for the base class.")
        return []

    def load_vendor_phase_correction(self, file_path):
        """
        Load a vendor-provided phase-correction image into
        ``source["phase"]`` (inverted per the phase sign convention,
        scaled by the phase table, padded/unpadded to the SLM shape).
        Subclasses override for vendor-specific formats.
        
        """
        import cv2

        image = cv2.imread(file_path, cv2.IMREAD_UNCHANGED)
        if image is None:
            raise ValueError(f"Could not read image at '{file_path}'.")
        correction = self.bitresolution - 1 - np.asarray(image, dtype=float)
        if correction.ndim != 2:
            raise ValueError(f"Expected 2D image; found shape {correction.shape}.")
        correction *= 2 * np.pi / (self.phase_scaling * self.bitresolution)

        shape_sign = np.sign(np.array(correction.shape) - np.array(self.shape))
        if np.any(np.abs(np.diff(shape_sign)) > 1):
            raise ValueError(
                f"Cannot pad or unpad correction {correction.shape} to {self.shape}."
            )
        if np.any(shape_sign > 0):
            self.source["phase"] = toolbox.unpad(correction, self.shape)
        elif np.any(shape_sign < 0):
            self.source["phase"] = toolbox.pad(correction, self.shape)
        else:
            self.source["phase"] = correction
        return self.source["phase"]

    def plot(self, phase=None, limits=None, title="Phase", ax=None, cbar=True):
        """Plot ``phase`` (default: the last written phase). """
        import matplotlib.pyplot as plt

        if phase is None:
            phase = self.phase
        phase = as_numpy(phase)

        if ax is None:
            _, ax = plt.subplots()
        im = ax.imshow(phase, cmap="twilight", interpolation="none")
        if limits is not None:
            limits = np.asarray(limits, dtype=float)
            if limits.ndim == 0:
                center = np.flip(np.array(phase.shape)) / 2
                half = np.flip(np.array(phase.shape)) / 2 * float(limits)
                ax.set_xlim(center[0] - half[0], center[0] + half[0])
                ax.set_ylim(center[1] + half[1], center[1] - half[1])
            else:
                ax.set_xlim(*limits[0])
                ax.set_ylim(*np.flip(limits[1]))
        ax.set_title(title)
        if cbar:
            plt.colorbar(im, ax=ax)
        plt.sca(ax)
        return ax

    def save_phase(self, path=".", name=None):
        """Save the current :attr:`phase`/:attr:`display` to h5; returns the path."""
        if name is None:
            name = self.name + "-phase"
        file_path = generate_path(path, name, extension="h5")
        save_h5(file_path, {"phase": as_numpy(self.phase), "display": as_numpy(self.display)})
        return file_path

    def load_phase(self, file_path=None, path=".", name=None, set_phase=True,
                   settle=False):
        """Load phase from a file (or the latest autosave); optionally
        write it (``settle`` sleeps for :attr:`settle_time_s` after the
        write, reference-compatible)."""
        if file_path is None:
            if name is None:
                name = self.name + "-phase"
            file_path = latest_path(path, name, extension="h5")
            if file_path is None:
                raise FileNotFoundError(f"No saved phase found under '{name}' in '{path}'.")
        data = load_h5(file_path)
        if set_phase:
            self.set_phase(data["phase"], settle=settle)
        return data["phase"]

    def set_input_trigger(self, on=False):
        """**(Not supported by this SLM.)** External display-update trigger."""
        raise NotImplementedError("This SLM does not support input triggering.")

    def set_output_trigger(self, on=False):
        """**(Not supported by this SLM.)** Display-updated output signal."""
        raise NotImplementedError("This SLM does not support output triggering.")

    def set_source_aperture(self, amplitude_center_pix=None, amplitude_radius=None, amplitude_extent=None, amplitude_extent_radius=None):
        """Directly set fitted source parameters (regridding on a new center)."""
        if amplitude_center_pix is not None:
            amplitude_center_pix = np.array(amplitude_center_pix)
            current = np.array(
                [np.argmin(np.abs(self.grid[0][0, :])), np.argmin(np.abs(self.grid[1][:, 0]))]
            )
            dcenter = current - amplitude_center_pix
            self.grid[0] += dcenter[0] * self.pitch[0]
            self.grid[1] += dcenter[1] * self.pitch[1]
            self.source["amplitude_center_pix"] = amplitude_center_pix

        if amplitude_radius is not None:
            self.source["amplitude_radius"] = float(amplitude_radius)
        if amplitude_extent is not None:
            self.source["amplitude_extent"] = np.array(amplitude_extent)
        if amplitude_extent_radius is not None:
            self.source["amplitude_extent_radius"] = float(amplitude_extent_radius)
        return self.source

    def get_source_radius(self):
        """Source 1/e amplitude radius in normalized units."""
        self.fit_source_amplitude(force=False)
        return self.source["amplitude_radius"]

    def get_source_center(self):
        """Source center pixel."""
        self.fit_source_amplitude(force=False)
        return self.source["amplitude_center_pix"]

    def plot_source(self, source=None, sim=False, power=False):
        """
        Plot the source phase and amplitude (or power) distributions,
        plus — for measured sources carrying a wavefront-calibration
        fit — the r² goodness-of-fit map with the ``r2_threshold``
        contour overlaid on every panel (the fit-quality boundary of
        the usable correction).
        """
        import matplotlib.pyplot as plt
        from mpl_toolkits.axes_grid1 import make_axes_locatable

        if source is None:
            source = self.source
        suffix = "_sim" if sim else ""
        if ("amplitude" + suffix) not in source or ("phase" + suffix) not in source:
            raise RuntimeError(
                "amplitude/phase keywords missing from slm.source. Run "
                "wavefront calibration or set_source_analytic()."
            )

        plot_r2 = not sim and "r2" in source
        r2_full_shape = plot_r2 and (
            np.shape(source["r2"]) == tuple(self.shape)
        )
        plot_contour = r2_full_shape and "r2_threshold" in source

        def r2_contour(ax):
            if plot_contour:
                ax.contour(
                    source["r2"], levels=[float(source["r2_threshold"])],
                    colors="red", linewidths=1,
                )

        fig, axs = plt.subplots(1, 3 if plot_r2 else 2, figsize=(10, 6))

        im = axs[0].imshow(
            np.mod(source["phase" + suffix], 2 * np.pi),
            cmap="twilight", vmin=0, vmax=2 * np.pi, interpolation="none",
        )
        r2_contour(axs[0])
        axs[0].set_title("Simulated Source Phase" if sim else "Source Phase")
        cax = make_axes_locatable(axs[0]).append_axes("right", size="5%", pad=0.05)
        plt.colorbar(im, cax=cax)

        data = source["amplitude" + suffix]
        im = axs[1].imshow(np.square(data) if power else data, clim=(0, 1))
        r2_contour(axs[1])
        kind = "Power" if power else "Amplitude"
        axs[1].set_title(f"Simulated Source {kind}" if sim else f"Source {kind}")
        cax = make_axes_locatable(axs[1]).append_axes("right", size="5%", pad=0.05)
        plt.colorbar(im, cax=cax)

        if plot_r2:
            im = axs[2].imshow(source["r2"], clim=(0, 1))
            r2_contour(axs[2])
            axs[2].set_title("Cal Fitting $R^2$")
            unit = "pix" if r2_full_shape else "superpix"
            axs[2].set_xlabel(f"SLM $x$ [{unit}]")
            axs[2].set_ylabel(f"SLM $y$ [{unit}]")

        for ax in axs[:2]:
            ax.set_xlabel("SLM $x$ [pix]")
            ax.set_ylabel("SLM $y$ [pix]")

        plt.show()
        return axs

    def test(self):
        """Exercise core SLM methods; benchmark the write path."""
        print(f"Testing SLM: {self.name}")

        n_iter = 20
        phase = np.random.rand(n_iter, *self.shape) * 2 * np.pi
        t0 = time.time()
        for i in range(n_iter):
            self.set_phase(phase[i], phase_correct=False)
        elapsed = time.time() - t0
        print(f"  set_phase benchmark: {n_iter / elapsed:.1f} Hz "
              f"({elapsed / n_iter * 1e3:.2f} ms/frame)")

        for setter in (self.set_input_trigger, self.set_output_trigger):
            for val in (True, False):
                try:
                    setter(val)
                except NotImplementedError:
                    pass

        return True

    def get_point_spread_function_knm(self, padded_shape=None, device=None):
        """The expected diffraction-limited point spread function: the
        magnitude of the centered ortho FFT of the source amplitude, padded
        to ``padded_shape``, as a float32 tensor on ``device`` (None: the
        port's default device)."""
        import torch

        from slmsuite_torch import resolve_device

        nearfield = torch.as_tensor(
            np.fft.fftshift(toolbox.pad(self._get_source_amplitude(), padded_shape)),
            dtype=torch.float32, device=resolve_device(device),
        )
        return torch.abs(torch.fft.fftshift(torch.fft.fft2(nearfield, norm="ortho")))
