r"""
Abstract camera interface (the port's copy of
:mod:`slmsuite_tpu.hardware.cameras.camera`, numpy only): shape, bit
depth and dtype, the orientation transform, exposure, single, averaged
and HDR captures with retries, the buffer flush, and the exposure and
focus searches (:meth:`Camera.autoexposure`, :meth:`Camera.autofocus`,
which can take an SLM as its focus actuator), :meth:`Camera.plot` and the
self-test :meth:`Camera.test`. The live viewer is not copied yet
(ROADMAP.md queue 1, item 12, part two).
"""

import time
import warnings
from abc import ABC, abstractmethod

import numpy as np
from scipy.optimize import curve_fit

from slmsuite_torch.hardware import _Picklable
from slmsuite_torch.holography import analysis
from slmsuite_torch.holography.analysis.fitfunctions import lorentzian
from slmsuite_torch.holography.toolbox import format_shape
from slmsuite_torch.misc.host import as_numpy
from slmsuite_torch.misc.math import REAL_TYPES


class Camera(_Picklable, ABC):
    """
    Abstract class for cameras: orientation transforms, frame averaging,
    multi-exposure HDR and capture retries.

    Attributes
    ----------
    name : str
    shape, default_shape : (int, int)
        ``(height, width)`` after/before the orientation transform.
    bitdepth, bitresolution : int
        Well depth in bits; ``2**bitdepth * averaging``.
    dtype : numpy.dtype
        Type returned by the hardware.
    pitch_um : numpy.ndarray OR None
        Pixel pitch in microns.
    exposure_s, exposure_bounds_s
        Cached exposure and allowed range.
    averaging : int OR None
        Frames summed per capture.
    hdr : (int, int) OR None
        Multi-exposure HDR (exposure count, power base).
    capture_attempts : int
        Retries for transient hardware failures.
    woi : (int, int, int, int)
        Window of interest ``(x, w, y, h)``.
    transform : callable
        Orientation transform applied to returned frames.
    last_image : numpy.ndarray OR None
        Pointer to the most recent capture.
    """

    _pickle = [
        "name",
        "shape",
        "bitdepth",
        "bitresolution",
        "pitch_um",
        "exposure_s",
        "exposure_bounds_s",
        "averaging",
        "hdr",
        "woi",
        "default_shape",
    ]
    _pickle_data = ["last_image"]

    @abstractmethod
    def __init__(
        self,
        resolution,
        bitdepth=8,
        pitch_um=None,
        name="camera",
        exposure_bounds_s=None,
        averaging=None,
        capture_attempts=5,
        hdr=None,
        rot="0",
        fliplr=False,
        flipud=False,
    ):
        """
        Initialize a camera. ``resolution`` is ``(width, height)`` — the
        opposite of the numpy convention in :attr:`shape`. ``rot``/
        ``fliplr``/``flipud`` configure :attr:`transform`.
        """
        width, height = format_shape(resolution)

        if rot in ("90", 1, "270", 3):
            self.shape = self.default_shape = (width, height)
        else:
            self.shape = self.default_shape = (height, width)

        self.capture_attempts = int(capture_attempts)
        if capture_attempts <= 0:
            raise ValueError("capture_attempts must be positive.")

        self.transform = analysis.get_orientation_transformation(rot, fliplr, flipud)

        self.woi = (0, width, 0, height)
        try:
            self.set_woi()
        except NotImplementedError:
            pass

        self.last_image = None
        self.name = str(name)

        self.exposure_bounds_s = (
            (np.min(exposure_bounds_s), np.max(exposure_bounds_s))
            if exposure_bounds_s is not None
            else None
        )
        self.exposure_s = 1
        self.exposure_s = self.get_exposure()

        self.bitdepth = int(bitdepth)
        self.dtype = self._get_dtype()

        self.averaging = self._parse_averaging(averaging, preserve_none=True)
        self.hdr = self._parse_hdr(hdr, preserve_none=True)
        self._flush_iterations = 2

        if pitch_um is not None and not (np.isscalar(pitch_um) and pitch_um <= 0):
            if isinstance(pitch_um, REAL_TYPES):
                pitch_um = [pitch_um, pitch_um]
            pitch_um = np.squeeze(pitch_um)
            if len(pitch_um) != 2 or np.any(pitch_um <= 0):
                raise ValueError("Expected positive (float, float) for pitch_um")
            self.pitch_um = np.array([float(pitch_um[0]), float(pitch_um[1])])
        else:
            self.pitch_um = None

        self.viewer = None

    @property
    def bitresolution(self):
        return (2**self.bitdepth) * (self.averaging if self.averaging is not None else 1)

    # ------------------------------------------------------------------
    # Abstract hardware interface.
    # ------------------------------------------------------------------

    @abstractmethod
    def close(self):
        """Close the camera and free hardware resources."""
        raise NotImplementedError()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @staticmethod
    def info(verbose=True):
        """List available cameras (subclass-specific)."""
        if verbose:
            print(".info() NotImplemented.")
        return []

    @abstractmethod
    def _get_exposure_hw(self):
        """Hardware read of the integration time in seconds."""
        raise NotImplementedError()

    @abstractmethod
    def _set_exposure_hw(self, exposure_s):
        """Hardware write of the integration time in seconds."""
        raise NotImplementedError()

    @abstractmethod
    def _get_image_hw(self, timeout_s):
        """Hardware capture of one frame of shape :attr:`default_shape`."""
        raise NotImplementedError()

    def _get_images_hw(self, image_count, timeout_s, out=None):
        """Batch capture (default: repeated single captures)."""
        out = self._get_out(image_count, out)
        for i in range(image_count):
            out[i, :, :] = self._get_image_hw_tolerant(timeout_s=timeout_s + self.exposure_s)
        return out

    def set_woi(self, woi=None):
        """Set the hardware window of interest (subclass-specific)."""
        raise NotImplementedError()

    # ------------------------------------------------------------------
    # Exposure.
    # ------------------------------------------------------------------

    def get_exposure(self):
        """Frame integration time in seconds (cached in :attr:`exposure_s`)."""
        self.exposure_s = self._get_exposure_hw()
        return self.exposure_s

    def set_exposure(self, exposure_s):
        """Set the integration time (clipped into :attr:`exposure_bounds_s`)."""
        if self.exposure_bounds_s is not None:
            clipped = np.clip(exposure_s, *self.exposure_bounds_s)
            if clipped != exposure_s:
                warnings.warn(
                    f"Requested exposure {exposure_s} s out of bounds "
                    f"{self.exposure_bounds_s} s; clipping to {clipped} s."
                )
                exposure_s = clipped
        self._set_exposure_hw(exposure_s)
        return self.get_exposure()

    # ------------------------------------------------------------------
    # Capture plumbing.
    # ------------------------------------------------------------------

    def flush(self, timeout_s=1):
        """Cycle the image buffer so subsequent captures are fresh."""
        for _ in range(self._flush_iterations):
            self._get_image_hw_tolerant(timeout_s=timeout_s + self.exposure_s)

    def _get_out(self, image_count, out=None):
        out_shape = (int(image_count), self.default_shape[0], self.default_shape[1])
        if out is None:
            out = np.empty(out_shape, dtype=self.dtype)
        elif out.shape != out_shape:
            raise ValueError(f"Expected out of shape {out_shape}; found {out.shape}.")
        return out

    def _tolerant(self, fn, *args, **kwargs):
        """Retry a capture ``capture_attempts`` times before re-raising."""
        err = None
        failures = 0
        for _ in range(self.capture_attempts):
            try:
                result = fn(*args, **kwargs)
                if failures:
                    warnings.warn(
                        f"'{self.name}' capture failed {failures} times before succeeding."
                    )
                return result
            except Exception as e:
                failures += 1
                err = e
        warnings.warn(f"'{self.name}' capture failed {failures} times before quitting.")
        raise err

    def _get_image_hw_tolerant(self, *args, **kwargs):
        return self._tolerant(self._get_image_hw, *args, **kwargs)

    def _get_images_hw_tolerant(self, *args, **kwargs):
        return self._tolerant(self._get_images_hw, *args, **kwargs)

    def _get_dtype(self, get_image_function=None):
        """Infer :attr:`dtype` from a trial capture (fallback: bitdepth)."""
        if get_image_function is None:
            get_image_function = self._get_image_hw_tolerant
        try:
            self.dtype = np.dtype(np.asarray(get_image_function()).dtype)
        except Exception:
            if self.bitdepth <= 0:
                raise ValueError("Non-positive bitdepth does not make sense.")
            for bits, dtype in [(8, np.uint8), (16, np.uint16), (32, np.uint32), (64, np.uint64)]:
                if self.bitdepth <= bits:
                    self.dtype = np.dtype(dtype)
                    break
            else:
                self.dtype = np.dtype(float)
        return self.dtype

    def _parse_averaging(self, averaging=None, preserve_none=False):
        if averaging is None:
            if preserve_none:
                return None
            averaging = self.averaging if getattr(self, "averaging", None) else 1
        elif averaging is False:
            averaging = 1
        averaging = int(averaging)
        if averaging <= 0:
            raise ValueError("Cannot have negative averaging.")
        return averaging

    def _parse_hdr(self, exposures=None, preserve_none=False):
        if exposures is None:
            if preserve_none:
                return None
            if getattr(self, "hdr", None) is None:
                return (1, 0)
            return self._parse_hdr(self.hdr)
        if exposures is False:
            return (1, 0)
        if np.isscalar(exposures):
            return (int(exposures), 2)
        return (int(exposures[0]), int(exposures[1]))

    def _get_averaging_dtype(self, averaging=None):
        """Datatype needed to sum ``averaging`` frames without overflow."""
        averaging = self._parse_averaging(averaging)
        dtype = np.dtype(self.dtype)
        if dtype.kind in "iu":
            dtype_bitdepth = 8 * dtype.itemsize - (1 if dtype.kind == "i" else 0)
            extra_bits = int(np.rint(np.log2(averaging)))
            if self.bitdepth + extra_bits <= dtype_bitdepth:
                return self.dtype
            return float
        if dtype.kind == "f":
            return self.dtype
        raise ValueError(f"Datatype {self.dtype} does not make sense as a camera return.")

    # ------------------------------------------------------------------
    # User-facing capture.
    # ------------------------------------------------------------------

    def get_image(self, timeout_s=1, transform=True, hdr=None, averaging=None):
        """
        Capture one processed frame: plain, summed over ``averaging``
        frames, or stitched HDR; orientation-transformed by default.
        """
        averaging = self._parse_averaging(averaging)
        exposures, exposure_power = self._parse_hdr(hdr)

        if exposures > 1:
            return self.get_image_hdr(
                (exposures, exposure_power),
                timeout_s=timeout_s,
                transform=transform,
                averaging=averaging,
            )

        if averaging > 1:
            averaging_dtype = self._get_averaging_dtype(averaging)
            try:
                imgs = self._get_images_hw(
                    averaging, timeout_s=timeout_s + self.exposure_s
                ).astype(averaging_dtype)
                img = np.sum(imgs, axis=0)
            except NotImplementedError:
                img = np.zeros(self.default_shape, dtype=averaging_dtype)
                for _ in range(averaging):
                    img += self._get_image_hw_tolerant(
                        timeout_s=timeout_s + self.exposure_s
                    ).astype(averaging_dtype)
        else:
            img = self._get_image_hw_tolerant(timeout_s=timeout_s + self.exposure_s)

        if transform:
            img = self.transform(img)

        self.last_image = img
        if self.viewer is not None:
            self.viewer.render(img / averaging if averaging > 1 else img)
        return img

    def get_images(self, image_count, timeout_s=1, out=None, transform=True, flush=False):
        """Grab ``image_count`` raw frames (no averaging/HDR)."""
        if flush:
            self.flush()

        imgs = self._get_images_hw(image_count, timeout_s=timeout_s + self.exposure_s, out=out)

        if transform:
            transformed = np.empty(
                (int(image_count), self.shape[0], self.shape[1]), dtype=self.dtype
            )
            for i in range(image_count):
                transformed[i, :, :] = self.transform(imgs[i])
            imgs = transformed

        self.last_image = imgs[-1]
        if self.viewer is not None:
            self.viewer.render(imgs[-1])
        return imgs

    def get_image_hdr(self, exposures=None, return_raw=False, **kwargs):
        r"""
        Multi-exposure HDR: capture a stack at exposures :math:`\tau p^i`,
        then stitch (:meth:`get_image_hdr_analysis`) at the original
        exposure's scale.
        """
        exposures, exposure_power = self._parse_hdr(exposures)
        overexposure_threshold = self.bitresolution / 2
        if self.averaging is not None:
            overexposure_threshold *= self.averaging

        original_exposure = self.get_exposure()
        imgs = np.zeros((exposures, self.shape[0], self.shape[1]), self.dtype)
        exposure_times = np.zeros((exposures,), dtype=float)

        for i in range(exposures):
            exposure_times[i] = self.set_exposure(
                int(exposure_power**i) * original_exposure
            )
            self.flush()
            imgs[i, :, :] = self.get_image(hdr=False, **kwargs)

        self.set_exposure(original_exposure)

        if return_raw:
            return imgs, exposure_times

        img = self.get_image_hdr_analysis(
            imgs,
            overexposure_threshold=overexposure_threshold,
            exposure_power=exposure_times,
        )
        if np.max(img) >= self.bitresolution:
            warnings.warn("HDR image is overexposed.")
        self.last_image = img
        return img

    @staticmethod
    def get_image_hdr_analysis(imgs, overexposure_threshold=None, exposure_power=2):
        """Stitch an exposure stack: overwrite with rescaled unsaturated data."""
        if np.isscalar(exposure_power):
            exposure_times = np.power(float(int(exposure_power)), np.arange(imgs.shape[0]))
        else:
            exposure_times = np.array(exposure_power, dtype=float)
            if np.all(exposure_times <= 0):
                raise ValueError("exposure_times cannot all be non-positive.")
            exposure_times = exposure_times / np.min(exposure_times[exposure_times > 0])

        if overexposure_threshold is None:
            overexposure_threshold = np.max(imgs) / 2

        img = None
        for i in range(imgs.shape[0]):
            current = imgs[i, :, :].astype(float)
            if i == 0:
                img = current
            elif exposure_times[i] > 0:
                mask = current < overexposure_threshold
                img[mask] = current[mask] / exposure_times[i]
        return img

    # ------------------------------------------------------------------
    # Autoexposure and autofocus.
    # ------------------------------------------------------------------

    def autoexposure(
        self,
        set_fraction=0.5,
        tol=0.05,
        exposure_bounds_s=None,
        window=None,
        timeout_s=5,
        verbose=True,
    ):
        """
        Proportional exposure search (steps clipped to 0.5x-2x) until the
        image maximum in ``window`` (``(x, w, y, h)``, centered; the whole
        frame by default) is half the dynamic range within ``tol``, then
        scaled to ``set_fraction`` of it. Returns the exposure in seconds.
        """
        if exposure_bounds_s is None:
            exposure_bounds_s = self.exposure_bounds_s or (0, np.inf)

        if window is None:
            wxi, wxf, wyi, wyf = 0, self.shape[1], 0, self.shape[0]
        else:
            wxi = int(window[0] - window[1] / 2)
            wxf = int(window[0] + window[1] / 2)
            wyi = int(window[2] - window[3] / 2)
            wyf = int(window[2] + window[3] / 2)

        set_val = 0.5 * self.bitresolution
        exp = self.get_exposure()
        self.flush()
        img = self.get_image()
        im_max = np.amax(img[wyi:wyf, wxi:wxf])

        err = np.abs(im_max - set_val) / self.bitresolution
        start = time.perf_counter()

        while err > tol and time.perf_counter() - start < timeout_s:
            exp = exp / np.amax([0.5, np.amin([(im_max / set_val), 2])])
            exp_desired = exp
            exp = np.clip(exp, exposure_bounds_s[0], exposure_bounds_s[1])
            if exp_desired != exp:
                raise RuntimeError(
                    f"autoexposure has railed (exposure: {exp_desired}, "
                    f"bounds: {exposure_bounds_s})."
                )

            self.set_exposure(exp)
            self.flush()
            img = self.get_image()
            im_max = np.amax(img[wyi:wyf, wxi:wxf])
            err = np.abs(im_max - set_val) / self.bitresolution

            if verbose:
                print(f"Autoexposure: exposure = {exp:<.2e} s, image_max = {im_max}")

        if set_fraction != 0.5:
            exp = exp * (2 * set_fraction)
            self.set_exposure(exp)
        return exp

    @staticmethod
    def _autofocus_metric(img, plot=False):
        """Fourier contrast: sum of max-normalized FFT amplitudes."""
        dft_amp = np.abs(np.fft.fftshift(np.fft.fft2(img.astype(float))))
        fom = np.sum(dft_amp / np.amax(dft_amp))
        if plot:
            import matplotlib.pyplot as plt

            plt.imshow(dft_amp / np.amax(dft_amp))
            plt.title(f"FoM = {fom}")
            plt.show()
        return fom

    def autofocus(self, set_z, get_z=0, range_z=2, metric=None, plot=False, verbose=False):
        """
        Sweep a focus actuator over ``z``, evaluate a sharpness ``metric``
        per image, and Lorentzian-fit the optimum. Passing an SLM as
        ``set_z`` applies Zernike defocus through ``source["phase"]``
        (optimal defocus retained in the wavefront correction).
        """
        from slmsuite_torch.holography.toolbox.phase import zernike

        if hasattr(set_z, "set_phase"):
            slm = set_z
            base_phase = slm.phase.copy()
            base_correction = slm.source.get("phase", np.zeros_like(base_phase))
            base_phase = base_phase - base_correction

            def slm_set_z(z_val):
                slm.source["phase"] = base_correction + zernike(
                    slm, index=4, weight=z_val, use_mask=False
                )
                slm.set_phase(base_phase, settle=True)

            set_z = slm_set_z

        if not callable(set_z):
            raise ValueError("set_z must be a function or SLM.")

        z_base = get_z() if callable(get_z) else get_z
        z_list = (
            np.linspace(-range_z, range_z, 11, endpoint=True)
            if np.isscalar(range_z)
            else np.asarray(range_z, dtype=float)
        )
        z_list = np.sort(z_list + z_base)

        if metric is None:
            metric = Camera._autofocus_metric

        counts = np.full(len(z_list), np.nan)
        images = []
        for i, z in enumerate(z_list):
            try:
                if verbose:
                    print(f"Moving to z = {z:<.2f}...", end="\r")
                set_z(z)
                self.flush()
                img = self.get_image()
                images.append(np.copy(img))
                counts[i] = metric(img)
            except Exception:
                pass

        if np.all(np.isnan(counts)):
            try:
                set_z(z_base)
            except Exception:
                pass
            raise RuntimeError("Autofocus failed; no valid images captured.")

        best = int(np.nanargmax(counts))
        dz = np.mean(np.diff(z_list))
        guess = [
            z_list[best],
            np.nanmax(counts) - np.nanmin(counts),
            np.nanmin(counts),
            z_list[-1] - z_list[0],
        ]
        bounds = (
            [z_list[0], 0, 0, dz],
            [z_list[-1], (np.nanmax(counts) - np.nanmin(counts)) * 2 + 1e-12,
             np.nanmax(counts) + 1e-12, np.inf],
        )
        try:
            valid = ~np.isnan(counts)
            popt, _ = curve_fit(
                lorentzian, z_list[valid], counts[valid], p0=guess, bounds=bounds
            )
            z_opt = popt[0]
        except RuntimeError:
            z_opt = z_list[best]

        set_z(z_opt)

        if plot:
            import matplotlib.pyplot as plt

            plt.plot(z_list, counts, "o")
            z_fine = np.linspace(z_list[0], z_list[-1], 200)
            try:
                plt.plot(z_fine, lorentzian(z_fine, *popt))
            except Exception:
                pass
            plt.axvline(z_opt, color="r")
            plt.xlabel("z")
            plt.ylabel("FoM")
            plt.show()

        return z_opt

    def plot(self, image=None, limits=None, title="Image", ax=None, cbar=True):
        """
        Plot an image: ``None`` grabs a fresh frame, ``False`` uses
        :attr:`last_image`. Ref ``camera.py:1033``.
        """
        import matplotlib.pyplot as plt

        if image is None:
            self.flush()
            image = self.get_image()
        elif image is False:
            image = self.last_image
        image = as_numpy(image)

        if ax is None:
            _, ax = plt.subplots()
        im = ax.imshow(image)
        if cbar:
            plt.colorbar(im, ax=ax)
        ax.set_title(title)
        if limits is not None and limits != 1:
            limits = np.asarray(limits, dtype=float)
            if limits.ndim == 0:
                center = np.flip(np.array(image.shape)) / 2
                half = np.flip(np.array(image.shape)) / 2 * float(limits)
                ax.set_xlim(center[0] - half[0], center[0] + half[0])
                ax.set_ylim(center[1] + half[1], center[1] - half[1])
            else:
                ax.set_xlim(*limits[0])
                ax.set_ylim(*np.flip(limits[1]))
        plt.sca(ax)
        return ax

    def live(self, activate=None, widgets=True, backend="ipython", **kwargs):
        """The notebook's live viewer: not ported yet (ROADMAP.md queue 1,
        item 12, part two, with ``cameras/_viewer.py``)."""
        raise NotImplementedError(
            "Camera.live: the live viewer is not ported yet (ROADMAP.md queue 1, "
            "item 12, part two)."
        )

    def test(self):
        """Exercise the core camera methods against the hardware."""
        print(f"Testing camera: {self.name}")

        exposure = self.get_exposure()
        self.set_exposure(exposure)
        print(f"  exposure get/set OK ({exposure} s)")

        img = self.get_image()
        assert img.shape == tuple(self.shape), (img.shape, self.shape)
        print(f"  get_image OK {img.shape}")

        self.flush()
        print("  flush OK")

        imgs = self.get_images(2)
        assert imgs.shape[0] == 2
        print("  get_images OK")

        n_iter = 10
        t0 = time.time()
        for _ in range(n_iter):
            self.get_image()
        elapsed = time.time() - t0
        print(f"  capture benchmark: {n_iter / elapsed:.1f} fps")
        return True
