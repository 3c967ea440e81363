r"""
Simulated camera: images the farfield of a simulated SLM (port of
:mod:`slmsuite_tpu.hardware.cameras.simulated`).

The SLM's *quantized* displayed phase (its bit depth) plus the simulated
source phase is propagated on the camera's device by the same shift-free
transform the holography algorithms use; camera pixels sample the farfield
power through an affine-mapped nearest-pixel gather on the device, and
only the camera-sized frame crosses to the host, where exposure noise,
saturation and the cast to the camera's dtype are applied.
"""

import warnings

import numpy as np
import torch

from slmsuite_torch import resolve_device
from slmsuite_torch.hardware.cameras.camera import Camera
from slmsuite_torch.holography import toolbox
from slmsuite_torch.holography.algorithms import Hologram
from slmsuite_torch.misc.math import REAL_TYPES


class SimulatedCamera(Camera):
    """
    Simulated camera imaging a simulated SLM's farfield.

    Attributes
    ----------
    grid : (numpy.ndarray, numpy.ndarray)
        Camera pixel grid (``"ij"``, or kxy under the affine transform).
    shape_padded : (int, int)
        FFT canvas size needed to resolve the camera's pixels.
    knm_cam : numpy.ndarray
        ``(2, h, w)`` canvas pixel coordinates (row; column) of every
        camera pixel.
    noise : dict OR None
        Noise model: ``{'dark': fn, 'read': fn}`` returning the noise for
        a given normalized input (dark scales with exposure; read does
        not).
    device : torch.device
        Where the farfield is computed and sampled.
    """

    def __init__(self, slm, resolution=None, M=None, b=None, noise=None, pitch_um=None,
                 gain=1, device=None, **kwargs):
        """
        A simulated camera viewing ``slm``. ``M``/``b`` (or ``f_eff`` and
        friends through :meth:`set_affine`) place the camera in the SLM's
        k-space; with neither, pixels map one-to-one onto the SLM's
        computational farfield. ``device`` is the package default when
        None.
        """
        self._slm = slm
        self._interpolate = False
        self.device = resolve_device(device)

        if resolution is None:
            resolution = slm.shape[::-1]
        elif any(r != s for r, s in zip(resolution, slm.shape[::-1])):
            self._interpolate = True

        super().__init__(resolution, pitch_um=pitch_um, **kwargs)

        self.gain = gain
        self.noise = noise

        self.grid = np.meshgrid(np.arange(resolution[0]), np.arange(resolution[1]))
        self.set_affine(M, b)

    def close(self):
        pass

    def set_affine(self, M=None, b=None, **kwargs):
        """
        Place the camera in the SLM's k-space by the affine ``(M, b)`` (or
        by :meth:`build_affine`'s arguments, with ``f_eff``); rebuilds the
        sampling grid and the internal propagation hologram.
        """
        if M is None or b is None:
            f_eff = kwargs.pop("f_eff", None)
            if f_eff is not None:
                M, b = self.build_affine(f_eff, **kwargs)

        self._interpolate = not (M is None or b is None)
        self.grid = np.meshgrid(np.arange(self.shape[1]), np.arange(self.shape[0]))
        self.shape_padded = tuple(self._slm.shape)

        if self._interpolate:
            self.M = M
            self.b = b

            # Camera ij grid -> kxy.
            self.grid = toolbox.transform_grid(self, M, b, direction="rev")

            # The canvas resolves the finest camera pixel spacing in k.
            dkxy = np.sqrt(
                np.square(self.grid[0][:2, :2] - self.grid[0][0, 0])
                + np.square(self.grid[1][:2, :2] - self.grid[1][0, 0])
            )
            dkxy_min = dkxy.ravel()[1:].min()
            self.shape_padded = Hologram.get_padded_shape(self._slm, precision=dkxy_min)

            # kxy -> canvas pixels (row, col): kn = H * pitch_y * ky + H/2,
            # km = W * pitch_x * kx + W/2. The column takes the X pitch.
            self.knm_cam = np.array(
                [
                    self.shape_padded[0] * self._slm.pitch[1] * self.grid[1]
                    + self.shape_padded[0] / 2,
                    self.shape_padded[1] * self._slm.pitch[0] * self.grid[0]
                    + self.shape_padded[1] / 2,
                ]
            )

            if (
                np.amax(np.abs(self.knm_cam[0] - self.shape_padded[0] / 2))
                > self.shape_padded[1] / 2
                or np.amax(np.abs(self.knm_cam[1] - self.shape_padded[1] / 2))
                > self.shape_padded[0] / 2
            ):
                warnings.warn(
                    "Camera extends beyond the accessible SLM k-space;"
                    " some pixels may not be targetable."
                )

        # The initial phase is given, so nothing is drawn from numpy's
        # global generator.
        self._hologram = Hologram(
            self.shape_padded,
            amp=self._slm.source["amplitude_sim"],
            phase=self._display_phase(float),
            slm_shape=tuple(self._slm.shape),
            device=self.device,
        )
        self._sampler_cache = None

    def _display_phase(self, dtype):
        """The phase the SLM displays (its quantized levels) plus the
        simulated source phase."""
        phase = -self._slm.display.astype(dtype) * (2 * np.pi / self._slm.bitresolution)
        return phase - phase.min() + self._slm.source["phase_sim"].astype(dtype)

    def build_affine(self, f_eff, units="norm", theta=0, shear_angle=0, offset=None):
        """
        ``(M, b)`` from physical parameters: the effective focal length
        ``f_eff`` (in ``units``), the camera's rotation ``theta``,
        ``shear_angle``, and the center ``offset`` (the camera's center by
        default).
        """
        if offset is None:
            offset = np.flip(self.shape) / 2
        return SimulatedCamera._build_affine(
            f_eff,
            units=units,
            theta=theta,
            shear_angle=shear_angle,
            offset=offset,
            cam_pitch_um=self.pitch_um,
            wav_um=self._slm.wav_um,
        )

    @staticmethod
    def _build_affine(f_eff, units="ij", theta=0, shear_angle=0, offset=(0, 0),
                      cam_pitch_um=None, wav_um=None):
        """``(M, b)`` from the optical parameters (FourierSLM's analytic
        calibration shares it)."""
        if isinstance(f_eff, REAL_TYPES):
            f_eff = [f_eff, f_eff]
        if isinstance(cam_pitch_um, REAL_TYPES):
            cam_pitch_um = [cam_pitch_um, cam_pitch_um]
        elif cam_pitch_um is not None:
            cam_pitch_um = np.ravel(cam_pitch_um)
        if isinstance(shear_angle, REAL_TYPES):
            shear_angle = [shear_angle, shear_angle]
        if offset is None:
            offset = (0, 0)

        f_eff = np.squeeze(f_eff).astype(float)
        shear_angle = np.squeeze(shear_angle)

        if units == "ij":
            pass
        elif units == "norm":
            if wav_um is None:
                raise ValueError("wav_um is required for unit 'norm'")
            if cam_pitch_um is None or cam_pitch_um[0] is None:
                raise ValueError("cam_pitch_um is required for unit 'norm'")
            f_eff = f_eff * (wav_um / np.squeeze(cam_pitch_um))
        elif units in toolbox.LENGTH_FACTORS:
            if cam_pitch_um is None or cam_pitch_um[0] is None:
                raise ValueError(f"cam_pitch_um is required for unit '{units}'")
            f_eff = f_eff * (toolbox.LENGTH_FACTORS[units] / np.squeeze(cam_pitch_um))
        else:
            raise ValueError(f"Unit '{units}' not recognized as a length.")

        mag = np.array([[f_eff[0], 0], [0, f_eff[1]]])
        shear = np.array([[1, np.tan(shear_angle[0])], [np.tan(shear_angle[1]), 1]])
        rot = np.array(
            [[np.cos(-theta), np.sin(-theta)], [-np.sin(-theta), np.cos(-theta)]]
        )
        return mag @ shear @ rot, toolbox.format_2vectors(offset)

    # ------------------------------------------------------------------
    # Hardware interface (virtual).
    # ------------------------------------------------------------------

    def flush(self, timeout_s=1):
        """A simulation has no buffer to flush."""

    def _get_exposure_hw(self):
        return self.exposure_s

    def _set_exposure_hw(self, exposure_s):
        self.exposure_s = exposure_s

    def _sample_maps(self):
        """Gather maps ``(flat int64, valid float32)`` (numpy) of the
        camera's pixels into the flattened canvas: nearest-pixel rounding
        as scipy's order-0 spline does it (``floor(x + 0.5)``), and 0
        weight outside the canvas."""
        coords = np.floor(np.asarray(self.knm_cam, np.float64) + 0.5)
        Hp, Wp = self.shape_padded
        valid = (
            (coords[0] >= 0) & (coords[0] <= Hp - 1)
            & (coords[1] >= 0) & (coords[1] <= Wp - 1)
        )
        flat = (
            np.clip(coords[0], 0, Hp - 1).astype(np.int64) * Wp
            + np.clip(coords[1], 0, Wp - 1).astype(np.int64)
        )
        return flat, valid.astype(np.float32)

    def _device_sampler(self):
        """
        ``sample(amp_ff, scale)``: the farfield power at the camera's
        pixels on the device (nearest pixel, 0 outside the canvas, as
        ``scipy.ndimage.map_coordinates(order=0, mode='constant')``),
        times ``scale``. Cached while ``knm_cam`` is the same array.
        """
        key = self.knm_cam if self._interpolate else None
        cached = self._sampler_cache
        # The cache holds the keyed array, so a new knm_cam allocated at a
        # reused address cannot be served the old maps.
        if cached is not None and cached[0] is key:
            return cached[1]

        if self._interpolate:
            flat, valid = self._sample_maps()
            flat_dev = torch.as_tensor(flat, device=self.device)
            valid_dev = torch.as_tensor(valid, device=self.device)

            def sample(amp_ff, scale):
                return torch.square(amp_ff).reshape(-1)[flat_dev] * valid_dev * scale
        else:
            cam_shape = tuple(self.shape)

            def sample(amp_ff, scale):
                return torch.square(toolbox.unpad(amp_ff, cam_shape)) * scale

        self._sampler_cache = (key, sample)
        return sample

    def _get_dtype(self, get_image_function=None):
        """The virtual camera's dtype follows from its bit depth: at
        construction the affine and the hologram are not built yet, so a
        trial capture would only burn the retry budget."""
        if get_image_function is None and not hasattr(self, "_hologram"):
            def get_image_function():
                raise RuntimeError("Simulated camera is not propagating yet.")
        return super()._get_dtype(get_image_function)

    def _get_image_hw(self, timeout_s=None):
        """
        Form an image: propagate the SLM's quantized display (plus the
        simulated source) on the device, sample the farfield power at the
        camera's pixels, and apply exposure, gain, noise and saturation.
        """
        if not hasattr(self, "_hologram"):
            raise RuntimeError(
                "Cannot display SimulatedCamera before affine transformation is defined."
            )

        holo = self._hologram
        # The raw source amplitude sets the brightness convention.
        holo.amp = np.asarray(self._slm.source["amplitude_sim"], dtype=holo.dtype)
        holo.reset_phase(self._display_phase(holo.dtype))
        holo._populate_results()

        amp_ff = type(holo).amp_ff.device(holo, self.device)
        img = self._device_sampler()(
            amp_ff, float(np.float32(self.exposure_s * self.gain))
        ).cpu().numpy()

        if self.noise is not None:
            for key in self.noise:
                if key == "dark":
                    img = img + self.noise["dark"](
                        np.ones_like(img) * self.bitresolution
                    ) / self.exposure_s
                elif key == "read":
                    img = img + self.noise["read"](np.ones_like(img) * self.bitresolution)
                else:
                    raise RuntimeError(f"Unknown noise source {key} specified!")

        img = np.minimum(img, self.bitresolution - 1)
        return img.astype(self.dtype)
