r"""
DFT-based phase retrieval: the :class:`Hologram` class (PyTorch
counterpart of :mod:`slmsuite_tpu.holography.algorithms._hologram`).

The nearfield phase is carried in the *folded* (checkerboard) basis so
the loop runs shift-free (see :mod:`slmsuite_torch.ops.propagation`); all
user-facing accessors unfold. Fully-computational runs go through the
engine (:mod:`slmsuite_torch.ops.engine`) in chunks, with the planes kept
on the device between calls; a target with nan (MRAF noise regions) runs
MRAF. A callback, feedback measured on the host or given by the user, or a
stat group the device does not compute runs the stepwise host loop
(:meth:`Hologram._stepwise_iteration`): its transforms stay on the device,
and only the stats, the weights' inputs and the camera frames cross to the
host. Gradient phase retrieval (``"CG"``, :meth:`Hologram.optimize_cg`)
differentiates the loss through :class:`slmsuite_torch.ops.grad.Fft2`,
whose forward and backward are the FFT kernels, and steps an optimizer of
:mod:`slmsuite_torch.ops.optim`. Mesh-sharded runs are not ported yet and
raise :class:`NotImplementedError`.
"""

import warnings

import numpy as np
import torch

from slmsuite_torch import resolve_device
from slmsuite_torch.holography import analysis
from slmsuite_torch.holography.algorithms._header import (
    ALGORITHM_DEFAULTS,
    FEEDBACK_OPTIONS,
)
from slmsuite_torch.holography.algorithms._stats import _HologramStats
from slmsuite_torch.holography.toolbox import REAL_TYPES
from slmsuite_torch.holography.toolbox import phase as tphase
from slmsuite_torch.misc import profile as _profile
from slmsuite_torch.ops import engine as _engine
from slmsuite_torch.ops import optim as _optim
from slmsuite_torch.ops import propagation as _prop
from slmsuite_torch.ops.stats import STAT_KEYS, calculate_stats
from slmsuite_torch.ops.weights import update_weights_generic


class ComplexMSELoss:
    """Mean-squared error between the unit-power-normalized amplitude of a
    complex farfield and a real target (nan counted as 0), for
    :meth:`Hologram.optimize` with ``method="CG"`` (``loss=ComplexMSELoss()``;
    ``slmsuite_tpu``'s, on torch tensors). ``reduction`` is ``"mean"``
    (the default CG loss of :class:`Hologram`) or ``"sum"``."""

    def __init__(self, reduction="mean"):
        if reduction not in ("mean", "sum"):
            raise ValueError(f"Unsupported reduction '{reduction}'.")
        self.reduction = reduction

    def __call__(self, farfield, target):
        amp = torch.abs(farfield)
        amp = amp / torch.sqrt(torch.sum(torch.square(amp)))
        sq = torch.square(amp - torch.nan_to_num(target))
        return torch.mean(sq) if self.reduction == "mean" else torch.sum(sq)


class MaxUniformLoss:
    """``-sum(|F|^2) + 10 std(|F|)`` with the Bessel-corrected std: total
    farfield power against amplitude spread (``slmsuite_tpu``'s, on torch
    tensors). The target is ignored."""

    def __call__(self, farfield, target):
        amp = torch.abs(farfield)
        return -torch.sum(torch.square(amp)) + 10.0 * torch.std(amp, correction=1)


def _default_cg_loss(farfield, target):
    """The default CG loss of the compressed and multiplane holograms: the
    mean squared error of the unit-power farfield amplitude against
    ``target`` as given (:class:`ComplexMSELoss` cleans nan first)."""
    amp = torch.abs(farfield)
    amp = amp / torch.sqrt(torch.sum(torch.square(amp)))
    return torch.mean(torch.square(amp - target))


def _cg_loop(psi, loss_from_psi, flags, iterations, on_step):
    """The CG loop of every class (``slmsuite_tpu``'s ``cg_step`` loop):
    each iteration the loss and its gradient by autograd, one step of the
    optimizer named by the ``optimizer`` flag, ``flags["loss_result"]`` (one
    host transfer), then ``on_step(psi)``, which returns True to stop before
    the iteration counts. Returns the last psi."""
    optimizer = _optim.get_optimizer(
        flags.get("optimizer", "adam"),
        flags.get("optimizer_kwargs", {"learning_rate": 0.1}),
    )
    state = optimizer.init(psi)
    for _ in iterations:
        leaf = psi.detach().requires_grad_(True)
        value = loss_from_psi(leaf)
        (grads,) = torch.autograd.grad(value, leaf)
        psi, state = optimizer.update(grads, state, psi)
        flags["loss_result"] = float(value.detach())
        if hasattr(iterations, "set_description"):
            iterations.set_description(f"loss={flags['loss_result']:.3e}")
        if on_step(psi):
            break
    return psi


def _crosses(device):
    """Whether a copy to or from ``device`` crosses between the host and a
    device."""
    return device.type != "cpu"


def _upload(host, device, dtype=None, copy=False):
    """``torch.as_tensor(host, dtype, device)`` (``torch.tensor`` with
    ``copy``: a private copy on the CPU too), the hologram modules' one way
    of moving host data to the device: where it crosses to one, its bytes
    count as ``h2d_bytes`` (:func:`slmsuite_torch.misc.profile.count`)."""
    out = (torch.tensor if copy else torch.as_tensor)(host, dtype=dtype, device=device)
    if _crosses(out.device):
        _profile.count("h2d_bytes", out.numel() * out.element_size())
    return out


def _download(tensor):
    """``tensor`` as a host numpy array, the hologram modules' one way of
    reading device data: where it crosses from a device, the host waits for
    it, and that counts as one of the ``syncs``
    (:func:`slmsuite_torch.misc.profile.count`)."""
    if _crosses(tensor.device):
        _profile.count("syncs")
    return tensor.detach().cpu().numpy()


class _Plane:
    """A plane attribute kept on the device, with a host numpy view made
    on first read. Writes take either kind. The device copy is trusted
    only while no host view exists (a host view may have been edited)."""

    def __set_name__(self, owner, name):
        self.host = f"_{name}_host"
        self.dev = f"_{name}_dev"

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        host = obj.__dict__.get(self.host)
        dev = obj.__dict__.get(self.dev)
        if host is None and dev is not None:
            host = _download(dev)
            obj.__dict__[self.host] = host
        return host

    def __set__(self, obj, value):
        if value is None or torch.is_tensor(value):
            obj.__dict__[self.host] = None
            obj.__dict__[self.dev] = value
        else:
            obj.__dict__[self.host] = np.asarray(value)
            obj.__dict__[self.dev] = None

    def resident(self, obj):
        """The device tensor while it is the trusted copy, else None."""
        if obj.__dict__.get(self.host) is None:
            return obj.__dict__.get(self.dev)
        return None

    def is_set(self, obj):
        """Whether the plane holds a value (no transfer)."""
        return obj.__dict__.get(self.host) is not None or obj.__dict__.get(self.dev) is not None

    def device(self, obj, device):
        """The plane as an f32 tensor on ``device`` (no copy when resident)."""
        dev = self.resident(obj)
        if dev is not None:
            return dev
        host = self.__get__(obj)
        if host is None:
            return None
        # A private f32 copy: the host view may be read-only or edited later.
        return _upload(np.array(host, dtype=np.float32), device)


class Hologram(_HologramStats):
    r"""
    Core DFT phase retrieval.

    Attributes
    ----------
    slm_shape : (int, int)
        Shape of the nearfield device.
    shape : (int, int)
        Shape of the computational farfield.
    phase : numpy.ndarray
        Nearfield phase (radians), shape :attr:`slm_shape`.
    amp : float OR numpy.ndarray
        Nearfield amplitude (normalized).
    target, weights : numpy.ndarray
        Farfield target amplitude (nan marks MRAF noise regions) and the
        current optimization weights, shape :attr:`shape`.
    amp_ff, phase_ff : numpy.ndarray OR None
        Current farfield amplitude/phase.
    zero_weights : numpy.ndarray OR None
        MRAF zero-region weights as a (2, H, W) re/im pair, once an
        ``optimize`` with ``zero_factor`` has run; the next such call
        resumes from them.
    flags : dict
        Persistent optimization flags (see :meth:`optimize`).
    stats : dict
        Per-iteration statistics in the reference schema.
    device : torch.device
        Where the planes and the loop live.
    """

    #: Folded nearfield phase.
    _psi = _Plane()
    #: Optimization weights.
    weights = _Plane()
    #: Farfield amplitude.
    amp_ff = _Plane()
    #: Folded farfield phase (the Kim phase store).
    _phase_ff_folded = _Plane()
    #: MRAF zero-region weights, (2, H, W) re/im.
    zero_weights = _Plane()

    def __init__(
        self,
        target,
        amp=None,
        phase=None,
        slm_shape=None,
        dtype=np.float32,
        propagation_kernel=None,
        device=None,
        **kwargs,
    ):
        """
        Parameters
        ----------
        target : array_like OR (int, int) OR None
            Target farfield **amplitude** (or a shape for an empty target).
        amp : array_like OR None
            Nearfield amplitude (normalized internally); uniform if None.
        phase : array_like OR None
            Initial nearfield phase (random if None).
        slm_shape : (int, int) OR SLM OR None
            Nearfield shape, or an SLM to take it from (with its measured
            source amplitude as ``amp`` when ``amp`` is None).
        dtype : type
            Host dtype: float32 (default) or float64. The loop runs in f32.
        propagation_kernel : array_like OR None
            Nearfield phase kernel baked into propagation.
        device : str OR torch.device OR None
            Device of the planes and the loop; the package default
            (``cuda``) when None.
        **kwargs :
            Initial :attr:`flags`.
        """
        self.device = resolve_device(device)
        if hasattr(slm_shape, "slm") and hasattr(slm_shape, "cam"):
            slm_shape = slm_shape.slm  # A CameraSLM: its SLM.
        if hasattr(slm_shape, "shape") and hasattr(slm_shape, "grid"):
            # An SLM: its shape, and its measured source amplitude as amp.
            source_amp = slm_shape.source.get("amplitude")
            if amp is None and source_amp is not None:
                amp = np.asarray(source_amp)
            slm_shape = tuple(slm_shape.shape)
        elif slm_shape is not None:
            slm_shape = tuple(int(v) for v in np.ravel(slm_shape))

        candidates = []
        if amp is not None and not np.isscalar(amp):
            candidates.append(tuple(np.shape(amp)))
        if phase is not None:
            candidates.append(tuple(np.shape(phase)))
        if slm_shape is not None:
            candidates.append(tuple(slm_shape))
        if candidates:
            if len(set(candidates)) > 1:
                raise ValueError(
                    f"Inconsistent shapes among amp/phase/slm_shape: {candidates}"
                )
            self.slm_shape = candidates[0]
        else:
            self.slm_shape = None

        if target is None:
            if self.slm_shape is None:
                raise ValueError("SLM shape must be provided when target is None.")
            self.shape = tuple(self.slm_shape)
            target_array = None
        elif np.ndim(target) <= 1 and len(target) == 2:
            self.shape = tuple(int(v) for v in target)
            target_array = None
        elif np.ndim(target) == 2:
            self.shape = tuple(np.shape(target))
            target_array = target
        else:
            raise ValueError(f"Unexpected target {np.shape(target)}.")

        if self.slm_shape is None:
            self.slm_shape = self.shape

        if np.dtype(dtype).itemsize == 4:
            self.dtype = np.float32
        elif np.dtype(dtype).itemsize == 8:
            self.dtype = np.float64
        else:
            raise ValueError(f"Data type {dtype} not supported.")

        if amp is None:
            self.amp = 1 / np.sqrt(np.prod(self.slm_shape))
        else:
            amp = np.asarray(amp, dtype=self.dtype)
            self.amp = amp / Hologram._norm(amp)

        if propagation_kernel is None or isinstance(propagation_kernel, REAL_TYPES):
            self.propagation_kernel = None
        else:
            self.propagation_kernel = np.asarray(propagation_kernel, dtype=self.dtype)
            if self.propagation_kernel.shape != tuple(self.slm_shape):
                raise ValueError("propagation_kernel must match slm_shape.")

        self.flags = dict(kwargs)

        self.target = None
        self._set_target(target_array, reset_weights=False)

        self._psi = None
        self.reset_phase(phase)
        self.reset(reset_phase=False, reset_flags=False)

    @staticmethod
    def get_padded_shape(
        slm_shape,
        padding_order=1,
        square_padding=True,
        precision=np.inf,
        precision_basis="kxy",
    ):
        """
        The computational shape for ``slm_shape`` (a shape, an SLM or a
        CameraSLM): padded to the ``padding_order``-th larger power of 2
        (squared by default), or as far as a k-space ``precision`` in
        ``precision_basis`` (``"kxy"`` or ``"ij"``) needs.
        """
        cameraslm = None
        if hasattr(slm_shape, "slm") and hasattr(slm_shape, "cam"):
            cameraslm = slm_shape
            slm_shape = cameraslm.slm.shape
        elif hasattr(slm_shape, "shape") and hasattr(slm_shape, "grid"):
            slm_obj = slm_shape
            slm_shape = slm_obj.shape
            if precision_basis == "ij" and np.isfinite(precision):
                raise ValueError("Pass a CameraSLM for 'ij' precision_basis.")
            cameraslm = type("_Fake", (), {"slm": slm_obj})()

        slm_shape = tuple(int(v) for v in slm_shape)

        if np.isfinite(precision) and cameraslm is not None:
            if precision <= 0:
                raise ValueError("precision must be positive.")
            fs = 1 / np.amin(cameraslm.slm.pitch)
            if precision_basis == "ij":
                pixels = np.amax(cameraslm.kxyslm_to_ijcam([fs, fs])) / precision
            else:
                pixels = fs / precision
            pixels = int(2 ** int(np.ceil(np.log2(pixels))))
            precision_shape = (pixels, pixels)
        elif np.isfinite(precision):
            raise ValueError("Pass a CameraSLM/SLM for precision calculations.")
        else:
            precision_shape = slm_shape

        if padding_order > 0:
            padding_shape = np.power(
                2, np.ceil(np.log2(slm_shape)) + padding_order - 1
            ).astype(int)
        else:
            padding_shape = slm_shape

        shape = tuple(
            int(v) for v in np.amax(np.vstack((precision_shape, padding_shape)), axis=0)
        )
        if square_padding:
            largest = int(np.amax(shape))
            shape = (largest, largest)
        return shape

    @staticmethod
    def _host_fingerprint(host):
        """Shape and the bytes of <= 1024 strided samples of a host array
        (None for a tensor): catches in-place edits that identity misses."""
        if not isinstance(host, np.ndarray):
            return None
        flat = host.reshape(-1)
        return (host.shape, flat[::max(1, flat.size // 1024)].tobytes())

    def _dev_const(self, key, host, make):
        """``make(host)``, kept on the device across calls while ``host`` is
        the same array with the same fingerprint."""
        cache = self.__dict__.setdefault("_dev_cache", {})
        fp = self._host_fingerprint(host)
        cached = cache.get(key)
        if cached is not None and cached[0] is host and cached[1] == fp:
            return cached[2]
        dev = make(host)
        cache[key] = (host, fp, dev)
        return dev

    def _target_device(self):
        """The target as an f32 device tensor (nan kept), uploaded once
        while :attr:`target` is unchanged; a copy on every device (a CPU
        tensor would otherwise share the host array's memory)."""
        return self._dev_const("target", self.target, lambda t: _upload(
            np.asarray(t, np.float32), self.device, copy=True))

    # ------------------------------------------------------------------
    # Phase conventions.
    # ------------------------------------------------------------------

    @property
    def phase(self):
        """Nearfield phase in the user (unfolded) convention."""
        psi = self._psi
        if psi is None:
            return None
        return _prop.unfold_phase(np.asarray(psi, dtype=self.dtype), self.shape)

    @phase.setter
    def phase(self, value):
        if value is None:
            self._psi = None
        else:
            self._psi = _prop.fold_phase(
                np.asarray(value, dtype=self.dtype), self.shape
            )

    def _unfold_ff_phase(self, theta_folded):
        """Folded-layout farfield phase -> true centered farfield phase
        (its own inverse)."""
        H, W = self.shape
        iy, ix = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        offset = np.pi * ((iy + ix) % 2)
        if _prop.farfield_sign(self.shape) < 0:
            offset = offset + np.pi
        return np.mod(theta_folded + offset + np.pi, 2 * np.pi) - np.pi

    # ------------------------------------------------------------------
    # Reset / target management.
    # ------------------------------------------------------------------

    @_profile.spanned("hologram.reset")
    def reset(self, reset_phase=True, reset_flags=False):
        """Reset the hologram to an initial state."""
        if self._psi is None or reset_phase:
            self.reset_phase()
        self.reset_weights()

        self.iter = 0
        self.stats = {"method": [], "flags": {}, "stats": {}}
        if reset_flags:
            self.flags = {"method": ""}

        self.amp_ff = None
        self._phase_ff_folded = None
        self._farfield_folded = None
        self._final_fixed_phase = False

    @_profile.spanned("hologram.reset_phase")
    def reset_phase(self, custom_phase=None, random_phase=None, quadratic_phase=None):
        r"""
        Reset :attr:`phase` to ``custom_phase``, or to (scaled) uniform
        random phase from numpy's global generator plus, with
        ``quadratic_phase`` (a scaling of the lens; the flag of the same name
        by default), the analytic blaze and lens of
        :meth:`_get_quadratic_initial_phase`.
        """
        if custom_phase is not None:
            custom_phase = np.asarray(custom_phase, dtype=self.dtype)
            if tuple(custom_phase.shape) != tuple(self.slm_shape):
                raise ValueError(
                    f"Reset phase of shape {custom_phase.shape} is not slm_shape {self.slm_shape}"
                )
            self.phase = custom_phase
            return

        if quadratic_phase is None:
            quadratic_phase = self.flags.get("quadratic_phase", False)
        if random_phase is None:
            random_phase = self.flags.get("random_phase", 1)

        phase = np.zeros(self.slm_shape, dtype=self.dtype)
        if quadratic_phase:
            phase += self._get_quadratic_initial_phase(quadratic_phase)
        if random_phase:
            phase += random_phase * np.random.uniform(
                -np.pi, np.pi, self.slm_shape
            ).astype(self.dtype)
        self.phase = phase

    def reset_weights(self):
        """Reset weights to the target (MRAF noise regions zeroed)."""
        if self.target is not None:
            self.weights = np.nan_to_num(self.target.copy(), nan=0)
        else:
            self.weights = None

    def _set_target(self, new_target, reset_weights=False):
        if new_target is None:
            self.target = np.zeros(self.shape, dtype=self.dtype)
        else:
            new_target = np.abs(np.asarray(new_target, dtype=self.dtype))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                self.target = new_target / Hologram._norm(new_target)
        if reset_weights:
            self.reset_weights()

    def set_target(self, new_target, reset_weights=False):
        """Change the target (cleans and normalizes)."""
        self._set_target(new_target=new_target, reset_weights=reset_weights)

    def set_weights(self, new_weights):
        """Set the weights to a new array of the target's shape."""
        new_weights = np.asarray(new_weights, dtype=self.dtype)
        if new_weights.shape != self.target.shape:
            raise ValueError(
                f"New weights {new_weights.shape} do not match target {self.target.shape}"
            )
        self.weights = new_weights

    def get_weights(self):
        """Current weights (numpy)."""
        return np.asarray(self.weights)

    def load_arrays(self, arrays):
        """
        Take state from numpy arrays, typically those of a
        ``slmsuite_tpu`` hologram (``np.asarray`` of its attributes), so
        that both packages start from identical planes. Recognized keys:
        ``"psi"`` (folded nearfield phase), ``"phase"`` (user phase),
        ``"weights"``, ``"phase_ff_folded"``, ``"target"``, ``"amp"``,
        ``"iter"`` and ``"fixed_phase"``.
        """
        known = {"psi", "phase", "weights", "phase_ff_folded", "target",
                 "amp", "iter", "fixed_phase"}
        unknown = set(arrays) - known
        if unknown:
            raise ValueError(f"Unrecognized arrays {sorted(unknown)}.")
        if "target" in arrays:
            self.target = np.asarray(arrays["target"], dtype=self.dtype)
        if "amp" in arrays:
            amp = np.asarray(arrays["amp"], dtype=self.dtype)
            self.amp = float(amp) if amp.ndim == 0 else amp
        if "psi" in arrays:
            self._psi = np.asarray(arrays["psi"], dtype=self.dtype)
        if "phase" in arrays:
            self.phase = arrays["phase"]
        if "weights" in arrays:
            self.weights = np.asarray(arrays["weights"], dtype=self.dtype)
        if "phase_ff_folded" in arrays:
            self._phase_ff_folded = np.asarray(arrays["phase_ff_folded"], np.float32)
        if "iter" in arrays:
            self.iter = int(arrays["iter"])
        if "fixed_phase" in arrays:
            self.flags["fixed_phase"] = bool(arrays["fixed_phase"])

    # ------------------------------------------------------------------
    # Accessors.
    # ------------------------------------------------------------------

    @_profile.spanned("hologram.get_phase")
    def get_phase(self, include_propagation=False):
        r"""Current nearfield phase, +pi (or with the propagation kernel
        included)."""
        if include_propagation and self.propagation_kernel is not None:
            return self.phase + self.propagation_kernel
        return self.phase + np.pi

    def get_amp(self):
        """Nearfield amplitude (scalar or numpy array)."""
        return self.amp

    def get_amp_ff(self):
        """Current farfield amplitude (numpy or None)."""
        return None if self.amp_ff is None else np.asarray(self.amp_ff)

    @property
    def phase_ff(self):
        """Current farfield phase (true centered convention) or None."""
        if self._phase_ff_folded is None:
            return None
        return self._unfold_ff_phase(np.asarray(self._phase_ff_folded))

    @phase_ff.setter
    def phase_ff(self, value):
        if value is None:
            self._phase_ff_folded = None
        else:
            self._phase_ff_folded = self._unfold_ff_phase(np.asarray(value))

    @property
    def farfield(self):
        """Current complex farfield (true centered convention) or None."""
        if self._farfield_folded is None:
            return None
        return _prop.unfold_farfield(self._farfield_folded).cpu().numpy()

    def _amp_device(self):
        """The amplitude as the engine takes it: a float or a device plane."""
        if np.isscalar(self.amp) or np.ndim(self.amp) == 0:
            return float(self.amp)
        return torch.as_tensor(np.asarray(self.amp, np.float32), device=self.device)

    def _kernel_device(self):
        """The propagation kernel as an f32 device tensor (None without
        one), uploaded once while :attr:`propagation_kernel` is unchanged,
        as :meth:`_target_device` is."""
        if self.propagation_kernel is None:
            return None
        return self._dev_const("propagation_kernel", self.propagation_kernel,
                               lambda k: _upload(np.asarray(k, np.float32), self.device,
                                                 copy=True))

    def get_farfield(self, shape=None, propagation_kernel=None, affine=None, get=True):
        r"""
        The complex farfield (numpy) from the current phase/amp, optionally
        at another ``shape`` or through an ``affine`` transform.
        """
        if shape is None:
            shape = self.shape
        shape = tuple(int(v) for v in shape)

        if propagation_kernel is None:
            propagation_kernel = self.propagation_kernel
        if isinstance(propagation_kernel, REAL_TYPES) and propagation_kernel == 0:
            propagation_kernel = None
        kernel = (
            None if propagation_kernel is None
            else torch.as_tensor(np.asarray(propagation_kernel, np.float32),
                                 device=self.device)
        )

        psi = torch.as_tensor(
            _prop.fold_phase(np.asarray(self.phase, np.float32), shape),
            device=self.device,
        )
        farfield = _prop.compute_farfield(
            psi, self._amp_device(), shape, kernel
        ).cpu().numpy()

        if shape == tuple(self.shape):
            self.amp_ff = np.abs(farfield)

        if affine is not None:
            from scipy.ndimage import affine_transform

            farfield = affine_transform(
                input=farfield,
                matrix=affine["M"],
                offset=np.ravel(affine["b"]),
                output_shape=shape,
                order=3,
                mode="constant",
                cval=0,
            )
        return farfield

    def _populate_results(self):
        """Farfield, amp_ff and phase_ff from the current phase/amp (kept
        on the device; host views are made on first read)."""
        psi = type(self)._psi.device(self, self.device)
        folded, amp_ff, theta = _prop.forward_fields(
            psi, self._amp_device(), tuple(self.shape), self._kernel_device()
        )
        self._farfield_folded = folded
        self.amp_ff = amp_ff
        self._phase_ff_folded = theta
        self._midloop_cleaning()

    # ------------------------------------------------------------------
    # The quadratic initial phase (slmsuite_tpu _hologram.py:825-858).
    # ------------------------------------------------------------------

    def _get_target_moments_knm_norm(self):
        """First/second moments of the target in normalized knm space."""
        target = np.nan_to_num(np.asarray(self.target))
        center_knm = analysis.image_positions(target, nansum=True)
        std_knm = np.sqrt(
            analysis.image_variances(target, centers=center_knm, nansum=True)[:2, 0]
        )
        shape = np.flip(self.shape).astype(float)
        return np.squeeze(center_knm) / shape, np.squeeze(std_knm) / shape

    def _get_quadratic_initial_phase(self, scaling=1):
        """The blaze toward the target's centroid plus the lens that spreads
        the source over the target's extent (host numpy)."""
        amp = self.amp
        if np.isscalar(amp):
            amp = np.ones(self.slm_shape)
        std_amp = np.sqrt(analysis.image_variances(np.asarray(amp))[:2, 0])
        slm_shape = np.flip(self.slm_shape).astype(float)
        std_amp = std_amp / slm_shape

        center_knm_norm, std_knm_norm = self._get_target_moments_knm_norm()

        grid = analysis._generate_grid(self.slm_shape[1], self.slm_shape[0], centered=True)
        grid = [
            grid[0].astype(self.dtype) / self.slm_shape[1],
            grid[1].astype(self.dtype) / self.slm_shape[0],
        ]
        # A target of no extent along an axis (one spot, or a line) has no
        # focal power there (a flat phase), not an infinite one.
        with np.errstate(divide="ignore"):
            focal = np.reciprocal(scaling * slm_shape * std_knm_norm / std_amp)
        return (
            tphase.blaze(grid, slm_shape * center_knm_norm)
            + tphase.lens(grid, focal)
        ).astype(self.dtype)

    # ------------------------------------------------------------------
    # Optimization.
    # ------------------------------------------------------------------

    @_profile.spanned("hologram.optimize")
    def optimize(
        self,
        method="GS",
        maxiter=20,
        verbose=True,
        callback=None,
        feedback=None,
        stat_groups=[],
        **kwargs,
    ):
        r"""
        Iterative phase retrieval. The port runs ``"GS"`` and the WGS
        methods (``"WGS-Leonardo"``, ``"WGS-Kim"``, ``"WGS-Nogrette"``,
        ``"WGS-Wu"``, ``"WGS-tanh"``) on the device, with
        ``"computational"`` feedback (on a :class:`SpotHologram` also
        ``"computational_spot"`` and, with a simulated rig as
        ``cameraslm``, ``"experimental_spot"``: the camera measures inside
        the loop on the device), the matching stat groups, padded
        farfields (``shape != slm_shape``) and propagation kernels.
        Leonardo, Kim, Wu and tanh
        with computational feedback and stats on an unpadded farfield
        take the fused loop; everything else the natural step.

        A target with nan runs MRAF: the nan pixels are the noise region,
        whose farfield evolves freely (times the ``mraf_factor`` flag when
        it is set), the zeros of the target are the zero region, held at
        0 or, with a ``zero_factor`` flag, at weights that evolve as
        ``zw - zero_factor |F| F`` and persist across calls in
        :attr:`zero_weights`. WGS-Leonardo and WGS-Kim with computational
        feedback and stats on an unpadded farfield take the carry-mode
        MRAF loop; every other MRAF run the natural step.

        A ``callback(holo)`` (called each iteration after the forward
        transform; returning True stops the loop before the weights and
        :attr:`iter` move), feedback measured on the host (a camera that
        the device measurement does not model, image feedback) or given by
        the user (``"external_spot"``), or a stat group that only the host
        computes runs the stepwise host loop, as in ``slmsuite_tpu``.
        ``"CG"`` runs gradient phase retrieval (:meth:`optimize_cg`).

        Parameters follow ``slmsuite_tpu``'s :meth:`optimize`: ``method``,
        ``maxiter``, ``verbose``, ``callback``, ``feedback``,
        ``stat_groups`` and method flags in ``**kwargs`` (persisted into
        :attr:`flags`).

        ``mesh=`` a :class:`slmsuite_torch.parallel.mesh.Mesh` runs the
        optimization sharded over it, as in ``slmsuite_tpu``: a plane's rows
        (:mod:`slmsuite_torch.parallel.plane`), :class:`MultiplaneHologram`'s
        planes, or :class:`CompressedSpotHologram`'s pixels. The mesh
        persists for later ``optimize`` calls until ``mesh=None`` is passed.
        """
        name = kwargs.pop("name", None)
        if "mesh" in kwargs:
            self._mesh = kwargs.pop("mesh")
        self._update_flags(method, verbose, feedback, stat_groups, **kwargs)

        if "GS" in method:
            self.optimize_gs(maxiter, callback, verbose=verbose, name=name)
        elif "CG" in method:
            progress = self._progress(maxiter, verbose, name)
            self.optimize_cg(range(maxiter) if progress is None else progress, callback)
            if progress is not None:
                progress.close()
        else:
            raise ValueError(f"Unsupported optimization method '{method}'")

    def optimize_cg(self, iterations, callback):
        """
        Gradient phase retrieval (``slmsuite_tpu``'s): each iteration the
        loss of the farfield of the current phase and its gradient by
        autograd through :meth:`slmsuite_torch.ops.propagation.
        differentiable_farfield` (the FFT kernels forward and backward),
        then one step of the optimizer named by the ``"optimizer"`` flag
        (:mod:`slmsuite_torch.ops.optim`; ``"optimizer_kwargs"`` passed
        through, ``lr`` accepted as an alias of ``learning_rate``).

        The ``"loss"`` flag may be a callable ``loss(farfield, target) ->
        scalar`` on torch tensors (the complex farfield and the raw target,
        nan kept); the default is the mean squared error of the
        unit-power farfield amplitude against the target, nan counted as 0
        (:class:`ComplexMSELoss`). ``flags["loss_result"]`` holds each
        iteration's loss. A ``callback(holo)`` runs after the phase is set
        and stops the loop before :attr:`iter` moves by returning True.
        """
        psi, loss_from_psi = self._cg_objective()

        def on_step(psi):
            if callback is not None:
                self._adopt_cg_psi(psi)
                if callback(self):
                    return True
            if self.flags["stat_groups"]:
                self._adopt_cg_psi(psi)
                self._populate_results()
                self._update_stats(self.flags["stat_groups"])
            self.iter += 1
            return False

        self._adopt_cg_psi(_cg_loop(psi, loss_from_psi, self.flags, iterations, on_step))
        self._populate_results()

    def _cg_objective(self):
        """``(psi, loss_from_psi)``: the current phase as the CG loop carries
        it (here the folded psi) and its loss, differentiable in psi."""
        loss = self.flags.get("loss")
        if loss is None:
            loss = ComplexMSELoss()
        shape = tuple(self.shape)
        amp = self._amp_device()
        target = self._target_device()
        kernel = self._kernel_device()

        def loss_from_psi(psi):
            return loss(_prop.differentiable_farfield(psi, amp, shape, kernel), target)

        return type(self)._psi.device(self, self.device), loss_from_psi

    def _adopt_cg_psi(self, psi):
        """Set the phase from the CG loop's psi."""
        self._psi = psi

    def _update_flags(self, method, verbose, feedback, stat_groups, **kwargs):
        """Merge method defaults + kwargs into :attr:`flags`."""
        if method not in ALGORITHM_DEFAULTS:
            raise ValueError(
                f"Unrecognized method '{method}'. Valid: {list(ALGORITHM_DEFAULTS)}"
            )
        self.flags["method"] = method

        for flag, value in ALGORITHM_DEFAULTS[method].items():
            self.flags.setdefault(flag, value)
        self.flags.setdefault("fixed_phase", False)

        for flag in kwargs:
            self.flags[flag] = kwargs[flag]

        for group in stat_groups:
            if group not in FEEDBACK_OPTIONS:
                raise ValueError(
                    f"Statistics group '{group}' invalid. Valid: {FEEDBACK_OPTIONS}"
                )
        self.flags["stat_groups"] = list(stat_groups)

        if feedback is not None:
            if feedback not in FEEDBACK_OPTIONS:
                raise ValueError(
                    f"Feedback '{feedback}' invalid. Valid: {FEEDBACK_OPTIONS}"
                )
            self.flags["feedback"] = feedback

        if verbose > 1:
            import pprint

            print(f"Optimizing with '{method}' using flags:")
            pprint.pprint(
                {k: v for k, v in self.flags.items() if k in ALGORITHM_DEFAULTS[method]}
            )

    def _engine_feedback(self):
        """The device feedback mode for the engine ('computational' here)."""
        feedback = self.flags.get("feedback", "computational")
        if feedback not in ("computational",):
            raise ValueError(
                f"Feedback '{feedback}' requires a FeedbackHologram/SpotHologram subclass."
            )
        return feedback

    def _device_stat_groups(self):
        """Stat groups the engine can compute on device."""
        return tuple(
            g
            for g in self.flags.get("stat_groups", [])
            if g in ("computational", "computational_spot")
        )

    def _midloop_cleaning(self):
        """Drop what was cached for the last phase (hook for subclasses)."""

    def _mraf_enabled(self):
        return bool(np.any(np.isnan(self.target))) if self.target is not None else False

    def _build_config(self):
        mraf = self._mraf_enabled()
        config = _engine.GSConfig(
            method=self.flags["method"],
            shape=tuple(self.shape),
            slm_shape=tuple(self.slm_shape),
            feedback=self._engine_feedback(),
            stat_groups=self._device_stat_groups(),
            mraf=mraf,
            mraf_factor=mraf and self.flags.get("mraf_factor") is not None,
            zero_factor=mraf and bool(self.flags.get("zero_factor", 0)),
            has_kernel=self.propagation_kernel is not None,
            kim_efficiency_trigger=(
                "Kim" in self.flags["method"]
                and self.flags.get("fix_phase_efficiency") is not None
            ),
            spot_single_px=getattr(self, "_spot_single_px", False),
        )
        return self._amend_config(config)

    def _amend_config(self, config):
        """Hook for subclasses to refine the engine config (the simulated
        rig's camera statics)."""
        return config

    def _build_consts(self, config):
        device = self.device
        target = np.asarray(self.target, dtype=np.float32)

        def scalar(value, dtype=torch.float32):
            return torch.tensor(value, dtype=dtype, device=device)

        consts = {
            "amp": self._amp_device(),
            "target": torch.as_tensor(target, device=device),
            "stat_mask": torch.as_tensor((target != 0) & ~np.isnan(target), device=device),
            "feedback_exponent": scalar(float(self.flags.get("feedback_exponent", 0.8))),
            "feedback_factor": scalar(float(self.flags.get("feedback_factor", 0.1))),
            "fix_phase_iteration": scalar(
                int(self.flags.get("fix_phase_iteration", 10)), torch.int32
            ),
            "fix_phase_efficiency": scalar(
                float(self.flags.get("fix_phase_efficiency") or np.nan)
            ),
        }
        if config.has_kernel:
            consts["kernel"] = self._kernel_device()
        if config.mraf:
            noise = np.isnan(target)
            zero = ~noise & (target == 0)
            for key, mask in (("signal_mask", ~(noise | zero)), ("noise_mask", noise),
                              ("zero_mask", zero)):
                consts[key] = torch.as_tensor(mask, device=device)
            consts["mraf_factor"] = scalar(float(self.flags.get("mraf_factor") or 1.0))
            consts["zero_factor"] = scalar(float(self.flags.get("zero_factor", 0.0)))
        self._extend_consts(consts, config)
        return consts

    def _extend_consts(self, consts, config):
        """Hook for subclasses (spot gather maps)."""

    def _build_state(self, config):
        device = self.device
        phase_ff = type(self)._phase_ff_folded.device(self, device)
        # A second optimize() with zero_factor resumes from the last run's.
        zero_weights = (
            type(self).zero_weights.device(self, device) if config.zero_factor else None
        )
        if zero_weights is None:
            zero_weights = _engine.empty_zero_weights(config, device)
        return _engine.GSState(
            psi=type(self)._psi.device(self, device),
            weights=torch.nan_to_num(type(self).weights.device(self, device)),
            phase_ff=(
                phase_ff if phase_ff is not None
                else torch.zeros(config.shape, dtype=torch.float32, device=device)
            ),
            zero_weights=zero_weights,
            fixed_phase=torch.tensor(bool(self.flags.get("fixed_phase", False)),
                                     device=device),
            unfixed_streak=torch.zeros((), dtype=torch.int32, device=device),
            iteration=torch.tensor(self.iter, dtype=torch.int32, device=device),
        )

    def _sync_from_state(self, state):
        """Write the device state back into the hologram (planes stay on
        the device; one host fetch for the scalars)."""
        self._psi = state.psi
        self.weights = state.weights
        self._phase_ff_folded = state.phase_ff
        if state.zero_weights.numel():
            self.zero_weights = state.zero_weights
        scalars = torch.stack([
            state.fixed_phase.to(torch.float32),
            state.iteration.to(torch.float32),
        ]).cpu().numpy()
        self._final_fixed_phase = bool(scalars[0])
        self.iter = int(scalars[1])

    @staticmethod
    def _progress(maxiter, verbose, name):
        """A tqdm progress bar over ``range(maxiter)`` (advanced by hand or
        by iterating it) when ``verbose`` and tqdm is installed, else None."""
        if not verbose or maxiter <= 1:
            return None
        try:
            from tqdm.auto import tqdm
        except ImportError:
            return None
        return tqdm(range(maxiter), desc=name)

    def optimize_gs(self, maxiter, callback, verbose=True, name=None):
        """
        GS/WGS loop. Fully-computational runs take the engine, in chunks
        (progress reporting between chunks when ``verbose``), with the
        stats fetched once per call; a callback, host feedback or host
        stats take the stepwise host loop, one :meth:`_stepwise_iteration`
        per iteration.
        """
        if isinstance(maxiter, range):
            maxiter = len(maxiter)

        host_loop = (
            callback is not None
            or bool(self._stats_pending_groups())
            or self._engine_feedback() in ("external", "external_spot")
        )
        if (
            self.flags.get("fix_phase_efficiency") is not None
            and "Kim" in self.flags["method"]
            and not self._device_stat_groups()
            and not host_loop
        ):
            raise ValueError("Must track statistics to fix phase based on efficiency!")

        config = self._build_config()
        consts = self._build_consts(config)
        progress = self._progress(maxiter, verbose, name)

        if host_loop:
            self._warn_mesh_host_loop()
            for _ in range(maxiter):
                self._stepwise_iteration(config, consts, callback)
                if progress is not None:
                    progress.update(1)
                if self._break_requested:
                    break
        else:
            state = self._build_state(config)
            start_iter = self.iter
            chunk = maxiter if not verbose else max(1, int(np.ceil(maxiter / 10)))
            on_chunk = progress.update if progress is not None else None
            state, all_stats = _engine.run_gs_chunked(
                config, state, consts, maxiter, chunk=chunk, on_chunk=on_chunk,
                run=self._plane_mesh_run(config),
            )
            self._sync_from_state(state)
            if self._device_stat_groups():
                self._record_scan_stats(torch.cat(all_stats).cpu().numpy(), start_iter)
        if progress is not None:
            progress.close()
        self._populate_results()

    #: Set by a callback that returned True; ends the host loop.
    _break_requested = False

    #: The active :class:`slmsuite_torch.parallel.mesh.Mesh` (set through
    #: ``optimize(mesh=...)``).
    _mesh = None

    def _warn_mesh_host_loop(self):
        """The host loop runs on one device, whatever the mesh."""
        if self._mesh is not None:
            warnings.warn(
                "mesh-sharded optimization requires the fully-computational "
                "path (no callback/experimental feedback); running on a "
                "single device."
            )

    def _plane_mesh_run(self, config):
        """The run of a chunk that shards the plane's rows over the mesh's
        first axis (:meth:`slmsuite_torch.parallel.plane.run_sharded_plane_gs`),
        or None for the engine's own: with no mesh, or one that
        :meth:`~slmsuite_torch.parallel.plane.plane_shardable` refuses (then
        with a warning, and the run is on one device)."""
        from slmsuite_torch.parallel.plane import plane_shardable, run_sharded_plane_gs

        mesh = self._mesh
        if mesh is None:
            return None
        if not plane_shardable(config, mesh.size):
            warnings.warn(
                "mesh-sharded plane optimization requires farfield "
                "shape == SLM shape, computational (non-spot) "
                "feedback, and dimensions divisible by the mesh; "
                "running on a single device."
            )
            return None

        def run(config, state, consts, n):
            return run_sharded_plane_gs(config, state, consts, mesh, n, mesh.axis_names[0])

        return run

    def _stepwise_iteration(self, config, consts, callback):
        """
        One host-paced iteration: the forward transform on the device (the
        complex farfield stays there), the callback, the stats and the
        weight update, then the constraint and backward transform on the
        device (:meth:`slmsuite_torch.ops.propagation.stepwise_backward`).
        """
        self._break_requested = False
        device = self.device
        kernel = consts["kernel"] if config.has_kernel else None
        farfield, amp_ff, theta = _prop.forward_fields(
            type(self)._psi.device(self, device), consts["amp"], tuple(config.shape), kernel
        )
        self._farfield_folded = farfield
        self.amp_ff = amp_ff
        self._midloop_cleaning()

        if callback is not None and callback(self):
            self._break_requested = True
            return
        self._update_stats(self.flags["stat_groups"])

        was_not_fixed = not self.flags.get("fixed_phase", False)
        if "WGS" in self.flags["method"] and self.iter > 0:
            self._update_weights()
            self._kim_decision_host()
        # The constraint phase: the current angle while unfixed, including
        # the iteration that fixes it.
        if was_not_fixed or not type(self)._phase_ff_folded.is_set(self):
            self._phase_ff_folded = theta

        self._psi = _prop.stepwise_backward(config)(
            farfield,
            torch.nan_to_num(type(self).weights.device(self, device)),
            type(self)._phase_ff_folded.device(self, device),
            consts,
        )
        self.iter += 1

    def _kim_decision_host(self):
        """Kim's phase fixing in the host loop: on the last stat group's
        efficiency (``fix_phase_efficiency``), or after
        ``fix_phase_iteration`` unfixed iterations in the flag history."""
        if "Kim" not in self.flags["method"]:
            self.flags["fixed_phase"] = False
            return

        was_not_fixed = not self.flags.get("fixed_phase", False)

        if self.flags.get("fix_phase_efficiency") is not None:
            stats = self.stats["stats"]
            if len(stats) == 0:
                raise ValueError("Must track statistics to fix phase based on efficiency!")
            group = list(stats.keys())[-1]
            if stats[group]["efficiency"][self.iter] > self.flags["fix_phase_efficiency"]:
                self.flags["fixed_phase"] = True

        n = self.flags.get("fix_phase_iteration", 10)
        if was_not_fixed and self.iter >= n - 1:
            previous = self.stats["flags"].get("fixed_phase", [])
            if len(previous) >= n and all(not bool(previous[-1 - i]) for i in range(n)):
                self.flags["fixed_phase"] = True

    def _updated_weights(self, feedback_amp, target_amp):
        """The method's weight update of the current weights on the device,
        from device ``feedback_amp`` and ``target_amp`` of their shape."""
        return update_weights_generic(
            torch.nan_to_num(type(self).weights.device(self, self.device)),
            feedback_amp,
            target_amp,
            self.flags["method"],
            self.flags.get("feedback_exponent", 0.8),
            self.flags.get("feedback_factor", 0.1),
        )

    def _update_weights(self):
        """The host loop's computational weight update (subclasses add
        feedback modes); it runs on the device."""
        if self.flags["feedback"] == "computational":
            self.weights = self._updated_weights(
                type(self).amp_ff.device(self, self.device), self._target_device()
            )

    def _populate_stats(self, stats, stat_groups):
        """The ``computational`` group on the device while the farfield
        amplitude is there (four numbers cross to the host); the host's
        stats otherwise and for ``raw_stats``."""
        amp_ff = type(self).amp_ff.resident(self)
        if ("computational" in stat_groups and amp_ff is not None
                and not self.flags.get("raw_stats")):
            values = calculate_stats(
                amp_ff, self._target_device(), efficiency_compensation=False
            ).cpu().numpy()
            stats["computational"] = dict(zip(STAT_KEYS, (float(v) for v in values)))
            stat_groups = [g for g in stat_groups if g != "computational"]
        super()._populate_stats(stats, stat_groups)

    def _remove_vortices(self):
        """Remove farfield phase vortices where the target is positive."""
        if self.phase_ff is not None:
            cleaned = analysis.image_remove_vortices(
                self.phase_ff.copy(), np.nan_to_num(np.asarray(self.target)) > 0
            )
            self.phase_ff = cleaned

    # ------------------------------------------------------------------
    # Memory (slmsuite_tpu _hologram.py:729-800, 1452-1474). The live-set
    # model is the JAX package's, so that an explicit budget gives its
    # answer; the budget itself is read from the CUDA device.
    # ------------------------------------------------------------------

    #: Planes of the scanned step's live set, by path (the JAX package's
    #: model: carry, weights, target, phase store, stats mask, the step's
    #: outputs and workspace; the natural path adds the farfield planes).
    _STEP_LIVE_PLANES = {"fused": 14, "natural": 22}

    #: Multiplicative slack for allocator fragmentation.
    _HBM_SLACK = 1.25

    def _calculate_memory_constrained_shape(self, device=0, dtype=None, budget=None,
                                            path="fused"):
        """
        Largest square computational side :math:`N` whose step's live set
        (:attr:`_STEP_LIVE_PLANES` planes of ``dtype``, times
        :attr:`_HBM_SLACK`) fits in ``budget`` bytes; ``budget=None`` reads
        the device's limit (:meth:`get_mempool_limit`, from
        ``torch.cuda.mem_get_info``). ``path`` is ``"fused"`` or
        ``"natural"``. Returns the side as a float.
        """
        if dtype is None:
            dtype = self.dtype
        return Hologram._memory_constrained_side(budget, device=device, dtype=dtype, path=path)

    @staticmethod
    def _memory_constrained_side(budget, device=0, dtype=np.float32, path="fused"):
        """Core of :meth:`_calculate_memory_constrained_shape` (shared with
        the instance-free :meth:`suggest_memory_strategy`)."""
        if budget is None:
            budget = Hologram.get_mempool_limit(device=device)
        if budget is None or budget <= 0:
            raise RuntimeError(
                "No device memory budget available; pass budget= explicitly "
                "(e.g. 80e9 for an H100)."
            )
        planes = Hologram._STEP_LIVE_PLANES[path]
        bytes_per_value = np.dtype(dtype).itemsize
        values_per_plane = budget / (planes * bytes_per_value * Hologram._HBM_SLACK)
        return float(np.sqrt(values_per_plane))

    @staticmethod
    def suggest_memory_strategy(shape, budget=None, device=0, dtype=np.float32, spots=False):
        """
        Sizing advice for a computational ``shape`` against a device memory
        ``budget`` in bytes (None: the device's, :meth:`get_mempool_limit`):
        whether one device's engine fits, the largest side that would, and
        above the budget which path to take (the row-sharded plane of
        :mod:`slmsuite_torch.parallel.plane` for images; the grid-free
        :class:`CompressedSpotHologram` for spots). Returns ``{"shape",
        "max_side", "fits", "recommendation", "budget"}``.
        """
        max_side = Hologram._memory_constrained_side(budget, device=device, dtype=dtype)
        side = int(np.max(shape) if not np.isscalar(shape) else shape)
        fits = side <= max_side
        if fits:
            recommendation = "single-chip"
        elif spots:
            recommendation = "compressed"
        else:
            recommendation = "shard-plane"
        return {
            "shape": (side, side),
            "max_side": max_side,
            "fits": fits,
            "recommendation": recommendation,
            "budget": budget,
        }

    #: The fraction of each CUDA device's memory this process may allocate,
    #: as :meth:`set_mempool_limit` last set it (1 where it was not set).
    _mempool_fraction = {}

    @staticmethod
    def _cuda_index(device):
        device = torch.device("cuda", device) if isinstance(device, int) else torch.device(device)
        return torch.cuda.current_device() if device.index is None else device.index

    @staticmethod
    def set_mempool_limit(device=0, size=None, fraction=None):
        """
        Limit the memory PyTorch's caching allocator may take on a CUDA
        ``device`` to ``size`` bytes or a ``fraction`` of the device
        (``torch.cuda.set_per_process_memory_fraction``: upstream's trim of
        the GPU memory pool). Warns and does nothing without a CUDA device.
        """
        if not torch.cuda.is_available():
            warnings.warn("set_mempool_limit: no CUDA device; nothing to limit.")
            return
        index = Hologram._cuda_index(device)
        if fraction is None:
            if size is None:
                fraction = 1.0
            else:
                fraction = float(size) / torch.cuda.mem_get_info(index)[1]
        fraction = float(np.clip(fraction, 0.0, 1.0))
        torch.cuda.set_per_process_memory_fraction(fraction, index)
        Hologram._mempool_fraction[index] = fraction

    @staticmethod
    def get_mempool_limit(device=0):
        """The bytes this process may allocate on a CUDA ``device``: the
        device's memory (``torch.cuda.mem_get_info``) times the fraction
        :meth:`set_mempool_limit` set; -1 without a CUDA device."""
        if not torch.cuda.is_available():
            return -1
        index = Hologram._cuda_index(device)
        total = torch.cuda.mem_get_info(index)[1]
        return int(total * Hologram._mempool_fraction.get(index, 1.0))

    @staticmethod
    def _norm(matrix):
        r"""Root of sum of squares :math:`\sqrt{\iint |E|^2}`."""
        matrix = np.asarray(matrix)
        if np.iscomplexobj(matrix):
            return np.sqrt(np.nansum(np.square(np.abs(matrix))))
        return np.sqrt(np.nansum(np.square(matrix)))
