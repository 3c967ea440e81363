r"""
DFT-based phase retrieval: the :class:`Hologram` class (PyTorch
counterpart of :mod:`slmsuite_tpu.holography.algorithms._hologram`).

The nearfield phase is carried in the *folded* (checkerboard) basis so
the loop runs shift-free (see :mod:`slmsuite_torch.ops.propagation`); all
user-facing accessors unfold. Fully-computational runs go through the
engine (:mod:`slmsuite_torch.ops.engine`) in chunks, with the planes kept
on the device between calls; a target with nan (MRAF noise regions) runs
MRAF. The stepwise host loop (callbacks, experimental feedback),
conjugate gradient and mesh-sharded runs are not ported yet and raise
:class:`NotImplementedError`.
"""

import warnings

import numpy as np
import torch

from slmsuite_torch import resolve_device
from slmsuite_torch.holography.algorithms._header import (
    ALGORITHM_DEFAULTS,
    FEEDBACK_OPTIONS,
)
from slmsuite_torch.holography.algorithms._stats import _HologramStats
from slmsuite_torch.holography.toolbox import REAL_TYPES
from slmsuite_torch.ops import engine as _engine
from slmsuite_torch.ops import propagation as _prop


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
            host = dev.detach().cpu().numpy()
            obj.__dict__[self.host] = host
        return host

    def __set__(self, obj, value):
        if value is None or torch.is_tensor(value):
            obj.__dict__[self.host] = None
            obj.__dict__[self.dev] = value
        else:
            obj.__dict__[self.host] = np.asarray(value)
            obj.__dict__[self.dev] = None

    def device(self, obj, device):
        """The plane as an f32 tensor on ``device`` (no copy when resident)."""
        dev = obj.__dict__.get(self.dev)
        if dev is not None and obj.__dict__.get(self.host) is None:
            return dev
        host = self.__get__(obj)
        if host is None:
            return None
        # A private f32 copy: the host view may be read-only or edited later.
        return torch.from_numpy(np.array(host, dtype=np.float32)).to(device)


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
        slm_shape : (int, int) OR None
            Nearfield shape.
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
        if slm_shape is not None:
            if hasattr(slm_shape, "shape") and hasattr(slm_shape, "grid"):
                raise NotImplementedError(
                    "SLM objects as slm_shape come with the hardware slice "
                    "(ROADMAP.md queue 1, item 9); pass a shape."
                )
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

    def reset_phase(self, custom_phase=None, random_phase=None, quadratic_phase=None):
        r"""
        Reset :attr:`phase` to ``custom_phase``, or to (scaled) uniform
        random phase from numpy's global generator.
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
        if quadratic_phase:
            raise NotImplementedError(
                "The quadratic initial phase comes with the analysis helpers "
                "(ROADMAP.md queue 1, item 12)."
            )
        if random_phase is None:
            random_phase = self.flags.get("random_phase", 1)

        phase = np.zeros(self.slm_shape, dtype=self.dtype)
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
        if self.propagation_kernel is None:
            return None
        return torch.as_tensor(
            np.asarray(self.propagation_kernel, np.float32), device=self.device
        )

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

    # ------------------------------------------------------------------
    # Optimization.
    # ------------------------------------------------------------------

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
        ``"computational"`` feedback (and ``"computational_spot"`` on a
        :class:`SpotHologram`), ``"computational"`` and
        ``"computational_spot"`` stats, padded farfields (``shape !=
        slm_shape``) and propagation kernels. Leonardo, Kim, Wu and tanh
        with computational feedback and stats on an unpadded farfield
        take the fused loop; everything else the natural step.

        A target with nan runs MRAF: the nan pixels are the noise region,
        whose farfield evolves freely (times the ``mraf_factor`` flag when
        it is set), the zeros of the target are the zero region, held at
        0 or, with a ``zero_factor`` flag, at weights that evolve as
        ``zw - zero_factor |F| F`` and persist across calls in
        :attr:`zero_weights`. WGS-Leonardo and WGS-Kim with computational
        feedback and stats on an unpadded farfield take the carry-mode
        MRAF loop; every other MRAF run the natural step. ``"CG"``,
        callbacks and camera feedback raise :class:`NotImplementedError`
        naming their ROADMAP item.

        Parameters follow ``slmsuite_tpu``'s :meth:`optimize`: ``method``,
        ``maxiter``, ``verbose``, ``callback``, ``feedback``,
        ``stat_groups`` and method flags in ``**kwargs`` (persisted into
        :attr:`flags`).
        """
        name = kwargs.pop("name", None)
        if kwargs.pop("mesh", None) is not None:
            raise NotImplementedError(
                "Mesh-sharded optimization comes with the distributed engines "
                "(ROADMAP.md queue 1, item 11)."
            )
        self._update_flags(method, verbose, feedback, stat_groups, **kwargs)

        if "GS" in method:
            self.optimize_gs(maxiter, callback, verbose=verbose, name=name)
        elif "CG" in method:
            self.optimize_cg()
        else:
            raise ValueError(f"Unsupported optimization method '{method}'")

    def optimize_cg(self, *args, **kwargs):
        """Gradient-based phase retrieval (torch.autograd + torch.optim)."""
        raise NotImplementedError(
            "Conjugate-gradient optimization is not ported yet "
            "(ROADMAP.md queue 1, item 6)."
        )

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

    def _mraf_enabled(self):
        return bool(np.any(np.isnan(self.target))) if self.target is not None else False

    def _build_config(self):
        mraf = self._mraf_enabled()
        return _engine.GSConfig(
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

    def optimize_gs(self, maxiter, callback, verbose=True, name=None):
        """
        GS/WGS loop on the engine, in chunks (progress reporting between
        chunks when ``verbose``); stats are fetched once per call.
        """
        if isinstance(maxiter, range):
            maxiter = len(maxiter)

        if (
            callback is not None
            or self._stats_pending_groups()
            or self._engine_feedback() in ("external", "external_spot")
        ):
            raise NotImplementedError(
                "The stepwise host loop (callbacks, experimental or external "
                "feedback) is not ported yet (ROADMAP.md queue 1, items 6 and 9)."
            )
        if (
            self.flags.get("fix_phase_efficiency") is not None
            and "Kim" in self.flags["method"]
            and not self._device_stat_groups()
        ):
            raise ValueError("Must track statistics to fix phase based on efficiency!")

        config = self._build_config()
        consts = self._build_consts(config)
        state = self._build_state(config)
        start_iter = self.iter

        chunk = maxiter if not verbose else max(1, int(np.ceil(maxiter / 10)))
        progress = None
        if verbose and maxiter > 1:
            try:
                from tqdm.auto import tqdm
            except ImportError:
                tqdm = None
            if tqdm is not None:
                progress = tqdm(total=maxiter, desc=name)
        state, all_stats = _engine.run_gs_chunked(
            config, state, consts, maxiter, chunk=chunk,
            on_chunk=(progress.update if progress is not None else None),
        )
        if progress is not None:
            progress.close()

        self._sync_from_state(state)
        if self._device_stat_groups():
            self._record_scan_stats(torch.cat(all_stats).cpu().numpy(), start_iter)
        self._populate_results()

    @staticmethod
    def _norm(matrix):
        r"""Root of sum of squares :math:`\sqrt{\iint |E|^2}`."""
        matrix = np.asarray(matrix)
        if np.iscomplexobj(matrix):
            return np.sqrt(np.nansum(np.square(np.abs(matrix))))
        return np.sqrt(np.nansum(np.square(matrix)))
