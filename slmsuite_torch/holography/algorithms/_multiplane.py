r"""
Multiplane holography: several child holograms sharing one nearfield
(PyTorch counterpart of
:mod:`slmsuite_tpu.holography.algorithms._multiplane`).

Each child (possibly at a different focal plane through its
``propagation_kernel``) computes its own farfield and constraint; the
complex nearfields (kernels removed) are weight-summed into the shared
phase. A homogeneous, fully computational, callback-free problem runs as
one batched device loop (:mod:`slmsuite_torch.parallel.multiplane`: each
transform launched once an iteration for all planes, no host transfer in
the loop). Anything else (a callback, ``SpotHologram`` children, host
feedback or stats, ``zero_factor``) runs the host meta loop: each child's
forward, stats, weight update and constraint, then one weighted sum of the
windows. ``"CG"`` differentiates the plane-weighted sum of the children's
losses through each child's :class:`slmsuite_torch.ops.grad.Fft2`.
With ``optimize(mesh=...)`` the batched engine cuts the planes over the
mesh (:meth:`slmsuite_torch.parallel.multiplane.run_batched_gs`); a problem
it does not cover warns and runs the host meta loop.
"""

import warnings

import numpy as np
import torch

from slmsuite_torch import resolve_device
from slmsuite_torch.holography.algorithms._hologram import (
    Hologram,
    _cg_loop,
    _default_cg_loss,
)
from slmsuite_torch.holography.analysis._cv import gaussian_blur
from slmsuite_torch.ops import fft as _fft
from slmsuite_torch.ops import propagation as _prop


def _child_backward(config):
    """The meta loop's backward for a child's engine ``config``:
    ``backward(farfield, weights, phase_ff, plane_weight, consts) -> (re,
    im)``, the plane-weighted complex nearfield window with the child's
    propagation kernel removed. Without MRAF the constraint ``w e^{i
    phase_ff}`` goes to :meth:`slmsuite_torch.ops.fft.wexp_ifft2`; with MRAF
    its region mix to :meth:`~slmsuite_torch.ops.fft.ifft2`."""
    y0, y1, x0, x1 = _prop.pad_window_slices(config.shape, config.slm_shape)

    def backward(farfield, weights, phase_ff, plane_weight, consts):
        if config.mraf:
            re, im = weights * torch.cos(phase_ff), weights * torch.sin(phase_ff)
            signal = consts["signal_mask"]
            re = torch.where(signal, re, farfield.real)
            im = torch.where(signal, im, farfield.imag)
            if config.mraf_factor:
                noise, k = consts["noise_mask"], consts["mraf_factor"]
                re, im = torch.where(noise, k * re, re), torch.where(noise, k * im, im)
            zero = consts["zero_mask"]
            re, im = torch.where(zero, 0.0, re), torch.where(zero, 0.0, im)
            re, im = _fft.ifft2(re.contiguous(), im.contiguous())
        else:
            re, im = _fft.wexp_ifft2(weights, phase_ff)
        re, im = re[y0:y1, x0:x1], im[y0:y1, x0:x1]
        if config.has_kernel:
            c, s = torch.cos(consts["kernel"]), torch.sin(consts["kernel"])
            re, im = re * c + im * s, im * c - re * s
        return plane_weight * re, plane_weight * im

    return backward


def _combine_windows(windows):
    """Sum the children's complex windows; the shared folded phase."""
    re, im = windows[0]
    for wr, wi in windows[1:]:
        re, im = re + wr, im + wi
    return torch.atan2(im, re)


class MultiplaneHologram(Hologram):
    """
    Meta-hologram optimizing ``N`` child holograms simultaneously through
    one shared phase pattern.

    Attributes
    ----------
    holograms : list of Hologram
        Children (any non-multiplane Hologram subclass).
    weights : numpy.ndarray
        Per-child power weights (normalized).
    """

    def __init__(self, holograms, weights=None):
        """Initialize from children; weights default to even power. The
        parent lives on the first child's device."""
        self.holograms = holograms

        for h in self.holograms:
            if isinstance(h, MultiplaneHologram):
                raise ValueError("Multiplane hologram recursion is not supported.")
            if not isinstance(h, Hologram):
                raise ValueError(
                    f"Multiplane hologram must be given child holograms, not {type(h)}"
                )

        super().__init__(
            target=holograms[0].slm_shape,
            amp=holograms[0].amp,
            phase=holograms[0].phase,
            slm_shape=holograms[0].slm_shape,
            dtype=holograms[0].dtype,
            device=holograms[0].device,
        )
        self.target = None

        # Children share the parent's nearfield.
        for h in self.holograms:
            h.amp = self.amp

        if weights is None:
            weights = np.ones(len(self), dtype=self.dtype)
        self.weights = np.asarray(weights, dtype=self.dtype)
        self.weights = self.weights / Hologram._norm(self.weights)

    def __len__(self):
        return len(self.holograms)

    @staticmethod
    def get_multiplane_defocus_blur(cameraslm, targets, target_depths, return_depths=None,
                                    sharp_focus=True, device=None):
        """
        Propagate a stack of target images between depths with Gaussian
        defocus blur (``slmsuite_tpu``'s, which blurs with
        ``cv2.GaussianBlur``; here the same kernel and borders in torch on
        ``device``, the package default when None). Returns the
        ``(len(return_depths), h, w)`` float64 stack (numpy).
        """
        if return_depths is None:
            return_depths = target_depths
        targets = np.asarray(targets)
        if targets.ndim != 3:
            raise ValueError("Expected 3D stack of 2D images.")
        image_count, h, w = targets.shape
        if image_count != len(target_depths):
            raise ValueError("There should be the same number of images as target_depths.")

        if cameraslm.cam.pitch_um is None:
            raise ValueError("Camera pitch_um is necessary to calculate defocus blur.")

        device = resolve_device(device)
        images = torch.as_tensor(targets, dtype=torch.float64, device=device)
        canvas = torch.zeros((len(return_depths), h, w), dtype=torch.float64, device=device)
        f_eff = np.sqrt(np.abs(np.linalg.det(cameraslm.calibrations["fourier"]["M"])))
        w0_kxy = cameraslm.slm.get_spot_radius_kxy()
        w0_pix = f_eff * w0_kxy
        w0_um = w0_pix * np.mean(cameraslm.cam.pitch_um)
        zr = np.pi * w0_um * w0_um / cameraslm.slm.wav_um

        for j, z2 in enumerate(return_depths):
            for i, z1 in enumerate(target_depths):
                dz = (z1 - z2) * (f_eff * f_eff)
                blur = w0_pix * (np.sqrt(1 + (dz / zr) ** 2) - (1 if sharp_focus else 0))
                blur = 2 * int(blur) + 1
                canvas[j] += gaussian_blur(images[i], blur)

        return canvas.cpu().numpy()

    # ------------------------------------------------------------------
    # Meta plumbing (slmsuite_tpu _multiplane.py:146-186).
    # ------------------------------------------------------------------

    def _update_flags(self, method, verbose, feedback, stat_groups, **kwargs):
        super()._update_flags(method, verbose, feedback, stat_groups, **kwargs)
        for h in self.holograms:
            h.flags.update(self.flags)

    def reset(self, reset_phase=True, reset_flags=False):
        super().reset(reset_phase, reset_flags)
        if hasattr(self, "holograms"):
            for h in self.holograms:
                h.reset(reset_phase=False, reset_flags=reset_flags)

    def reset_weights(self):
        if hasattr(self, "holograms"):
            for h in self.holograms:
                h.reset_weights()

    def set_target(self, *args, **kwargs):
        raise RuntimeError(
            "Do not use MultiplaneHologram.set_target(). "
            "Update the targets of the child holograms directly."
        )

    def _update_stats(self, stat_groups=[]):
        for h in self.holograms:
            h._update_stats(stat_groups)

    def plot_farfield(self, *args, **kwargs):
        for h in self.holograms:
            h.plot_farfield(*args, **kwargs)

    def plot_stats(self, *args, **kwargs):
        for h in self.holograms:
            h.plot_stats(*args, **kwargs)

    def remove_vortices(self):
        for h in self.holograms:
            h.remove_vortices()

    # ------------------------------------------------------------------
    # Optimization.
    # ------------------------------------------------------------------

    def _mesh_eligible(self, callback, n_dev=None, warn=True):
        """Whether the batched engine covers this problem (``slmsuite_tpu``'s
        gate): no callback, plain-Hologram children sharing one farfield
        shape (MRAF masks included: they are plane-local), computational
        feedback, computational stats only, no ``zero_factor`` (its evolving
        zero-region weights are host meta loop state), and a plane count
        that divides by ``n_dev`` (the mesh's size by default, 1 without a
        mesh). Where it does not, it warns when ``warn``."""
        children = self.holograms
        reasons = []
        if callback is not None:
            reasons.append("callback requires the host meta loop")
        if any(type(h) is not Hologram for h in children):
            reasons.append("children must be plain Hologram instances")
        if self.flags.get("feedback", "computational") != "computational":
            reasons.append("only computational feedback is data-parallel")
        if len({tuple(h.shape) for h in children}) != 1:
            reasons.append("children must share one farfield shape")
        if any(bool(h.flags.get("zero_factor", 0)) for h in children) or bool(
            self.flags.get("zero_factor", 0)
        ):
            reasons.append(
                "zero_factor (evolving zero-region weights) carries extra "
                "complex state; host meta loop only"
            )
        if set(self.flags.get("stat_groups", [])) - {"computational"}:
            reasons.append("only 'computational' stats are device-side here")
        if n_dev is None:
            n_dev = 1 if self._mesh is None else self._mesh.size
        if len(children) % n_dev:
            reasons.append(f"plane count {len(children)} must divide the mesh ({n_dev})")
        if reasons:
            if warn:
                warnings.warn(
                    "mesh-sharded multiplane optimization unavailable ("
                    + "; ".join(reasons) + "); running the host meta loop."
                )
            return False
        return True

    def _batched_inputs(self):
        """The inputs of the batched run from the children's state, on the
        device: ``(config, psi, weights, consts, phase_ff, fixed)`` for
        :meth:`slmsuite_torch.parallel.multiplane.run_batched_gs`, resumed
        as the single-plane engine resumes (the Kim flags from the
        children's flags, the phase store from their ``_phase_ff_folded``,
        None on a fresh run)."""
        from slmsuite_torch.parallel.multiplane import BatchedGSConfig, make_multiplane_consts

        children = self.holograms
        device = self.device
        slm_shape = tuple(self.slm_shape)
        # Raw targets keep their nan noise regions: make_multiplane_consts
        # derives per-plane MRAF region codes from them.
        targets = np.stack([np.asarray(h.target, np.float32) for h in children])
        mraf = bool(np.any(np.isnan(targets)))
        kernels = np.stack([
            np.zeros(slm_shape, np.float32) if h.propagation_kernel is None
            else np.asarray(h.propagation_kernel, np.float32)
            for h in children
        ])
        config = BatchedGSConfig(
            method=self.flags["method"],
            shape=tuple(children[0].shape),
            slm_shape=slm_shape,
            n_planes=len(children),
            # Kernel-free batches skip the kernel add and the backward's
            # phasor multiply.
            has_kernel=any(h.propagation_kernel is not None for h in children),
            stats=bool(self.flags.get("stat_groups", [])),
            kim_efficiency_trigger=(
                "Kim" in self.flags["method"]
                and self.flags.get("fix_phase_efficiency") is not None
            ),
            mraf=mraf,
            mraf_factor=mraf and self.flags.get("mraf_factor") is not None,
        )
        consts = make_multiplane_consts(
            targets, kernels, np.asarray(self.weights, np.float32), self.amp,
            feedback_exponent=self.flags.get("feedback_exponent", 0.8),
            feedback_factor=self.flags.get("feedback_factor", 0.1),
            fix_phase_iteration=self.flags.get("fix_phase_iteration", 10),
            fix_phase_efficiency=self.flags.get("fix_phase_efficiency"),
            mraf_factor=self.flags.get("mraf_factor"),
            device=device,
        )
        weights = torch.stack([
            torch.nan_to_num(type(h).weights.device(h, device)) for h in children
        ])
        phase_ff = (
            torch.stack([type(h)._phase_ff_folded.device(h, device) for h in children])
            if all(type(h)._phase_ff_folded.is_set(h) for h in children) else None
        )
        fixed = torch.tensor([bool(h.flags.get("fixed_phase", False)) for h in children],
                             device=device)
        psi = type(self)._psi.device(self, device)
        return config, psi, weights, consts, phase_ff, fixed

    def _optimize_gs_batched(self, maxiter, verbose, name, mesh=None):
        """The batched multiplane run (``slmsuite_tpu``'s
        ``_optimize_gs_mesh``): the whole run is one device loop
        (:meth:`slmsuite_torch.parallel.multiplane.run_batched_gs`), its
        planes cut over the first axis of ``mesh`` where one is given, from
        :meth:`_batched_inputs`, with the state and stats scattered back
        into the children once at the end."""
        from slmsuite_torch.parallel.multiplane import run_batched_gs

        children = self.holograms
        start_iter = self.iter
        config, psi, weights0, consts, phase_ff0, fixed0 = self._batched_inputs()
        progress = self._progress(maxiter, verbose, name)
        psi, weights, stats, phase_ff, fixed = run_batched_gs(
            config, psi, weights0, consts, maxiter,
            mesh=mesh, axis_name=None if mesh is None else mesh.axis_names[0],
            start_iteration=start_iter, phase_ff=phase_ff0, fixed=fixed0,
        )
        if progress is not None:
            progress.update(maxiter)
            progress.close()

        # Scatter the state back into the children: planes stay on the
        # device, the flags and the stats cross to the host once.
        self._psi = psi
        stats = stats.cpu().numpy()  # (n, B, 5): 4 metrics + Kim flag history.
        fixed = fixed.cpu().numpy()
        for b, h in enumerate(children):
            h._psi = psi
            h.weights = weights[b]
            h._phase_ff_folded = phase_ff[b]
            h.flags["fixed_phase"] = bool(fixed[b])
            h.iter = start_iter + maxiter
            if config.stats and h.flags.get("stat_groups"):
                # The history column records the pre-iteration flag, so
                # this lags a flip in the very last iteration.
                h._final_fixed_phase = bool(stats[-1, b, 4]) if maxiter else False
                n_groups = len(h.flags["stat_groups"])
                arr = np.full((maxiter, n_groups + 1, 4), np.nan, np.float32)
                for g, group in enumerate(h.flags["stat_groups"]):
                    if group == "computational":
                        arr[:, g, :] = stats[:, b, :4]
                arr[:, -1, 0] = stats[:, b, 0]
                arr[:, -1, 1] = stats[:, b, 4]
                h._record_scan_stats(arr, start_iter)
        self.iter = start_iter + maxiter
        self._populate_results()

    def optimize_gs(self, maxiter, callback, verbose=True, name=None):
        """
        Multiplane GS. A homogeneous, computational, callback-free problem
        runs the batched engine (:meth:`_optimize_gs_batched`), over the
        mesh where ``optimize(mesh=...)`` gave one; anything else the host
        meta loop (with a warning under a mesh): per iteration, every child
        runs its forward, stats, weight update and constraint on the device,
        and the plane-weighted complex windows combine into the shared phase.
        """
        if isinstance(maxiter, range):
            maxiter = len(maxiter)

        if self._mesh is not None and self._mesh_eligible(callback):
            return self._optimize_gs_batched(maxiter, verbose, name, mesh=self._mesh)
        if self._mesh is None and self._mesh_eligible(callback, n_dev=1, warn=False):
            return self._optimize_gs_batched(maxiter, verbose, name)

        children = self.holograms
        device = self.device
        configs = [h._build_config() for h in children]
        consts = [h._build_consts(c) for h, c in zip(children, configs)]
        backwards = [_child_backward(c) for c in configs]
        amp = self._amp_device()
        progress = self._progress(maxiter, verbose, name)

        for _ in range(maxiter):
            windows = []
            psi = type(self)._psi.device(self, device)
            for b, (h, config, c) in enumerate(zip(children, configs, consts)):
                # Forward with the child's kernel, from the shared phase.
                h._psi = psi
                kernel = c["kernel"] if config.has_kernel else None
                farfield, amp_ff, theta = _prop.forward_fields(psi, amp, config.shape, kernel)
                h._farfield_folded = farfield
                h.amp_ff = amp_ff
                h._midloop_cleaning()
                h.iter = self.iter

                # Stats, weights and the Kim decision, per child.
                h._update_stats(h.flags.get("stat_groups", []))
                was_not_fixed = not h.flags.get("fixed_phase", False)
                if "WGS" in h.flags["method"] and h.iter > 0:
                    h._update_weights()
                    h._kim_decision_host()
                if was_not_fixed or not type(h)._phase_ff_folded.is_set(h):
                    h._phase_ff_folded = theta

                windows.append(backwards[b](
                    farfield,
                    torch.nan_to_num(type(h).weights.device(h, device)),
                    type(h)._phase_ff_folded.device(h, device),
                    float(np.float32(self.weights[b])),
                    c,
                ))

            self._psi = _combine_windows(windows)
            stop = callback is not None and bool(callback(self))
            self.iter += 1
            if progress is not None:
                progress.update(1)
            if stop:
                break

        if progress is not None:
            progress.close()
        self._populate_results()

    def _cg_objective(self):
        """``(psi, loss_from_psi)`` of gradient phase retrieval on the shared
        phase (``slmsuite_tpu``'s ``optimize_cg``): the loss is the
        plane-weighted sum of each child's loss (the ``"loss"`` flag, or the
        default of :meth:`Hologram.optimize_cg`), each child's farfield
        through its own shape, propagation kernel and
        :class:`slmsuite_torch.ops.grad.Fft2`, against its target with nan
        counted as 0; one gradient through all planes."""
        amp = self._amp_device()
        planes = [
            (tuple(h.shape), h._kernel_device(),
             torch.nan_to_num(h._target_device()), float(np.float32(w)))
            for h, w in zip(self.holograms, self.weights)
        ]
        loss = self.flags.get("loss")
        if loss is None:
            loss = _default_cg_loss

        def loss_from_psi(psi):
            total = 0.0
            for shape, kernel, target, weight in planes:
                farfield = _prop.differentiable_farfield(psi, amp, shape, kernel)
                total = total + weight * loss(farfield, target)
            return total

        return type(self)._psi.device(self, self.device), loss_from_psi

    def optimize_cg(self, iterations, callback):
        """Gradient phase retrieval on the shared phase (:meth:`_cg_objective`).
        No stats are taken in the loop; at the end every child takes the
        shared phase and :attr:`iter`."""
        psi, loss_from_psi = self._cg_objective()

        def on_step(psi):
            if callback is not None:
                self._psi = psi
                if callback(self):
                    return True
            self.iter += 1
            return False

        self._psi = psi = _cg_loop(psi, loss_from_psi, self.flags, iterations, on_step)
        for h in self.holograms:
            h._psi = psi
            h.iter = self.iter
        self._populate_results()
