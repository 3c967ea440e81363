r"""
Batched multiplane GS on one device (PyTorch counterpart of
:mod:`slmsuite_tpu.parallel.multiplane`).

``B`` planes share one nearfield phase; each plane has its own propagation
kernel, farfield target, weights and constraint; the complex nearfields
(with each plane's kernel removed) are weight-summed back into the shared
phase. The planes are a leading dimension of every tensor, and each
transform runs once an iteration for all of them: the forward is
:meth:`slmsuite_torch.ops.fft.fft2_polar_from_phase` on the ``(B, H, W)``
stack of phase canvases against one shared amplitude canvas (kernels
``carry_entry`` and ``cols_fwd_polar``), the backward the complex
:meth:`~slmsuite_torch.ops.fft.wexp_ifft2` (``cols_wexp_inv`` and
``rows_fft``) or, with MRAF region codes, :meth:`~slmsuite_torch.ops.fft.ifft2`
(``cols_fft`` and ``rows_fft``): the planes' complex windows are summed
before the angle is taken, so the phase-only backward does not apply. The
per-plane stats and WGS weights run under :func:`torch.vmap`, so each plane
is reduced on its own.

With ``run_batched_gs(mesh=...)`` the planes are cut over a ``data`` mesh
axis: each shard runs its ``B/D`` planes as one stack through the same
kernels, sums its own plane-weighted windows, and the one collective of
the step adds those sums across the shards in rank order
(:mod:`slmsuite_torch.ops.collectives`) before the angle is taken,
once, and given to every shard.

Not ported, by design:

- ``_batched_can_scramble`` and ``_permute_planes``: the scrambled farfield
  layout is the TPU's four-step FFT; the port runs in natural order.
- The ``lru_cache``'d jit wrappers: the loop is a Python loop over global
  iteration numbers.
"""

import dataclasses

import numpy as np
import torch

from slmsuite_torch import resolve_device
from slmsuite_torch.ops import collectives as C
from slmsuite_torch.ops import fft as _fft
from slmsuite_torch.ops.propagation import pad_window_slices
from slmsuite_torch.ops.stats import calculate_stats
from slmsuite_torch.ops.weights import update_weights_generic


@dataclasses.dataclass(frozen=True)
class BatchedGSConfig:
    """Static configuration of a batched multiplane GS step."""

    method: str
    shape: tuple
    slm_shape: tuple
    n_planes: int
    has_kernel: bool = True
    stats: bool = True
    kim_efficiency_trigger: bool = False
    #: MRAF: per-plane region codes (``consts["mcodes"]``: 1 = signal,
    #: 2 = noise, 0 = zero) select the constraint mix, per plane.
    mraf: bool = False
    mraf_factor: bool = False  # apply the noise-region retention factor

    @property
    def is_wgs(self):
        return self.method.startswith("WGS")

    @property
    def is_kim(self):
        return "Kim" in self.method


def _augment_consts(config, consts):
    """Loop-invariant tensors of the step, made once per run: the shared
    amplitude canvas (the SLM window of a zero (H, W) plane, or the scalar
    or plane amplitude itself when the farfield is the SLM plane) and the
    phasor of each plane's kernel, ``(cos k, sin k)``."""
    consts = dict(consts)
    device = consts["targets"].device
    amp = consts["amp"]
    if tuple(config.shape) == tuple(config.slm_shape):
        canvas = amp
    else:
        y0, y1, x0, x1 = pad_window_slices(config.shape, config.slm_shape)
        canvas = torch.zeros(tuple(config.shape), dtype=torch.float32, device=device)
        canvas[y0:y1, x0:x1] = amp
    consts["_amp_canvas"] = canvas
    if config.has_kernel:
        kernels = consts["kernels"]
        consts["_kernel_phasor"] = (torch.cos(kernels), torch.sin(kernels))
    return consts


def make_batched_gs_step(config: BatchedGSConfig):
    """
    The per-iteration step for ``B`` planes sharing one phase:
    ``step(carry, consts, iteration) -> (carry', stats (B, 5))`` with
    ``carry = (psi, weights (B, H, W), phase_ff (B, H, W), fixed (B,),
    streak (B,))``, ``consts`` from :meth:`make_multiplane_consts` (and
    :meth:`_augment_consts`) and ``iteration`` the global iteration number.
    Per plane, the stats row is ``[efficiency, uniformity, pkpk_err,
    std_err, fixed_phase]``, the last column the Kim flag before the step.

    ``step.local(carry, consts, iteration)`` is the step up to its one
    collective point: it returns the plane-weighted window sum as a pair,
    the rest of the new carry and the stats; the shared psi is the angle of
    the sum over every shard's (:meth:`run_batched_gs` with a mesh).
    """
    y0, y1, x0, x1 = pad_window_slices(config.shape, config.slm_shape)
    full = tuple(config.shape) == tuple(config.slm_shape)
    needs_stats = config.stats or config.kim_efficiency_trigger

    def plane_forward(psi, consts):
        """(|F|, arg F) of every plane, (B, H, W); without kernels the
        planes' farfields are one, computed once."""
        total = psi + consts["kernels"] if config.has_kernel else psi[None]
        if full:
            phase = total.contiguous()
        else:
            phase = torch.zeros((total.shape[0], *config.shape), dtype=torch.float32,
                                device=psi.device)
            phase[:, y0:y1, x0:x1] = total
        amp_ff, theta = _fft.fft2_polar_from_phase(phase, consts["_amp_canvas"])
        if not config.has_kernel:
            shape = (config.n_planes, *config.shape)
            amp_ff, theta = amp_ff.expand(shape), theta.expand(shape)
        return amp_ff, theta

    def plane_stats(amp_ff, target):
        if needs_stats:
            return calculate_stats(amp_ff, target, mask=target != 0,
                                   efficiency_compensation=False)
        return torch.zeros(4, dtype=torch.float32, device=amp_ff.device)

    def plane_weights_update(weights, amp_ff, target, consts):
        return update_weights_generic(
            weights, amp_ff, target, config.method,
            consts["feedback_exponent"], consts["feedback_factor"],
        )

    def constrain(amp_ff, theta, carry, consts, iteration):
        """Stats, WGS weights and Kim fixing of every plane (the
        reference's vmapped ``plane_constrain``)."""
        _, weights, phase_ff, fixed, streak = carry
        targets = consts["targets"]
        fixed_in = fixed  # The flag history records the pre-decision state.
        stats = torch.vmap(plane_stats)(amp_ff, targets)
        if config.is_wgs and iteration > 0:
            weights = torch.vmap(
                lambda w, a, t: plane_weights_update(w, a, t, consts)
            )(weights, amp_ff, targets)
        if config.is_kim:
            was_not_fixed = torch.logical_not(fixed)
            if config.kim_efficiency_trigger:
                fixed = fixed | (stats[:, 0] > consts["fix_phase_efficiency"])
            streak = torch.where(was_not_fixed, streak + 1, streak)
            n_fix = consts["fix_phase_iteration"]
            iter_trigger = was_not_fixed & (iteration >= n_fix - 1) & (streak >= n_fix)
            fixed = (fixed | iter_trigger) if iteration > 0 else torch.zeros_like(fixed)
            phase_ff = torch.where(was_not_fixed[:, None, None], theta, phase_ff)
        else:
            phase_ff = theta
        stats = torch.cat([stats, fixed_in.to(torch.float32)[:, None]], dim=1)
        return weights, phase_ff.contiguous(), fixed, streak, stats

    def backward(amp_ff, theta, weights, phase_ff, consts):
        """The planes' nearfields, (B, H, W) pairs: ``ifft2`` of the
        constraint ``w e^{i phase_ff}`` or, with MRAF, of its region mix."""
        if not config.mraf:
            return _fft.wexp_ifft2(weights, phase_ff)
        mcodes = consts["mcodes"]
        re = torch.where(mcodes == 1, weights * torch.cos(phase_ff), amp_ff * torch.cos(theta))
        im = torch.where(mcodes == 1, weights * torch.sin(phase_ff), amp_ff * torch.sin(theta))
        if config.mraf_factor:
            noise, k = mcodes == 2, consts["mraf_factor"]
            re, im = torch.where(noise, k * re, re), torch.where(noise, k * im, im)
        zero = mcodes == 0
        re, im = torch.where(zero, 0.0, re), torch.where(zero, 0.0, im)
        return _fft.ifft2(re.contiguous(), im.contiguous())

    def window_sum(re, im, consts):
        """The plane-weighted sum of the windows, each with its kernel
        removed, as a pair: its angle is the shared psi."""
        re, im = re[:, y0:y1, x0:x1], im[:, y0:y1, x0:x1]
        if config.has_kernel:
            c, s = consts["_kernel_phasor"]
            re, im = re * c + im * s, im * c - re * s
        pw = consts["plane_weights"][:, None, None]
        return (pw * re).sum(dim=0), (pw * im).sum(dim=0)

    def local(carry, consts, iteration):
        amp_ff, theta = plane_forward(carry[0], consts)
        weights, phase_ff, fixed, streak, stats = constrain(
            amp_ff, theta, carry, consts, iteration
        )
        re, im = backward(amp_ff, theta, weights, phase_ff, consts)
        return window_sum(re, im, consts), (weights, phase_ff, fixed, streak), stats

    def step(carry, consts, iteration):
        (re, im), rest, stats = local(carry, consts, iteration)
        return (torch.atan2(im, re), *rest), stats

    step.local = local
    return step


def _scan_planes(config, n_iterations, psi, weights, phase_ff, fixed, streak, start, consts,
                 devices):
    """Run the step from the RESUMABLE Kim state over global iteration
    numbers ``start + [0, n)``, so a second call continues the trajectory
    of the first (the WGS warm-up is not re-run and a fixed Kim phase stays
    fixed), with the planes cut over ``devices`` (one device: no cut): each
    shard runs :meth:`make_batched_gs_step`'s local stage on its planes, the
    window sums add across the shards in rank order, and the angle of the
    total, taken once, is every shard's psi. Returns ``(psi, weights,
    phase_ff, fixed, stats (n, B, 5))``, gathered on the device of
    ``consts``."""
    home = consts["targets"].device
    D = len(devices)
    B = weights.shape[0]
    step = make_batched_gs_step(dataclasses.replace(config, n_planes=B // D))

    def cut(x):
        return C.split(x, devices)

    plane_keys = ("kernels", "targets", "mcodes", "plane_weights")
    shards = [{} for _ in devices]
    for key, value in consts.items():
        parts = (cut(value) if key in plane_keys
                 else C.broadcast(value, devices) if torch.is_tensor(value) else [value] * D)
        for sh, part in zip(shards, parts):
            sh[key] = part
    shards = [_augment_consts(config, sh) for sh in shards]
    carries = list(zip(C.broadcast(psi, devices), cut(weights), cut(phase_ff), cut(fixed),
                       cut(streak)))
    rows = [[] for _ in devices]
    for i in range(int(n_iterations)):
        sums_re, sums_im, rests = [], [], []
        for d, (carry, sh) in enumerate(zip(carries, shards)):
            with C.on_device(devices[d]):
                (re, im), rest, stats = step.local(carry, sh, start + i)
            sums_re.append(re)
            sums_im.append(im)
            rests.append(rest)
            rows[d].append(stats)
        psi = torch.atan2(C.reduce_sum(sums_im), C.reduce_sum(sums_re))
        carries = [(p, *rest) for p, rest in zip(C.broadcast(psi, devices), rests)]
    n = int(n_iterations)
    stats = (C.gather([torch.stack(r) for r in rows], home, axis=1) if n
             else torch.zeros((0, B, 5), dtype=torch.float32, device=home))
    _, weights, phase_ff, fixed, _ = zip(*carries)
    return (carries[0][0].to(home), C.gather(weights, home), C.gather(phase_ff, home),
            C.gather(fixed, home), stats)


def run_batched_gs(config, psi, weights, consts, n_iterations, mesh=None,
                   axis_name="data", start_iteration=0, phase_ff=None, fixed=None):
    """
    Run ``n_iterations`` of the batched multiplane loop on the device of
    ``consts`` (:meth:`make_multiplane_consts`).

    ``start_iteration``/``phase_ff``/``fixed`` RESUME a previous run: global
    iteration numbers continue, so the WGS warm-up is not silently re-run
    and a fixed Kim phase stays fixed. Defaults start a fresh run.
    ``psi`` and ``weights`` may be numpy or tensors. With a ``mesh``
    (:class:`slmsuite_torch.parallel.mesh.Mesh`), the planes are cut over
    its ``axis_name`` (:meth:`_scan_planes`); the plane count must
    divide by the axis size. The results are gathered on the device of
    ``consts``.

    Returns ``(psi, weights, stats (n, B, 5), phase_ff, fixed)``: per plane
    ``[efficiency, uniformity, pkpk_err, std_err, fixed_phase]`` (the last
    column the Kim flag history; zeros for non-Kim methods), and the final
    per-plane farfield phase store and Kim flags to resume from.
    """
    device = consts["targets"].device

    def tensor(x, dtype=torch.float32):
        if torch.is_tensor(x):
            return x.to(device=device, dtype=dtype).contiguous()
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    psi, weights = tensor(psi), tensor(weights)
    B = weights.shape[0]
    phase_ff = torch.zeros_like(weights) if phase_ff is None else tensor(phase_ff)
    fixed = (torch.zeros(B, dtype=torch.bool, device=device) if fixed is None
             else tensor(fixed, torch.bool))
    streak = torch.zeros(B, dtype=torch.int32, device=device)
    devices = [device]
    if mesh is not None:
        devices = mesh.axis_devices(axis_name)
        if B % len(devices):
            raise ValueError(
                f"Plane count {B} must divide the mesh axis '{axis_name}' "
                f"({len(devices)} devices)."
            )
    psi, weights, phase_ff, fixed, stats = _scan_planes(
        config, n_iterations, psi, weights, phase_ff, fixed, streak,
        int(start_iteration), consts, devices,
    )
    return psi, weights, stats, phase_ff, fixed


def make_multiplane_consts(targets, kernels, plane_weights, amp,
                           feedback_exponent=0.8, feedback_factor=0.1,
                           fix_phase_iteration=10, fix_phase_efficiency=None,
                           mraf_factor=None, device=None):
    """The consts dict of :meth:`run_batched_gs` from numpy inputs, on
    ``device`` (the package default when None). ``targets`` may carry nan
    noise regions (MRAF): per-plane region codes are derived here and the
    stored targets are cleaned. A scalar ``amp`` stays a Python float."""
    device = resolve_device(device)
    targets = np.asarray(targets, dtype=np.float32)

    def tensor(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    consts = {
        "kernels": tensor(np.asarray(kernels, np.float32)),
        "targets": tensor(np.nan_to_num(targets)),
        "plane_weights": tensor(np.asarray(plane_weights, np.float32)),
        "amp": float(amp) if np.ndim(amp) == 0 else tensor(np.asarray(amp, np.float32)),
        "feedback_exponent": tensor(np.float32(feedback_exponent)),
        "feedback_factor": tensor(np.float32(feedback_factor)),
        "fix_phase_iteration": tensor(np.int32(fix_phase_iteration), torch.int32),
        "fix_phase_efficiency": tensor(
            np.float32(np.nan if fix_phase_efficiency is None else fix_phase_efficiency)
        ),
    }
    if np.any(np.isnan(targets)):
        nan = np.isnan(targets)
        consts["mcodes"] = tensor(
            np.where(nan, 2, np.nan_to_num(targets) > 0).astype(np.uint8), torch.uint8
        )
        consts["mraf_factor"] = tensor(np.float32(1.0 if mraf_factor is None else mraf_factor))
    return consts
