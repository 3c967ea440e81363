r"""
The Gerchberg-Saxton engine (PyTorch counterpart of
:mod:`slmsuite_tpu.ops.engine`).

The JAX package's ``lax.scan`` becomes a Python loop over one of three
steps:

- the fully-fused carry-mode WGS step (:meth:`_make_fused_step`, gate
  :meth:`_fused_active`), whose two kernels per iteration are
  :meth:`slmsuite_torch.ops.fft.wgs_carry_step`;
- the carry-mode MRAF step (:meth:`_make_mraf_fused_step`, gate
  :meth:`_mraf_fused_active`: Leonardo and Kim with an MRAF target),
  whose three kernels per iteration are
  :meth:`slmsuite_torch.ops.fft.mraf_carry_step`;
- the natural step (:meth:`_make_natural_step`) for every other
  configuration: GS and all five WGS rules, ``computational``,
  ``computational_spot``, ``experimental_spot_sim``, ``external`` and
  ``external_spot`` feedback and stats, padded farfields (``shape != slm_shape``), propagation kernels
  and MRAF. Its transforms
  are :meth:`slmsuite_torch.ops.fft.fft2_polar_from_phase` and
  :meth:`~slmsuite_torch.ops.fft.wexp_ifft2_phase` (MRAF:
  :meth:`~slmsuite_torch.ops.fft.ifft2_phase`) when the farfield is the
  SLM plane, else :meth:`~slmsuite_torch.ops.fft.fft2_polar` and
  :meth:`~slmsuite_torch.ops.fft.wexp_ifft2` (MRAF:
  :meth:`~slmsuite_torch.ops.fft.ifft2`) on the canvas.

All loop state stays on the device (including ``fixed_phase``,
``unfixed_streak``, ``iteration`` and ``w_norm``); no ``.item()`` or
Python branch on a tensor value runs inside the loop, and the stats rows
are stacked once per run.

:meth:`run_gs_batch` runs K independent holograms (``optimize_batch``),
each through :meth:`run_gs` on its own loop and kernels, with a mesh K/D on
each of its devices.

``experimental_spot_sim`` closes the camera loop on the device for a
simulated rig: :meth:`sim_measure_spots` forms the quantized display, the
farfield on the camera's canvas, the camera frame and the spot-window sums
from psi inside the step, with no host hop. ``external`` and
``external_spot`` feedback leave the weights to the host (the stepwise host
loop of the hologram classes updates them between iterations), and a stat
group the device does not compute gives a row of nan, as in the JAX
package.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from slmsuite_torch import resolve_device
from slmsuite_torch.ops import fft as _fft
from slmsuite_torch.ops import propagation as _prop
from slmsuite_torch.ops.collectives import on_device
from slmsuite_torch.ops.stats import calculate_stats, std_from_moments
from slmsuite_torch.ops.weights import update_weights_generic


class GSState(NamedTuple):
    """Everything that evolves across GS iterations (device tensors).

    Inside the fused loops ``psi`` holds the carry pair ``(gr, gi)`` and,
    for Kim, ``phase_ff`` the unit-phasor pair; outside them they are
    (H, W) planes.
    """

    psi: object                 # (Hs, Ws) folded nearfield phase
    weights: torch.Tensor       # (H, W) farfield weight amplitudes
    phase_ff: object            # (H, W) stored farfield phase (Kim)
    zero_weights: torch.Tensor  # (2, H, W) re/im (zero_factor) or (2, 0, 0)
    fixed_phase: torch.Tensor   # bool scalar
    unfixed_streak: torch.Tensor  # int32: consecutive unfixed iterations
    iteration: torch.Tensor     # int32: global iteration counter
    #: f32 scalar: the weights' norm under the fused loop's deferred-by-one
    #: normalization (weights are renormalized once on exit).
    w_norm: torch.Tensor = None


@dataclasses.dataclass(frozen=True)
class GSConfig:
    """Static configuration of the engine."""

    method: str
    shape: tuple
    slm_shape: tuple
    #: ``computational`` and ``computational_spot`` update the weights on
    #: the device from the computed farfield; ``experimental_spot_sim``
    #: closes the simulated rig's camera loop on the device
    #: (:meth:`sim_measure_spots`); ``external`` and ``external_spot`` leave
    #: the weights to the host between stepwise calls.
    feedback: str = "computational"
    stat_groups: tuple = ()
    mraf: bool = False
    mraf_factor: bool = False        # apply the noise-region factor
    zero_factor: bool = False        # evolving zero-region weights
    has_kernel: bool = False
    kim_efficiency_trigger: bool = False
    spot_single_px: bool = False     # stats skip integration (shape == slm_shape)
    # The simulated rig's closed loop (feedback "experimental_spot_sim" or
    # stat group "experimental_spot"): statics of :meth:`sim_measure_spots`.
    sim_bitres: float = 0.0          # SLM gray levels (a power of two)
    sim_cam_sat: float = 0.0         # camera saturation level (counts)
    sim_truncates: bool = False      # the camera's dtype is integer (floor counts)
    sim_shape_padded: tuple = ()     # the camera's FFT canvas shape

    @property
    def is_wgs(self):
        return self.method.startswith("WGS")

    @property
    def is_kim(self):
        return "Kim" in self.method


# The step fills the scalar buffer's lanes 1-3 from device state.
assert _fft.SCALAR_KEYS[1:4] == ("inv_prev_norm", "apply_update", "use_theta")

#: WGS rules whose weight correction is elementwise once the Parseval
#: feedback norm is substituted (Nogrette needs a plane mean).
_FUSABLE_METHODS = ("WGS-Leonardo", "WGS-Kim", "WGS-Wu", "WGS-tanh")


def _fused_common(config: GSConfig):
    """The gate shared by the two carry-mode steps: farfield == SLM shape,
    no propagation kernel, a fusable rule with plain computational
    feedback, no spot integration, and computational stats only (Kim's
    efficiency trigger needs them)."""
    needs_spot = (
        config.feedback == "computational_spot"
        or "computational_spot" in config.stat_groups
    )
    return (
        tuple(config.shape) == tuple(config.slm_shape)
        and not config.has_kernel
        and config.is_wgs
        and config.feedback == "computational"
        and not needs_spot
        and config.method in _FUSABLE_METHODS
        and (not config.kim_efficiency_trigger or bool(config.stat_groups))
        and all(g == "computational" for g in config.stat_groups)
    )


def _fused_active(config: GSConfig):
    """True when the fully-fused carry-mode WGS step applies: the shared
    gate, without MRAF masks."""
    return _fused_common(config) and not config.mraf


def _mraf_fused_active(config: GSConfig):
    """True when the carry-mode MRAF step applies: the shared gate WITH
    MRAF masks, for Leonardo and Kim only. Their correction factor is
    exactly 1 on the cleaned (noise -> 0) target, as on the natural
    step's NaN guard; Wu and tanh spread the NaN target into 1e-4 noise
    weights, whose share of the norm the kernels would not reproduce."""
    return (
        _fused_common(config)
        and config.mraf
        and config.method in ("WGS-Leonardo", "WGS-Kim")
    )


def _carry_active(config: GSConfig):
    """Whether either carry-mode step runs ``config``."""
    return _fused_active(config) or _mraf_fused_active(config)


#: Feedback modes whose weights the device updates, and those whose
#: weights the host updates.
_DEVICE_FEEDBACK = ("computational", "computational_spot", "experimental_spot_sim")
_HOST_FEEDBACK = ("external", "external_spot")


def _needs_sim_measure(config: GSConfig):
    """Whether the step measures with the simulated camera."""
    return (
        config.feedback == "experimental_spot_sim"
        or "experimental_spot" in config.stat_groups
    )


def _config_error(config: GSConfig):
    """The ValueError for a configuration the engine cannot run (an unknown
    feedback mode, or the simulated camera without its statics), or None."""
    if config.feedback not in _DEVICE_FEEDBACK + _HOST_FEEDBACK:
        return ValueError(
            f"Unknown engine feedback '{config.feedback}'; the engine takes "
            f"{_DEVICE_FEEDBACK + _HOST_FEEDBACK}."
        )
    if _needs_sim_measure(config) and not config.sim_shape_padded:
        return ValueError(
            "The simulated camera's statics (sim_bitres, sim_cam_sat, "
            "sim_truncates, sim_shape_padded) are missing from the config."
        )
    return None


def sim_measure_spots(psi, consts, *, bitres, cam_sat, truncates, shape_padded):
    """
    The simulated rig's measurement on the device: the quantized display
    (``SLM._phase2gray`` for ``phase_scaling == 1`` and a power-of-two bit
    depth), the farfield on the camera's padded canvas, nearest-pixel
    camera sampling, exposure, saturation, integer truncation and the
    spot-window sums. The host twin is ``slm.set_phase`` ->
    ``cam.get_image`` -> ``analysis.take(..., integrate=True)``.

    ``consts`` keys (device tensors that do not change in the loop):

    - ``sim_pre``: SLM-shaped phase added before quantization (minus the
      hologram's fold, plus the propagation kernel and the hardware
      correction phase).
    - ``sim_post``: SLM-shaped phase added after it (the simulated
      aberration plus the camera canvas's fold).
    - ``sim_amp``: SLM-shaped simulated source amplitude.
    - ``sim_flat_cam`` / ``sim_valid_cam``: the camera pixels' int64 gather
      map into the flattened canvas power, and their validity weights.
    - ``sim_spot_flat``: (N, D*D) int64 gather of the spot windows into
      the flattened camera frame.
    - ``sim_scale``: exposure_s * gain (0-d tensor).

    Returns ``(spot_powers (N,), total_power ())`` in camera counts. The
    canvas transform is :meth:`slmsuite_torch.ops.fft.fft2`.
    """
    two_pi = 2.0 * np.pi
    phase = psi + consts["sim_pre"]
    # display = (rint(-phase * s) - 1) mod 2^b; the modulus takes the
    # divisor's sign, so a negative level wraps upward.
    q = torch.round(phase * float(np.float32(-bitres / two_pi))) - 1.0
    disp = torch.remainder(q, float(bitres))
    # A global phase offset drops out of |F|.
    phase_cam = -disp * float(np.float32(two_pi / bitres)) + consts["sim_post"]
    fr, fi = _prop.nearfield_to_farfield(*_prop.build_folded_nearfield(
        phase_cam, consts["sim_amp"], tuple(shape_padded)
    ))
    pwr = (torch.square(fr) + torch.square(fi)).reshape(-1)
    img = pwr[consts["sim_flat_cam"]] * consts["sim_valid_cam"] * consts["sim_scale"]
    img = torch.clamp(img, max=float(cam_sat))
    if truncates:
        # The host camera casts counts to its integer dtype (non-negative
        # values: floor == trunc).
        img = torch.floor(img)
    return img[consts["sim_spot_flat"]].sum(dim=-1), img.sum()


def _augment_fused_consts(config: GSConfig, consts):
    """Loop-invariant scalars of the carry-mode steps, computed once per
    run. MRAF adds the region code plane (1 signal, 2 noise, 0 zero),
    its factor ``_mraf_k`` and the cleaned target (noise -> 0), which the
    kernels read and ``_inv_tsum`` is computed from."""
    consts = dict(consts)
    if config.mraf:
        consts["_mraf_code"] = (
            consts["signal_mask"].to(torch.float32)
            + 2.0 * consts["noise_mask"].to(torch.float32)
        )
        consts["_mraf_k"] = consts["mraf_factor"] if config.mraf_factor else 1.0
        consts["target"] = torch.nan_to_num(consts["target"])
    amp = consts["amp"]
    device = consts["target"].device
    H, W = config.shape
    if _fft.is_scalar_amp(amp):
        amp_t = torch.as_tensor(amp, dtype=torch.float32, device=device)
        # Parseval: sum |F|^2 == sum amp^2 exactly for the ortho pair.
        fsum = torch.square(amp_t) * (H * W)
        post = amp_t / np.sqrt(H * W)
    else:
        fsum = torch.square(amp).sum()
        post = torch.tensor(1.0 / np.sqrt(H * W), dtype=torch.float32, device=device)
    consts["_zero"] = torch.zeros((), dtype=torch.float32, device=device)
    consts["_nan"] = torch.full((), float("nan"), dtype=torch.float32, device=device)
    consts["_inv_fsum"] = 1.0 / fsum
    consts["_inv_fnorm"] = 1.0 / torch.sqrt(fsum)
    if config.stat_groups:
        mask_f = consts["stat_mask"].to(torch.float32)
        consts["_stat_mask_f32"] = mask_f
        consts["_stat_count"] = mask_f.sum()
        consts["_inv_tsum"] = 1.0 / torch.square(consts["target"]).sum()
    else:
        consts["_inv_tsum"] = torch.ones((), dtype=torch.float32, device=device)
    # The step's scalar buffer with its loop-invariant lanes filled; the
    # step writes lanes 1-3 (inv_prev_norm, apply_update, use_theta).
    consts["_scal"] = _fft.pack_scalars({
        "post": post,
        "inv_prev_norm": 1.0,
        "apply_update": 0.0,
        "use_theta": 0.0,
        "feedback_exponent": consts["feedback_exponent"],
        "feedback_factor": consts["feedback_factor"],
        "inv_fnorm": consts["_inv_fnorm"],
        "inv_tsum": consts["_inv_tsum"],
        "inv_fsum": consts["_inv_fsum"],
        "mraf_factor": consts.get("_mraf_k", 0.0),
        "zero_factor": consts.get("zero_factor", 0.0),
    }, device)
    return consts


def _carry_scalars(state, consts):
    """The step's scalar buffer: the loop-invariant lanes of
    ``consts["_scal"]`` with lanes 1-3 from the device state."""
    flags = torch.stack([state.iteration > 0, torch.logical_not(state.fixed_phase)])
    base = consts["_scal"]
    return torch.cat([base[:1], (1.0 / state.w_norm)[None], flags.to(torch.float32),
                      base[4:]])


def _carry_finish(config, state, consts, carry, weights, pff_out, zero_weights,
                  sums, maxs):
    """What follows the kernels of a carry-mode step: the deferred norm,
    the stats row from the kernels' sums, Kim's phase fixing, and the new
    state. Returns ``(state, stats rows)``."""
    was_not_fixed = torch.logical_not(state.fixed_phase)
    apply_update = state.iteration > 0
    w_norm = torch.where(
        apply_update, torch.sqrt(sums[3]).to(torch.float32), state.w_norm
    )

    if config.stat_groups:
        # sums are float64; efficiency, uniformity and pkpk_err keep
        # their f32 definitions, std_err is formed in float64.
        count = consts["_stat_count"]
        overlap = sums[0].to(torch.float32)
        efficiency = torch.square(overlap) * consts["_inv_tsum"] * consts["_inv_fsum"]
        u_max, u_min = maxs[1], -maxs[3]
        uniformity = 1 - (u_max - u_min) / (u_max + u_min)
        pkpk_err = count * (maxs[0] + maxs[2])
        std_err = std_from_moments(sums[1], sums[2], count)
        stats_rows = [torch.stack([efficiency, uniformity, pkpk_err, std_err])]
    else:
        efficiency = consts["_nan"]
        stats_rows = []

    # Kim phase fixing. The efficiency trigger compares the CURRENT
    # (pre-constraint) efficiency; the in-kernel phase select always
    # uses the PREVIOUS flag, as on the standard path.
    if config.is_kim:
        fixed = state.fixed_phase
        if config.kim_efficiency_trigger:
            fixed = fixed | (efficiency > consts["fix_phase_efficiency"])
        streak = torch.where(
            was_not_fixed, state.unfixed_streak + 1, state.unfixed_streak
        )
        iter_trigger = (
            was_not_fixed
            & (state.iteration >= consts["fix_phase_iteration"] - 1)
            & (streak >= consts["fix_phase_iteration"])
        )
        fixed = (fixed | iter_trigger) & (state.iteration > 0)
        phase_ff = pff_out
    else:
        fixed = torch.zeros_like(state.fixed_phase)
        streak = state.unfixed_streak
        phase_ff = state.phase_ff

    new_state = GSState(
        psi=carry,
        weights=weights,
        phase_ff=phase_ff,
        zero_weights=zero_weights,
        fixed_phase=fixed,
        unfixed_streak=streak,
        iteration=state.iteration + 1,
        w_norm=w_norm,
    )
    zero = consts["_zero"]
    internal = torch.stack(
        [efficiency, state.fixed_phase.to(torch.float32), zero, zero]
    )
    return new_state, torch.stack(stats_rows + [internal])


def _make_fused_step(config: GSConfig):
    """The fully-fused WGS step in CARRY mode: ``state.psi`` holds the
    rows-transformed field pair (converted at the loop boundaries by
    :meth:`_run_fused`); each iteration is the two kernels of
    :meth:`slmsuite_torch.ops.fft.wgs_carry_step`."""
    stats_on = bool(config.stat_groups)
    rule = config.method[4:].lower()

    def step(state, consts):
        gr, gi, weights, pff_out, sums, maxs = _fft.wgs_carry_step(
            *state.psi,
            consts["amp"],
            state.weights,
            state.phase_ff if config.is_kim else None,
            consts["target"],
            consts.get("_stat_mask_f32"),
            _carry_scalars(state, consts),
            rule=rule,
            kim=config.is_kim,
            stats_on=stats_on,
        )
        return _carry_finish(config, state, consts, (gr, gi), weights, pff_out,
                             state.zero_weights, sums, maxs)

    return step


def _make_mraf_fused_step(config: GSConfig):
    """The MRAF step in CARRY mode: the three kernels of
    :meth:`slmsuite_torch.ops.fft.mraf_carry_step`, whose norm sync reads
    the device sums (no host round trip). Like the fused WGS step, the
    weights are carried unnormalized with their norm in ``w_norm``
    (finalized on exit); ``zero_factor`` updates ride in the carried
    ``zero_weights`` pair."""
    stats_on = bool(config.stat_groups)
    rule = config.method[4:].lower()

    def step(state, consts):
        gr, gi, uw, pff_out, zw_out, sums, maxs = _fft.mraf_carry_step(
            *state.psi,
            consts["amp"],
            state.weights,
            state.phase_ff if config.is_kim else None,
            consts["target"],
            consts.get("_stat_mask_f32"),
            consts["_mraf_code"],
            state.zero_weights if config.zero_factor else None,
            _carry_scalars(state, consts),
            rule=rule,
            kim=config.is_kim,
            stats_on=stats_on,
            zero=config.zero_factor,
        )
        zero_weights = zw_out if config.zero_factor else state.zero_weights
        return _carry_finish(config, state, consts, (gr, gi), uw, pff_out,
                             zero_weights, sums, maxs)

    return step


def _spot_feedback_amp(amp_ff_sq, consts):
    """Integrated power around each spot -> feedback amplitudes (N,).
    ``consts["spot_flat_idx"]`` is the (N, D*D) gather map into the
    flattened farfield plane."""
    gathered = amp_ff_sq.reshape(-1)[consts["spot_flat_idx"]]
    return torch.sqrt(gathered.sum(dim=-1))


def _compute_group_stats(group, config, consts, amp_ff, spot_feedback,
                         sim_measured=None):
    """Length-4 stats vector for one stat group: nan for a group the host
    computes."""
    if group == "computational":
        return calculate_stats(
            amp_ff, consts["target"], mask=consts["stat_mask"],
            efficiency_compensation=False,
        )
    if group == "experimental_spot":
        # From the camera measurement inside the step.
        sim_spot_pwr, sim_total = sim_measured
        return calculate_stats(
            torch.sqrt(sim_spot_pwr), consts["spot_amp"], mask=consts["spot_amp"] != 0,
            efficiency_compensation=False, total=sim_total,
        )
    if group != "computational_spot":
        return consts["_nan"].expand(4)
    total = torch.square(amp_ff).sum()
    if config.spot_single_px:
        # One-pixel spots: no integration.
        feedback = amp_ff.reshape(-1)[consts["spot_center_idx"]]
    else:
        feedback = spot_feedback
    return calculate_stats(
        feedback, consts["spot_amp"], mask=consts["spot_amp"] != 0,
        efficiency_compensation=False, total=total,
    )


def _mraf_mix(config, consts, amp_ff, theta, weights, phase_ff, zero_weights):
    """The natural step's MRAF constraint (elementwise PyTorch, as XLA
    code in JAX): ``w e^{i phi}`` in the signal region, the free farfield
    (times ``mraf_factor`` when set) in the noise region, and 0 or the
    updated zero weights ``zw - zf |F| F`` in the zero region. Returns
    the constrained farfield pair and the zero weights."""
    fr, fi = amp_ff * torch.cos(theta), amp_ff * torch.sin(theta)
    signal, noise, zmask = consts["signal_mask"], consts["noise_mask"], consts["zero_mask"]
    re = torch.where(signal, weights * torch.cos(phase_ff), fr)
    im = torch.where(signal, weights * torch.sin(phase_ff), fi)
    if config.mraf_factor:
        k = consts["mraf_factor"]
        re, im = torch.where(noise, k * re, re), torch.where(noise, k * im, im)
    if config.zero_factor:
        step = consts["zero_factor"] * amp_ff
        zero_weights = torch.stack([
            torch.where(zmask, zero_weights[0] - step * fr, zero_weights[0]),
            torch.where(zmask, zero_weights[1] - step * fi, zero_weights[1]),
        ])
        re, im = torch.where(zmask, zero_weights[0], re), torch.where(zmask, zero_weights[1], im)
    else:
        re, im = torch.where(zmask, 0.0, re), torch.where(zmask, 0.0, im)
    return (re, im), zero_weights


def _make_natural_step(config: GSConfig):
    """The natural (non-fused) step: forward transform to (|F|, arg F),
    device stats, the weight update and Kim's decision in PyTorch, the
    constraint ``w e^{i phi}`` (or the MRAF mix) and the backward
    transform to psi."""
    needs_spot = (
        config.feedback == "computational_spot"
        or "computational_spot" in config.stat_groups
    )
    needs_sim = _needs_sim_measure(config)
    # Farfield == SLM plane with no kernel: nearfield == amp e^{i psi}, so
    # the transforms start and end at psi and no canvas exists.
    full_fuse = (
        tuple(config.shape) == tuple(config.slm_shape) and not config.has_kernel
    )

    def step(state, consts):
        kernel = consts["kernel"] if config.has_kernel else None
        if full_fuse:
            amp_ff, theta = _fft.fft2_polar_from_phase(state.psi, consts["amp"])
        else:
            amp_ff, theta = _fft.fft2_polar(*_prop.build_folded_nearfield(
                state.psi, consts["amp"], config.shape, kernel
            ))

        spot_feedback = (
            _spot_feedback_amp(torch.square(amp_ff), consts) if needs_spot else None
        )
        # The camera measures psi, the folded nearfield phase, directly.
        sim_measured = (
            sim_measure_spots(
                state.psi, consts,
                bitres=config.sim_bitres, cam_sat=config.sim_cam_sat,
                truncates=config.sim_truncates, shape_padded=config.sim_shape_padded,
            )
            if needs_sim else None
        )
        stats_rows = [
            _compute_group_stats(g, config, consts, amp_ff, spot_feedback, sim_measured)
            for g in config.stat_groups
        ]

        weights = state.weights
        if config.is_wgs:
            rule_kw = dict(
                method=config.method,
                feedback_exponent=consts["feedback_exponent"],
                feedback_factor=consts["feedback_factor"],
            )
            if config.feedback == "computational":
                updated = update_weights_generic(
                    weights, amp_ff, consts["target"], **rule_kw
                )
            elif config.feedback in _HOST_FEEDBACK:
                updated = weights  # The host updates them between calls.
            else:
                center = consts["spot_center_idx"]
                if config.feedback == "experimental_spot_sim":
                    # The root of the camera's spot-window powers.
                    weight_feedback = torch.sqrt(sim_measured[0])
                else:
                    # Weight feedback integrates around the ROUNDED spot
                    # pixels; the stats use the raw positions.
                    weight_feedback = torch.sqrt(
                        torch.square(amp_ff).reshape(-1)[consts["spot_weight_flat_idx"]]
                        .sum(dim=-1)
                    )
                spot_weights = update_weights_generic(
                    weights.reshape(-1)[center], weight_feedback,
                    consts["spot_amp"], **rule_kw
                )
                updated = torch.zeros_like(weights).reshape(-1)
                updated[center] = spot_weights
                updated = updated.reshape(weights.shape)
            weights = torch.where(state.iteration > 0, updated, weights)

        # Kim phase fixing: the efficiency trigger reads the last stat
        # group's efficiency; fixing applies once weighting starts.
        was_not_fixed = torch.logical_not(state.fixed_phase)
        if config.is_kim:
            fixed = state.fixed_phase
            if config.kim_efficiency_trigger:
                fixed = fixed | (stats_rows[-1][0] > consts["fix_phase_efficiency"])
            streak = torch.where(
                was_not_fixed, state.unfixed_streak + 1, state.unfixed_streak
            )
            iter_trigger = (
                was_not_fixed
                & (state.iteration >= consts["fix_phase_iteration"] - 1)
                & (streak >= consts["fix_phase_iteration"])
            )
            fixed = (fixed | iter_trigger) & (state.iteration > 0)
            # The constraint phase: the current angle while unfixed
            # (including the iteration that fixes), the stored one after.
            phase_ff = torch.where(was_not_fixed, theta, state.phase_ff)
        else:
            fixed = torch.zeros_like(state.fixed_phase)
            streak = state.unfixed_streak
            phase_ff = theta

        zero_weights = state.zero_weights
        if config.mraf:
            new_farfield, zero_weights = _mraf_mix(
                config, consts, amp_ff, theta, weights, phase_ff, zero_weights
            )
            if full_fuse:
                psi = _fft.ifft2_phase(*new_farfield)
            else:
                nearfield = _fft.ifft2(*new_farfield)
                psi = _prop.extract_folded_phase(*nearfield, config.slm_shape, kernel)
        elif full_fuse:
            psi = _fft.wexp_ifft2_phase(weights, phase_ff)
        else:
            nearfield = _fft.wexp_ifft2(weights, phase_ff)
            psi = _prop.extract_folded_phase(*nearfield, config.slm_shape, kernel)

        new_state = state._replace(
            psi=psi,
            weights=weights,
            phase_ff=phase_ff,
            zero_weights=zero_weights,
            fixed_phase=fixed,
            unfixed_streak=streak,
            iteration=state.iteration + 1,
        )
        efficiency = stats_rows[-1][0] if stats_rows else consts["_nan"]
        zero = consts["_zero"]
        internal = torch.stack(
            [efficiency, state.fixed_phase.to(torch.float32), zero, zero]
        )
        return new_state, torch.stack(stats_rows + [internal])

    return step


def make_gs_step(config: GSConfig):
    """The per-iteration step ``step(state, consts) -> (state, stats
    (n_groups + 1, 4))``; the trailing row carries ``[efficiency,
    fixed_phase, 0, 0]``. The carry-mode steps need the constants of
    :meth:`_augment_fused_consts`, the natural step those of
    :meth:`_augment_natural_consts`."""
    err = _config_error(config)
    if err is not None:
        raise err
    if _fused_active(config):
        return _make_fused_step(config)
    if _mraf_fused_active(config):
        return _make_mraf_fused_step(config)
    return _make_natural_step(config)


def _augment_natural_consts(consts):
    """The natural loop's constants: the gather maps as int64 and
    the step's 0-d zero and nan."""
    consts = dict(consts)
    device = consts["target"].device
    for key in ("spot_flat_idx", "spot_weight_flat_idx", "spot_center_idx",
                "sim_flat_cam", "sim_spot_flat"):
        if key in consts:
            consts[key] = consts[key].to(device=device, dtype=torch.int64)
    consts["_zero"] = torch.zeros((), dtype=torch.float32, device=device)
    consts["_nan"] = torch.full((), float("nan"), dtype=torch.float32, device=device)
    return consts


def _stack_stats(config, rows, device):
    n_rows = len(config.stat_groups) + 1
    return torch.stack(rows) if rows else torch.zeros((0, n_rows, 4), device=device)


def _run_natural(config: GSConfig, state: GSState, consts: dict, n_iterations: int):
    """``n_iterations`` natural steps (for any ported configuration, the
    fusable ones included). Returns ``(state, stats (n, n_groups + 1,
    4))``."""
    step = _make_natural_step(config)
    consts = _augment_natural_consts(consts)
    rows = []
    for _ in range(int(n_iterations)):
        state, stats = step(state, consts)
        rows.append(stats)
    return state, _stack_stats(config, rows, state.weights.device)


def _run_fused(config: GSConfig, state: GSState, consts: dict, n_iterations: int):
    """Entry, ``n_iterations`` carry-mode steps (WGS or MRAF), exit.
    Returns ``(state, stats (n, n_groups + 1, 4))`` with the weights still
    unnormalized."""
    step = make_gs_step(config)
    consts = _augment_fused_consts(config, consts)
    # The loop carries the rows-transformed field pair and, for Kim, the
    # phase store as a unit phasor; convert at the boundaries. Entry
    # handles unbounded psi (warm starts).
    state = state._replace(psi=_fft.wgs_carry_entry(state.psi, consts["amp"]))
    if config.is_kim:
        state = state._replace(phase_ff=_fft.wgs_phasor_entry(state.phase_ff))
    rows = []
    for _ in range(int(n_iterations)):
        state, stats = step(state, consts)
        rows.append(stats)
    state = state._replace(psi=_fft.wgs_carry_exit(*state.psi))
    if config.is_kim:
        state = state._replace(phase_ff=_fft.wgs_phasor_exit(*state.phase_ff))
    return state, _stack_stats(config, rows, state.weights.device)


def _carry_runs(config: GSConfig, device):
    """Whether a carry-mode loop runs ``config`` on ``device``: on the CPU,
    where its plain versions stand in for the kernels, and on the card only
    where the kernels take the plane (:meth:`slmsuite_torch.ops.fft.kernel_tier`).
    The card's plain tier runs the natural step, as the JAX package's
    non-kernel tier does."""
    return _carry_active(config) and (
        device.type == "cpu" or _fft.kernel_tier(device.type, config.shape) == "kernels"
    )


def _run(config: GSConfig, state: GSState, consts: dict, n_iterations: int):
    if _carry_runs(config, state.weights.device):
        return _run_fused(config, state, consts, n_iterations)
    return _run_natural(config, state, consts, n_iterations)


def run_gs(config: GSConfig, state: GSState, consts: dict, n_iterations: int):
    """
    Run ``n_iterations`` of GS/WGS on the device, on a carry-mode step
    where :meth:`_fused_active` or :meth:`_mraf_fused_active` allows, else
    on the natural step.

    Returns ``(state, stats)`` with stats of shape ``(n_iterations,
    len(stat_groups) + 1, 4)`` (a device tensor).
    """
    state = _provision_fused(config, state)
    state, stats = _run(config, state, consts, n_iterations)
    return _finalize_fused(config, state), stats


def run_gs_chunked(config, state, consts, n_iterations, chunk=None, on_chunk=None, run=None):
    """
    Like :meth:`run_gs` but split into ``chunk``-sized runs with
    ``on_chunk(n)`` called between them (progress reporting). Fused
    chunks enter and exit the carry, as the JAX package's chunks do; the
    deferred weight norm is finalized once at the end. ``run(config,
    state, consts, n) -> (state, stats)`` runs a chunk in place of the
    engine's own loop (the row-sharded plane's,
    :meth:`slmsuite_torch.parallel.plane.run_sharded_plane_gs`).

    Returns ``(state, [stats_chunk, ...])``.
    """
    n_iterations = int(n_iterations)
    chunk = n_iterations if chunk is None else max(1, int(chunk))
    run = _run if run is None else run
    state = _provision_fused(config, state)
    all_stats = []
    done = 0
    while done < n_iterations:
        n = min(chunk, n_iterations - done)
        state, stats = run(config, state, consts, n)
        all_stats.append(stats)
        done += n
        if on_chunk is not None:
            on_chunk(n)
    return _finalize_fused(config, state), all_stats


def run_gs_scheduled(*args, **kwargs):
    """The TPU's coarse-then-refine FFT precision schedule."""
    raise NotImplementedError(
        "run_gs_scheduled is TPU matrix-unit precision machinery; a reduced "
        "precision mode for the port is opt-in later work (ROADMAP.md "
        "'Semantics, not means')."
    )


def run_gs_batch(config: GSConfig, states: GSState, consts: dict, n_iterations: int,
                 mesh=None, axis_name="data"):
    """
    Run ``n_iterations`` of GS/WGS on a BATCH of K independent holograms
    (no coupling; contrast :mod:`slmsuite_torch.parallel.multiplane`, whose
    planes share one phase). ``states`` and ``consts`` hold the
    per-instance states and constants stacked on a leading K (a scalar
    amplitude as a (K,) tensor). Each instance runs through :meth:`run_gs`,
    on the loop and the kernels its configuration takes (the fused carry
    loop, the MRAF carry loop or the natural step); the amplitudes cross to
    the host once, before the first.

    With ``mesh`` (:class:`slmsuite_torch.parallel.mesh.Mesh`), the K
    instances are cut over its ``axis_name``, K/D on each device in turn,
    with no collective; K must divide by the axis size. The results are
    gathered on the device of ``states``.

    Returns ``(states, stats)``: the final states stacked on K, and the
    stats, ``(K, n_iterations, len(stat_groups) + 1, 4)``.
    """
    K = states.weights.shape[0]
    home = states.weights.device
    devices = [home] * K
    if mesh is not None:
        axis = mesh.axis_devices(axis_name)
        if K % len(axis):
            raise ValueError(
                f"Batch size {K} must divide the mesh "
                f"({len(axis)} devices) for sharded batch optimization."
            )
        devices = [axis[k // (K // len(axis))] for k in range(K)]
    amps = consts["amp"]
    if amps.ndim == 1:
        amps = amps.tolist()  # Scalar amplitudes: Python floats, as run_gs takes them.

    def moved(x, device):
        return x.to(device) if torch.is_tensor(x) else x

    finals, stats = [], []
    for k, device in enumerate(devices):
        state = GSState(*(None if field is None else field[k].to(device) for field in states))
        instance = {key: moved(amps[k] if key == "amp" else value[k], device)
                    for key, value in consts.items()}
        with on_device(device):
            state, rows = run_gs(config, state, instance, n_iterations)
        finals.append(GSState(*(None if f is None else f.to(home) for f in state)))
        stats.append(rows.to(home))
    states = GSState(*(None if fields[0] is None else torch.stack(fields)
                       for fields in zip(*finals)))
    return states, torch.stack(stats)


def set_scrambled_mode(enable):
    """The TPU's four-step scrambled farfield layout."""
    raise NotImplementedError(
        "The scrambled layout is TPU machinery; the port runs in natural "
        "order (ROADMAP.md 'Semantics, not means')."
    )


def _provision_fused(config: GSConfig, state: GSState):
    """Raise for a configuration the engine cannot run; give the fused
    loop its deferred-normalization scalar."""
    err = _config_error(config)
    if err is not None:
        raise err
    if _carry_active(config) and state.w_norm is None:
        state = state._replace(
            w_norm=torch.ones((), dtype=torch.float32, device=state.weights.device)
        )
    return state


def _finalize_fused(config: GSConfig, state: GSState):
    """Renormalize the deferred-norm weights once on exit."""
    if _carry_active(config) and state.w_norm is not None:
        state = state._replace(
            weights=state.weights / state.w_norm,
            w_norm=torch.ones_like(state.w_norm),
        )
    return state


def init_gs_state(config: GSConfig, psi, weights, phase_ff=None, device=None):
    """Fresh loop state from the initial folded phase and weights (numpy
    or tensors), on ``device``; zero weights of 0 when
    ``config.zero_factor`` is set."""
    device = resolve_device(device)

    def plane(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=torch.float32, device=device)

    shape = tuple(config.shape)
    return GSState(
        psi=plane(psi),
        weights=plane(weights),
        phase_ff=(
            torch.zeros(shape, dtype=torch.float32, device=device)
            if phase_ff is None
            else plane(phase_ff)
        ),
        zero_weights=empty_zero_weights(config, device),
        fixed_phase=torch.zeros((), dtype=torch.bool, device=device),
        unfixed_streak=torch.zeros((), dtype=torch.int32, device=device),
        iteration=torch.zeros((), dtype=torch.int32, device=device),
    )


def empty_zero_weights(config: GSConfig, device):
    """Zero weights of 0: (2, H, W) when ``config.zero_factor`` is set,
    else the empty (2, 0, 0) pair."""
    shape = (2, *config.shape) if config.zero_factor else (2, 0, 0)
    return torch.zeros(shape, dtype=torch.float32, device=device)


def spot_gather_indices(spot_ij, window, shape):
    """
    The (N, D*D) flat gather map for spot-integration feedback and the
    (N,) spot-center flat indices (numpy).

    Parameters
    ----------
    spot_ij : numpy.ndarray
        (2, N) integer spot pixel coordinates (x; y) in the farfield plane.
    window : int
        Integration width D (centered).
    shape : (int, int)
        Farfield plane shape.
    """
    spot_ij = np.asarray(spot_ij, dtype=int)
    edge = np.floor(np.arange(window) - ((window - 1) / 2)).astype(int)
    ex, ey = np.meshgrid(edge, edge)

    ix = np.clip(spot_ij[0][:, None] + ex.ravel()[None, :], 0, shape[1] - 1)
    iy = np.clip(spot_ij[1][:, None] + ey.ravel()[None, :], 0, shape[0] - 1)

    flat = (iy * shape[1] + ix).astype(np.int32)
    center = (spot_ij[1] * shape[1] + spot_ij[0]).astype(np.int32)
    return flat, center
