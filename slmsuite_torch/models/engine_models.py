"""
Engine-level models (PyTorch counterpart of
:mod:`slmsuite_tpu.models.engine_models`): the headline ``spot_array_wgs``
workload and the MRAF image workload ``image_mraf``, built from a seed,
ready to run on a device, and ``camera_loop_wgs``, the simulated rig and
spot hologram of the camera-in-the-loop WGS (BASELINE config 4).
"""

import dataclasses

import numpy as np
import torch

from slmsuite_torch import resolve_device


@dataclasses.dataclass
class EngineModel:
    """A ready-to-run engine workload: config + device consts + the
    initial folded phase and weights (device tensors, copied on every
    :meth:`run`; zero-region weights start at 0 when
    ``config.zero_factor`` is set)."""

    config: object
    consts: dict
    target: np.ndarray
    phase0: torch.Tensor   # folded initial phase (device)
    weights0: torch.Tensor  # initial weights: the cleaned target (device)

    def init_state(self):
        from slmsuite_torch.ops.engine import init_gs_state

        return init_gs_state(
            self.config, self.phase0.clone(), self.weights0.clone(),
            device=self.phase0.device,
        )

    @property
    def step(self):
        from slmsuite_torch.ops.engine import make_gs_step

        return make_gs_step(self.config)

    def run(self, n_iterations):
        """``n_iterations`` from a fresh initial state: ``(state, stats)``."""
        from slmsuite_torch.ops.engine import run_gs

        return run_gs(self.config, self.init_state(), self.consts, n_iterations)


def spot_array_target(N, n_side, spacing_div):
    """(N, N) target with an ``n_side`` x ``n_side`` centered spot grid
    spaced ``N // spacing_div`` pixels apart, unit power."""
    target = np.zeros((N, N), dtype=np.float32)
    idx = (
        (np.arange(n_side) - (n_side - 1) / 2) * (N // spacing_div) + N / 2
    ).astype(int)
    xs, ys = np.meshgrid(idx, idx)
    target[ys.ravel(), xs.ravel()] = 1.0
    return target / np.sqrt((target**2).sum())


def _base_consts(N, target, device):
    clean = torch.as_tensor(np.nan_to_num(target), device=device)

    def scalar(value, dtype=torch.float32):
        return torch.tensor(value, dtype=dtype, device=device)

    return {
        "amp": 1.0 / N,
        "target": clean,
        "stat_mask": clean != 0,
        "feedback_exponent": scalar(0.8),
        "feedback_factor": scalar(0.1),
        "fix_phase_iteration": scalar(10, torch.int32),
        "fix_phase_efficiency": scalar(float("nan")),
    }


def spot_array_wgs(N=2048, n_side=32, spacing_div=70, method="WGS-Kim",
                   stats=True, seed=0, device=None):
    """The headline model: ``N``^2 SLM, ``n_side``^2 spot array, any
    ``method``: Leonardo, Kim, Wu and tanh run the fused loop, GS and
    Nogrette the natural step."""
    from slmsuite_torch.ops.engine import GSConfig
    from slmsuite_torch.ops.propagation import fold_phase

    device = resolve_device(device)
    target = spot_array_target(N, n_side, spacing_div)
    rng = np.random.default_rng(seed)
    phase0 = fold_phase(
        rng.uniform(-np.pi, np.pi, (N, N)).astype(np.float32), (N, N)
    )
    config = GSConfig(
        method=method, shape=(N, N), slm_shape=(N, N),
        stat_groups=("computational",) if stats else (),
    )
    return EngineModel(
        config, _base_consts(N, target, device), target,
        torch.as_tensor(phase0, device=device),
        torch.as_tensor(np.nan_to_num(target), device=device),
    )


def image_mraf_target(N):
    """(N, N) MRAF target of :meth:`image_mraf`: a unit-power ring of
    radius ``N/8`` and width ``N/40``, nan (the noise region) outside
    radius ``N/4``."""
    yy, xx = np.meshgrid(*(np.arange(N) - N / 2 for _ in range(2)), indexing="ij")
    radius = np.sqrt(xx**2 + yy**2)
    target = np.where(np.abs(radius - N / 8) < N / 80, 1.0, 0.0).astype(np.float32)
    target /= np.sqrt(np.nansum(target**2))
    target[radius > N / 4] = np.nan  # Noise region: amplitude freedom.
    return target


def image_mraf(N=2048, method="WGS-Leonardo", mraf_factor=0.5, stats=True,
               seed=0, device=None):
    """BASELINE config 3: the ring image target of
    :meth:`image_mraf_target`, whose amplitude-free noise region (nan)
    lies outside radius ``N/4`` and zero region inside it. Leonardo and
    Kim run the carry-mode MRAF step, the other methods the natural
    step."""
    from slmsuite_torch.ops.engine import GSConfig
    from slmsuite_torch.ops.propagation import fold_phase

    device = resolve_device(device)
    target = image_mraf_target(N)
    rng = np.random.default_rng(seed)
    phase0 = fold_phase(
        rng.uniform(-np.pi, np.pi, (N, N)).astype(np.float32), (N, N)
    )
    config = GSConfig(
        method=method, shape=(N, N), slm_shape=(N, N),
        stat_groups=("computational",) if stats else (),
        mraf=True, mraf_factor=mraf_factor is not None,
    )
    consts = _base_consts(N, target, device)
    noise = np.isnan(target)
    clean = np.nan_to_num(target)
    for key, mask in (("signal_mask", ~noise & (clean > 0)), ("noise_mask", noise),
                      ("zero_mask", ~noise & (clean == 0))):
        consts[key] = torch.as_tensor(mask, device=device)
    consts["mraf_factor"] = torch.tensor(
        1.0 if mraf_factor is None else mraf_factor, dtype=torch.float32, device=device
    )
    return EngineModel(
        config, consts, target,
        torch.as_tensor(phase0, device=device),
        torch.as_tensor(clean, device=device),
    )


#: BASELINE config 4's spots, in camera pixels.
CAMERA_LOOP_SPOTS_IJ = np.array([[160.0, 256, 352, 256], [256.0, 160, 256, 352]])


def camera_loop_rig(slm_side=512, cam_side=512, M=None, b=None, device=None):
    """The simulated rig of BASELINE config 4: a ``slm_side``^2 SLM (8 um
    pixels, 0.78 um light) under a Gaussian simulated source of radius
    0.35 of its side, viewed by a ``cam_side``^2 camera (5.5 um pixels,
    exposure 1) through the affine ``M`` (default ``[[8e3, 200], [-200,
    8e3]]``) and ``b`` (default the camera's center). Returns the
    uncalibrated :class:`~slmsuite_torch.hardware.cameraslms.FourierSLM`."""
    from slmsuite_torch.hardware.cameras.simulated import SimulatedCamera
    from slmsuite_torch.hardware.cameraslms import FourierSLM
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM

    slm = SimulatedSLM(resolution=(slm_side, slm_side), pitch_um=(8, 8), wav_um=0.78)
    slm.set_source_analytic(
        "gaussian2d", sim=True, x0=0, y0=0, a=1, c=0,
        wx=0.35 * slm_side * slm.pitch[0], wy=0.35 * slm_side * slm.pitch[1],
    )
    if M is None:
        M = np.array([[8.0e3, 200.0], [-200.0, 8.0e3]])
    if b is None:
        b = np.array([[cam_side / 2.0], [cam_side / 2.0]])
    cam = SimulatedCamera(
        slm, resolution=(cam_side, cam_side), pitch_um=(5.5, 5.5), M=M, b=b,
        device=device,
    )
    cam.set_exposure(1.0)
    return FourierSLM(cam, slm)


def camera_loop_wgs(spot_ij=None, shape=(1024, 1024), calibration="analytic", seed=0,
                    device=None, **rig):
    """BASELINE config 4: the rig of :meth:`camera_loop_rig`, Fourier
    calibrated, and a :class:`SpotHologram` of ``shape`` on the spots
    ``spot_ij`` (camera pixels; config 4's four by default), its initial
    phase drawn from ``seed``. ``calibration="analytic"`` sets the
    calibration from the camera's own affine; ``"measured"`` projects and
    detects a 5 x 5 grid at pitch 16 (it needs OpenCV). Optimize with
    ``feedback="experimental_spot"`` to close the loop through the
    simulated camera. Returns ``(cameraslm, hologram)``."""
    from slmsuite_torch.holography.algorithms import SpotHologram

    device = resolve_device(device)
    fs = camera_loop_rig(device=device, **rig)
    if calibration == "analytic":
        fs.fourier_calibrate_analytic(fs.cam.M, fs.cam.b)
    elif calibration == "measured":
        fs.fourier_calibrate(array_shape=5, array_pitch=16, verbose=False)
    else:
        raise ValueError(f"Unrecognized calibration '{calibration}'.")
    if spot_ij is None:
        spot_ij = CAMERA_LOOP_SPOTS_IJ
    phase = np.random.default_rng(seed).uniform(-np.pi, np.pi, fs.slm.shape)
    holo = SpotHologram(shape, spot_ij, basis="ij", cameraslm=fs, phase=phase,
                        device=device)
    return fs, holo


#: The aberration :meth:`zernike_calibration_rig` injects: ANSI indices
#: (focus, oblique astigmatism, primary spherical) and their weights (rad).
ZERNIKE_RIG_ABERRATION = ((4, 3, 12), (1.0, -0.6, 0.4))
#: The calibration rig's kxy -> ij affine at a 1024^2 SLM: four times
#: config 4's focal length, so that a spot of the 1024^2 SLM's Gaussian
#: source spans ~1.4 camera pixels (sigma) and the spot-area metric sees a
#: radian of aberration (at config 4's it spans 0.35 px); the camera's
#: canvas is then 4096^2, the kernels' longest side.
ZERNIKE_RIG_M = np.array([[3.2e4, 800.0], [-800.0, 3.2e4]])


def zernike_calibration_rig(slm_side=1024, cam_side=1024, aberration=ZERNIKE_RIG_ABERRATION,
                            M=None, device=None, **rig):
    """The rig of the Zernike wavefront calibration: :meth:`camera_loop_rig`
    at ``slm_side``^2 and ``cam_side``^2 through the affine ``M`` (default
    :data:`ZERNIKE_RIG_M` scaled to ``slm_side``, the spot's width in
    camera pixels kept), its Fourier calibration set from the camera's own
    affine (as ``camera_loop_wgs(calibration="analytic")`` does), and the
    simulated source phase ``zernike_sum(slm, *aberration)`` that the
    calibration is to find. Returns the
    :class:`~slmsuite_torch.hardware.cameraslms.FourierSLM`."""
    from slmsuite_torch.holography.toolbox.phase import zernike_sum

    if M is None:
        M = ZERNIKE_RIG_M * (slm_side / 1024)
    fs = camera_loop_rig(slm_side=slm_side, cam_side=cam_side, M=M,
                         device=resolve_device(device), **rig)
    fs.fourier_calibrate_analytic(fs.cam.M, fs.cam.b)
    indices, weights = aberration
    fs.slm.source["phase_sim"] = np.asarray(zernike_sum(fs.slm, indices, weights))
    return fs
