"""
Engine-level models (PyTorch counterpart of
:mod:`slmsuite_tpu.models.engine_models`): the headline ``spot_array_wgs``
workload and the MRAF image workload ``image_mraf``, built from a seed,
ready to run on a device.
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
