"""
Batched holography: a movie of spot-array frames optimized together with
:func:`optimize_batch`, against one frame on its own.

    python -m slmsuite_torch.examples.batched_holography --device cpu
"""

import time

import numpy as np

from slmsuite_torch.examples._rig import last, on_device, run, save_figure


def frame_target(shape, t, n_spots=5, seed=0):
    """Spot array rotating with frame index ``t`` (a tweezer movie)."""
    rng = np.random.default_rng(seed)
    radii = rng.uniform(0.15, 0.35, n_spots) * shape[0]
    phases = rng.uniform(0, 2 * np.pi, n_spots)
    target = np.zeros(shape, np.float32)
    for r, p0 in zip(radii, phases):
        y = int(shape[0] / 2 + r * np.sin(p0 + 0.15 * t))
        x = int(shape[1] / 2 + r * np.cos(p0 + 0.15 * t))
        target[y, x] = 1.0
    return target / np.sqrt((target**2).sum())


def main(device="cuda", plots=True, shape=(256, 256), n_frames=8, maxiter=20):
    from slmsuite_torch.holography.algorithms import Hologram, optimize_batch

    result = {}
    with on_device(device):
        rng = np.random.default_rng(1)
        phase0 = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
        frames = []
        for t in range(n_frames):
            h = Hologram(frame_target(shape, t), slm_shape=shape)
            h.reset_phase(phase0)  # Warm start all frames identically.
            frames.append(h)

        t0 = time.perf_counter()
        optimize_batch(frames, "WGS-Kim", maxiter=maxiter, verbose=False,
                       stat_groups=["computational"])
        t_batch = time.perf_counter() - t0
        effs = [last(h, "computational", "efficiency") for h in frames]
        result["frame_efficiency_min"], result["frame_efficiency_max"] = min(effs), max(effs)
        result["frame_uniformity_min"] = min(last(h, "computational", "uniformity")
                                             for h in frames)
        print(f"  {n_frames} frames x {maxiter} iters in {t_batch:.2f}s "
              f"(efficiency {min(effs):.3f}-{max(effs):.3f})")

        solo = Hologram(frame_target(shape, 0), slm_shape=shape)
        solo.reset_phase(phase0)
        t0 = time.perf_counter()
        solo.optimize("WGS-Kim", maxiter=maxiter, verbose=False, stat_groups=["computational"])
        t_solo = time.perf_counter() - t0
        result["solo_efficiency"] = last(solo, "computational", "efficiency")
        print(f"  sequential single frame: {t_solo:.2f}s")

        if plots:
            frames[0].plot_farfield(title="Frame 0")
            save_figure("batched_frame0.png")
            frames[-1].plot_farfield(title=f"Frame {n_frames - 1}")
            save_figure("batched_frame_last.png")
    return result


if __name__ == "__main__":
    run(main, shape_arg=True)
