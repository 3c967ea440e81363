"""
Computational holography: phase retrieval without hardware.

The core :class:`Hologram` / :class:`SpotHologram` workflow: weighted-GS
optimization of a spot array, an MRAF image target, and the per-iteration
stats. ``shape`` is the spot array's plane; the MRAF ring is computed on a
plane of the same side with an SLM of half of it.

    python -m slmsuite_torch.examples.computational_holography --device cpu
"""

import numpy as np

from slmsuite_torch.examples._rig import last, on_device, run, save_figure


def main(device="cuda", plots=True, shape=(512, 512), maxiter=30):
    from slmsuite_torch.holography.algorithms import Hologram, SpotHologram

    result = {}
    with on_device(device):
        # --- 1. A 10x10 optical focus array with WGS-Kim. ------------------
        print("SpotHologram: 10x10 grid, WGS-Kim")
        pitch = max(20, shape[0] // 25)
        holo = SpotHologram.make_rectangular_array(
            shape, array_shape=(10, 10), array_pitch=(pitch, pitch), basis="knm"
        )
        holo.optimize("WGS-Kim", maxiter=maxiter, verbose=False,
                      stat_groups=["computational", "computational_spot"])
        result["spot_efficiency"] = last(holo, "computational_spot", "efficiency")
        result["spot_uniformity"] = last(holo, "computational_spot", "uniformity")
        print(f"  efficiency {result['spot_efficiency']:.3f}  "
              f"uniformity {result['spot_uniformity']:.4f}")
        if plots:
            holo.plot_farfield(title="10x10 WGS-Kim")
            save_figure("computational_spot_array.png")
            holo.plot_stats()
            save_figure("computational_stats.png")

        # --- 2. An image target with MRAF (amplitude freedom). -------------
        print("Hologram: ring image target, WGS-Leonardo + MRAF")
        yy, xx = np.meshgrid(*(np.arange(s) - s / 2 for s in shape), indexing="ij")
        radius = np.sqrt(xx**2 + yy**2)
        scale = shape[0] / 512
        target = np.where(np.abs(radius - 60 * scale) < 6 * scale, 1.0, 0.0).astype(np.float32)
        target[radius > 120 * scale] = np.nan  # The MRAF noise region.

        holo_img = Hologram(target, slm_shape=(shape[0] // 2, shape[1] // 2))
        holo_img.optimize("WGS-Leonardo", maxiter=maxiter, verbose=False, mraf_factor=0.5,
                          stat_groups=["computational"])
        result["mraf_efficiency"] = last(holo_img, "computational", "efficiency")
        print(f"  signal-region efficiency {result['mraf_efficiency']:.3f}")
        if plots:
            holo_img.plot_farfield(title="Ring target (MRAF)")
            save_figure("computational_mraf_ring.png")

        # --- 3. The phase goes to an SLM. ----------------------------------
        phase = np.asarray(holo.get_phase())
        print(f"  phase pattern: {phase.shape}, range "
              f"[{phase.min():.2f}, {phase.max():.2f}] rad")
    return result


if __name__ == "__main__":
    run(main, shape_arg=True)
