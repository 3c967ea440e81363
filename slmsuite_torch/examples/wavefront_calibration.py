"""
Wavefront calibration: inject an aberration into the simulated source,
measure it with the superpixel interference method, apply the correction
and compare the spot's peak before and after.

    python -m slmsuite_torch.examples.wavefront_calibration --device cpu
"""

import numpy as np

from slmsuite_torch.examples._rig import (
    fourier_calibrate,
    make_rig,
    on_device,
    pyplot,
    run,
    save_figure,
)


def main(device="cuda", plots=True, resolution=(512, 512), superpixel_size=64):
    from slmsuite_torch.holography.toolbox import phase as tphase

    result = {}
    with on_device(device):
        fs = make_rig(resolution)
        fourier_calibrate(fs)

        aberration = tphase.zernike_sum(fs.slm, (4, 3, 5), (1.5, -1.0, 0.8)).astype(np.float32)
        fs.slm.source["phase_sim"] = aberration  # The ground truth, unknown to us.
        print("Injected astigmatism+defocus aberration "
              f"(peak-to-peak {np.ptp(aberration):.1f} rad)")

        def spot_peak():
            fs.slm.set_phase(None, settle=False)
            return float(np.max(np.asarray(fs.cam.get_image())))

        print("Measuring (superpixel interference sweep)...")
        point = np.array([[330.0], [220.0]]) * resolution[0] / 512
        fs.wavefront_calibrate(
            method="superpixel",
            calibration_points=point,
            superpixel_size=superpixel_size,
            phase_steps=8,
            plot=-1,
        )
        fs.wavefront_calibration_superpixel_process(apply=True, smooth=2, plot=False)

        while spot_peak() >= 0.9 * fs.cam.bitresolution:
            fs.cam.set_exposure(fs.cam.get_exposure() / 2)
        after = spot_peak()

        correction = fs.slm.source.pop("phase")  # Removed for a moment.
        before = spot_peak()
        fs.slm.source["phase"] = correction

        result["peak_before"], result["peak_after"] = before, after
        result["strehl_gain"] = after / max(before, 1)
        print(f"  spot peak before correction: {before:.0f}")
        print(f"  spot peak after  correction: {after:.0f}  "
              f"({result['strehl_gain']:.1f}x Strehl gain)")

        if plots:
            plt = pyplot()
            measured = np.asarray(fs.slm.source.get("phase", np.zeros_like(aberration)))
            fig, axes = plt.subplots(1, 2, figsize=(10, 4))
            axes[0].imshow(np.mod(aberration, 2 * np.pi), cmap="twilight")
            axes[0].set_title("Injected aberration")
            axes[1].imshow(np.mod(measured, 2 * np.pi), cmap="twilight")
            axes[1].set_title("Measured correction")
            for ax in axes:
                ax.set_axis_off()
            save_figure("wavefront_calibration.png")
    return result


if __name__ == "__main__":
    run(main)
