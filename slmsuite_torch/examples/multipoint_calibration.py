"""
Multipoint wavefront calibration: the Zernike method, spot by spot over
the camera, against an injected aberration.

    python -m slmsuite_torch.examples.multipoint_calibration --device cpu
"""

import numpy as np

from slmsuite_torch.examples._rig import fourier_calibrate, make_rig, on_device, run


def main(device="cuda", plots=True, resolution=(512, 512)):
    from slmsuite_torch.holography.toolbox import phase as tphase

    result = {}
    with on_device(device):
        fs = make_rig(resolution)
        fourier_calibrate(fs)

        aberration = tphase.zernike_sum(fs.slm, (4, 3), (1.0, -0.6)).astype(np.float32)
        fs.slm.source["phase_sim"] = aberration
        print(f"Injected aberration, peak-to-peak {np.ptp(aberration):.1f} rad")

        calibration = fs.wavefront_calibrate(
            method="zernike",
            calibration_points=9,
            zernike_indices=5,
            perturbation=np.linspace(-1.5, 1.5, 7),
            optimize_weights=2,
            plot=1 if plots else -1,
        )
        if plots:
            from slmsuite_torch.examples._rig import pyplot, save_figure

            pyplot()
            fs._wavefront_calibrate_zernike_plot_raw(index=3)
            save_figure("multipoint_calibration.png")

        corrected = np.asarray(calibration["corrected_spots"])
        print(f"Per-point corrected Zernike vectors: {corrected.shape} (terms x points)")
        print("Mean correction per aberration term (rad):")
        for index, value in enumerate(np.mean(corrected, axis=-1)[2:], start=2):
            print(f"  term {index}: {value:+.3f}")
            result[f"term_{index}"] = float(value)
        assert "wavefront_zernike" in fs.calibrations
    return result


if __name__ == "__main__":
    run(main)
