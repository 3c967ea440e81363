"""
Experimental holography: calibrate the rig, project spots at camera
targets, check where they land, then close the loop with camera feedback.

    python -m slmsuite_torch.examples.experimental_holography --device cpu
"""

import numpy as np

from slmsuite_torch.examples._rig import (
    fourier_calibrate,
    last,
    make_rig,
    on_device,
    pyplot,
    run,
    save_figure,
)


def main(device="cuda", plots=True, shape=(1024, 1024), resolution=(512, 512)):
    from slmsuite_torch.holography.algorithms import SpotHologram

    result = {}
    with on_device(device):
        fs = make_rig(resolution)

        print("Fourier calibration")
        fourier_calibrate(fs)
        M = fs.calibrations["fourier"]["M"]
        b = fs.calibrations["fourier"]["b"]
        print(f"  M =\n{np.array2string(np.asarray(M), precision=1)}\n  b = {np.ravel(b)}")

        print("Projecting spots at camera targets")
        # A cross and a diagonal pair about the camera's centre (the
        # reference example's targets on its 512^2 camera, scaled).
        c = np.array(resolution) / 2
        d, e = resolution[0] * 96 / 512, resolution[0] * 46 / 512
        spot_ij = np.array([
            [c[0] - d, c[0], c[0] + d, c[0], c[0] - e, c[0] + e],
            [c[1], c[1] - d, c[1], c[1] + d, c[1] - e, c[1] + e],
        ], dtype=float)
        holo = SpotHologram(shape, spot_ij, basis="ij", cameraslm=fs)
        holo.optimize("WGS-Kim", maxiter=20, verbose=False,
                      stat_groups=["computational_spot"])
        result["spot_efficiency"] = last(holo, "computational_spot", "efficiency")
        result["spot_uniformity"] = last(holo, "computational_spot", "uniformity")

        fs.slm.set_phase(holo.get_phase(), settle=False)
        img = np.asarray(fs.cam.get_image())

        found = []
        for k in range(spot_ij.shape[1]):
            j, i = spot_ij[:, k]
            window = img[int(i) - 6:int(i) + 7, int(j) - 6:int(j) + 7]
            di, dj = np.unravel_index(np.argmax(window), window.shape)
            found.append(np.hypot(di - 6, dj - 6))
        result["placement_error_px"] = float(max(found))
        print(f"  max spot placement error: {max(found):.1f} px")

        if plots:
            plt = pyplot()
            plt.imshow(img, cmap="turbo")
            plt.scatter(spot_ij[0], spot_ij[1], s=120, fc="none", ec="w")
            plt.title("Measured camera image with targets")
            save_figure("experimental_spots.png")

        print("Experimental-feedback WGS")
        holo.optimize("WGS-Kim", maxiter=10, verbose=False,
                      feedback="experimental_spot", stat_groups=["experimental_spot"])
        result["measured_uniformity"] = last(holo, "experimental_spot", "uniformity")
        print(f"  measured uniformity after feedback: {result['measured_uniformity']:.4f}")
    return result


if __name__ == "__main__":
    run(main, shape_arg=True)
