"""
Zernike holography: grid-free 3D spots with :class:`CompressedSpotHologram`
(a lattice at several depths, then a custom Zernike basis), and a CG
polish of the first.

    python -m slmsuite_torch.examples.zernike_holography --device cpu
"""

import numpy as np

from slmsuite_torch.examples._rig import make_rig, on_device, run


def main(device="cuda", plots=True, resolution=(512, 512)):
    from slmsuite_torch.holography.algorithms import CompressedSpotHologram

    result = {}
    with on_device(device):
        fs = make_rig(resolution)

        print("3D spot lattice via WGS-Kim")
        kx, ky = np.meshgrid((-6e-3, 0, 6e-3), (-6e-3, 0, 6e-3))
        focus = np.linspace(-4e-6, 4e-6, kx.size)  # A depth for each spot.
        spots = np.vstack([kx.ravel(), ky.ravel(), focus])

        holo = CompressedSpotHologram(spots, basis="kxy", cameraslm=fs)
        holo.optimize("WGS-Kim", maxiter=20, verbose=False, stat_groups=["computational_spot"])
        amps = np.asarray(holo.amp_ff)
        result["lattice_cv"] = float(np.std(amps) / np.mean(amps))
        result["lattice_efficiency"] = float(
            holo.stats["stats"]["computational_spot"]["efficiency"][-1])
        result["lattice_uniformity"] = float(
            holo.stats["stats"]["computational_spot"]["uniformity"][-1])
        print(f"  {len(holo)} spots, amplitude CV {result['lattice_cv']:.4f}")

        print("Custom Zernike basis (tilt + focus + astig + coma)")
        basis = [2, 1, 4, 3, 8]  # ANSI: x-tilt, y-tilt, focus, astig, coma.
        rng = np.random.default_rng(0)
        spots5 = np.vstack([
            rng.uniform(-5e-3, 5e-3, (2, 6)),     # Lateral.
            np.zeros((1, 6)),                     # Focus.
            rng.uniform(-0.3, 0.3, (2, 6)),       # Astigmatism, coma (rad).
        ])
        holo5 = CompressedSpotHologram(spots5, basis=basis, cameraslm=fs)
        holo5.optimize("WGS-Kim", maxiter=15, verbose=False)
        amps5 = np.asarray(holo5.amp_ff)
        result["custom_cv"] = float(np.std(amps5) / np.mean(amps5))
        print(f"  converged, efficiency-normalized amps: "
              f"{np.array2string(amps5 / np.max(amps5), precision=2)}")

        print("CG polish")
        holo.optimize("CG", maxiter=30, verbose=False, optimizer_kwargs={"learning_rate": 0.2})
        result["cg_loss"] = float(holo.flags["loss_result"])
        print(f"  final loss {result['cg_loss']:.2e}")
    return result


if __name__ == "__main__":
    run(main)
