"""
Mesh scaling: multiplane holography over a data axis, pixel-sharded
compressed spots, and a row-sharded plane, each on a mesh of ``devices``
(one device repeated four times by default: every exchange runs).

    python -m slmsuite_torch.examples.multichip_scaling --device cpu
"""

import numpy as np

from slmsuite_torch.examples._rig import last, on_device, run


def multiplane_over_mesh(mesh, N=64):
    """Planes data-parallel: 8 focal planes across the devices."""
    from slmsuite_torch.holography.algorithms import Hologram, MultiplaneHologram

    children = []
    for b in range(8):
        target = np.zeros((N, N), np.float32)
        target[16 + (3 * b) % 32, 20 + (5 * b) % 24] = 1.0
        children.append(Hologram(target, slm_shape=(N, N)))
    np.random.seed(0)
    mp = MultiplaneHologram(children)
    mp.optimize("WGS-Leonardo", maxiter=20, verbose=False, mesh=mesh,
                stat_groups=["computational"])
    eff = float(np.mean([last(h, "computational", "efficiency") for h in children]))
    print(f"  multiplane over {mesh.shape}: mean plane efficiency {eff:.3f}")
    return eff


def compressed_over_mesh(mesh):
    """Pixel-sharded grid-free 3D spots."""
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM
    from slmsuite_torch.holography.algorithms import CompressedSpotHologram

    slm = SimulatedSLM(resolution=(128, 128), pitch_um=(8, 8), wav_um=0.78)
    kx, ky = np.meshgrid(np.linspace(-8e-3, 8e-3, 4), np.linspace(-8e-3, 8e-3, 4))
    spots = np.vstack([kx.ravel(), ky.ravel(),
                       np.random.default_rng(0).uniform(-2e-6, 2e-6, kx.size)])
    np.random.seed(0)
    holo = CompressedSpotHologram(spots, basis="kxy", cameraslm=slm)
    holo.optimize("WGS-Kim", maxiter=20, verbose=False, mesh=mesh,
                  stat_groups=["computational_spot"])
    u = last(holo, "computational_spot", "uniformity")
    print(f"  compressed spots over {mesh.shape}: uniformity {u:.4f}")
    return u


def plane_over_mesh(mesh, N=64):
    """Row-sharded full-plane WGS (farfields beyond one device)."""
    from slmsuite_torch.holography.algorithms import Hologram

    target = np.zeros((N, N), np.float32)
    target[N // 2, N // 4] = target[N // 4, N // 2] = 1.0
    np.random.seed(0)
    holo = Hologram(target, slm_shape=(N, N))
    holo.optimize("WGS-Leonardo", maxiter=20, verbose=False, mesh=mesh,
                  stat_groups=["computational"])
    eff = last(holo, "computational", "efficiency")
    print(f"  row-sharded plane over {mesh.shape}: efficiency {eff:.3f}")
    return eff


def main(device="cuda", plots=True, n_devices=4, N=64):
    from slmsuite_torch.parallel import make_mesh

    del plots  # Nothing to draw.
    result = {}
    state = np.random.get_state()
    try:
        with on_device(device) as dev:
            devices = [dev] * n_devices
            print(f"devices: {n_devices} x {dev}")
            print("1. Batched multiplane (data axis)")
            result["multiplane_efficiency"] = multiplane_over_mesh(
                make_mesh(axis_names=("data",), devices=devices), N)
            print("2. Pixel-sharded compressed spots (pixels axis)")
            result["compressed_uniformity"] = compressed_over_mesh(
                make_mesh(axis_names=("pixels",), devices=devices))
            print("3. Row-sharded giant farfield (rows axis)")
            result["plane_efficiency"] = plane_over_mesh(
                make_mesh(axis_names=("rows",), devices=devices), N)
    finally:
        np.random.set_state(state)
    print("done")
    return result


if __name__ == "__main__":
    run(main)
