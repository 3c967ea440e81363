"""
Structured light: the analytic phase patterns of the toolbox (blazes,
lenses, axicons, Zernike sums, Laguerre-, Hermite-, Ince- and
Mathieu-Gaussian beams, Airy beams), imprinted into windows and displayed
on an SLM of ``resolution`` (width, height).

    python -m slmsuite_torch.examples.structured_light --device cpu
"""

import numpy as np

from slmsuite_torch.examples._rig import make_slm, on_device, pyplot, run, save_figure


def main(device="cuda", plots=True, resolution=(512, 512)):
    from slmsuite_torch.holography import toolbox
    from slmsuite_torch.holography.toolbox import phase

    result = {}
    with on_device(device):
        slm = make_slm(resolution)
        patterns = {
            "blaze": phase.blaze(slm, (0.01, 0.005)),
            "lens (f=200k)": phase.lens(slm, 2e5),
            "axicon (f=200k)": phase.axicon(slm, (2e5, 2e5)),
            "LG (l=3, p=0)": phase.laguerre_gaussian(slm, l=3, p=0),
            "HG (n=2, m=1)": phase.hermite_gaussian(slm, n=2, m=1),
            "zernike sum": phase.zernike_sum(slm, (3, 5, 10), (0.5, -0.8, 0.3)),
            "IG helical (p=4, m=2)": phase.ince_gaussian(slm, 4, 2, parity=0),
            "Mathieu (r=2, q=4)": phase.matheui_gaussian(slm, 2, 4.0),
            "Airy cubic": phase.airy(slm, f=(2e5, 2e5), w=200),
        }
        for name, pattern in patterns.items():
            pattern = np.asarray(pattern)
            assert pattern.shape == slm.shape and np.all(np.isfinite(pattern)), name
        result["patterns"] = len(patterns)
        if plots:
            plt = pyplot()
            fig, axes = plt.subplots(3, 3, figsize=(12, 12))
            for ax, (name, pattern) in zip(axes.ravel(), patterns.items()):
                ax.imshow(np.mod(pattern, 2 * np.pi), cmap="twilight",
                          vmin=0, vmax=2 * np.pi, interpolation="nearest")
                ax.set_title(name)
                ax.set_axis_off()
            save_figure("structured_light_patterns.png")

        canvas = phase.blaze(slm, (0.02, 0))
        w, h = slm.shape[1] // 4, slm.shape[0] // 4
        toolbox.imprint(
            canvas,
            window=(w, 2 * w, h, 2 * h),  # (x, width, y, height)
            function=phase.laguerre_gaussian,
            grid=slm,
            l=1, p=0,
        )
        if plots:
            plt = pyplot()
            plt.imshow(np.mod(canvas, 2 * np.pi), cmap="twilight",
                       vmin=0, vmax=2 * np.pi, interpolation="nearest")
            plt.title("LG vortex imprinted on a blaze")
            save_figure("structured_light_imprint.png")

        slm.set_phase(canvas, settle=False)
        shown = np.asarray(slm.phase)
        result["phase_min"], result["phase_max"] = float(shown.min()), float(shown.max())
        print(f"  displayed pattern, SLM reports phase range "
              f"[{shown.min():.2f}, {shown.max():.2f}] rad")
    return result


if __name__ == "__main__":
    run(main)
