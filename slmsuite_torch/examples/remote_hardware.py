"""
Remote hardware: serve a simulated SLM and camera over TCP on loopback and
drive them through :class:`RemoteSLM` and :class:`RemoteCamera` (the wire
protocol is the JAX package's, so either package's clients and servers
talk to each other).

    python -m slmsuite_torch.examples.remote_hardware --device cpu
"""

import threading
import time

import numpy as np

from slmsuite_torch.examples._rig import on_device, pyplot, run, save_figure


def _free_port():
    import socket

    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def main(device="cuda", plots=True, resolution=(256, 256)):
    from slmsuite_torch.hardware.cameras.remote import RemoteCamera
    from slmsuite_torch.hardware.cameras.simulated import SimulatedCamera
    from slmsuite_torch.hardware.remote import Server
    from slmsuite_torch.hardware.slms.remote import RemoteSLM
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM
    from slmsuite_torch.holography.toolbox.phase import blaze

    result = {}
    with on_device(device):
        slm = SimulatedSLM(resolution, pitch_um=(8, 8), wav_um=0.78)
        slm.name = "demo-slm"
        cam = SimulatedCamera(slm, resolution, pitch_um=(4, 4))
        cam.name = "demo-cam"
        cam.set_exposure(1.0)

        port = _free_port()
        server = Server([slm, cam], port=port)
        thread = threading.Thread(target=server.listen, kwargs={"verbose": False}, daemon=True)
        thread.start()
        time.sleep(0.5)
        print(f"server listening on localhost:{port} (slm + camera)")

        rslm = RemoteSLM("demo-slm", host="localhost", port=port)
        rcam = RemoteCamera("demo-cam", host="localhost", port=port)
        print(f"connected: RemoteSLM {rslm.shape}, RemoteCamera {rcam.shape}")

        rslm.set_phase(blaze(grid=rslm, vector=(0.01, 0.005)))
        img = np.asarray(rcam.get_image())
        peak = np.unravel_index(np.argmax(img), img.shape)
        print(f"image over the wire: shape {img.shape}, peak at {peak}")
        assert peak != (img.shape[0] // 2, img.shape[1] // 2)  # The spot moved.
        result["peak"] = [int(v) for v in peak]

        if plots:
            plt = pyplot()
            fig, axes = plt.subplots(1, 2, figsize=(10, 5))
            axes[0].imshow(np.asarray(rslm.phase), cmap="twilight")
            axes[0].set_title("phase written via RemoteSLM")
            axes[1].imshow(img, cmap="magma")
            axes[1].set_title("image read via RemoteCamera")
            for ax in axes:
                ax.set_xticks([]), ax.set_yticks([])
            save_figure("remote_hardware.png")

        t0 = time.perf_counter()
        n = 20
        for _ in range(n):
            rcam.flush()
        dt = (time.perf_counter() - t0) / n
        result["flush_ms"] = 1e3 * dt
        print(f"mean round-trip latency (flush): {1e3 * dt:.2f} ms over loopback")
    return result


if __name__ == "__main__":
    run(main)
