"""
The port's remote hardware against the JAX package's, on loopback: the
port's clients (``RemoteSLM``, ``RemoteCamera``) with the JAX package's
``Server``, and the JAX package's clients with the port's ``Server``. The
wire protocol is the same byte for byte (the codec is held equal on the
same message), so a display written by either client reaches the served
SLM, and a frame taken by the served camera reaches either client, equal.
"""

import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

import slmsuite_torch
from slmsuite_torch.hardware import remote as tremote
from slmsuite_torch.hardware.cameras.remote import RemoteCamera as TRemoteCamera
from slmsuite_torch.hardware.cameras.simulated import SimulatedCamera as TCamera
from slmsuite_torch.hardware.slms.remote import RemoteSLM as TRemoteSLM
from slmsuite_torch.hardware.slms.simulated import SimulatedSLM as TSLM
from slmsuite_tpu.hardware import remote as jremote
from slmsuite_tpu.hardware.cameras.remote import RemoteCamera as JRemoteCamera
from slmsuite_tpu.hardware.cameras.simulated import SimulatedCamera as JCamera
from slmsuite_tpu.hardware.slms.remote import RemoteSLM as JRemoteSLM
from slmsuite_tpu.hardware.slms.simulated import SimulatedSLM as JSLM


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


@pytest.fixture(autouse=True, scope="module")
def _torch_cpu():
    slmsuite_torch.set_default_device("cpu")
    yield
    slmsuite_torch.set_default_device("cuda")


def _free_port():
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def test_codec_matches_jax():
    """The same message encodes to the same bytes and decodes alike; a
    tensor travels as its numpy array."""
    arr = np.random.default_rng(1).standard_normal((6, 5)).astype(np.float32)
    msg = {"x": arr, "n": np.int64(3), "f": np.float32(2.5), "d": np.dtype(np.uint16),
           "b": np.bool_(True), "s": "text"}
    got = json.dumps(msg, cls=tremote._NpEncoder)
    assert got == json.dumps(msg, cls=jremote._NpEncoder)
    assert json.dumps({**msg, "x": torch.as_tensor(arr)}, cls=tremote._NpEncoder) == got
    back = tremote._recurse_decompress(json.loads(got))
    ref = jremote._recurse_decompress(json.loads(got))
    np.testing.assert_array_equal(back["x"], ref["x"])
    assert back["d"] == ref["d"] and back["n"] == ref["n"] == 3


def _serve(server_module, hardware, requests):
    port = _free_port()
    server = server_module.Server(hardware, port=port)
    thread = threading.Thread(target=server.listen,
                              kwargs=dict(verbose=False, max_requests=requests), daemon=True)
    thread.start()
    return port, thread


def _connect(cls, name, port):
    for _ in range(50):
        try:
            return cls(name, host="localhost", port=port)
        except (ValueError, ConnectionError, OSError):
            time.sleep(0.1)
    raise AssertionError("the server never came up")


@pytest.mark.parametrize("pair", ["port_clients_jax_server", "jax_clients_port_server"])
def test_clients_and_servers_interoperate(pair):
    """A served SLM and camera, driven by the other package's clients: the
    attributes read at connection, a written display, a frame and its
    exposure round trip, against the same hardware used locally."""
    if pair == "port_clients_jax_server":
        server_module, slm_cls, cam_cls = jremote, JSLM, JCamera
        remote_slm, remote_cam = TRemoteSLM, TRemoteCamera
        cam_kw = {}
    else:
        server_module, slm_cls, cam_cls = tremote, TSLM, TCamera
        remote_slm, remote_cam = JRemoteSLM, JRemoteCamera
        cam_kw = dict(device="cpu")
    slm = slm_cls((48, 32), pitch_um=(8, 8), wav_um=0.78, name="lab-slm")
    cam = cam_cls(slm, (40, 30), pitch_um=(4, 4), name="lab-cam", **cam_kw)
    cam.set_exposure(1.0)
    port, thread = _serve(server_module, [slm, cam], requests=12)
    try:
        rslm = _connect(remote_slm, "lab-slm", port)
        rcam = _connect(remote_cam, "lab-cam", port)
        assert rslm.shape == slm.shape == (32, 48) and rslm.wav_um == 0.78
        assert rcam.shape == cam.shape and rcam.bitdepth == cam.bitdepth

        phase = np.random.default_rng(3).uniform(0, 2 * np.pi, rslm.shape)
        rslm.set_phase(phase, phase_correct=False)
        np.testing.assert_array_equal(np.asarray(slm.display), np.asarray(rslm.display))

        img = np.asarray(rcam.get_image())
        np.testing.assert_array_equal(img, np.asarray(cam.get_image()))
        rcam.set_exposure(0.5)
        assert cam.get_exposure() == rcam.get_exposure() == 0.5
        rcam.flush()
    finally:
        thread.join(timeout=2)


def test_examples_remote_client_reads_a_moved_spot():
    """The port's own pair: a blaze written over the wire moves the
    camera's spot off centre (the example's check)."""
    from slmsuite_torch.holography.toolbox.phase import blaze

    slm = TSLM((64, 64), pitch_um=(8, 8), wav_um=0.78, name="s")
    cam = TCamera(slm, (64, 64), pitch_um=(4, 4), name="c", device="cpu")
    cam.set_exposure(1.0)
    port, thread = _serve(tremote, [slm, cam], requests=12)
    try:
        rslm = _connect(TRemoteSLM, "s", port)
        rcam = _connect(TRemoteCamera, "c", port)
        rslm.set_phase(blaze(grid=rslm, vector=(0.02, 0.01)))
        img = np.asarray(rcam.get_image())
        assert np.unravel_index(np.argmax(img), img.shape) != (32, 32)
    finally:
        thread.join(timeout=2)
