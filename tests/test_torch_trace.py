"""
The program's spans and transfer counters (``slmsuite_torch.misc.profile``
``recording``/``span``/``count``) on the CPU: off by default, the spans of a
rehearsal-size ``CompressedSpotHologram``'s construction, initial phase,
``optimize`` and readback with their parents, the same names as
``user_annotation`` events of a Chrome trace, the exact bytes and syncs the
hologram module's upload and download helpers count against a stand-in
device (and none for a CPU hologram), and ``launches`` as the difference of
the kernel wrappers' ``LAUNCHES``.
"""

import json
import threading
import warnings

import numpy as np
import pytest
import torch

from slmsuite_torch.hardware.slms.simulated import SimulatedSLM
from slmsuite_torch.holography.algorithms import CompressedSpotHologram, Hologram
from slmsuite_torch.holography.algorithms import _hologram
from slmsuite_torch.misc import profile
from slmsuite_torch.ops import cuda_compressed, cuda_fft

SHAPE = (48, 64)   # (H, W)
TERMS, SPOTS, ITERS = 10, 16, 5

#: The spans of one request (build, custom phase, optimize, readback), as
#: ``(name, parent name)`` in the order they open. Hologram.__init__ draws
#: a phase and resets; the compressed class resets again (a second random
#: phase), then builds its basis.
REQUEST_SPANS = [
    ("hologram.init", None),
    ("hologram.reset_phase", "hologram.init"),
    ("hologram.reset", "hologram.init"),
    ("hologram.reset", "hologram.init"),
    ("hologram.reset_phase", "hologram.reset"),
    ("compressed.basis", "hologram.init"),
    ("hologram.reset_phase", None),
    ("hologram.optimize", None),
    ("gs.setup", "hologram.optimize"),
    ("gs.loop", "hologram.optimize"),
    *[("gs.iter", "gs.loop")] * ITERS,
    ("gs.finalize", "hologram.optimize"),
    ("hologram.get_phase", None),
]


def _slm():
    H, W = SHAPE
    slm = SimulatedSLM(resolution=(W, H), pitch_um=(8, 8), wav_um=0.78)
    slm.set_source_analytic("gaussian2d", x0=0, y0=0, a=1, c=0,
                            wx=0.35 * W * slm.pitch[0], wy=0.35 * H * slm.pitch[1])
    return slm


def _request(slm, callback=None):
    """Build, phase, optimize (WGS-Kim) and read back one hologram of
    ``SPOTS`` 3D spots in ``TERMS`` Zernike terms; returns the hologram."""
    rng = np.random.default_rng(3)
    coeffs = rng.uniform(-1.0, 1.0, (TERMS, SPOTS))
    coeffs[0] = 0.0
    coeffs[2], coeffs[1] = rng.uniform(-5e-3, 5e-3, (2, SPOTS))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # Piston in the basis.
        holo = CompressedSpotHologram(coeffs, basis=list(range(TERMS)), cameraslm=slm,
                                      device=torch.device("cpu"))
    holo.reset_phase(custom_phase=rng.uniform(-np.pi, np.pi, SHAPE))
    holo.optimize("WGS-Kim", maxiter=ITERS, feedback="computational_spot",
                  stat_groups=["computational_spot"], verbose=False, callback=callback)
    holo.get_phase()
    return holo


def _tree(spans):
    return [(s["name"], None if s["parent"] is None else spans[s["parent"]]["name"])
            for s in spans]


def test_recording_is_off_by_default():
    """Outside a recording ``span`` is one shared null context, ``count``
    and the spans of a whole request store nothing, and a recording opened
    afterwards starts empty."""
    assert profile._RECORDER is None
    assert profile.span("a") is profile.span("b") is profile._NULL_SPAN
    profile.count("h2d_bytes", 7)
    _request(_slm())
    with profile.recording() as rec:
        pass
    assert rec.result() == {"spans": [], "counters": {}, "launches": {}}
    assert profile.span("a") is profile._NULL_SPAN


def test_one_recording_at_a_time():
    with profile.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with profile.recording():
                pass
    assert profile._RECORDER is None


def test_request_spans_and_their_parents():
    """The table's spans, each inside its parent, on one thread, with no
    orphan: ``ITERS`` ``gs.iter`` under one ``gs.loop``."""
    slm = _slm()
    with profile.recording() as rec:
        _request(slm)
    spans = rec.result()["spans"]
    assert _tree(spans) == REQUEST_SPANS
    for i, s in enumerate(spans):
        assert s["start_ns"] <= s["end_ns"]
        assert s["thread"] == threading.get_ident()
        if s["parent"] is not None:
            parent = spans[s["parent"]]
            assert s["parent"] < i
            assert parent["start_ns"] <= s["start_ns"] and s["end_ns"] <= parent["end_ns"]


def test_host_loop_spans():
    """The compressed host loop (a callback): one ``gs.iter`` an iteration
    under ``gs.loop``, then ``gs.finalize``."""
    slm = _slm()
    with profile.recording() as rec:
        _request(slm, callback=lambda holo: False)
    assert _tree(rec.result()["spans"]) == REQUEST_SPANS


@pytest.mark.parametrize("method", ["WGS-Kim", "GS"])
def test_engine_spans_of_a_plain_hologram(method):
    """``ops/engine.py``'s loops give every other hologram its ``gs.loop``
    and ``gs.iter``."""
    target = np.zeros((32, 32))
    target[8, 8] = target[20, 12] = 1.0
    holo = Hologram(target, slm_shape=(32, 32), device=torch.device("cpu"))
    with profile.recording() as rec:
        holo.optimize(method, maxiter=4, verbose=False)
    tree = _tree(rec.result()["spans"])
    assert tree == [("hologram.optimize", None), ("gs.loop", "hologram.optimize"),
                    *[("gs.iter", "gs.loop")] * 4]


def test_spans_are_user_annotations(tmp_path):
    """Inside a profiled window every span is a ``user_annotation`` event
    of the Chrome trace."""
    slm = _slm()
    with profile.trace(str(tmp_path)), profile.recording():
        _request(slm)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(names) == sorted(name for name, _ in REQUEST_SPANS)


def test_spans_of_another_thread_have_their_own_parents():
    """A span's parent is the innermost open span of its own thread."""
    def work():
        with profile.span("worker"):
            pass

    with profile.recording() as rec:
        with profile.span("main"):
            worker = threading.Thread(target=work)
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
            with profile.span("inner"):
                pass
    spans = rec.result()["spans"]
    assert [(s["name"], s["parent"]) for s in spans] == [("main", None), ("worker", None),
                                                        ("inner", 0)]
    assert spans[1]["thread"] != spans[0]["thread"] == spans[2]["thread"]


def test_threads_lose_no_count_or_span():
    """More threads than cores, switching often: every count and span of
    every thread is kept, each span's parent on its own thread."""
    import os
    import sys

    n_threads, n = 2 * (os.cpu_count() or 1) + 2, 500

    def work():
        for _ in range(n):
            with profile.span("outer"):
                profile.count("n")
                with profile.span("inner"):
                    profile.count("n", 2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile.recording() as rec:
            workers = [threading.Thread(target=work) for _ in range(n_threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    result = rec.result()
    assert result["counters"] == {"n": 3 * n * n_threads}
    spans = result["spans"]
    assert len(spans) == 2 * n * n_threads
    for s in spans:
        if s["name"] == "inner":
            parent = spans[s["parent"]]
            assert parent["name"] == "outer" and parent["thread"] == s["thread"]
        else:
            assert s["parent"] is None


def _stand_in_device(monkeypatch):
    """Let the CPU stand in for a device: every copy the helpers make
    counts as crossing."""
    monkeypatch.setattr(_hologram, "_crosses", lambda device: True)


def test_helpers_count_exact_bytes_and_syncs(monkeypatch):
    _stand_in_device(monkeypatch)
    cpu = torch.device("cpu")
    with profile.recording() as rec:
        _hologram._upload(np.zeros((3, 5), np.float64), cpu, torch.float32)
        _hologram._upload(True, cpu)
        _hologram._upload(7, cpu, torch.int32, copy=True)
        _hologram._download(torch.zeros(9))
        _hologram._download(torch.zeros(2, dtype=torch.bool))
    assert rec.result()["counters"] == {"h2d_bytes": 15 * 4 + 1 + 4, "syncs": 2}


def _request_bytes(holo):
    """The bytes of the arrays a request's hologram moves to the device:
    the (D, P) basis, the (P,) amplitude and initial phase, the (D, N)
    coefficients, the (N,) target, stat mask (bool) and weights in float32,
    the four 0-d flags of the loop (4 bytes each), the fixed-phase flag (1)
    and the iteration (4)."""
    P, N = int(np.prod(holo.slm_shape)), len(holo)
    return 4 * (TERMS * P + P + P + TERMS * N + N + N) + N + 4 * 4 + 1 + 4


@pytest.mark.parametrize("host_loop", [False, True])
def test_request_counts_against_a_stand_in_device(monkeypatch, host_loop):
    """On a stand-in device a request uploads exactly its arrays; the
    engine's run waits for the device twice (the packed download, and
    ``get_phase``'s), the host loop once an iteration, once for its final
    state, twice for the farfield's amplitude and phase, and for
    ``get_phase``; and its weights and phases an iteration go up again."""
    _stand_in_device(monkeypatch)
    slm = _slm()
    with profile.recording() as rec:
        holo = _request(slm, callback=(lambda h: False) if host_loop else None)
    counters = rec.result()["counters"]
    expected = _request_bytes(holo)
    if host_loop:
        # Each iteration uploads the weights and farfield phase (N floats
        # each) and the fixed-phase flag.
        expected += ITERS * (2 * 4 * len(holo) + 1)
    assert counters == {"h2d_bytes": expected, "syncs": ITERS + 4 if host_loop else 2}


def test_a_cpu_hologram_counts_nothing():
    slm = _slm()
    with profile.recording() as rec:
        _request(slm)
    assert rec.result()["counters"] == {}


def test_launches_are_the_wrappers_difference(monkeypatch):
    """``launches`` holds what the wrappers' ``LAUNCHES`` gained during the
    recording, by wrapper, and nothing from before or after it."""
    for module in (cuda_fft, cuda_compressed):
        for name, n in module.LAUNCHES.items():
            monkeypatch.setitem(module.LAUNCHES, name, n)
    cuda_fft.LAUNCHES["rows_fft"] += 3
    with profile.recording() as rec:
        cuda_fft.LAUNCHES["rows_fft"] += 2
        cuda_compressed.LAUNCHES["n2f"] += 1
        assert rec.result()["launches"] == {"rows_fft": 2, "n2f": 1}
    cuda_compressed.LAUNCHES["f2n"] += 1
    assert rec.result()["launches"] == {"rows_fft": 2, "n2f": 1}
