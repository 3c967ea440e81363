"""``holobench.progtrace`` on a small synthetic chrome trace: idle gaps go to
the innermost program span, device operations to the span that launched
them (by the launch's correlation and thread, not by when the device ran
them), and the idle time by span plus ``outside the program`` is
``devtrace.reduce_trace``'s; then on a real trace of the port on the CPU."""

import json

import pytest

from holobench import devtrace, progtrace

HOST, OTHER = 1, 2


def _span(name, start, end, tid=HOST):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": start,
            "dur": end - start, "pid": 1, "tid": tid}


def _op(corr, launched_at, start, end, tid=HOST, cat="kernel"):
    """A device operation and the runtime call that launched it."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launched_at,
             "dur": 1, "pid": 1, "tid": tid, "args": {"correlation": corr}},
            {"ph": "X", "cat": cat, "name": f"op{corr}", "ts": start, "dur": end - start,
             "pid": 0, "tid": 7, "args": {"correlation": corr}}]


def _trace(tmp_path):
    """One request, 0-100 us: the construction with its basis, then an
    optimize of two iterations. Two operations run while the host is in a
    span that did not launch them (8, launched in ``gs.setup``, runs in the
    first ``gs.iter``; 6, launched by another thread, runs in ``gs.loop``),
    and one runs after the window."""
    events = [
        _span("request", 0, 100),
        _span("hologram.init", 5, 40), _span("compressed.basis", 10, 35),
        _span("hologram.optimize", 45, 90), _span("gs.setup", 46, 50),
        _span("gs.loop", 50, 85), _span("gs.iter", 55, 65), _span("gs.iter", 66, 76),
        _span("gs.finalize", 85, 89),
        *_op(1, 48, 49, 53, cat="gpu_memcpy"), *_op(8, 49, 56, 59),
        *_op(2, 56, 60, 70), *_op(3, 64, 70, 72), *_op(4, 67, 74, 80),
        *_op(5, 86, 86, 88), *_op(6, 58, 81, 82, tid=OTHER), *_op(7, 95, 120, 130),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_idle_goes_to_the_innermost_span(tmp_path):
    red = progtrace.reduce_program(_trace(tmp_path))
    assert red["requests"] == 1 and red["window_us"] == 100
    assert red["idle_by_span"] == pytest.approx({
        progtrace.OUTSIDE: 20, "hologram.init": 10, "compressed.basis": 25,
        "hologram.optimize": 2, "gs.setup": 3, "gs.loop": 6, "gs.iter": 4, "gs.finalize": 2})
    assert red["spans"]["hologram.optimize"]["idle_us"] == pytest.approx(17)


def test_ops_go_to_the_span_that_launched_them(tmp_path):
    spans = progtrace.reduce_program(_trace(tmp_path))["spans"]
    # 2, 3 and 4, whatever they overlap on the device; not 8 nor 6.
    assert spans["gs.iter"] == pytest.approx(
        {"count": 2, "host_us": 20, "device_us": 18, "ops": 3, "idle_us": 4})
    assert spans["gs.setup"]["device_us"] == 7 and spans["gs.setup"]["ops"] == 2
    assert spans["hologram.optimize"]["ops"] == 6
    assert spans["hologram.optimize"]["device_us"] == 27
    assert spans["compressed.basis"]["ops"] == 0


def test_idle_adds_up_to_devtrace(tmp_path):
    path = _trace(tmp_path)
    red, dev = progtrace.reduce_program(path), devtrace.reduce_trace(path)
    idle = dev["window_us"] - dev["busy_us"]
    assert red["idle_us"] == pytest.approx(idle) == 72
    assert sum(red["idle_by_span"].values()) == pytest.approx(idle)


def test_no_requests_no_window(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [_span("gs.iter", 0, 5)]}))
    assert progtrace.reduce_program(path)["requests"] == 0


def test_a_trace_of_the_port(tmp_path, capsys):
    """A rehearsal-size compressed hologram under ``recording()`` in a
    profiled request: every span is read, the CPU's window all idle."""
    import warnings

    import numpy as np
    import torch

    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM
    from slmsuite_torch.holography.algorithms import CompressedSpotHologram
    from slmsuite_torch.misc import profile

    rng = np.random.default_rng(0)
    coeffs = rng.uniform(-1e-3, 1e-3, (6, 9))
    slm = SimulatedSLM((40, 32))
    with profile.trace(str(tmp_path)), profile.recording():
        with torch.profiler.record_function("request"), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            holo = CompressedSpotHologram(coeffs, basis=list(range(6)), cameraslm=slm,
                                          device=torch.device("cpu"))
            holo.optimize("WGS-Kim", maxiter=3, verbose=False)
            holo.get_phase()
    red = progtrace.reduce_program(tmp_path / "trace.json")
    assert set(red["spans"]) == set(progtrace.PROGRAM_SPANS)
    assert red["spans"]["gs.iter"]["count"] == 3
    assert red["spans"]["hologram.init"]["count"] == 1
    assert red["idle_us"] == pytest.approx(red["window_us"])
    assert sum(red["idle_by_span"].values()) == pytest.approx(red["window_us"])
    assert progtrace.main([str(tmp_path / "trace.json")]) == 0
    assert "compressed.basis" in capsys.readouterr().out
