"""The work counts against hand-worked values at one small shape, and the
per-layer readers on a record made by hand."""

import pytest

from holobench.metrics import (
    device_idle,
    glue_ms_per_iter,
    kernel_roofline,
    launches_per_iter,
    prep_ms,
)
from holobench.work import compressed


def test_holobench_compressed_work():
    config = {"slm": {"shape": [48, 64]}}
    work = compressed.per_iteration(config, {"spots": [4, 4], "terms": 21})
    assert work["flops"] == 2 * 16 * 3072 * (42 + 24 + 8) == 7274496
    assert work["bytes"] == 4 * 3072 * 23 == 282624
    work = compressed.per_iteration(config, {"spots": [4, 4], "terms": 3})
    assert work["flops"] == 2 * 16 * 3072 * (6 + 24 + 8)


def record(**kw):
    base = {
        "device_ops": [["k1", "kernel", 0.0, 300.0, False], ["g", "kernel", 400.0, 100.0, True],
                       ["Memcpy DtoH", "gpu_memcpy", 600.0, 100.0, False]],
        "busy_s": 500e-6, "window_s": 1000e-6, "iterations": 2,
        "spans_ms": {"prep": [1.0, 3.0], "optimize": [5.0, 5.0], "readback": [2.0, 2.0]},
        "work": {"flops": 67e6, "bytes": 3.35e6},
        "peaks": {"flops": 67e12, "bytes_per_s": 3.35e12},
    }
    base.update(kw)
    return base


def test_holobench_readers():
    r = record()
    assert prep_ms.read(r) == 4.0
    assert launches_per_iter.read(r) == 1.0
    assert glue_ms_per_iter.read(r) == pytest.approx(0.05)
    # Least 1 us (both bounds) against 250 us of busy time an iteration.
    assert kernel_roofline.read(r) == pytest.approx(0.4)
    assert device_idle.read(r) == pytest.approx(0.5)


def test_holobench_readers_read_nothing_from_an_empty_trace():
    r = record(device_ops=[], busy_s=0.0, window_s=0.0, iterations=0)
    for reader in (launches_per_iter, glue_ms_per_iter, kernel_roofline, device_idle):
        assert reader.read(r) is None
