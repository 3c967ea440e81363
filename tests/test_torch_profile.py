"""
``slmsuite_torch.misc.profile`` on the CPU: :meth:`bytes_accessed` counts
an elementwise op on N floats as 2 * 4 * N bytes, adds the bytes each
hand-kernel launch declares (the wrappers' ``BYTES`` tally, which counts
the planes read once and written once), and moves no bytes for views and
allocations; :meth:`trace` writes a Chrome trace; :meth:`time_scan`
returns ``repeats`` positive times.
"""

import json

import pytest
import torch

from slmsuite_torch.misc import profile
from slmsuite_torch.ops import cuda_compressed, cuda_fft


@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_bytes_of_an_elementwise_op(n):
    x = torch.randn(n)
    total, detail = profile.bytes_accessed(lambda a: a * 2.0, x)
    assert total == detail["aten"] == 2 * 4 * n
    total, _ = profile.bytes_accessed(lambda a, b: a + b, x, x)
    assert total == 3 * 4 * n


def test_views_and_allocations_move_nothing():
    x = torch.randn(8, 16)
    total, _ = profile.bytes_accessed(lambda a: (a.t(), a.reshape(16, 8), torch.empty(99)), x)
    assert total == 0


def test_declared_kernel_bytes_are_added():
    """A launch's declared bytes (its wrapper's ``BYTES`` tally: each plane
    read once and written once) join the aten ops' count, by kernel."""
    x = torch.randn(64, 128)

    def step(a):
        cuda_fft._launched("rows_fft", (a, a), (a, a))
        cuda_compressed._launched("n2f", (a, None), (a,))
        return a * 1.0

    cuda_fft.reset_launch_counts()
    cuda_compressed.reset_launch_counts()
    total, detail = profile.bytes_accessed(step, x)
    plane = 64 * 128 * 4
    assert detail == {"aten": 2 * plane, "rows_fft": 4 * plane, "n2f": 2 * plane}
    assert total == 8 * plane
    assert cuda_fft.LAUNCHES["rows_fft"] == 1 and cuda_fft.BYTES["rows_fft"] == 4 * plane
    cuda_fft.reset_launch_counts()
    cuda_compressed.reset_launch_counts()
    assert cuda_fft.BYTES["rows_fft"] == 0 and cuda_compressed.BYTES["n2f"] == 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profile.trace(str(tmp_path / "run")) as prof:
        torch.fft.fft2(torch.randn(32, 32))
    assert prof is not None
    path = tmp_path / "run" / "trace.json"
    assert path.exists()
    assert "traceEvents" in json.loads(path.read_text())


@pytest.mark.parametrize("repeats", [1, 3])
def test_time_scan_returns_positive_times(repeats):
    calls = []

    def step(carry):
        calls.append(1)
        return (carry[0] * 0.5 + 1.0, carry[1])

    times = profile.time_scan(step, (torch.randn(64), "label"), n_iterations=5, repeats=repeats)
    assert len(times) == repeats and all(t > 0 for t in times)
    assert len(calls) == 5 * (repeats + 1)
