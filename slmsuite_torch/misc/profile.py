"""
Profiling and timing helpers (the port's counterpart of
:mod:`slmsuite_tpu.misc.profile`, on PyTorch's own means):

- :func:`trace`: a context around :class:`torch.profiler.profile` that
  writes a Chrome trace of the host and (on a CUDA device) the device.
- :func:`time_scan`: milliseconds an iteration of ``carry -> carry``
  function ``step``, chained ``n_iterations`` deep, by CUDA events on the
  card and :func:`time.perf_counter` on the CPU.
- :func:`bytes_accessed`: the bytes a call moves, the counterpart of XLA's
  cost analysis: each aten op's operands and results under a
  :class:`~torch.utils._python_dispatch.TorchDispatchMode`, plus the bytes
  each hand-kernel launch declares (its inputs read once, its outputs
  written once; ``BYTES`` of :mod:`slmsuite_torch.ops.cuda_fft` and
  :mod:`slmsuite_torch.ops.cuda_compressed`).
"""

import contextlib
import os
import time

__all__ = ["trace", "time_scan", "bytes_accessed"]


@contextlib.contextmanager
def trace(log_dir, record_shapes=False):
    """Record a :mod:`torch.profiler` trace of the block into
    ``log_dir/trace.json`` (Chrome trace format; CUDA activity too where a
    CUDA device is present). Yields the profiler."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    profiler = torch.profiler.profile(activities=activities, record_shapes=record_shapes)
    profiler.start()
    try:
        yield profiler
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        profiler.stop()
        profiler.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _leaf(carry):
    """The first tensor of a (nested) carry."""
    import torch

    if torch.is_tensor(carry):
        return carry
    if isinstance(carry, dict):
        carry = list(carry.values())
    for item in carry:
        leaf = _leaf(item)
        if leaf is not None:
            return leaf
    return None


def time_scan(step, init, n_iterations=50, repeats=3):
    """
    Milliseconds an iteration of ``carry -> carry`` function ``step``: each
    of ``repeats`` timed runs chains ``n_iterations`` calls (each depends on
    the previous, so nothing can be skipped), after one untimed run that
    warms up (builds and caches kernels). On a CUDA carry the time is CUDA
    events' on the current stream, else :func:`time.perf_counter`'s after
    the last result is read. Returns the ``repeats`` times, a list.
    """
    import torch

    leaf = _leaf(init)
    on_card = leaf is not None and leaf.is_cuda

    def once():
        carry = init
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(int(n_iterations)):
                carry = step(carry)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / n_iterations
        t0 = time.perf_counter()
        for _ in range(int(n_iterations)):
            carry = step(carry)
        out = _leaf(carry)
        if out is not None:
            out.cpu()
        return (time.perf_counter() - t0) * 1e3 / n_iterations

    once()
    return [once() for _ in range(int(repeats))]


#: Aten ops that allocate or re-view memory without moving it.
_MOVES_NOTHING = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                  "detach", "alias", "lift_fresh", "_local_scalar_dense")


def bytes_accessed(fn, *args, **kwargs):
    """
    The bytes ``fn(*args, **kwargs)`` moves: for each aten op it runs, its
    tensor operands' and results' bytes (views and allocations move none),
    plus, for each hand-kernel launch, the bytes its wrapper declares (the
    planes it reads once and writes once). Returns ``(total, detail)``,
    ``detail`` a dict of the aten ops' bytes (``"aten"``) and each
    kernel's declared bytes by name.
    """
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from slmsuite_torch.ops import cuda_compressed, cuda_fft

    def nbytes(tree):
        leaves, _ = tree_flatten(tree)
        return sum(t.numel() * t.element_size() for t in leaves if torch.is_tensor(t))

    class _Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if not (getattr(func, "is_view", False) or name in _MOVES_NOTHING):
                _Count.total += nbytes((args, kwargs)) + nbytes(out)
            return out

    before = {m: dict(m.BYTES) for m in (cuda_fft, cuda_compressed)}
    with _Count():
        fn(*args, **kwargs)
    detail = {"aten": _Count.total}
    for module, counts in before.items():
        for name, value in module.BYTES.items():
            if value != counts[name]:
                detail[name] = value - counts[name]
    return sum(detail.values()), detail
