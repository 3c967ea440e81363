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
- :func:`recording`, :func:`span`, :func:`spanned` and :func:`count`: the
  operator's view of one call's spans and transfers. The program marks its
  layer boundaries with :func:`span` (or :func:`spanned` on a whole
  function) and counts where data crosses between the host and a device
  with :func:`count`. Both do nothing until :func:`recording` is entered:
  :func:`span` then returns one shared null context after a single check
  of a module-level flag, and :func:`count` returns. Inside
  ``with recording() as rec:`` each span is kept in memory (its name, the
  index of the enclosing span of its thread, its ``time.perf_counter_ns()``
  start and end, its thread) and is also a
  :func:`torch.profiler.record_function` range, so that in a profiled
  window it is a ``user_annotation`` event of the Chrome trace, on the
  clock of the device's kernels and copies. No span synchronises the
  device. ``rec.result()`` gives ``{"spans", "counters", "launches"}``,
  ``launches`` the kernels each wrapper launched during the recording
  (the difference of the wrappers' ``LAUNCHES``).

  The spans of the compressed hologram's path: ``hologram.init``,
  ``hologram.reset``, ``compressed.basis``, ``hologram.reset_phase``,
  ``hologram.optimize``, ``gs.setup`` (the engine's configuration,
  constants and state, with their uploads), ``gs.loop`` (an engine run:
  its self time is the entry and exit transforms), ``gs.iter`` (one
  iteration), ``gs.finalize`` (the packed download) and
  ``hologram.get_phase``; ``ops/engine.py``'s loops give every other
  hologram ``gs.loop`` and ``gs.iter``. The counters: ``h2d_bytes`` (bytes
  copied from the host to a device) and ``syncs`` (each place the host
  waits for device data), counted by the hologram modules' upload and
  download helpers: every transfer of the compressed hologram's path, and
  the planes' of every hologram.
"""

import contextlib
import functools
import os
import threading
import time

__all__ = ["trace", "time_scan", "bytes_accessed", "recording", "span", "spanned", "count"]

#: The open :class:`Recorder`, or None: the one flag :func:`span` and
#: :func:`count` read.
_RECORDER = None
#: What :func:`span` returns while nothing records.
_NULL_SPAN = contextlib.nullcontext()
#: Held while a :func:`recording` is open.
_OPEN = threading.Lock()


class Recorder:
    """The spans and counters of one :func:`recording`."""

    def __init__(self):
        self.spans = []
        self.counters = {}
        self._lock = threading.Lock()
        self._stacks = threading.local()
        self._launches_at_start = _launch_counts()
        self._launches = None

    def _stack(self):
        stack = getattr(self._stacks, "open", None)
        if stack is None:
            stack = self._stacks.open = []
        return stack

    def _launches_since_start(self):
        start = self._launches_at_start
        return {name: n - start.get(name, 0)
                for name, n in _launch_counts().items() if n != start.get(name, 0)}

    def _close(self):
        self._launches = self._launches_since_start()

    def result(self):
        """``{"spans": [{"name", "parent", "start_ns", "end_ns", "thread"},
        ...], "counters": {key: n}, "launches": {wrapper: n}}``: ``parent``
        the index in ``spans`` of the enclosing span of the same thread
        (None at the top), ``end_ns`` None while the span is open,
        ``launches`` the nonzero launches since the recording began (to its
        end once it has ended), by kernel wrapper."""
        launches = self._launches if self._launches is not None else self._launches_since_start()
        with self._lock:
            return {"spans": [dict(s) for s in self.spans], "counters": dict(self.counters),
                    "launches": launches}


def _launch_counts():
    """Every kernel wrapper's launches so far, by name."""
    from slmsuite_torch.ops import cuda_compressed, cuda_fft

    return {**cuda_fft.LAUNCHES, **cuda_compressed.LAUNCHES}


class _Span:
    """One open span of a :class:`Recorder` (see :func:`span`)."""

    __slots__ = ("recorder", "name", "entry", "annotation")

    def __init__(self, recorder, name):
        self.recorder, self.name = recorder, name

    def __enter__(self):
        import torch

        rec = self.recorder
        stack = rec._stack()
        self.entry = {"name": self.name, "parent": stack[-1] if stack else None,
                      "start_ns": time.perf_counter_ns(), "end_ns": None,
                      "thread": threading.get_ident()}
        with rec._lock:
            stack.append(len(rec.spans))
            rec.spans.append(self.entry)
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        self.annotation.__exit__(*exc)
        self.entry["end_ns"] = time.perf_counter_ns()
        self.recorder._stack().pop()
        return False


def span(name):
    """A context that records the block as the span ``name`` while a
    :func:`recording` is open, and does nothing otherwise (it is then one
    shared null context)."""
    if _RECORDER is None:
        return _NULL_SPAN
    return _Span(_RECORDER, name)


def spanned(name):
    """Decorator: each call of the function is the span ``name``
    (:func:`span`)."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(key, n=1):
    """Add ``n`` to the counter ``key`` of the open :func:`recording`; does
    nothing while none is open."""
    rec = _RECORDER
    if rec is None:
        return
    with rec._lock:
        rec.counters[key] = rec.counters.get(key, 0) + n


@contextlib.contextmanager
def recording():
    """Record the program's spans and counters inside the block; yields the
    :class:`Recorder`, whose ``result()`` holds them. One recording at a
    time: entering a second while one is open raises ``RuntimeError``."""
    global _RECORDER
    if not _OPEN.acquire(blocking=False):
        raise RuntimeError("a recording is already open")
    rec = None
    try:
        rec = _RECORDER = Recorder()
        yield rec
    finally:
        _RECORDER = None
        _OPEN.release()
        if rec is not None:
            rec._close()


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
