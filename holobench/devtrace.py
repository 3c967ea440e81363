"""Reduction of a ``torch.profiler`` chrome trace to what the per-layer
metrics read: the device's operations (kernels, copies, sets) with their
times, whether PyTorch launched each kernel (under an ``aten::`` operator)
or the program's own code did, the union of the device's busy intervals,
the benchmark's spans, and the idle gaps by the span the host was in."""

import bisect
import json

#: Trace categories of device work.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: The benchmark's spans, recorded with ``record_function``.
SPANS = ("request", "prep", "optimize", "readback")


def _union(intervals):
    """Merged, sorted ``[(start, end), ...]`` of possibly overlapping ones."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _inside(merged, t):
    """Whether ``t`` lies in one of the sorted disjoint ``merged``."""
    i = bisect.bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def reduce_trace(path):
    """The record of a chrome trace at ``path``: ``device_ops`` (``[name,
    cat, start_us, dur_us, glue]``, glue for a kernel launched inside an
    ``aten::`` operator, so by PyTorch, cuFFT included), ``spans`` (``name
    -> [(start_us, end_us), ...]``), ``window_us`` (first request start to
    last request end), ``busy_us`` (the union of device work inside it)
    and ``idle_gaps`` (``span name -> idle us`` inside it)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    aten, launches, spans, device = {}, {}, {name: [] for name in SPANS}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        start, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        args = e.get("args") or {}
        if cat == "cpu_op" and name.startswith("aten::"):
            aten.setdefault(e.get("tid"), []).append((start, start + dur))
        elif cat == "cuda_runtime" and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), start)
        elif cat == "user_annotation" and name in spans:
            spans[name].append((start, start + dur))
        elif cat in DEVICE_CATS:
            device.append((name, cat, start, dur, args.get("correlation")))
    aten = {tid: _union(v) for tid, v in aten.items()}

    ops = []
    for name, cat, start, dur, corr in device:
        launch = launches.get(corr)
        glue = (cat == "kernel" and launch is not None
                and _inside(aten.get(launch[0], []), launch[1]))
        ops.append([name, cat, start, dur, glue])

    requests = sorted(spans["request"])
    if not requests:
        return {"device_ops": [], "spans": spans, "window_us": 0.0, "busy_us": 0.0,
                "idle_gaps": {}}
    w0, w1 = requests[0][0], requests[-1][1]
    inside = [op for op in ops if op[2] < w1 and op[2] + op[3] > w0]
    busy = _union((max(op[2], w0), min(op[2] + op[3], w1)) for op in inside)
    busy_us = sum(end - start for start, end in busy)

    gaps, t = [], w0
    for start, end in busy:
        if start > t:
            gaps.append((t, start))
        t = max(t, end)
    if t < w1:
        gaps.append((t, w1))
    by_span = {}
    for g0, g1 in gaps:
        # Split each gap over the spans the host was in, innermost first.
        left = g1 - g0
        for name in ("prep", "optimize", "readback"):
            for s0, s1 in spans[name]:
                overlap = min(g1, s1) - max(g0, s0)
                if overlap > 0:
                    by_span[name] = by_span.get(name, 0.0) + overlap
                    left -= overlap
        if left > 0:
            by_span["between requests"] = by_span.get("between requests", 0.0) + left
    return {"device_ops": inside, "spans": spans, "window_us": w1 - w0,
            "busy_us": busy_us, "idle_gaps": by_span}


def top_ops(ops, k=10):
    """The ``k`` device operations that took most time, ``[[name, s], ...]``."""
    total = {}
    for name, _, _, dur, _ in ops:
        total[name] = total.get(name, 0.0) + dur
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:k]
    return [[name, us * 1e-6] for name, us in ranked]
