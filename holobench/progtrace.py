"""The program's own spans in a traced run's chrome trace.

``slmsuite_torch.misc.profile.recording()`` makes each span of the port
(``hologram.init``, ``compressed.basis``, ``gs.iter``, ...) a
``user_annotation`` event of a profiled window, on the clock of the
device's kernels and copies. From such a trace this module gives, over the
window of the profiled requests (the benchmark's ``request`` spans, as in
``holobench.devtrace``):

- for each program span name, how many spans it had, their host time, and
  the device operations they launched: an operation belongs to a span when
  its launch (the ``cuda_runtime`` event of the same correlation) lies
  inside the span on the span's thread, whenever the device ran it;
- the device's idle time by the innermost program span the requests' host
  thread was in, the rest ``outside the program``; the two add up to
  ``devtrace.reduce_trace``'s idle time.

    python -m holobench.progtrace <trace.json>

from the root of a checkout prints that split and each span's device time.
"""

import bisect
import json
import sys

from holobench import devtrace

#: The port's spans (``slmsuite_torch.misc.profile``).
PROGRAM_SPANS = ("hologram.init", "hologram.reset", "compressed.basis", "hologram.reset_phase",
                 "hologram.optimize", "gs.setup", "gs.loop", "gs.iter", "gs.finalize",
                 "hologram.get_phase")
#: Where an idle gap falls when the host was in no program span.
OUTSIDE = "outside the program"


def _innermost(spans):
    """``[(start, end, name), ...]``, sorted and disjoint: the innermost of
    the properly nested ``spans`` (``(start, end, name)``) at each time."""
    segments, stack = [], []
    events = sorted(spans, key=lambda s: (s[0], -s[1]))

    def close_until(t):
        # Close every open span that ends by t, each leaving its parent on top.
        nonlocal cursor
        while stack and stack[-1][1] <= t:
            start, end, name = stack.pop()
            if end > cursor:
                segments.append((cursor, end, name))
                cursor = end

    cursor = float("-inf")
    for start, end, name in events:
        close_until(start)
        if stack and start > cursor:
            segments.append((cursor, start, stack[-1][2]))
        cursor = max(cursor, start)
        stack.append((start, end, name))
    close_until(float("inf"))
    return segments


def _overlap(intervals, lo, hi):
    """Total length of the sorted disjoint ``intervals`` inside ``[lo, hi]``."""
    return sum(max(0.0, min(hi, b) - max(lo, a)) for a, b in intervals)


def reduce_program(path):
    """The program's spans in the chrome trace at ``path``: ``{"requests",
    "window_us", "idle_us", "idle_by_span": {name or OUTSIDE: us}, "spans":
    {name: {"count", "host_us", "device_us", "ops", "idle_us"}}}``, each
    over the profiled requests' window. ``device_us`` is the union of the
    device operations launched inside the spans of that name (their
    children's included), ``idle_us`` the device's idle time inside them."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    requests, program, launches, device = [], [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        start, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        args = e.get("args") or {}
        if cat == "user_annotation" and name == "request":
            requests.append((start, start + dur, e.get("tid")))
        elif cat == "user_annotation" and name in PROGRAM_SPANS:
            program.append((start, start + dur, name, e.get("tid")))
        elif cat == "cuda_runtime" and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), start)
        elif cat in devtrace.DEVICE_CATS:
            device.append((start, start + dur, args.get("correlation")))
    if not requests:
        return {"requests": 0, "window_us": 0.0, "idle_us": 0.0, "idle_by_span": {},
                "spans": {}}
    requests.sort()
    w0, w1, host = requests[0][0], requests[-1][1], requests[0][2]
    program = [s for s in program if s[0] >= w0 and s[1] <= w1]
    device = [d for d in device if d[0] < w1 and d[1] > w0]

    busy = devtrace._union((max(a, w0), min(b, w1)) for a, b, _ in device)
    gaps, t = [], w0
    for start, end in busy:
        if start > t:
            gaps.append((t, start))
        t = max(t, end)
    if t < w1:
        gaps.append((t, w1))

    idle_by_span = {}
    segments = _innermost([(a, b, name) for a, b, name, tid in program if tid == host])
    starts = [s[0] for s in segments]
    for g0, g1 in gaps:
        left = g1 - g0
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        while i < len(segments) and segments[i][0] < g1:
            a, b, name = segments[i]
            overlap = min(g1, b) - max(g0, a)
            if overlap > 0:
                idle_by_span[name] = idle_by_span.get(name, 0.0) + overlap
                left -= overlap
            i += 1
        if left > 0:
            idle_by_span[OUTSIDE] = idle_by_span.get(OUTSIDE, 0.0) + left

    spans = {}
    for name in sorted({s[2] for s in program}):
        mine = [(a, b, tid) for a, b, n, tid in program if n == name]
        by_thread = {}
        for a, b, tid in mine:
            by_thread.setdefault(tid, []).append((a, b))
        by_thread = {tid: devtrace._union(v) for tid, v in by_thread.items()}
        launched = []
        for start, end, corr in device:
            launch = launches.get(corr)
            if launch is not None and devtrace._inside(by_thread.get(launch[0], []), launch[1]):
                launched.append((start, end))
        spans[name] = {
            "count": len(mine),
            "host_us": sum(b - a for a, b, _ in mine),
            "device_us": sum(b - a for a, b in devtrace._union(launched)),
            "ops": len(launched),
            "idle_us": sum(_overlap(gaps, a, b)
                           for a, b in devtrace._union((a, b) for a, b, _ in mine)),
        }
    return {"requests": len(requests), "window_us": w1 - w0,
            "idle_us": sum(b - a for a, b in gaps), "idle_by_span": idle_by_span,
            "spans": spans}


def main(argv):
    if len(argv) != 1:
        print("usage: python -m holobench.progtrace <trace.json>", file=sys.stderr)
        return 2
    red = reduce_program(argv[0])
    n = max(red["requests"], 1)
    print(f"{red['requests']} profiled requests, window {red['window_us'] / 1e3:.3f} ms, "
          f"device idle {red['idle_us'] / 1e3:.3f} ms")
    print("device idle by innermost program span (ms, ms a request):")
    for name, us in sorted(red["idle_by_span"].items(), key=lambda kv: -kv[1]):
        print(f"  {name:<22} {us / 1e3:10.3f} {us / 1e3 / n:10.3f}")
    print("spans (count; host ms, device ms of what they launched, ops, device idle ms inside):")
    for name, s in red["spans"].items():
        print(f"  {name:<22} {s['count']:5d} {s['host_us'] / 1e3:10.3f} "
              f"{s['device_us'] / 1e3:10.3f} {s['ops']:7d} {s['idle_us'] / 1e3:10.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
