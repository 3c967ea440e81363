"""The benchmark's run of one cell: set-up, a closed loop of one client for
``--seconds``, the comparison with the plain reference, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (its file, under
``holobench/configs``) and a traffic mix (``holobench/traffic/<name>.json``).
The configuration's ``driver`` names the kind: ``holobench/drivers/<kind>.py``
makes and serves the requests, ``holobench/reference/<kind>.py`` is the
plain reference and ``holobench/work/<kind>.py`` counts an iteration's least
work. Each per-layer metric of the cell is ``holobench/metrics/<name>.py``.
Nothing here names a cell, a configuration or a per-layer metric.

A request: the client draws its target from the seed and the request's
index, prepares the hologram (``prep``), runs ``optimize`` and copies the
phase to the host (``readback``); the next request is sent when it is done.
With ``--trace 1`` each of the three ends in a device synchronisation and is
a span, and the profiler records the first few requests of the window.
"""

import argparse
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
OUT = BENCH / "out"
#: Top-level modules that no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "slmsuite_tpu")


class Refused(Exception):
    """A run that cannot be made here (no card, too few cards)."""


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="run the cell on the CPU at its rehearsal shapes (tests only); "
                        "no device metric is written")
    return p.parse_args(argv)


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name, rehearse=False, root=ROOT):
    """``(cell, config, traffic, end_to_end, per_layer)`` of the workload
    ``name``; with ``rehearse``, the ``rehearse`` overrides of the
    configuration and the mix applied."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    if rehearse:
        config = {**config, **config.get("rehearse", {})}
        traffic = {**traffic, **traffic.get("rehearse", {})}
    e2e = [m for m in manifest["end_to_end"] if _applies(m, name)]
    layers = [m for m in manifest["per_layer"] if _applies(m, name)]
    return cell, config, traffic, e2e, layers


def forbidden_modules():
    """The loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Window:
    """The closed loop: requests served one after another, their latencies,
    failures, spans and the outputs of the sampled requests."""

    def __init__(self, client, torch, device, traced, sample):
        self.client, self.torch, self.device = client, torch, device
        self.traced, self.sample = traced, sample
        self.latencies, self.failed, self.kept = [], 0, []
        self.spans_ms = {"prep": [], "optimize": [], "readback": []}

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def _span(self, name, fn, *args):
        if not self.traced:
            return fn(*args)
        start = time.perf_counter()
        with self.torch.profiler.record_function(name):
            out = fn(*args)
            self._sync()
        self.spans_ms[name].append((time.perf_counter() - start) * 1e3)
        return out

    def serve(self, index):
        """One request; returns ``(req, phase)``."""
        client = self.client
        req = client.draw(index)
        self._span("prep", client.prep, req)
        self._span("optimize", client.optimize, req)
        return req, self._span("readback", client.readback, req)

    def run(self, seconds, profile_requests=0, trace_path=None):
        """Serve requests until ``seconds`` have passed since the first was
        sent (and the profiler is done); the last one sent completes.
        Returns the window's seconds, from the first request's start to the
        last one's end. With ``profile_requests``, the profiler warms up on
        the first request and records the next ``profile_requests`` into the
        chrome trace at ``trace_path``."""
        prof = None
        if profile_requests:
            prof = self._profiler(profile_requests, trace_path)
            prof.__enter__()
        t0 = time.perf_counter()
        t_end, index = t0, 0
        try:
            while time.perf_counter() - t0 < seconds or prof is not None:
                start = time.perf_counter()
                try:
                    if self.traced:
                        with self.torch.profiler.record_function("request"):
                            req, phase = self.serve(index)
                    else:
                        req, phase = self.serve(index)
                except Exception:  # A request that fails is counted, and the run goes on.
                    self.failed += 1
                    traceback.print_exc()
                    req = None
                t_end = time.perf_counter()
                if req is not None:
                    self.latencies.append(t_end - start)
                    if index in self.sample:
                        self.kept.append((req, phase, self.client.outputs(req)))
                if prof is not None:
                    prof.step()
                    if index == profile_requests:
                        prof.__exit__(None, None, None)
                        prof = None
                index += 1
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        return t_end - t0

    def _profiler(self, n, path):
        prof = self.torch.profiler
        activities = [prof.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(prof.ProfilerActivity.CUDA)
        # One request to warm the profiler, then n recorded.
        return prof.profile(activities=activities,
                            schedule=prof.schedule(wait=0, warmup=1, active=n, repeat=1),
                            on_trace_ready=lambda p: p.export_chrome_trace(str(path)))


def percentile(values, q):
    return float(np.percentile(np.asarray(values, float), q))


def end_to_end(name, latencies, seconds, peak, setup_s):
    """The value of the end-to-end metric ``name``: ``holograms_per_s``,
    ``request_ms_p<q>`` (the q-th percentile of the window's latencies),
    ``peak_device_gib`` or ``setup_s``; None where the window completed
    nothing."""
    if name == "setup_s":
        return setup_s
    if name == "peak_device_gib":
        return peak / 2**30
    if not latencies:
        return None
    if name == "holograms_per_s":
        return len(latencies) / seconds
    if name.startswith("request_ms_p"):
        return percentile(latencies, float(name[len("request_ms_p"):])) * 1e3
    raise ValueError(f"no end-to-end metric {name!r}")


def card_line():
    """``name, power limit`` of the card, from ``nvidia-smi``."""
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return done.stdout.strip().splitlines()[0] if done.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv, t_start, root=ROOT):
    """One run; ``root`` is the checkout whose ``BENCHMARK.json`` names the
    cell (configuration files are found relative to it)."""
    args = parse(argv)
    cell, config, traffic, e2e, layers = load_cell(args.workload, args.rehearse, root)

    marks = [("start", t_start), ("arguments", time.perf_counter())]
    import torch

    marks.append(("import torch", time.perf_counter()))
    if args.rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: the benchmark runs only on the card")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise Refused(f"{cell['name']} needs {cell['chips']} cards, "
                          f"{torch.cuda.device_count()} found")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)

    kind = config["driver"]
    driver = importlib.import_module(f"holobench.drivers.{kind}")
    reference = importlib.import_module(f"holobench.reference.{kind}")
    work = importlib.import_module(f"holobench.work.{kind}")
    readers = {m["name"]: importlib.import_module(f"holobench.metrics.{m['name']}")
               for m in layers}

    from holobench.drivers import request_rng

    sample_from = int(traffic["sample_from"])
    sample = set(int(i) for i in request_rng(args.seed, -2).choice(
        sample_from, size=min(int(traffic["sample"]), sample_from), replace=False))

    # Set-up: the client, then one request of the cell's own shapes.
    marks.append(("card and modules", time.perf_counter()))
    client = driver.Client(config, traffic, device, args.seed)
    marks.append(("client", time.perf_counter()))
    traced = bool(args.trace)
    Window(client, torch, device, False, ()).serve(-1)
    if device.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("warm-up request", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    print("set-up: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b)
                                 in zip(marks, marks[1:])), file=sys.stderr)

    OUT.mkdir(parents=True, exist_ok=True)
    trace_path = OUT / f"trace-{cell['name']}.json"
    trace_path.unlink(missing_ok=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window = Window(client, torch, device, traced, sample)
    n_prof = int(traffic["trace_requests"]) if traced else 0
    seconds = window.run(args.seconds, profile_requests=n_prof, trace_path=trace_path)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    completed = len(window.latencies)
    iters = int(traffic["iterations"])

    metrics, device_info, breakdown = {}, {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu rehearsal",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(peak),
    }, None
    if not traced:
        for m in e2e:
            metrics[m["name"]] = {"value": end_to_end(m["name"], window.latencies, seconds,
                                                      peak, setup_s), "unit": m["unit"]}
    else:
        from holobench import devtrace
        from holobench.peaks import peaks

        red = devtrace.reduce_trace(trace_path)
        if device.type == "cuda" and not any(op[1] == "kernel" for op in red["device_ops"]):
            raise RuntimeError("the profiler recorded no kernel in the traced requests")
        record = {
            "device_ops": red["device_ops"],
            "busy_s": red["busy_us"] * 1e-6,
            "window_s": red["window_us"] * 1e-6,
            "iterations": n_prof * iters,
            "spans_ms": window.spans_ms,
            "work": work.per_iteration(config, traffic),
            "peaks": peaks(device_info["kind"]) if device.type == "cuda" else None,
        }
        for m in layers:
            value = readers[m["name"]].read(record) if device.type == "cuda" else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = record["busy_s"]
        device_info["window_s"] = record["window_s"]
        breakdown = {
            "device_ops": devtrace.top_ops(red["device_ops"]),
            "idle_gaps": sorted(([k, v * 1e-6] for k, v in red["idle_gaps"].items()),
                                key=lambda kv: -kv[1])[:10],
        }
    if args.rehearse:
        # A CPU run writes no number under a device metric's name.
        metrics = {m["name"]: {"value": None, "unit": m["unit"], "note": "not measured"}
                   for m in (layers if traced else e2e)}

    # The reference, once the program's state is freed.
    kept, failures, latencies = window.kept, window.failed, window.latencies
    client.close()
    del window
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from holobench import judge

    readings = []
    for req, phase, outputs in kept:
        ref = reference.run(client.reference_inputs(req))
        readings.append(judge.compare(phase, outputs, ref))
        del ref
    numbers = judge.worst(readings) if readings else {n: math.nan for n in judge.NUMBERS}
    checked = judge.checks(numbers, config["limits"])
    correct = bool(readings) and judge.passed(checked) and failures == 0

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that the benchmark must not load: {found}")

    print(f"cell {cell['name']} seed {args.seed}: {completed} requests in {seconds:.3f} s, "
          f"{len(readings)} compared; card {card_line() if device.type == 'cuda' else 'none'}",
          file=sys.stderr)
    if completed:
        print("  latency ms: " + ", ".join(f"p{q} {percentile(latencies, q) * 1e3:.3f}"
                                           for q in (50, 80, 90, 95, 100)), file=sys.stderr)
    for name in judge.NUMBERS:
        if name not in checked:
            print(f"  reading {name} {numbers[name]:.6e} (no limit)", file=sys.stderr)
    for name, c in checked.items():
        print(f"check {name} {c['value']:.6e} limit {c['limit']:.6e}", file=sys.stderr)
    line = {"correct": correct, "attempted": completed + failures, "failed": failures,
            "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checked
    print(json.dumps(line))
    return 0
