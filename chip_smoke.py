#!/usr/bin/env python3
"""
Smoke run of the PyTorch / CUDA port (``slmsuite_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it fails (exit code != 0, no result line) when
there is no card or the port is missing. In order:

1. device check; 2. environment (torch, CUDA, nvcc, card, power limit);
3. build of the CUDA kernels from ``slmsuite_torch/csrc``;
4. each kernel against its plain PyTorch version on the card, at 2048^2
   and 256x512, for every fusable rule, scalar and array amplitude,
   stats on and off;
5. the slice: ``SpotHologram.make_rectangular_array((2048, 2048), 32x32,
   pitch 30, "knm")`` optimized with WGS-Kim for 50 iterations, through
   the kernels (launch counts checked) and through the plain step
   functions, and the 64^2 WGS-Kim golden replay;
6. timing with CUDA events: each kernel and its plain version at 2048^2,
   and ``spot_array_wgs(N=2048).run(n)`` for n = 50 and 200 through the
   kernels and through the plain (cuFFT) step;
7. a ``torch.profiler`` breakdown of ``spot_array_wgs(N=2048).run(50)``:
   device time, device busy share and device launches per iteration.

It prints the per-kernel JSON line, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``. Longer logs go to
``chiprun_out/``.
"""

import contextlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

#: Acceptance tolerances, kernel against plain version on the card.
CARRY_RTOL = 1e-4          # carry planes: max |diff| / max |plain|
WEIGHT_ATOL, WEIGHT_RTOL = 1e-4, 1e-3   # weights, phasors, sums, maxs
PSI_P99 = 2e-3             # psi: 99th percentile of the wrapped difference
SLICE_ATOL = 1e-3          # final efficiency / uniformity, kernel vs plain
GOLDEN_STATS_ATOL, GOLDEN_STATS_RTOL, GOLDEN_PHASE_ATOL = 1e-4, 1e-3, 5e-3

#: Kernel name -> the TPU kernel it replaces.
KERNELS = {
    "carry_entry": "slmsuite_tpu/ops/pallas_fft.py:1184",
    "cols_wgs_roundtrip": "slmsuite_tpu/ops/pallas_fft.py:797",
    "rows_normfwd": "slmsuite_tpu/ops/pallas_fft.py:835",
    "carry_exit": "slmsuite_tpu/ops/pallas_fft.py:1216",
}
SOURCE = "slmsuite_torch/csrc/wgs_carry.cu"
RULES = ("kim", "leonardo", "wu", "tanh")


def log(*args):
    print(*args, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("No CUDA device: chip_smoke.py needs a GPU.")
    return torch.device("cuda")


def nvidia_smi_line():
    done = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return done.stdout.strip().splitlines()[0]


def phase_environment():
    from slmsuite_torch.ops import cuda_fft

    nvcc = subprocess.run(
        [cuda_fft._nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    log(f"nvcc: {nvcc}")
    log(f"device: {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {nvidia_smi_line()}")


def phase_build():
    from slmsuite_torch.ops import cuda_fft

    path, seconds, build_log = cuda_fft.build()
    cuda_fft._lib()
    log(f"build: {path.relative_to(ROOT)} in {seconds:.1f} s")
    OUT.mkdir(exist_ok=True)
    (OUT / "ptxas.log").write_text(build_log)
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def spot_target(H, W, n=12, seed=5):
    rng = np.random.default_rng(seed)
    t = np.zeros((H, W), np.float32)
    t[rng.integers(0, H, n), rng.integers(0, W, n)] = 1.0
    return t / np.sqrt((t**2).sum())


def step_inputs(shape, amp_kind, rule, stats_on, device, seed=0):
    """Inputs of one carry step at ``shape`` (numpy seeded, then on the card)."""
    from slmsuite_torch.ops import fft

    H, W = shape
    rng = np.random.default_rng(seed)
    psi = rng.uniform(-4 * np.pi, 4 * np.pi, shape).astype(np.float32)
    target = spot_target(H, W)
    pff = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
    amp_plane = (0.5 + rng.uniform(0, 1, shape)).astype(np.float32)
    amp = 1.0 / np.sqrt(H * W) if amp_kind == "scalar" else amp_plane

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    post = 1.0 / np.sqrt(H * W) * (amp if amp_kind == "scalar" else 1.0)
    scal = fft.pack_scalars(dict(
        post=post, inv_prev_norm=0.7, apply_update=1.0,
        use_theta=float(stats_on), feedback_exponent=0.8, feedback_factor=0.2,
        inv_fnorm=1.3, inv_tsum=1.0 / float((target**2).sum()), inv_fsum=0.9,
    ), device)
    kim = rule == "kim"
    return dict(
        psi=dev(psi), amp=amp if amp_kind == "scalar" else dev(amp),
        weights=dev(target), target=dev(target),
        mask=dev((target != 0).astype(np.float32)) if stats_on else None,
        phase_ff=(dev(np.cos(pff)), dev(np.sin(pff))) if kim else None,
        scal=scal, rule=rule, kim=kim, stats_on=stats_on,
    )


def rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def max_abs(got, ref):
    return float((got - ref).abs().max())


def check_close(name, got, ref, atol, rtol):
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} values off, max |diff| {float(err.max()):.3e}"
        )
    return float(err.max())


def psi_p99(got, ref):
    diff = torch.remainder(got - ref + np.pi, 2 * np.pi) - np.pi
    return float(torch.quantile(diff.abs().flatten().double(), 0.99))


def phase_parity(device):
    """Every kernel against its plain version; returns the 2048^2 errors."""
    from slmsuite_torch.ops import cuda_fft, fft

    worst = dict.fromkeys(KERNELS, 0.0)
    lines = []
    for shape in ((2048, 2048), (256, 512)):
        for amp_kind in ("scalar", "array"):
            x = step_inputs(shape, amp_kind, "kim", True, device)
            gr, gi = cuda_fft.carry_entry(x["psi"], x["amp"])
            pr, pi_ = fft._wgs_carry_entry(x["psi"], x["amp"])
            e = max(rel_err(gr, pr), rel_err(gi, pi_))
            assert e <= CARRY_RTOL, f"carry_entry {shape} {amp_kind}: {e:.3e}"
            lines.append(f"carry_entry {shape} {amp_kind}: rel {e:.3e}")
            if shape == (2048, 2048):
                worst["carry_entry"] = max(worst["carry_entry"],
                                           max_abs(gr, pr), max_abs(gi, pi_))

            psi_k = cuda_fft.carry_exit(pr, pi_)
            psi_p = fft._wgs_carry_exit(pr, pi_)
            e = psi_p99(psi_k, psi_p)
            assert e < PSI_P99, f"carry_exit {shape}: p99 {e:.3e}"
            lines.append(f"carry_exit {shape} {amp_kind}: p99 {e:.3e}")
            if shape == (2048, 2048):
                wrapped = torch.remainder(psi_k - psi_p + np.pi, 2 * np.pi) - np.pi
                worst["carry_exit"] = max(worst["carry_exit"], float(wrapped.abs().max()))

            for rule in RULES:
                for stats_on in (True, False):
                    x = step_inputs(shape, amp_kind, rule, stats_on, device)
                    args = (pr, pi_, x["weights"], x["target"], x["mask"],
                            x["phase_ff"], x["scal"])
                    kw = dict(rule=rule, kim=x["kim"], stats_on=stats_on)
                    got = cuda_fft.cols_wgs_roundtrip(*args, **kw)
                    ref = fft._cols_wgs_roundtrip(*args, **kw)
                    tag = f"cols {shape} {amp_kind} {rule} stats={stats_on}"
                    e = max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1]))
                    assert e <= CARRY_RTOL, f"{tag}/h: {e:.3e}"
                    ew = check_close(tag + "/w", got[2], ref[2], WEIGHT_ATOL, WEIGHT_RTOL)
                    if x["kim"]:
                        for k in (0, 1):
                            check_close(tag + "/pff", got[3][k], ref[3][k],
                                        WEIGHT_ATOL, WEIGHT_RTOL)
                    es = check_close(tag + "/sums", got[4], ref[4], WEIGHT_ATOL, WEIGHT_RTOL)
                    em = check_close(tag + "/maxs", got[5], ref[5], WEIGHT_ATOL, WEIGHT_RTOL)
                    lines.append(f"{tag}: h rel {e:.3e} w {ew:.3e} sums {es:.3e} maxs {em:.3e}")
                    if shape == (2048, 2048):
                        worst["cols_wgs_roundtrip"] = max(
                            worst["cols_wgs_roundtrip"], max_abs(got[0], ref[0]),
                            max_abs(got[1], ref[1]), ew,
                        )

                    hr, hi = ref[0], ref[1]
                    rk = cuda_fft.rows_normfwd(hr, hi, x["amp"])
                    rp = fft._rows_normfwd(hr, hi, x["amp"])
                    e = max(rel_err(rk[0], rp[0]), rel_err(rk[1], rp[1]))
                    assert e <= CARRY_RTOL, f"rows {shape} {amp_kind} {rule}: {e:.3e}"
                    if shape == (2048, 2048):
                        worst["rows_normfwd"] = max(worst["rows_normfwd"],
                                                    max_abs(rk[0], rp[0]),
                                                    max_abs(rk[1], rp[1]))
    torch.cuda.synchronize()
    OUT.mkdir(exist_ok=True)
    (OUT / "parity.log").write_text("\n".join(lines) + "\n")
    log(f"parity: {len(lines)} checks passed; 2048^2 max |diff| "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def cuda_ms(fn, n=20, warmup=3):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def phase_kernel_timing(device):
    """Each kernel and its plain version at 2048^2 (WGS-Kim, scalar amp,
    stats on), alternating plain, kernel, kernel, plain."""
    from slmsuite_torch.ops import cuda_fft, fft

    x = step_inputs((2048, 2048), "scalar", "kim", True, device)
    gr, gi = fft._wgs_carry_entry(x["psi"], x["amp"])
    cols_args = (gr, gi, x["weights"], x["target"], x["mask"], x["phase_ff"], x["scal"])
    cases = {
        "carry_entry": (cuda_fft.carry_entry, fft._wgs_carry_entry,
                        (x["psi"], x["amp"]), {}),
        "cols_wgs_roundtrip": (cuda_fft.cols_wgs_roundtrip, fft._cols_wgs_roundtrip,
                               cols_args, dict(rule="kim", kim=True, stats_on=True)),
        "rows_normfwd": (cuda_fft.rows_normfwd, fft._rows_normfwd, (gr, gi, x["amp"]), {}),
        "carry_exit": (cuda_fft.carry_exit, fft._wgs_carry_exit, (gr, gi), {}),
    }
    times = {}
    for name, (kernel, plain, args, kwargs) in cases.items():
        p1 = cuda_ms(lambda: plain(*args, **kwargs))
        k1 = cuda_ms(lambda: kernel(*args, **kwargs))
        k2 = cuda_ms(lambda: kernel(*args, **kwargs))
        p2 = cuda_ms(lambda: plain(*args, **kwargs))
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"time {name} 2048^2: kernel {k1:.4f} {k2:.4f} ms, plain {p1:.4f} {p2:.4f} ms")
    return times


@contextlib.contextmanager
def plain_step_functions():
    """Route the engine's carry calls to the plain PyTorch versions."""
    from slmsuite_torch.ops import fft

    saved = (fft.wgs_carry_entry, fft.wgs_carry_step, fft.wgs_carry_exit)
    fft.wgs_carry_entry = fft._wgs_carry_entry
    fft.wgs_carry_step = fft._wgs_carry_step
    fft.wgs_carry_exit = fft._wgs_carry_exit
    try:
        yield
    finally:
        fft.wgs_carry_entry, fft.wgs_carry_step, fft.wgs_carry_exit = saved


def run_slice(device, seed=0):
    from slmsuite_torch.holography.algorithms import SpotHologram

    holo = SpotHologram.make_rectangular_array(
        (2048, 2048), array_shape=(32, 32), array_pitch=(30, 30), basis="knm",
        device=device,
    )
    rng = np.random.default_rng(seed)
    holo.reset_phase(custom_phase=rng.uniform(-np.pi, np.pi, (2048, 2048)))
    holo.optimize(method="WGS-Kim", maxiter=50, stat_groups=["computational"],
                  verbose=False)
    torch.cuda.synchronize()
    stats = holo.stats["stats"]["computational"]
    return holo, {k: float(stats[k][-1]) for k in ("efficiency", "uniformity")}


def phase_slice(device):
    from slmsuite_torch.ops import cuda_fft

    cuda_fft.reset_launch_counts()
    start = time.perf_counter()
    holo, kernel_stats = run_slice(device)
    seconds = time.perf_counter() - start
    launches = dict(cuda_fft.LAUNCHES)
    log(f"slice (kernels): {kernel_stats} in {seconds:.2f} s, launches {launches}")
    assert launches["carry_entry"] >= 1 and launches["carry_exit"] >= 1, launches
    assert launches["cols_wgs_roundtrip"] == 50 and launches["rows_normfwd"] == 50, launches
    phase = holo.get_phase()
    assert phase.shape == (2048, 2048) and np.isfinite(phase).all()
    for key, value in kernel_stats.items():
        assert np.isfinite(value) and 0 < value <= 1, (key, value)

    cuda_fft.reset_launch_counts()
    with plain_step_functions():
        _, plain_stats = run_slice(device)
    assert sum(cuda_fft.LAUNCHES.values()) == 0, cuda_fft.LAUNCHES
    log(f"slice (plain):   {plain_stats}")
    for key in kernel_stats:
        diff = abs(kernel_stats[key] - plain_stats[key])
        assert diff <= SLICE_ATOL, f"slice {key}: kernel vs plain differ by {diff:.3e}"
    return launches


def phase_golden():
    """The 64^2 WGS-Kim golden replay through the kernels on the card."""
    from slmsuite_torch.holography.algorithms import Hologram, SpotHologram

    golden_dir = ROOT / "tests" / "holography" / "golden"
    spec = importlib.util.spec_from_file_location("golden_configs", golden_dir / "configs.py")
    configs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(configs)
    golden = np.load(golden_dir / "ref_wgs_kim_iter.npz")

    stats, phase = configs.run_config("wgs_kim_iter", Hologram, SpotHologram)
    for key in configs.STAT_KEYS:
        np.testing.assert_allclose(stats[key], golden[key], atol=GOLDEN_STATS_ATOL,
                                   rtol=GOLDEN_STATS_RTOL, err_msg=key)
    dp = phase - golden["phase"]
    dp = np.mod(dp - dp.flat[0] + np.pi, 2 * np.pi) - np.pi
    assert np.abs(dp).max() < GOLDEN_PHASE_ATOL, np.abs(dp).max()
    log(f"golden wgs_kim_iter 64^2: stats and phase within tolerance "
        f"(phase max {np.abs(dp).max():.2e} rad)")


def phase_model_timing(device):
    """ms/iteration of spot_array_wgs(N=2048).run(n), kernels vs plain."""
    from slmsuite_torch.models.engine_models import spot_array_wgs

    model = spot_array_wgs(N=2048, device=device)

    def timed(n):
        model.run(2)  # warm-up
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        model.run(n)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n

    out = {}
    for n in (50, 200):
        with plain_step_functions():
            p1 = timed(n)
        k1 = timed(n)
        k2 = timed(n)
        with plain_step_functions():
            p2 = timed(n)
        out[n] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"spot_array_wgs(2048) run({n}): kernels {k1:.4f} {k2:.4f} ms/iter, "
            f"plain {p1:.4f} {p2:.4f} ms/iter  [{nvidia_smi_line()}]")
    return out


def _union_ms(spans):
    """Total length in ms of the union of ``(start, end)`` spans in us."""
    spans = sorted(spans)
    total, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            total, lo, hi = total + hi - lo, a, b
        else:
            hi = max(hi, b)
    return (total + hi - lo) / 1e3


def phase_profile(device, n=50):
    """Device-time breakdown of ``spot_array_wgs(N=2048).run(n)`` under
    ``torch.profiler``. Only device events (kernels, copies, memsets) are
    counted, never the host-side operator rows that enclose them. The
    busy share is the union of device spans over the host wall time of
    the run, both under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from slmsuite_torch.models.engine_models import spot_array_wgs

    model = spot_array_wgs(N=2048, device=device)
    model.run(5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        model.run(n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    events = [
        e for e in prof.events()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    assert events, "torch.profiler recorded no device events"
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    device_ms = sum(b - a for a, b in spans) / 1e3
    busy_ms = _union_ms(spans)
    log(f"profile spot_array_wgs(2048) run({n}) [{nvidia_smi_line()}]: "
        f"wall {wall_ms:.3f} ms ({wall_ms / n:.4f} ms/iter), device time "
        f"{device_ms:.3f} ms, device busy {busy_ms:.3f} ms (busy share "
        f"{busy_ms / wall_ms:.3f}), {len(events)} device events "
        f"({len(events) / n:.2f} per iteration)")
    per_name = {}
    for e in events:
        us, count = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    for name, (us, count) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"  {us / 1e3:9.3f} ms  {count:5d}  {name[:100]}")


def main():
    device = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_environment()
    phase_build()
    errors = phase_parity(device)
    launches = phase_slice(device)
    phase_golden()
    times = phase_kernel_timing(device)
    phase_model_timing(device)
    phase_profile(device)

    kernels = [
        {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errors[name],
            "ms": times[name][0], "plain_ms": times[name][1],
        }
        for name, replaces in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
