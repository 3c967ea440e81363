#!/usr/bin/env python3
"""
Smoke run of the PyTorch / CUDA port (``slmsuite_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it fails (exit code != 0, no result line) when
there is no card or the port is missing. In order:

1. device check; 2. environment (torch, CUDA, nvcc, card, power limit);
3. build of the CUDA kernels from ``slmsuite_torch/csrc`` (one ``nvcc``
   per source, in parallel);
4. each kernel against its plain PyTorch version on the card: the carry
   kernels at 2048^2 and 256x512 for every fusable rule, scalar and array
   amplitude, stats on and off; the natural-path kernels and the composed
   dispatchers at 2048^2 and 256x512, and the canvas transforms on a
   2048^2 canvas holding a 1024^2 window; the two MRAF kernels at 2048^2
   and 256x512 for Leonardo and Kim, zero weights on and off, stats on
   and off, scalar and array amplitude, and the composed ``ifft2_phase``,
   ``wgs_fused_step`` and ``mraf_fused_step``;
5. the paths, each driven with the launch counts set to 0 just before it:
   - the fused slice: ``SpotHologram.make_rectangular_array((2048, 2048),
     32x32, pitch 30, "knm")``, WGS-Kim, 50 iterations;
   - N1, the natural full-fuse geometry: the same array, WGS-Nogrette with
     ``computational_spot`` feedback and both stat groups, 50 iterations;
   - N2, BASELINE config 1 at 2x padding: a 10x10 array at pitch 60 on a
     2048^2 farfield over a 1024^2 SLM, GS then WGS-Kim, 50 iterations
     each;
   - M1, BASELINE config 3 through ``Hologram``: the 2048^2 ring target of
     ``image_mraf``, WGS-Leonardo with ``mraf_factor`` 0.5 (the MRAF carry
     loop), 50 iterations; M2, the same with WGS-Kim and ``zero_factor``
     0.1; M3, the same with GS (the natural MRAF step);
   each through the kernels (loop launches checked, launches after the
   loop counted apart; the kernels line reports both together) and
   through the plain versions (final efficiency and uniformity within
   1e-3);
6. the 64^2 goldens ``wgs_kim_iter``, ``gs``, ``wgs_nogrette``,
   ``gs_padded``, ``spots_kim``, ``gs_mraf`` and ``wgs_leonardo_mraf_zero``
   replayed through the kernels;
7. timing with CUDA events: each kernel, its plain version and, where one
   PyTorch call computes the same function, that call, at 2048^2; the
   composed ``fft2``/``ifft2`` against ``torch.fft.fft2``/``ifft2``, and
   the composed ``wexp_ifft2``, ``ifft2_phase`` (with ``torch.fft.ifft2``),
   ``wgs_fused_step`` and ``mraf_fused_step`` against their plain
   versions; and ms/iteration of ``spot_array_wgs(2048)`` (WGS-Kim,
   fused), ``spot_array_wgs(2048, method="WGS-Nogrette")`` (natural), the
   N2 GS loop and ``image_mraf(2048)`` (WGS-Leonardo, the MRAF carry loop;
   GS, the natural MRAF step), through the kernels and through the plain
   versions;
8. ``torch.profiler`` breakdowns of the fused, the natural (WGS-Nogrette),
   the N2 GS and the ``image_mraf(2048)`` loops: device time, device busy
   share, device launches per iteration.

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
CARRY_RTOL = 1e-4          # carry and transformed planes: max |diff| / max |plain|
WEIGHT_ATOL, WEIGHT_RTOL = 1e-4, 1e-3   # weights, phasors, sums, maxs
THETA_ATOL = 1e-3          # arg F, where |F| > 1e-3 max |F|
PSI_P99 = 2e-3             # psi: 99th percentile of the wrapped difference
SLICE_ATOL = 1e-3          # final efficiency / uniformity, kernel vs plain
GOLDEN_STATS_ATOL, GOLDEN_STATS_RTOL, GOLDEN_PHASE_ATOL = 1e-4, 1e-3, 5e-3
GOLDENS = ("wgs_kim_iter", "gs", "wgs_nogrette", "gs_padded", "spots_kim", "gs_mraf",
           "wgs_leonardo_mraf_zero")

#: Kernel name -> (source, the TPU kernel it replaces, the path whose
#: launches the kernels line reports).
KERNELS = {
    "carry_entry": ("wgs_carry.cu", "slmsuite_tpu/ops/pallas_fft.py:1184", "fused"),
    "cols_wgs_roundtrip": ("wgs_carry.cu", "slmsuite_tpu/ops/pallas_fft.py:797", "fused"),
    "rows_normfwd": ("wgs_carry.cu", "slmsuite_tpu/ops/pallas_fft.py:835", "fused"),
    "carry_exit": ("wgs_carry.cu", "slmsuite_tpu/ops/pallas_fft.py:1216", "fused"),
    "rows_fft": ("natural_fft.cu", "slmsuite_tpu/ops/pallas_fft.py:373", "N2"),
    "cols_fft": ("natural_fft.cu", "slmsuite_tpu/ops/pallas_fft.py:385", "N2"),
    "cols_fwd_polar": ("natural_fft.cu", "slmsuite_tpu/ops/pallas_fft.py:559", "N1"),
    "cols_wexp_inv": ("natural_fft.cu", "slmsuite_tpu/ops/pallas_fft.py:1885", "N1"),
    "cols_mraf_fwd": ("mraf_carry.cu", "slmsuite_tpu/ops/pallas_fft.py:1619", "M1"),
    "cols_mraf_mix_inv": ("mraf_carry.cu", "slmsuite_tpu/ops/pallas_fft.py:1664", "M1"),
}
RULES = ("kim", "leonardo", "wu", "tanh")
#: Shapes of the MRAF parity phase; the first is the main path's.
MRAF_SHAPES = ((2048, 2048), (256, 512))

#: The H100 SXM's published peaks (NVIDIA data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


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
    if not build_log:
        return  # already built: the log of that build stays
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
        mraf_factor=0.4, zero_factor=0.3,
    ), device)
    kim = rule == "kim"
    # MRAF regions: signal at the spots, noise or zero at random elsewhere.
    mcode = np.where(target > 0, 1.0, np.where(rng.uniform(size=shape) < 0.5, 2.0, 0.0))
    return dict(
        psi=dev(psi), amp=amp if amp_kind == "scalar" else dev(amp),
        weights=dev(target), target=dev(target), mcode=dev(mcode.astype(np.float32)),
        zw=dev((1e-3 * rng.standard_normal((2, *shape))).astype(np.float32)),
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
    """Every carry kernel against its plain version; returns the 2048^2
    errors."""
    from slmsuite_torch.ops import cuda_fft, fft

    worst = dict.fromkeys(("carry_entry", "cols_wgs_roundtrip", "rows_normfwd",
                           "carry_exit"), 0.0)
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


def phase_mraf_parity(device):
    """The two MRAF kernels and the MRAF/WGS compositions against their
    plain versions; returns the kernels' max |diff| at the first shape."""
    from slmsuite_torch.ops import cuda_fft, fft

    worst = dict.fromkeys(("cols_mraf_fwd", "cols_mraf_mix_inv"), 0.0)
    lines = []
    for shape in MRAF_SHAPES:
        for amp_kind in ("scalar", "array"):
            for rule in ("leonardo", "kim"):
                for stats_on in (True, False):
                    x = step_inputs(shape, amp_kind, rule, stats_on, device)
                    gr, gi = fft._wgs_carry_entry(x["psi"], x["amp"])
                    fwd = (gr, gi, x["weights"] * 1.3, x["target"], x["mask"], x["scal"])
                    got = cuda_fft.cols_mraf_fwd(*fwd, rule=rule, stats_on=stats_on)
                    ref = fft._cols_mraf_fwd(*fwd, rule=rule, stats_on=stats_on)
                    tag = f"cols_mraf_fwd {shape} {amp_kind} {rule} stats={stats_on}"
                    e = max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1]))
                    assert e <= CARRY_RTOL, f"{tag}/F: {e:.3e}"
                    ew = check_close(tag + "/uw", got[2], ref[2], WEIGHT_ATOL, WEIGHT_RTOL)
                    es = check_close(tag + "/sums", got[3], ref[3], WEIGHT_ATOL, WEIGHT_RTOL)
                    em = check_close(tag + "/maxs", got[4], ref[4], WEIGHT_ATOL, WEIGHT_RTOL)
                    lines.append(f"{tag}: F rel {e:.3e} uw {ew:.3e} sums {es:.3e} maxs {em:.3e}")
                    if shape == MRAF_SHAPES[0]:
                        worst["cols_mraf_fwd"] = max(worst["cols_mraf_fwd"], ew,
                                                     max_abs(got[0], ref[0]),
                                                     max_abs(got[1], ref[1]))
                    for zero in (True, False):
                        mix = (ref[0], ref[1], ref[2], x["mcode"], x["phase_ff"],
                               x["zw"] if zero else None, ref[3], x["scal"])
                        kw = dict(kim=x["kim"], zero=zero)
                        got_m = cuda_fft.cols_mraf_mix_inv(*mix, **kw)
                        ref_m = fft._cols_mraf_mix_inv(*mix, **kw)
                        tag_m = f"cols_mraf_mix_inv {shape} {amp_kind} {rule} zero={zero}"
                        e = max(rel_err(got_m[0], ref_m[0]), rel_err(got_m[1], ref_m[1]))
                        assert e <= CARRY_RTOL, f"{tag_m}/h: {e:.3e}"
                        pairs = list(zip(got_m[2], ref_m[2])) if x["kim"] else []
                        pairs += list(zip(got_m[3], ref_m[3])) if zero else []
                        ez = max([check_close(tag_m + "/pff, zw", g, r, WEIGHT_ATOL,
                                              WEIGHT_RTOL) for g, r in pairs] or [0.0])
                        lines.append(f"{tag_m} (after stats={stats_on}): h rel {e:.3e} "
                                     f"pff, zw {ez:.3e}")
                        if shape == MRAF_SHAPES[0]:
                            worst["cols_mraf_mix_inv"] = max(
                                worst["cols_mraf_mix_inv"], ez,
                                max_abs(got_m[0], ref_m[0]), max_abs(got_m[1], ref_m[1]))
            # The compositions: ifft2_phase, and the psi -> psi steps with
            # Kim's angle store.
            x = step_inputs(shape, amp_kind, "kim", True, device)
            xr, xi = random_pair(shape, device)
            e = psi_p99(fft.ifft2_phase(xr, xi), fft._ifft2_phase(xr, xi))
            assert e < PSI_P99, f"ifft2_phase {shape}: p99 {e:.3e}"
            lines.append(f"ifft2_phase {shape}: p99 {e:.3e}")
            angle = torch.atan2(x["phase_ff"][1], x["phase_ff"][0])
            args = (x["psi"], x["amp"], x["weights"] * 1.3, angle, x["target"], x["mask"])
            for name, extra in (("wgs_fused_step", ()), ("mraf_fused_step", (x["mcode"],))):
                kw = dict(rule="kim", kim=True, stats_on=True)
                got = getattr(fft, name)(*args, *extra, x["scal"], **kw)
                ref = getattr(fft, "_" + name)(*args, *extra, x["scal"], **kw)
                tag = f"{name} {shape} {amp_kind} kim"
                e = psi_p99(got[0], ref[0])
                assert e < PSI_P99, f"{tag} psi: p99 {e:.3e}"
                ew = check_close(tag + "/w", got[1], ref[1], WEIGHT_ATOL, WEIGHT_RTOL)
                amp_ff = fft._fft2_polar_from_phase(x["psi"], x["amp"])[0]
                et = theta_err(got[2], ref[2], amp_ff)
                assert et < THETA_ATOL, f"{tag} phase_ff: {et:.3e}"
                es = check_close(tag + "/sums", got[3], ref[3], WEIGHT_ATOL, WEIGHT_RTOL)
                lines.append(f"{tag}: psi p99 {e:.3e} w {ew:.3e} phase_ff {et:.3e} "
                             f"sums {es:.3e}")
    torch.cuda.synchronize()
    OUT.mkdir(exist_ok=True)
    (OUT / "parity_mraf.log").write_text("\n".join(lines) + "\n")
    log(f"MRAF parity: {len(lines)} checks passed; {MRAF_SHAPES[0]} max |diff| "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def wrapped_abs(a, b):
    return (torch.remainder(a - b + np.pi, 2 * np.pi) - np.pi).abs()


def theta_err(got, ref, amp):
    """Largest wrapped |arg difference| where |F| > 1e-3 max |F|."""
    on = amp > 1e-3 * amp.max()
    return float(wrapped_abs(got, ref)[on].max())


def theta_yardstick(device, lines, seeds=range(3, 8)):
    """What THETA_ATOL is held against: ``cols_fwd_polar``'s arg F and its
    plain version's (cuFFT), each against a float64 column FFT of the same
    2048^2 input, on several seeded inputs; and the kernel against the
    plain version with no |F| mask, where the angle of a round-off-sized
    value is arbitrary."""
    from slmsuite_torch.ops import cuda_fft, fft

    worst = dict(kernel=0.0, plain=0.0, kernel_vs_plain=0.0, unmasked=0.0)
    for seed in seeds:
        xr, xi = random_pair((2048, 2048), device, seed)
        _, th_k = cuda_fft.cols_fwd_polar(xr, xi, 1.0)
        amp_p, th_p = fft._cols_fwd_polar(xr, xi, 1.0)
        truth = torch.fft.fft(torch.complex(xr.double(), xi.double()), dim=-2)
        amp_t, th_t = truth.abs(), torch.angle(truth)
        errs = dict(kernel=theta_err(th_k.double(), th_t, amp_t),
                    plain=theta_err(th_p.double(), th_t, amp_t),
                    kernel_vs_plain=theta_err(th_k, th_p, amp_p),
                    unmasked=float(wrapped_abs(th_k, th_p).max()))
        lines.append(f"arg F yardstick seed {seed}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()))
        worst = {k: max(worst[k], errs[k]) for k in worst}
    log(f"arg F yardstick, cols_fwd_polar 2048^2, seeds {seeds.start}-{seeds.stop - 1}, "
        f"where |F| > 1e-3 max |F|: kernel vs float64 {worst['kernel']:.3e}, plain vs "
        f"float64 {worst['plain']:.3e}, kernel vs plain {worst['kernel_vs_plain']:.3e} "
        f"(limit {THETA_ATOL}); kernel vs plain unmasked {worst['unmasked']:.3e} rad")
    assert worst["kernel"] < THETA_ATOL and worst["plain"] < THETA_ATOL, worst


def random_pair(shape, device, seed=3):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
                 for _ in range(2))


def phase_natural_parity(device):
    """The natural-path kernels and the composed dispatchers against their
    plain versions; returns the kernels' 2048^2 max |diff|."""
    from slmsuite_torch.ops import cuda_fft, fft, propagation

    worst = dict.fromkeys(("rows_fft", "cols_fft", "cols_fwd_polar", "cols_wexp_inv"), 0.0)
    lines = []

    def planes(tag, got, ref, kernel=None):
        e = max(rel_err(g, r) for g, r in zip(got, ref))
        assert e <= CARRY_RTOL, f"{tag}: rel {e:.3e}"
        lines.append(f"{tag}: rel {e:.3e}")
        if kernel and tag.startswith(f"{kernel} (2048, 2048)"):
            worst[kernel] = max(worst[kernel], *(max_abs(g, r) for g, r in zip(got, ref)))

    def polar(tag, got, ref, kernel=None):
        planes(tag + " |F|", got[:1], ref[:1], kernel)
        e = theta_err(got[1], ref[1], ref[0])
        assert e < THETA_ATOL, f"{tag} arg F: {e:.3e}"
        lines.append(f"{tag} arg F: max {e:.3e}")
        if kernel and tag.startswith(f"{kernel} (2048, 2048)"):
            worst[kernel] = max(worst[kernel], e)

    def phase(tag, got, ref):
        e = psi_p99(got, ref)
        assert e < PSI_P99, f"{tag}: p99 {e:.3e}"
        lines.append(f"{tag}: p99 {e:.3e}")

    for shape in ((2048, 2048), (256, 512)):
        xr, xi = random_pair(shape, device)
        for inverse in (False, True):
            for name in ("rows_fft", "cols_fft"):
                planes(f"{name} {shape} inverse={inverse}",
                       getattr(cuda_fft, name)(xr, xi, inverse=inverse, scale=0.5),
                       getattr(fft, "_" + name)(xr, xi, inverse=inverse, scale=0.5), name)
        polar(f"cols_fwd_polar {shape}", cuda_fft.cols_fwd_polar(xr, xi, 0.25),
              fft._cols_fwd_polar(xr, xi, 0.25), "cols_fwd_polar")
        w, phi = xr.abs(), xi * np.pi
        planes(f"cols_wexp_inv {shape}", cuda_fft.cols_wexp_inv(w, phi),
               fft._cols_wexp_inv(w, phi), "cols_wexp_inv")
        for amp_kind in ("scalar", "array"):
            x = step_inputs(shape, amp_kind, "kim", True, device)
            polar(f"fft2_polar_from_phase {shape} {amp_kind}",
                  fft.fft2_polar_from_phase(x["psi"], x["amp"]),
                  fft._fft2_polar_from_phase(x["psi"], x["amp"]))
        amp_ff, theta = fft._fft2_polar_from_phase(x["psi"], x["amp"])
        phase(f"wexp_ifft2_phase {shape}", fft.wexp_ifft2_phase(w, theta),
              fft._wexp_ifft2_phase(w, theta))
        planes(f"wexp_ifft2 {shape}", fft.wexp_ifft2(w, theta), fft._wexp_ifft2(w, theta))

    # A 2048^2 canvas holding a 1024^2 window, as in the padded loop.
    rng = np.random.default_rng(4)
    window = torch.from_numpy(rng.uniform(-np.pi, np.pi, (1024, 1024)).astype(np.float32))
    for amp_kind in ("scalar", "array"):
        amp = (1.0 / 1024 if amp_kind == "scalar" else
               torch.from_numpy(rng.uniform(0.5, 1, (1024, 1024)).astype(np.float32)).to(device))
        nr, ni = propagation.build_folded_nearfield(window.to(device), amp, (2048, 2048))
        tag = f"canvas 2048^2 / 1024^2 {amp_kind}"
        planes(f"fft2 {tag}", fft.fft2(nr, ni), fft._fft2(nr, ni))
        polar(f"fft2_polar {tag}", fft.fft2_polar(nr, ni), fft._fft2_polar(nr, ni))
        fr, fi = fft._fft2(nr, ni)
        planes(f"ifft2 {tag}", fft.ifft2(fr, fi), fft._ifft2(fr, fi))
        amp_c, theta_c = fft._fft2_polar(nr, ni)
        planes(f"wexp_ifft2 {tag}", fft.wexp_ifft2(amp_c, theta_c),
               fft._wexp_ifft2(amp_c, theta_c))
    theta_yardstick(device, lines)
    torch.cuda.synchronize()
    OUT.mkdir(exist_ok=True)
    (OUT / "parity_natural.log").write_text("\n".join(lines) + "\n")
    log(f"natural parity: {len(lines)} checks passed; 2048^2 max |diff| "
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


def bound(shape, planes_moved, line_ffts):
    """``(bound_ms, bound_by)`` of an (n, n) kernel: the larger of the
    bytes moved (each input plane read once, each output written once)
    over the HBM rate and the FFT flops (5 n log2 n per line, n lines per
    pass, ``line_ffts`` passes) over the f32 peak."""
    H, W = shape
    assert H == W, shape
    byte_ms = planes_moved * 4 * H * W / HBM_BYTES_PER_S * 1e3
    flop_ms = line_ffts * 5 * H * W * np.log2(H) / F32_FLOP_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= flop_ms else (flop_ms, "operations")


def interleaved(name, kernel, plain, library=None, bound_of=None):
    """Time ``kernel`` and ``plain`` in turns (plain, kernel, kernel,
    plain) and ``library`` once between them; log and return
    ``{kernel, plain, library, bound, bound_by}`` in ms."""
    p1 = cuda_ms(plain)
    k1 = cuda_ms(kernel)
    lib = cuda_ms(library) if library is not None else None
    k2 = cuda_ms(kernel)
    p2 = cuda_ms(plain)
    bound_ms, bound_by = bound_of if bound_of is not None else (None, None)
    log(f"time {name} 2048^2: kernel {k1:.4f} {k2:.4f} ms, plain {p1:.4f} {p2:.4f} ms"
        + (f", library {lib:.4f} ms" if lib is not None else "")
        + (f", bound {bound_ms:.4f} ms ({bound_by})" if bound_ms is not None else ""))
    return dict(kernel=(k1 + k2) / 2, plain=(p1 + p2) / 2, library=lib,
                bound=bound_ms, bound_by=bound_by)


def phase_kernel_timing(device):
    """Each kernel and its plain version at 2048^2 (carry kernels:
    WGS-Kim, scalar amp, stats on), and the library calls."""
    from slmsuite_torch.ops import cuda_fft, fft

    shape = (2048, 2048)
    x = step_inputs(shape, "scalar", "kim", True, device)
    gr, gi = fft._wgs_carry_entry(x["psi"], x["amp"])
    cols_args = (gr, gi, x["weights"], x["target"], x["mask"], x["phase_ff"], x["scal"])
    cols_kw = dict(rule="kim", kim=True, stats_on=True)
    xr, xi = random_pair(shape, device)
    w, phi = xr.abs(), xi * np.pi
    z = torch.complex(xr, xi)
    t = {}
    t["carry_entry"] = interleaved(
        "carry_entry", lambda: cuda_fft.carry_entry(x["psi"], x["amp"]),
        lambda: fft._wgs_carry_entry(x["psi"], x["amp"]), bound_of=bound(shape, 3, 1))
    t["cols_wgs_roundtrip"] = interleaved(
        "cols_wgs_roundtrip", lambda: cuda_fft.cols_wgs_roundtrip(*cols_args, **cols_kw),
        lambda: fft._cols_wgs_roundtrip(*cols_args, **cols_kw), bound_of=bound(shape, 12, 2))
    t["rows_normfwd"] = interleaved(
        "rows_normfwd", lambda: cuda_fft.rows_normfwd(gr, gi, x["amp"]),
        lambda: fft._rows_normfwd(gr, gi, x["amp"]), bound_of=bound(shape, 4, 2))
    t["carry_exit"] = interleaved(
        "carry_exit", lambda: cuda_fft.carry_exit(gr, gi),
        lambda: fft._wgs_carry_exit(gr, gi), bound_of=bound(shape, 3, 1))
    t["rows_fft"] = interleaved(
        "rows_fft", lambda: cuda_fft.rows_fft(xr, xi, inverse=False),
        lambda: fft._rows_fft(xr, xi, inverse=False),
        library=lambda: torch.fft.fft(z, dim=-1), bound_of=bound(shape, 4, 1))
    t["cols_fft"] = interleaved(
        "cols_fft", lambda: cuda_fft.cols_fft(xr, xi, inverse=False),
        lambda: fft._cols_fft(xr, xi, inverse=False),
        library=lambda: torch.fft.fft(z, dim=0), bound_of=bound(shape, 4, 1))
    t["cols_fwd_polar"] = interleaved(
        "cols_fwd_polar", lambda: cuda_fft.cols_fwd_polar(xr, xi, 1.0),
        lambda: fft._cols_fwd_polar(xr, xi, 1.0), bound_of=bound(shape, 4, 1))
    t["cols_wexp_inv"] = interleaved(
        "cols_wexp_inv", lambda: cuda_fft.cols_wexp_inv(w, phi),
        lambda: fft._cols_wexp_inv(w, phi), bound_of=bound(shape, 4, 1))
    # The composed transforms (two launches each) against torch.fft.
    interleaved("fft2 (rows_fft + cols_fft)", lambda: cuda_fft.fft2(xr, xi),
                lambda: fft._fft2(xr, xi), library=lambda: torch.fft.fft2(z, norm="ortho"),
                bound_of=bound(shape, 8, 2))
    interleaved("ifft2 (cols_fft + rows_fft)", lambda: cuda_fft.ifft2(xr, xi),
                lambda: fft._ifft2(xr, xi), library=lambda: torch.fft.ifft2(z, norm="ortho"),
                bound_of=bound(shape, 8, 2))
    # The padded loop's backward half: w and phi in, the pair out.
    interleaved("wexp_ifft2 (cols_wexp_inv + rows_fft)", lambda: cuda_fft.wexp_ifft2(w, phi),
                lambda: fft._wexp_ifft2(w, phi), bound_of=bound(shape, 4, 2))

    # MRAF: the M1 variants (WGS-Leonardo, stats on, no zero weights), and
    # the mix kernel's largest variant (Kim, zero weights).
    m = step_inputs(shape, "scalar", "leonardo", True, device)
    fwd = (gr, gi, m["weights"], m["target"], m["mask"], m["scal"])
    fr, fi, uw, sums, _ = fft._cols_mraf_fwd(*fwd, rule="leonardo", stats_on=True)
    mix = (fr, fi, uw, m["mcode"], None, None, sums, m["scal"])
    mix_kim = (fr, fi, uw, m["mcode"], x["phase_ff"], m["zw"], sums, m["scal"])
    t["cols_mraf_fwd"] = interleaved(
        "cols_mraf_fwd", lambda: cuda_fft.cols_mraf_fwd(*fwd, rule="leonardo", stats_on=True),
        lambda: fft._cols_mraf_fwd(*fwd, rule="leonardo", stats_on=True),
        bound_of=bound(shape, 8, 1))
    t["cols_mraf_mix_inv"] = interleaved(
        "cols_mraf_mix_inv", lambda: cuda_fft.cols_mraf_mix_inv(*mix, kim=False, zero=False),
        lambda: fft._cols_mraf_mix_inv(*mix, kim=False, zero=False),
        bound_of=bound(shape, 6, 1))
    interleaved("cols_mraf_mix_inv (Kim, zero weights)",
                lambda: cuda_fft.cols_mraf_mix_inv(*mix_kim, kim=True, zero=True),
                lambda: fft._cols_mraf_mix_inv(*mix_kim, kim=True, zero=True),
                bound_of=bound(shape, 14, 1))
    # The compositions: arg ifft2 (the GS-MRAF backward half), and the two
    # psi -> psi steps (WGS-Kim and MRAF WGS-Kim, stats on).
    interleaved("ifft2_phase (cols_fft + carry_exit)", lambda: cuda_fft.ifft2_phase(xr, xi),
                lambda: fft._ifft2_phase(xr, xi),
                library=lambda: torch.fft.ifft2(z, norm="ortho"), bound_of=bound(shape, 3, 2))
    angle = torch.atan2(x["phase_ff"][1], x["phase_ff"][0])
    args = (x["psi"], x["amp"], x["weights"], angle, x["target"], x["mask"])
    kw = dict(rule="kim", kim=True, stats_on=True)
    interleaved("wgs_fused_step (carry_entry + cols_wgs_roundtrip + carry_exit)",
                lambda: cuda_fft.wgs_fused_step(*args, x["scal"], **kw),
                lambda: fft._wgs_fused_step(*args, x["scal"], **kw), bound_of=bound(shape, 8, 4))
    interleaved("mraf_fused_step (carry_entry + cols_mraf_fwd + cols_mraf_mix_inv + carry_exit)",
                lambda: cuda_fft.mraf_fused_step(*args, m["mcode"], x["scal"], **kw),
                lambda: fft._mraf_fused_step(*args, m["mcode"], x["scal"], **kw),
                bound_of=bound(shape, 9, 4))
    return t


#: The dispatchers that the plain runs swap for their plain versions.
DISPATCHERS = ("wgs_carry_entry", "wgs_carry_step", "wgs_carry_exit", "mraf_carry_step",
               "fft2", "ifft2", "ifft2_phase", "fft2_polar", "fft2_polar_from_phase",
               "wexp_ifft2", "wexp_ifft2_phase")


@contextlib.contextmanager
def plain_step_functions():
    """Route the engine's and the propagation's transforms to the plain
    PyTorch versions."""
    from slmsuite_torch.ops import fft

    saved = {name: getattr(fft, name) for name in DISPATCHERS}
    for name in DISPATCHERS:
        setattr(fft, name, getattr(fft, "_" + name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(fft, name, fn)


def spot_array(device, array_shape, array_pitch, slm_shape=None, seed=0):
    from slmsuite_torch.holography.algorithms import SpotHologram

    kwargs = {} if slm_shape is None else dict(slm_shape=slm_shape)
    holo = SpotHologram.make_rectangular_array(
        (2048, 2048), array_shape=array_shape, array_pitch=array_pitch, basis="knm",
        device=device, **kwargs,
    )
    rng = np.random.default_rng(seed)
    holo.reset_phase(custom_phase=rng.uniform(-np.pi, np.pi, holo.slm_shape))
    return holo


def image_hologram(device):
    """``Hologram`` on the 2048^2 ``image_mraf`` ring target (nan noise
    region), from a seeded phase."""
    from slmsuite_torch.holography.algorithms import Hologram
    from slmsuite_torch.models.engine_models import image_mraf_target

    holo = Hologram(target=image_mraf_target(2048), device=device)
    rng = np.random.default_rng(0)
    holo.reset_phase(custom_phase=rng.uniform(-np.pi, np.pi, (2048, 2048)))
    return holo


def drive(make, optimize):
    """Run ``optimize(holo)`` on a fresh ``make()`` with the launch counts
    set to 0 just before it. Returns ``(holo, final computational
    efficiency and uniformity, loop launches, launches after the loop)``:
    the counts are read when ``_populate_results`` starts."""
    from slmsuite_torch.ops import cuda_fft

    holo = make()
    populate = holo._populate_results
    at_populate = {}

    def counted_populate():
        at_populate.update(cuda_fft.LAUNCHES)
        populate()

    holo._populate_results = counted_populate
    cuda_fft.reset_launch_counts()
    optimize(holo)
    torch.cuda.synchronize()
    after = {k: v - at_populate[k] for k, v in cuda_fft.LAUNCHES.items() if v - at_populate[k]}
    loop = {k: v for k, v in at_populate.items() if v}
    stats = holo.stats["stats"]["computational"]
    return holo, {k: float(stats[k][-1]) for k in ("efficiency", "uniformity")}, loop, after


def run_path(label, make, optimize, expect):
    """One path through the kernels (loop launches must equal ``expect``)
    and through the plain versions (no launch; final efficiency and
    uniformity within SLICE_ATOL). Returns the path's launches, in the
    loop and after it."""
    from slmsuite_torch.ops import cuda_fft

    start = time.perf_counter()
    holo, kernel_stats, loop, after = drive(make, optimize)
    seconds = time.perf_counter() - start
    log(f"{label} (kernels): {kernel_stats} in {seconds:.2f} s; loop launches {loop}; "
        f"after the loop {after}")
    assert loop == expect, (label, loop, expect)
    phase = holo.get_phase()
    assert phase.shape == tuple(holo.slm_shape) and np.isfinite(phase).all()
    for key, value in kernel_stats.items():
        assert np.isfinite(value) and 0 < value <= 1, (label, key, value)
    with plain_step_functions():
        _, plain_stats, plain_loop, plain_after = drive(make, optimize)
    assert not plain_loop and not plain_after, (plain_loop, plain_after)
    log(f"{label} (plain):   {plain_stats}")
    for key in kernel_stats:
        diff = abs(kernel_stats[key] - plain_stats[key])
        assert diff <= SLICE_ATOL, f"{label} {key}: kernel vs plain differ by {diff:.3e}"
    return {k: loop.get(k, 0) + after.get(k, 0) for k in {*loop, *after}}


def phase_paths(device):
    """The fused slice, N1 and N2; returns each path's loop launches."""
    n = 50
    fused = run_path(
        "fused slice WGS-Kim 2048^2",
        lambda: spot_array(device, (32, 32), (30, 30)),
        lambda h: h.optimize(method="WGS-Kim", maxiter=n, stat_groups=["computational"],
                             verbose=False),
        dict(carry_entry=1, cols_wgs_roundtrip=n, rows_normfwd=n, carry_exit=1),
    )
    n1 = run_path(
        "N1 WGS-Nogrette computational_spot 2048^2",
        lambda: spot_array(device, (32, 32), (30, 30)),
        lambda h: h.optimize(method="WGS-Nogrette", maxiter=n, feedback="computational_spot",
                             stat_groups=["computational", "computational_spot"],
                             verbose=False),
        dict(carry_entry=n, cols_fwd_polar=n, cols_wexp_inv=n, carry_exit=n),
    )
    n2 = {}
    for method in ("GS", "WGS-Kim"):
        n2[method] = run_path(
            f"N2 {method} 2048^2 canvas / 1024^2 SLM",
            lambda: spot_array(device, (10, 10), (60, 60), slm_shape=(1024, 1024)),
            lambda h, m=method: h.optimize(method=m, maxiter=n,
                                           stat_groups=["computational"], verbose=False),
            dict(rows_fft=2 * n, cols_fwd_polar=n, cols_wexp_inv=n),
        )
    mraf = dict(carry_entry=1, cols_mraf_fwd=n, cols_mraf_mix_inv=n, rows_normfwd=n,
                carry_exit=1)
    m1 = run_path(
        "M1 MRAF WGS-Leonardo image 2048^2",
        lambda: image_hologram(device),
        lambda h: h.optimize(method="WGS-Leonardo", maxiter=n, mraf_factor=0.5,
                             stat_groups=["computational"], verbose=False),
        mraf,
    )
    run_path(
        "M2 MRAF WGS-Kim zero_factor image 2048^2",
        lambda: image_hologram(device),
        lambda h: h.optimize(method="WGS-Kim", maxiter=n, mraf_factor=0.5, zero_factor=0.1,
                             stat_groups=["computational"], verbose=False),
        mraf,
    )
    m3 = run_path(
        "M3 MRAF GS image 2048^2",
        lambda: image_hologram(device),
        lambda h: h.optimize(method="GS", maxiter=n, mraf_factor=0.5,
                             stat_groups=["computational"], verbose=False),
        dict(carry_entry=n, cols_fwd_polar=n, cols_fft=n, carry_exit=n),
    )
    return {"fused": fused, "N1": n1, "N2": n2["GS"], "M1": m1, "M3": m3}


def phase_golden():
    """The 64^2 goldens replayed through the kernels on the card."""
    from slmsuite_torch.holography.algorithms import Hologram, SpotHologram
    from slmsuite_torch.ops import cuda_fft

    golden_dir = ROOT / "tests" / "holography" / "golden"
    spec = importlib.util.spec_from_file_location("golden_configs", golden_dir / "configs.py")
    configs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(configs)
    for name in GOLDENS:
        golden = np.load(golden_dir / f"ref_{name}.npz")
        cuda_fft.reset_launch_counts()
        stats, phase = configs.run_config(name, Hologram, SpotHologram)
        launched = sum(cuda_fft.LAUNCHES.values())
        assert launched > 0, f"golden {name} launched no kernel"
        for key in configs.STAT_KEYS:
            np.testing.assert_allclose(stats[key], golden[key], atol=GOLDEN_STATS_ATOL,
                                       rtol=GOLDEN_STATS_RTOL, err_msg=f"{name}/{key}")
        dp = phase - golden["phase"]
        dp = np.mod(dp - dp.flat[0] + np.pi, 2 * np.pi) - np.pi
        assert np.abs(dp).max() < GOLDEN_PHASE_ATOL, (name, np.abs(dp).max())
        std_diff = np.abs(stats["std_err"] - golden["std_err"]).max()
        log(f"golden {name}: stats and phase within tolerance (phase max "
            f"{np.abs(dp).max():.2e} rad, std_err max |diff| {std_diff:.2e}, "
            f"{launched} kernel launches)")


def engine_loop(holo, method):
    """The engine inputs of ``holo`` for ``method`` with computational
    stats, and a function that runs ``n`` iterations from them."""
    from slmsuite_torch.ops import engine

    holo._update_flags(method, False, None, ["computational"])
    config = holo._build_config()
    consts = holo._build_consts(config)
    state = holo._build_state(config)
    return lambda n: engine.run_gs(config, state, consts, n)


def phase_model_timing(device, n=50):
    """ms/iteration of the fused, the natural and the MRAF loops at
    2048^2, through the kernels and through the plain versions, in turns."""
    from slmsuite_torch.models.engine_models import image_mraf, spot_array_wgs

    loops = {
        "spot_array_wgs(2048) WGS-Kim fused": spot_array_wgs(N=2048, device=device).run,
        "spot_array_wgs(2048) WGS-Nogrette natural": spot_array_wgs(
            N=2048, method="WGS-Nogrette", device=device).run,
        "N2 GS 2048^2 canvas / 1024^2 SLM": engine_loop(
            spot_array(device, (10, 10), (60, 60), slm_shape=(1024, 1024)), "GS"),
        "image_mraf(2048) WGS-Leonardo MRAF carry": image_mraf(N=2048, device=device).run,
        "image_mraf(2048) GS natural MRAF": image_mraf(N=2048, method="GS",
                                                       device=device).run,
    }

    def timed(run):
        run(2)  # warm-up
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(n)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n

    out = {}
    for label, run in loops.items():
        with plain_step_functions():
            p1 = timed(run)
        k1 = timed(run)
        k2 = timed(run)
        with plain_step_functions():
            p2 = timed(run)
        out[label] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"{label} run({n}): kernels {k1:.4f} {k2:.4f} ms/iter, "
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


def phase_profile(device, label, run, n=50):
    """Device-time breakdown of ``run(n)`` under ``torch.profiler``. Only
    device events (kernels, copies, memsets) are counted, never the
    host-side operator rows that enclose them. The busy share is the
    union of device spans over the host wall time of the run, both under
    the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run(5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run(n)
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
    log(f"profile {label} run({n}) [{nvidia_smi_line()}]: "
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
    from slmsuite_torch.models.engine_models import image_mraf, spot_array_wgs

    device = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_environment()
    phase_build()
    errors = phase_parity(device)
    errors.update(phase_natural_parity(device))
    errors.update(phase_mraf_parity(device))
    paths = phase_paths(device)
    phase_golden()
    times = phase_kernel_timing(device)
    phase_model_timing(device)
    phase_profile(device, "spot_array_wgs(2048) WGS-Kim fused",
                  spot_array_wgs(N=2048, device=device).run)
    phase_profile(device, "spot_array_wgs(2048) WGS-Nogrette natural",
                  spot_array_wgs(N=2048, method="WGS-Nogrette", device=device).run)
    phase_profile(device, "N2 GS 2048^2 canvas / 1024^2 SLM", engine_loop(
        spot_array(device, (10, 10), (60, 60), slm_shape=(1024, 1024)), "GS"))
    phase_profile(device, "image_mraf(2048) WGS-Leonardo MRAF carry",
                  image_mraf(N=2048, device=device).run)

    kernels = []
    for name, (source, replaces, path) in KERNELS.items():
        launches = paths[path].get(name, 0)
        assert launches > 0, f"{name} was not launched on the {path} path"
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"slmsuite_torch/csrc/{source}",
            "replaces": replaces, "path": path, "launches": launches,
            "max_abs_err": errors[name], "ms": t["kernel"], "plain_ms": t["plain"],
            "bound_ms": t["bound"], "bound_us": t["bound"] * 1e3, "bound_by": t["bound_by"],
            "library_ms": t["library"],
        })
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
