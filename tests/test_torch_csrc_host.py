"""
The line kernels' CUDA sources (``slmsuite_torch/csrc``) compiled for the
host with a C++20 compiler against a stand-in of the CUDA runtime
(``tests/cuda_host``: a block's threads run as ``std::thread``s that meet
at a ``std::barrier`` in ``__syncthreads``, shared memory is one host
array), then run on the CPU through their C entry points and held against
the kernels' plain PyTorch versions. Where there is no card this holds
the device code itself, not only its model (``test_torch_fft_plan.py``):
the index arithmetic, the pass tables and the launch shapes of every
mixed-line plan (P = 8 and 16; passes of radix 4, 8, 16, 3, 5, 7, 9, 15
and direct sums) and of the power-of-two lines. It runs rows_fft,
cols_fft, carry_entry, carry_exit, rows_normfwd, cols_fwd_polar and
cols_wexp_inv; the kernels with stats (warp shuffles) are compiled, not
run, and so is the cluster code (its inline PTX is dropped).

The sources are rewritten for the host before they compile: the dynamic
shared memory becomes the stand-in's array, inline PTX is dropped, and a
launch ``k<<<grid, block, smem, stream>>>(args)`` becomes
``host_launch(grid, block, smem, stream)(k, args)``. Tolerances are
``chip_smoke.py``'s: planes within 1e-4 of their largest value, psi's
99th-percentile wrapped difference below 2e-3.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from slmsuite_torch.ops import cuda_fft
from slmsuite_torch.ops import fft as TF

HOST = Path(__file__).resolve().parent / "cuda_host"
#: The sources compiled, each as its two units (power-of-two and mixed
#: plans), as cuda_fft.build compiles them for the card.
SOURCES = ("natural_fft.cu", "wgs_carry.cu", "mraf_carry.cu")
RTOL = 1e-4
PSI_P99 = 2e-3
#: Row lengths (the rows of an 8-row plane): every mixed plan's shape of
#: pass list, the real panels' sides, a prime pass of 1021 terms (8168)
#: and two powers of two.
ROW_SIDES = (72, 96, 120, 792, 1080, 1152, 1200, 1272, 1920, 4160, 6144, 8168, 256, 2048)
#: Column lengths (the columns of a plane 8 columns wide).
COL_SIDES = (72, 96, 792, 1080, 1152, 1792, 1920, 4160, 128, 1024)


def _for_host(source):
    """A CUDA source rewritten for the host stand-in."""
    source = source.replace("extern __shared__ float2 sbuf[];", "float2* sbuf = host_shared;")
    source = re.sub(r"asm\s*(volatile)?\s*\((.|\n)*?\);", ";", source)
    return re.sub(r"(\w+)<<<(.*?)>>>\(", r"host_launch(\2)(\1, ", source, flags=re.S)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++)")
    work = tmp_path_factory.mktemp("csrc_host")
    for src in list(cuda_fft._CSRC.glob("*.cu")) + list(cuda_fft._CSRC.glob("*.cuh")):
        (work / src.name).write_text(_for_host(src.read_text()))
    (work / "host_shared.cpp").write_text(
        '#include "cuda_runtime.h"\n'
        'extern "C" { float2 host_shared[227 * 1024 / sizeof(float2)]; }\n')
    flags = [cxx, "-std=c++20", "-O1", "-fPIC", "-pthread", "-w", f"-I{HOST}", f"-I{work}"]
    jobs = [(work / "host_shared.o", [*flags, "-c", str(work / "host_shared.cpp")])]
    for name in SOURCES:
        for unit in (0, 1):
            obj = work / f"{name}.{unit}.o"
            jobs.append((obj, [*flags, f"-DSLM_UNIT_MIXED={unit}", "-x", "c++", "-c",
                               str(work / name)]))
    procs = [(obj, subprocess.Popen([*cmd, "-o", str(obj)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for obj, cmd in jobs]
    failed = []
    for obj, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{obj.name}:\n{out[:4000]}")
    assert not failed, "the sources do not compile for the host:\n" + "\n".join(failed)
    so = work / "liblines_host.so"
    subprocess.run([cxx, "-shared", "-pthread", "-o", str(so), *(str(o) for o, _ in jobs)],
                   check=True)
    handle = ctypes.CDLL(str(so))
    for name, argtypes in cuda_fft._SIGNATURES.items():
        if hasattr(handle, name):
            getattr(handle, name).argtypes = argtypes
            getattr(handle, name).restype = ctypes.c_int
    return handle


def _entry(lib, name, n):
    return getattr(lib, name + ("_mixed" if n & (n - 1) else ""))


def _ptr(a):
    return None if a is None else a.ctypes.data


def _tw(n, inverse):
    return np.ascontiguousarray(cuda_fft._twiddles(n, bool(inverse), "cpu").numpy())


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _psi_p99(got, ref):
    return float(np.percentile(np.abs(np.angle(np.exp(1j * (got - ref)))), 99))


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", ROW_SIDES)
def test_rows_fft_on_the_host(lib, n, inverse):
    H = 8
    xr, xi = _pair((H, n), n)
    yr, yi = np.empty_like(xr), np.empty_like(xr)
    tw = _tw(n, inverse)
    rc = _entry(lib, "slm_rows_fft", n)(_ptr(xr), _ptr(xi), _ptr(yr), _ptr(yi), H, n,
                                        int(inverse), _ptr(tw), 0.5, None)
    assert rc == 0
    ref = TF._rows_fft(*_t(xr, xi), inverse=inverse, scale=0.5)
    assert max(_rel(yr, ref[0]), _rel(yi, ref[1])) <= RTOL


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", COL_SIDES)
def test_cols_fft_on_the_host(lib, n, inverse):
    W = 8
    xr, xi = _pair((n, W), n + 1)
    yr, yi = np.empty_like(xr), np.empty_like(xr)
    tw = _tw(n, inverse)
    rc = _entry(lib, "slm_cols_fft", n)(_ptr(xr), _ptr(xi), _ptr(yr), _ptr(yi), 1, n, W,
                                        int(inverse), _ptr(tw), 0.5, None)
    assert rc == 0
    ref = TF._cols_fft(*_t(xr, xi), inverse=inverse, scale=0.5)
    assert max(_rel(yr, ref[0]), _rel(yi, ref[1])) <= RTOL


@pytest.mark.parametrize("n", (96, 1080, 1152, 1272, 1920, 2048))
def test_carry_kernels_on_the_host(lib, n):
    """carry_entry (an amplitude plane), carry_exit and rows_normfwd (the
    two transforms of one block, with the barrier between them)."""
    H = 8
    rng = np.random.default_rng(n + 2)
    psi = rng.uniform(-4 * np.pi, 4 * np.pi, (H, n)).astype(np.float32)
    amp = (0.5 + rng.uniform(0, 1, (H, n))).astype(np.float32)
    gr, gi = np.empty_like(psi), np.empty_like(psi)
    rc = _entry(lib, "slm_carry_entry", n)(_ptr(psi), _ptr(amp), _ptr(gr), _ptr(gi), 1, H, n,
                                           _ptr(_tw(n, False)), None)
    assert rc == 0
    ref = TF._wgs_carry_entry(*_t(psi, amp))
    assert max(_rel(gr, ref[0]), _rel(gi, ref[1])) <= RTOL
    pr, pi_ = (r.numpy() for r in ref)
    out = np.empty_like(psi)
    rc = _entry(lib, "slm_carry_exit", n)(_ptr(pr), _ptr(pi_), _ptr(out), H, n,
                                          _ptr(_tw(n, True)), None)
    assert rc == 0
    assert _psi_p99(out, TF._wgs_carry_exit(*_t(pr, pi_)).numpy()) < PSI_P99
    hr, hi = _pair((H, n), n + 3)
    rc = _entry(lib, "slm_rows_normfwd", n)(_ptr(hr), _ptr(hi), None, _ptr(gr), _ptr(gi), H, n,
                                            _ptr(_tw(n, False)), _ptr(_tw(n, True)), None)
    assert rc == 0
    ref = TF._rows_normfwd(*_t(hr, hi), 1.0)
    assert max(_rel(gr, ref[0]), _rel(gi, ref[1])) <= RTOL


@pytest.mark.parametrize("n", (72, 1080, 1152, 1920, 1024))
def test_cols_polar_and_wexp_on_the_host(lib, n):
    W = 8
    xr, xi = _pair((n, W), n + 4)
    amp, theta = np.empty_like(xr), np.empty_like(xr)
    rc = _entry(lib, "slm_cols_fwd_polar", n)(_ptr(xr), _ptr(xi), _ptr(amp), _ptr(theta), 1, n,
                                              W, _ptr(_tw(n, False)), 0.25, None)
    assert rc == 0
    ref = TF._cols_fwd_polar(*_t(xr, xi), 0.25)
    assert _rel(amp, ref[0]) <= RTOL
    seen = ref[0].numpy() > 1e-3 * float(ref[0].max())
    assert np.abs(np.angle(np.exp(1j * (theta - ref[1].numpy()))))[seen].max() < 1e-3
    w, phi = np.abs(xr), xi * np.float32(np.pi)
    yr, yi = np.empty_like(xr), np.empty_like(xr)
    rc = _entry(lib, "slm_cols_wexp_inv", n)(_ptr(w), _ptr(phi), _ptr(yr), _ptr(yi), 1, n, W,
                                             _ptr(_tw(n, True)), None)
    assert rc == 0
    ref = TF._cols_wexp_inv(*_t(w, phi))
    assert max(_rel(yr, ref[0]), _rel(yi, ref[1])) <= RTOL
