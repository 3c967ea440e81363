"""
The compressed kernels' CUDA source (``slmsuite_torch/csrc/compressed.cu``)
compiled for the host with a C++20 compiler against the stand-in of the
CUDA runtime in ``tests/cuda_host`` (a block's threads as ``std::thread``s
meeting at a ``std::barrier``, shared memory one host array, a cp.async
copy a plain copy), then run on the CPU through its C entry points and
held against the plain PyTorch versions in ``ops/compressed.py``. Where
there is no card this holds the device code of the wide kernels (past 16
Zernike terms) itself: their staging ring, the index arithmetic of their
pixels, spots and term groups, n2f's spot groups and its partials as
``spot_reduce`` reads them. Sizes: every term count the wide kernels
instantiate differently at (17: five groups, one term in the last; 21;
28: seven whole groups; 44: the last compile-time count, one spot a lane;
48: the count at run time), spot counts that leave pad spots (1, 17, 97)
and pixel counts with tail pixels (3000, 5000); and past one staged
buffer of spots: 600 at 21 terms (f2n's ring turns over three buffers,
n2f's spot columns fill a block and a second block of spots follows) and
300 at 48 terms (two buffers of 160 spots at the run-time group count). Tolerance: ``CMP_RTOL``
of ``chip_smoke.py``, 1e-4 of the largest value.
"""

import ctypes
import itertools
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from slmsuite_torch.ops import compressed as C
from slmsuite_torch.ops import cuda_compressed, cuda_fft

HOST = Path(__file__).resolve().parent / "cuda_host"
CMP_RTOL = 1e-4
TERMS = (17, 21, 28, 44, 48)
SPOTS = (1, 17, 97)
PIXELS = (3000, 5000)
#: (D, N, P) past one staged buffer of spots.
RING = ((21, 600, 3000), (48, 300, 3000))


def _for_host(source):
    """The CUDA source rewritten for the host stand-in: the dynamic shared
    memory is the stand-in's array, inline PTX is dropped, and a launch
    ``k<<<grid, block, smem, stream>>>(args)`` becomes ``host_launch(grid,
    block, smem, stream)(k, args)``."""
    source = source.replace("extern __shared__ float4 smem4[];",
                            "float4* smem4 = reinterpret_cast<float4*>(host_shared);")
    source = re.sub(r"asm\s*(volatile)?\s*\((.|\n)*?\);", ";", source)
    return re.sub(r"(\w+(?:<[\w, ]+>)?)<<<(.*?)>>>\(", r"host_launch(\2)(\1, ", source,
                  flags=re.S)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++)")
    work = tmp_path_factory.mktemp("csrc_host_compressed")
    src = work / "compressed.cpp"
    src.write_text(_for_host((cuda_fft._CSRC / "compressed.cu").read_text()))
    (work / "host_shared.cpp").write_text(
        '#include "cuda_runtime.h"\n'
        'extern "C" { alignas(16) float2 host_shared[227 * 1024 / sizeof(float2)]; }\n')
    flags = [cxx, "-std=c++20", "-O1", "-fPIC", "-pthread", "-w", f"-I{HOST}"]
    jobs = [(work / "host_shared.o", [*flags, "-c", str(work / "host_shared.cpp")])]
    for unit in (0, 1):  # the build's two objects of the source (cuda_fft._UNITS)
        jobs.append((work / f"compressed.{unit}.o",
                     [*flags, f"-DSLM_UNIT_MIXED={unit}", "-c", str(src)]))
    procs = [(obj, subprocess.Popen([*cmd, "-o", str(obj)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for obj, cmd in jobs]
    failed = []
    for obj, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{obj.name}:\n{out[:4000]}")
    assert not failed, "compressed.cu does not compile for the host:\n" + "\n".join(failed)
    so = work / "libcompressed_host.so"
    subprocess.run([cxx, "-shared", "-pthread", "-o", str(so), *(str(o) for o, _ in jobs)],
                   check=True)
    handle = ctypes.CDLL(str(so))
    for name, argtypes in cuda_compressed._SIGNATURES.items():
        getattr(handle, name).argtypes = argtypes
        getattr(handle, name).restype = ctypes.c_int
    return handle


def _inputs(D, P, N, seed):
    """Seeded inputs as the card's tests make them (``_cmp_inputs``)."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return np.ascontiguousarray(rng.normal(size=shape) * scale, np.float32)

    return dict(basis=f32(D, P, scale=2), coeffs=f32(D, N, scale=5), ffr=f32(N), ffi=f32(N),
                nfr=f32(P), nfi=f32(P),
                amp=np.ascontiguousarray(0.5 + rng.uniform(0, 1, P), np.float32))


def _ptr(a):
    return None if a is None else a.ctypes.data


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _t(x, *names):
    return tuple(torch.from_numpy(x[name]) for name in names)


@pytest.mark.parametrize("D, N, P", list(itertools.product(TERMS, SPOTS, PIXELS)) + list(RING))
def test_wide_kernels_on_the_host(lib, D, N, P):
    """The wide f2n (scaled, and the amplitude replacement with an
    amplitude plane) and n2f (normalized through spot_reduce and unit_norm,
    and the unnormalized sum fused_iter takes past its kernel) against
    their plain versions."""
    x = _inputs(D, P, N, seed=D * 100 + N + P)
    ff, nf, cb = _t(x, "ffr", "ffi"), _t(x, "nfr", "nfi"), _t(x, "coeffs", "basis")
    nfr, nfi = np.empty(P, np.float32), np.empty(P, np.float32)
    for amp in (None, x["amp"]):
        rc = lib.slm_cmp_f2n(_ptr(x["ffr"]), _ptr(x["ffi"]), _ptr(x["coeffs"]), _ptr(x["basis"]),
                             _ptr(amp), P, N, D, float(P ** -0.5), int(amp is not None),
                             _ptr(nfr), _ptr(nfi), None)
        assert rc == 0
        ref = C._farfield_to_nearfield(*ff, *cb, amp=None if amp is None else torch.from_numpy(amp))
        assert max(_rel(nfr, ref[0]), _rel(nfi, ref[1])) <= CMP_RTOL, ("f2n", amp is not None)
    n_blocks = -(-P // lib.slm_cmp_block_pixels())
    partials = np.empty((2, n_blocks, N), np.float32)
    out_re, out_im = np.empty(N, np.float32), np.empty(N, np.float32)
    for normalize in (True, False):
        rc = lib.slm_cmp_n2f(_ptr(x["nfr"]), _ptr(x["nfi"]), _ptr(x["coeffs"]), _ptr(x["basis"]),
                             P, N, D, float(P ** -0.5) if normalize else 1.0, int(normalize),
                             _ptr(partials), _ptr(out_re), _ptr(out_im), None)
        assert rc == 0
        ref = (C._nearfield_to_farfield(*nf, *cb) if normalize
               else C._nearfield_to_farfield_raw(*nf, *cb, scale=1.0))
        assert max(_rel(out_re, ref[0]), _rel(out_im, ref[1])) <= CMP_RTOL, ("n2f", normalize)


def test_wide_kernels_at_the_term_limit(lib):
    """The most terms the wrapper takes (``slm_cmp_max_terms()``: one buffer
    of eight items) runs, on inputs whose phases are exact in f32 (the basis
    and coefficients multiples of 1/4 within [-2, 2] and [-1, 1]: every
    partial sum a multiple of 1/16 below 2^20); eight items of 1,816 groups
    exceed a block's shared memory, and the launcher refuses them."""
    limit = lib.slm_cmp_max_terms()
    assert limit == 7248
    P, N = 300, 3
    rng = np.random.default_rng(1)
    x = _inputs(limit, P, N, seed=1)
    x["basis"] = np.ascontiguousarray(rng.integers(-8, 9, (limit, P)) / 4, np.float32)
    x["coeffs"] = np.ascontiguousarray(rng.integers(-4, 5, (limit, N)) / 4, np.float32)
    nfr, nfi = np.empty(P, np.float32), np.empty(P, np.float32)
    args = (_ptr(x["ffr"]), _ptr(x["ffi"]), _ptr(x["coeffs"]), _ptr(x["basis"]), None, P, N)
    assert lib.slm_cmp_f2n(*args, limit, 1.0, 0, _ptr(nfr), _ptr(nfi), None) == 0
    ref = C._farfield_to_nearfield(*_t(x, "ffr", "ffi", "coeffs", "basis"))
    assert max(_rel(nfr, ref[0] * P ** 0.5), _rel(nfi, ref[1] * P ** 0.5)) <= CMP_RTOL
    assert lib.slm_cmp_f2n(*args, 4 * 1816, 1.0, 0, _ptr(nfr), _ptr(nfi), None) != 0
