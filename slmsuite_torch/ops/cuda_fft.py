"""
CUDA kernels of the GS engine (counterpart of
:mod:`slmsuite_tpu.ops.pallas_fft`), their build and their wrappers:
the carry-mode WGS loop (``csrc/wgs_carry.cu``), the two column passes
of the carry-mode MRAF step (``csrc/mraf_carry.cu``) and the
natural-order transforms of the natural step (``csrc/natural_fft.cu``).
The compressed spot transforms (``csrc/compressed.cu``) build into the
same library; their wrappers are in :mod:`slmsuite_torch.ops.cuda_compressed`.

The sources are ``slmsuite_torch/csrc/*.cu`` and ``*.cuh``. On the first
launch each ``.cu`` is compiled with ``nvcc`` for ``sm_90a``, all at
once in parallel (a source of the line kernels twice, its power-of-two
plans and, with ``SLM_UNIT_MIXED=1``, its mixed plan: the second object's
entry points end in ``_mixed``), and the objects are linked into
``build/slmsuite_torch/<hash of the sources>/libslmsuite_torch.so``
(beside the package, in the checkout), loaded with ``ctypes``;
importing this module builds nothing. Each wrapper checks its inputs
(CUDA, float32, contiguous, one shape, sides multiples of 8 in
[64, 8192]) and raises on anything else, allocates its outputs, launches
on the current stream, raises if the launcher reports an error, and
counts its launches in :data:`LAUNCHES` and the bytes it declares in
:data:`BYTES` (the planes read and written).

``carry_entry``, ``cols_fwd_polar``, ``cols_wexp_inv``, ``cols_fft`` and
``rows_fft`` also take a ``(B, H, W)`` stack of planes (the multiplane
engine's), in one launch for all B planes, counted once; ``carry_entry``
takes it against one shared ``(H, W)`` amplitude plane (or a scalar).
The compositions of these kernels (:meth:`fft2`, :meth:`ifft2`,
:meth:`fft2_polar`, :meth:`fft2_polar_from_phase`, :meth:`wexp_ifft2`)
take a stack with them. Every other wrapper takes ``(H, W)`` planes only.

The plain PyTorch version of each kernel is the underscored function of
the same name in :mod:`slmsuite_torch.ops.fft`.

Every kernel here is one of :data:`LINE_KERNELS` (``rows_fft``,
``cols_fft``, ``rows_normfwd``, ``cols_wgs_roundtrip``, ``carry_entry``,
``carry_exit``, ``cols_fwd_polar``, ``cols_wexp_inv``, ``cols_mraf_fwd``,
``cols_mraf_mix_inv``, ``cols_wgs_fwd``) and runs the register-resident
line FFT (``line_fft`` in ``csrc/fft_shared.cuh``). Its plan
(:meth:`fft_plan`), its exchange's index maps, and a plain PyTorch model
that follows it pass by pass (:meth:`line_fft_model`) are here, so that
they can be tested without a card; the launch shapes are the launchers'
own (:meth:`fft_launch_shape` asks them).
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from slmsuite_torch.ops.fft import (
    SCALAR_KEYS,
    is_scalar_amp,
    kernel_len_ok,
    ortho_scale,
    post_scale,
    wgs_phasor_entry,
    wgs_phasor_exit,
)

#: Launches per wrapper since the last :meth:`reset_launch_counts`.
LAUNCHES = {
    "carry_entry": 0,
    "cols_wgs_roundtrip": 0,
    "rows_normfwd": 0,
    "carry_exit": 0,
    "rows_fft": 0,
    "cols_fft": 0,
    "cols_fwd_polar": 0,
    "cols_wexp_inv": 0,
    "cols_mraf_fwd": 0,
    "cols_mraf_mix_inv": 0,
    "cols_wgs_fwd": 0,
}

#: Bytes each wrapper declares for its launches since the last
#: :meth:`reset_launch_counts`: the planes its kernel reads, each once, and
#: writes, each once (the rule of the kernels' bound; the twiddle tables,
#: the scalar buffer and the stats partials are left out).
BYTES = dict.fromkeys(LAUNCHES, 0)


def _launched(name, reads, writes):
    """Count one launch of ``name`` and its declared bytes."""
    LAUNCHES[name] += 1
    BYTES[name] += sum(t.numel() * t.element_size()
                       for t in (*reads, *writes) if t is not None)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "slmsuite_torch"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_NVCC_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_RULES = {"leonardo": 0, "kim": 0, "wu": 1, "tanh": 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "slm_carry_entry": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
    "slm_cols_wgs_roundtrip": [_P] * 16 + [_I, _I, _I, _P, _P, _I, _I, _I, _P],
    "slm_cols_blocks": [_I, _I, _I],
    "slm_cols_wgs_fwd": [_P] * 14 + [_I, _I, _I, _P, _I, _I, _I, _P],
    "slm_rows_normfwd": [_P] * 5 + [_I, _I, _P, _P, _P],
    "slm_carry_exit": [_P, _P, _P, _I, _I, _P, _P],
    "slm_rows_fft": [_P] * 4 + [_I, _I, _I, _P, _F, _P],
    "slm_cols_fft": [_P] * 4 + [_I, _I, _I, _I, _P, _F, _P],
    "slm_fft_launch_shape": [_I, _I, _I, ctypes.POINTER(_I)],
    "slm_cols_fwd_polar": [_P] * 4 + [_I, _I, _I, _P, _F, _P],
    "slm_cols_wexp_inv": [_P] * 4 + [_I, _I, _I, _P, _P],
    "slm_cols_mraf_fwd": [_P] * 12 + [_I, _I, _I, _P, _I, _I, _P],
    "slm_cols_mraf_mix_inv": [_P] * 16 + [_I, _I, _P, _I, _I, _P],
}

#: The entry points of the line kernels: each also as ``name + "_mixed"``,
#: its mixed plan's, in the second object of its source (:meth:`_entry`).
_LINE_ENTRIES = ("slm_carry_entry", "slm_cols_wgs_roundtrip", "slm_cols_wgs_fwd",
                 "slm_rows_normfwd", "slm_carry_exit", "slm_rows_fft", "slm_cols_fft",
                 "slm_cols_fwd_polar", "slm_cols_wexp_inv", "slm_cols_mraf_fwd",
                 "slm_cols_mraf_mix_inv")
_SIGNATURES.update({name + "_mixed": _SIGNATURES[name] for name in _LINE_ENTRIES})
#: The compilations of a source of the line kernels: (object suffix, flags).
_UNITS = (("", ()), (".mixed", ("-DSLM_UNIT_MIXED=1",)))

_LIB = None


def reset_launch_counts():
    """Set every launch count to 0."""
    for key in LAUNCHES:
        LAUNCHES[key] = 0
        BYTES[key] = 0


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built.")


def build():
    """
    Compile the kernels (once per source hash) and return ``(path,
    seconds, log)``: the library, the build time (0.0 when it was already
    built) and nvcc's output (its ``-Xptxas -v`` register and
    shared-memory report). One ``nvcc`` per source runs at the same time;
    every one is waited for before a failure is raised.
    """
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = _BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / "libslmsuite_torch.so"
    if lib_path.exists():
        return lib_path, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = _nvcc()
    start = time.perf_counter()
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        units = _UNITS if "SLM_ENTRY(" in src.read_text() else _UNITS[:1]
        for suffix, flags in units:
            obj = out_dir / f"{src.stem}{suffix}.{tag}.o"
            cmd = [nvcc, *_NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(src)]
            jobs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
    logs, failed = [], []
    for obj, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{obj.name} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out_dir / f"libslmsuite_torch.{tag}.so"
    done = subprocess.run(
        [nvcc, *_ARCH, "-shared", "-o", str(tmp), *[str(obj) for obj, _ in jobs]],
        capture_output=True, text=True,
    )
    if done.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({done.returncode}):\n{done.stdout}\n{done.stderr}"
        )
    os.replace(tmp, lib_path)
    seconds = time.perf_counter() - start
    return lib_path, seconds, "".join(logs) + done.stdout + done.stderr


def _lib():
    global _LIB
    if _LIB is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=512)
def _twiddles(n, inverse, device):
    """exp(sign 2 pi i k / n), k < n/2, computed in float64, stored f32
    as (n/2, 2) (re, im) pairs on ``device``."""
    sign = 1.0 if inverse else -1.0
    w = np.exp(sign * 2j * np.pi * np.arange(n // 2) / n)
    table = np.stack([w.real, w.imag], axis=-1).astype(np.float32)
    return torch.from_numpy(table).to(device)


# ----------------------------------------------------------------------
# The register-resident line FFT of the LINE_KERNELS (line_fft in
# csrc/fft_shared.cuh): its plan, its index maps, and a plain PyTorch
# model that follows the kernel pass by pass.
# ----------------------------------------------------------------------


def line_split(n):
    """``(P, m)`` of a line of ``n`` points, ``n = m * P``: ``(n, 1)`` for a
    power of two, else ``(8, n // 8)``, a mixed line: ``m`` interleaved
    8-point lines, then one pass per prime factor of ``m``."""
    return (n, 1) if n & (n - 1) == 0 else (8, n // 8)


def _pow2_plan(p):
    """Radices of the passes of a ``p``-point line: one pass at 8 (a mixed
    line's 8-point lines), two up to 256, three up to 4096, four at 8192,
    radix 8 first and radix 16 for what is left (2048 = 8 * 16 * 16)."""
    log2p = p.bit_length() - 1
    passes = 1 if log2p <= 4 else 2 if log2p <= 8 else 3 if log2p <= 12 else 4
    sixteens = log2p - 3 * passes
    return (8,) * (passes - sixteens) + (16,) * sixteens


def _factors(m):
    """The prime factors of ``m``, smallest first, with repeats: the
    radices of a mixed line's passes of ``m``."""
    factors, r = [], 2
    while m > 1:
        while m % r == 0:
            factors.append(r)
            m //= r
        r += 1 if r == 2 else 2
    return tuple(factors)


def fft_plan(n):
    """The radices of the line FFT's passes for a line of ``n`` points, in
    the order they run: the power-of-two part's register passes
    (:meth:`_pow2_plan`), then, for a mixed line, one pass for each prime
    factor of ``m`` (:meth:`line_split`; 1080 = 8 * 3 * 3 * 3 * 5, 1920 =
    8 * 2 * 2 * 2 * 2 * 3 * 5)."""
    if not kernel_len_ok(n):
        raise ValueError(f"No plan for a line of {n} points.")
    p, m = line_split(n)
    return _pow2_plan(p) + _factors(m)


def line_points(n):
    """Points of a line that one thread holds in registers: the largest
    radix of the power-of-two passes. A line takes ``n // line_points(n)``
    threads, and thread ``s`` holds the points ``s + q * n //
    line_points(n)`` before the first pass and after the last."""
    fft_plan(n)
    return max(_pow2_plan(line_split(n)[0]))


def line_pad(m):
    """Slot of point ``m`` of a line in the shared-memory exchange buffer:
    one slot of padding after every 16, so that the first pass's writes
    (stride 8 or 16) spread over the banks."""
    return m + (m >> 4)


def line_pitch(n):
    """Slots of one line in the exchange buffer."""
    return n + n // 16


def line_slot(n, m, blocks=1):
    """``(block, slot)`` of point ``m`` of a power-of-two line in the
    exchange: the block of the cluster whose threads read it next (thread
    ``m mod T`` of the line's ``T = n // line_points(n)``; the blocks take
    the threads in groups of 8 in turn), and its padded slot in that
    block's buffer, which holds the points of its own threads only. One
    block: ``(0, line_pad(m))``."""
    threads = n // max(_pow2_plan(n))
    reader = m % threads
    local = (m // threads) * (threads // blocks) + reader // (8 * blocks) * 8 + reader % 8
    return reader // 8 % blocks, line_pad(local)


_C1, _S1, _H = (np.float32(x) for x in (np.cos(np.pi / 8), np.sin(np.pi / 8), np.sqrt(0.5)))
#: (cos, sin) of 2 pi e / 16, as f32, for the exponents the radix-8 and
#: radix-16 butterflies rotate by (csrc/fft_shared.cuh has the same).
_ROOT16 = {1: (_C1, _S1), 2: (_H, _H), 3: (_S1, _C1), 6: (-_H, _H), 9: (-_C1, -_S1)}


def _rot(a, e, inverse):
    """``a`` times the 16th root of unity ``e`` (forward: its conjugate)."""
    if e == 0:
        return a
    if e == 4:
        return torch.complex(-a.imag, a.real) if inverse else torch.complex(a.imag, -a.real)
    c, s = _ROOT16[e]
    s = s if inverse else -s
    return torch.complex(a.real * c - a.imag * s, a.real * s + a.imag * c)


def _fft4(a, inverse):
    """Radix-4 butterfly, natural order, as ``fft4`` of the kernel."""
    s02, d02, s13 = a[0] + a[2], a[0] - a[2], a[1] + a[3]
    d13 = _rot(a[1] - a[3], 4, inverse)
    return [s02 + s13, d02 + d13, s02 - s13, d02 - d13]


def _radix(u, inverse):
    """Radix-8 or radix-16 butterfly of the list ``u``, natural order, as
    ``radix<8>``/``radix<16>`` of the kernel: R = 4 * n2, input ``n1 + 4 *
    n2``, output ``k2 + n2 * k1``."""
    n2 = len(u) // 4
    a = list(u)
    for n1 in range(4):
        if n2 == 2:
            a[n1], a[n1 + 4] = a[n1] + a[n1 + 4], a[n1] - a[n1 + 4]
        else:
            a[n1::4] = _fft4(a[n1::4], inverse)
    for k2 in range(1, n2):
        for n1 in range(1, 4):
            a[n1 + 4 * k2] = _rot(a[n1 + 4 * k2], n1 * k2 * (16 // len(u)), inverse)
    for k2 in range(n2):
        a[4 * k2:4 * k2 + 4] = _fft4(a[4 * k2:4 * k2 + 4], inverse)
    return [a[4 * (k % n2) + k // n2] for k in range(len(u))]


def _table_at(table, at):
    """Entries ``at`` < n of the rotations from the table of n / 2:
    ``-table[at - n / 2]`` above it, as ``tw_full`` of the kernel."""
    half = table.shape[0]
    return torch.where(at < half, table[at % half], -table[at % half])


def _pow2_passes(x, table, inverse, blocks):
    """The passes of ``line_fft`` on the power-of-two lines along the last
    axis of ``x`` (complex64), with their table of twiddles."""
    n = x.shape[-1]
    p = 1
    for radix in _pow2_plan(n):
        i = torch.arange(n // radix)
        k = i & (p - 1)
        stride = n // (p * radix)
        lo = [None, table[k * stride]]
        lo += [lo[1] * lo[1], lo[1] * lo[1] * lo[1]]
        hi = [None, table[4 * k * stride]]
        hi += [hi[1] * hi[1], hi[1] * hi[1] * hi[1]]
        u = []
        for r in range(radix):
            points = x[..., i + r * (n // radix)]
            if p > 1 and r > 0:
                a, b = divmod(r, 4)
                w = lo[b] if a == 0 else hi[a] if b == 0 else hi[a] * lo[b]
                points = points * w
            u.append(points)
        u = _radix(u, inverse)
        buf = torch.zeros((*x.shape[:-1], blocks, line_pitch(n) // blocks), dtype=x.dtype)
        for r in range(radix):
            block, slot = line_slot(n, (i - k) * radix + k + r * p, blocks)
            buf[..., block, slot] = u[r]
        block, slot = line_slot(n, torch.arange(n), blocks)
        x = buf[..., block, slot]
        p *= radix
    return x


def line_fft_model(xr, xi, *, inverse, blocks=1):
    """Plain PyTorch model of the kernels' ``line_fft`` along the last
    axis, in f32. The power-of-two passes (:meth:`_pow2_plan`), each a
    twiddle ``w^r`` formed from two reads of the f32 table of
    :meth:`_twiddles` (``w`` at ``k n / (p R)`` and ``w^4``: ``w^(4a + b) =
    (w^4)^a w^b``), a radix-8 or radix-16 butterfly in natural order, and a
    self-sorting exchange (write ``(i - k) R + k + r p``, read ``i + r n /
    R``) through one padded buffer for each of the ``blocks`` blocks that
    share the line (:meth:`line_slot`). A mixed line (``n = m P``, P = 8,
    :meth:`line_split`) runs one radix-8 butterfly on each of its ``m``
    interleaved ``P``-point lines ``b + m a``, rotates output ``k1`` of
    line ``b`` by ``w_n^(b k1)`` into slot ``k1 m + b``, and runs one pass
    per prime factor ``r`` of ``m``: output ``o`` of the ``m``-point
    line ``k1`` is ``sum_j x[i + j m / r] w_(p r)^(j (o mod p r))``, ``i =
    (o // (p r)) p + o mod p``, the sum in ``j`` order with the exponent
    stepped mod ``p r``, every pass but the last into slot ``k1 m + o``,
    the last to the line's output ``k1 + P o``. Unnormalized, like the
    kernels."""
    n = xr.shape[-1]
    p2, m = line_split(n)
    fft_plan(n)
    table = _twiddles(n, bool(inverse), "cpu")
    table = torch.complex(table[:, 0], table[:, 1])
    x = torch.complex(xr.float(), xi.float())
    if m == 1:
        x = _pow2_passes(x, table, inverse, blocks)
        return x.real.contiguous(), x.imag.contiguous()
    if blocks != 1:
        raise ValueError("A mixed line takes one block.")
    lead = x.shape[:-1]
    lines = x.reshape(*lead, p2, m).transpose(-1, -2)
    # The 8-point lines: one radix-8 butterfly, as the kernel's registers.
    y = torch.stack(_radix(list(lines.unbind(-1)), inverse), dim=-1)
    b, k1 = torch.arange(m)[:, None], torch.arange(p2)[None, :]
    y = y * _table_at(table, b * k1)
    buf = y.transpose(-1, -2).reshape(*lead, n)
    idx = torch.arange(n)
    p = 1
    for r in _factors(m):
        pr = p * r
        if pr == m:
            k1, o = idx & (p2 - 1), idx // p2
        else:
            k1, o = idx // m, idx % m
        e0 = o % pr
        at = k1 * m + (o // pr) * p + o % p
        acc = buf[..., at]
        e = e0
        for j in range(1, r):
            acc = acc + buf[..., at + j * (m // r)] * _table_at(table, e * (n // pr))
            e = torch.where(e + e0 >= pr, e + e0 - pr, e + e0)
        buf = acc
        p = pr
    return buf.real.contiguous(), buf.imag.contiguous()


def _check_planes(*planes, stack=False, rows=False):
    """Raise unless every plane is a contiguous f32 CUDA tensor of one
    shape, (H, W) or, with ``stack``, also (B, H, W) with B >= 1, whose
    sides the kernels take; with ``rows`` (a row kernel, which transforms
    lines of W points), W one the kernels take and H any positive multiple
    of 8 (a row shard of a plane). Returns ``(H, W)``."""
    shape = planes[0].shape
    ndims = (2, 3) if stack else (2,)
    for x in planes:
        if not torch.is_tensor(x) or not x.is_cuda:
            raise ValueError("CUDA kernel wrappers take CUDA tensors only.")
        if x.dtype != torch.float32:
            raise ValueError(f"Expected float32, got {x.dtype}.")
        if not x.is_contiguous():
            raise ValueError("Expected a contiguous tensor.")
        if x.shape != shape or x.ndim not in ndims or x.numel() == 0:
            raise ValueError(f"Shape mismatch: {tuple(x.shape)} vs {tuple(shape)}.")
        if x.device.index != torch.cuda.current_device():
            raise ValueError(
                f"Tensor on {x.device}, but the current CUDA device is "
                f"{torch.cuda.current_device()}: launches go to the current device."
            )
    H, W = shape[-2:]
    if rows and not (kernel_len_ok(W) and H % 8 == 0):
        raise ValueError(
            f"Rows must be multiples of 8 in [64, 8192] long and a multiple of 8 "
            f"in number; got {tuple(shape)}."
        )
    if not rows and not (kernel_len_ok(H) and kernel_len_ok(W)):
        raise ValueError(
            f"Sides must be multiples of 8 in [64, 8192]; got {tuple(shape)}."
        )
    return H, W


def _n_planes(x):
    """Planes in ``x``: B of a (B, H, W) stack, 1 of an (H, W) plane."""
    return x.shape[0] if x.ndim == 3 else 1


def _amp_plane(amp, shape, rows=False):
    """The (H, W) amplitude plane of planes of ``shape`` ((H, W) or a
    (B, H, W) stack, which shares it), or None for a scalar amplitude."""
    if is_scalar_amp(amp):
        return None
    _check_planes(amp, rows=rows)
    if amp.shape != shape[-2:]:
        raise ValueError(f"amp {tuple(amp.shape)} does not match {tuple(shape)}.")
    return amp


def _check_scal(scal, like):
    """Raise unless ``scal`` is the contiguous f32 :data:`SCALAR_KEYS`
    buffer on the planes' device."""
    if (scal.device != like.device or scal.dtype != torch.float32
            or scal.shape != (len(SCALAR_KEYS),) or not scal.is_contiguous()):
        raise ValueError(
            f"scal must be a contiguous f32 ({len(SCALAR_KEYS)},) tensor on the "
            "plane's device."
        )


def _check_rule(rule):
    if rule not in _RULES:
        raise ValueError(f"Unfusable rule '{rule}'.")


def _with_post(scal, post):
    """A copy of ``scal`` with its ``post`` lane set (on the device)."""
    scal = scal.clone()
    scal[SCALAR_KEYS.index("post")] = post
    return scal


def _ptr(x):
    return None if x is None else x.data_ptr()


def _entry(name, n):
    """The library's entry point ``name`` for lines of ``n`` points: the
    mixed plan's (``name + "_mixed"``) where ``n`` is not a power of two."""
    return getattr(_lib(), name + "_mixed" if n & (n - 1) else name)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: error {rc}.")


def carry_entry(psi, amp):
    """#1: psi -> rows-transformed carry ``(gr, gi)`` of ``e^{i psi}``
    (scalar ``amp``) or ``amp * e^{i psi}``. ``psi`` is an (H, W) plane or
    a (B, H, W) stack, whose planes share the (H, W) ``amp``."""
    H, W = _check_planes(psi, stack=True, rows=True)
    amp_plane = _amp_plane(amp, psi.shape, rows=True)
    gr, gi = torch.empty_like(psi), torch.empty_like(psi)
    rc = _entry("slm_carry_entry", W)(
        _ptr(psi), _ptr(amp_plane), _ptr(gr), _ptr(gi), _n_planes(psi), H, W,
        _ptr(_twiddles(W, False, psi.device)), _stream(),
    )
    _raise_on(rc, "carry_entry")
    _launched("carry_entry", (psi, amp_plane), (gr, gi))
    return gr, gi


def cols_wgs_roundtrip(gr, gi, weights, target, mask, phase_ff, scal,
                       *, rule, kim, stats_on):
    """#2: forward column FFT, WGS epilogue, inverse column FFT, plus the
    stats reduction. Returns ``(hr, hi, weights', phase_ff' | None, sums
    (float64), maxs)``."""
    planes = [gr, gi, weights, target]
    if stats_on:
        planes.append(mask)
    if kim:
        planes += list(phase_ff)
    H, W = _check_planes(*planes)
    _check_rule(rule)
    _check_scal(scal, gr)
    blocks = _cols_blocks("cols_wgs_roundtrip", H, W)
    hr, hi, wout = (torch.empty_like(gr) for _ in range(3))
    pff_out = (torch.empty_like(gr), torch.empty_like(gr)) if kim else (None, None)
    partials = torch.empty((blocks, 8), dtype=torch.float64, device=gr.device)
    sums = torch.empty(4, dtype=torch.float64, device=gr.device)
    maxs = torch.empty(4, dtype=torch.float32, device=gr.device)
    pff_in = phase_ff if kim else (None, None)
    rc = _entry("slm_cols_wgs_roundtrip", H)(
        _ptr(gr), _ptr(gi), _ptr(weights), _ptr(target),
        _ptr(mask if stats_on else None), _ptr(pff_in[0]), _ptr(pff_in[1]),
        _ptr(hr), _ptr(hi), _ptr(wout), _ptr(pff_out[0]), _ptr(pff_out[1]),
        _ptr(scal), _ptr(partials), _ptr(sums), _ptr(maxs), H, W, blocks,
        _ptr(_twiddles(H, False, gr.device)), _ptr(_twiddles(H, True, gr.device)),
        _RULES[rule], int(kim), int(stats_on), _stream(),
    )
    _raise_on(rc, "cols_wgs_roundtrip")
    _launched("cols_wgs_roundtrip", planes, (hr, hi, wout, *pff_out))
    return hr, hi, wout, pff_out if kim else None, sums, maxs


def cols_wgs_fwd(gr, gi, weights, target, mask, phase_ff, scal,
                 *, rule, kim, stats_on):
    """#7, cols half: forward column FFT of the rows-transformed carry,
    the WGS epilogue on Kim's ANGLE store ``phase_ff`` (None without
    Kim), the constrained farfield as a pair, plus the stats reduction.
    Returns ``(re, im, weights', phase_ff' | None, sums (float64), maxs)``."""
    planes = [gr, gi, weights, target]
    if stats_on:
        planes.append(mask)
    if kim:
        planes.append(phase_ff)
    H, W = _check_planes(*planes)
    _check_rule(rule)
    _check_scal(scal, gr)
    blocks = _cols_blocks("cols_wgs_fwd", H, W)
    re, im, wout = (torch.empty_like(gr) for _ in range(3))
    pff_out = torch.empty_like(gr) if kim else None
    partials = torch.empty((blocks, 8), dtype=torch.float64, device=gr.device)
    sums = torch.empty(4, dtype=torch.float64, device=gr.device)
    maxs = torch.empty(4, dtype=torch.float32, device=gr.device)
    rc = _entry("slm_cols_wgs_fwd", H)(
        _ptr(gr), _ptr(gi), _ptr(weights), _ptr(target),
        _ptr(mask if stats_on else None), _ptr(phase_ff if kim else None),
        _ptr(re), _ptr(im), _ptr(wout), _ptr(pff_out), _ptr(scal), _ptr(partials),
        _ptr(sums), _ptr(maxs), H, W, blocks, _ptr(_twiddles(H, False, gr.device)),
        _RULES[rule], int(kim), int(stats_on), _stream(),
    )
    _raise_on(rc, "cols_wgs_fwd")
    _launched("cols_wgs_fwd", planes, (re, im, wout, pff_out))
    return re, im, wout, pff_out, sums, maxs


def rows_normfwd(hr, hi, amp):
    """#3: inverse row FFT, amplitude replacement, forward row FFT."""
    H, W = _check_planes(hr, hi)
    amp_plane = _amp_plane(amp, hr.shape)
    gr, gi = torch.empty_like(hr), torch.empty_like(hr)
    rc = _entry("slm_rows_normfwd", W)(
        _ptr(hr), _ptr(hi), _ptr(amp_plane), _ptr(gr), _ptr(gi), H, W,
        _ptr(_twiddles(W, False, hr.device)), _ptr(_twiddles(W, True, hr.device)),
        _stream(),
    )
    _raise_on(rc, "rows_normfwd")
    _launched("rows_normfwd", (hr, hi, amp_plane), (gr, gi))
    return gr, gi


def carry_exit(gr, gi):
    """#4: rows-transformed carry -> psi (inverse row FFT, atan2)."""
    H, W = _check_planes(gr, gi, rows=True)
    psi = torch.empty_like(gr)
    rc = _entry("slm_carry_exit", W)(
        _ptr(gr), _ptr(gi), _ptr(psi), H, W,
        _ptr(_twiddles(W, True, gr.device)), _stream(),
    )
    _raise_on(rc, "carry_exit")
    _launched("carry_exit", (gr, gi), (psi,))
    return psi


def carry_step(gr, gi, amp, weights, phase_ff, target, mask, scal,
               *, rule, kim, stats_on):
    """One WGS iteration on the carry: :meth:`cols_wgs_roundtrip` then
    :meth:`rows_normfwd` (same contract as
    :meth:`slmsuite_torch.ops.fft._wgs_carry_step`)."""
    hr, hi, wout, pff_out, sums, maxs = cols_wgs_roundtrip(
        gr, gi, weights, target, mask, phase_ff, scal,
        rule=rule, kim=kim, stats_on=stats_on,
    )
    gr2, gi2 = rows_normfwd(hr, hi, amp)
    return gr2, gi2, wout, pff_out, sums, maxs


def cols_mraf_fwd(gr, gi, weights, target, mask, scal, *, rule, stats_on):
    """#10, K1: forward column FFT, the scaled complex farfield, the
    unnormalized weight update and the stats, plus the stats reduction.
    Returns ``(fr, fi, uw, sums (float64), maxs)``."""
    planes = [gr, gi, weights, target] + ([mask] if stats_on else [])
    H, W = _check_planes(*planes)
    _check_rule(rule)
    _check_scal(scal, gr)
    blocks = _cols_blocks("cols_mraf_fwd", H, W)
    fr, fi, uw = (torch.empty_like(gr) for _ in range(3))
    partials = torch.empty((blocks, 8), dtype=torch.float64, device=gr.device)
    sums = torch.empty(4, dtype=torch.float64, device=gr.device)
    maxs = torch.empty(4, dtype=torch.float32, device=gr.device)
    rc = _entry("slm_cols_mraf_fwd", H)(
        _ptr(gr), _ptr(gi), _ptr(weights), _ptr(target),
        _ptr(mask if stats_on else None), _ptr(fr), _ptr(fi), _ptr(uw),
        _ptr(scal), _ptr(partials), _ptr(sums), _ptr(maxs), H, W, blocks,
        _ptr(_twiddles(H, False, gr.device)), _RULES[rule], int(stats_on), _stream(),
    )
    _raise_on(rc, "cols_mraf_fwd")
    _launched("cols_mraf_fwd", planes, (fr, fi, uw))
    return fr, fi, uw, sums, maxs


def cols_mraf_mix_inv(fr, fi, uw, mcode, phase_ff, zw, sums, scal, *, kim, zero):
    """#10, K2: the region mix (norm read from the device ``sums``), Kim's
    phasor select, the zero-weight update, the inverse column FFT.
    Returns ``(hr, hi, phase_ff' | None, zw' | None)``."""
    planes = [fr, fi, uw, mcode]
    if kim:
        planes += list(phase_ff)
    if zero:
        planes += [zw[0], zw[1]]
    H, W = _check_planes(*planes)
    _check_scal(scal, fr)
    if (sums.device != fr.device or sums.dtype != torch.float64
            or sums.shape != (4,) or not sums.is_contiguous()):
        raise ValueError("sums must be the contiguous float64 (4,) stats sums.")
    hr, hi = torch.empty_like(fr), torch.empty_like(fr)
    pff_out = (torch.empty_like(fr), torch.empty_like(fr)) if kim else (None, None)
    zw_out = torch.empty((2, H, W), dtype=fr.dtype, device=fr.device) if zero else None
    pff_in = phase_ff if kim else (None, None)
    zw_in, zw_to = (zw, zw_out) if zero else ((None, None), (None, None))
    rc = _entry("slm_cols_mraf_mix_inv", H)(
        _ptr(fr), _ptr(fi), _ptr(uw), _ptr(mcode), _ptr(pff_in[0]), _ptr(pff_in[1]),
        _ptr(zw_in[0]), _ptr(zw_in[1]), _ptr(hr), _ptr(hi), _ptr(pff_out[0]),
        _ptr(pff_out[1]), _ptr(zw_to[0]), _ptr(zw_to[1]), _ptr(scal), _ptr(sums),
        H, W, _ptr(_twiddles(H, True, fr.device)), int(kim), int(zero), _stream(),
    )
    _raise_on(rc, "cols_mraf_mix_inv")
    _launched("cols_mraf_mix_inv", planes, (hr, hi, *pff_out, zw_out))
    return hr, hi, pff_out if kim else None, zw_out


def mraf_carry_step(gr, gi, amp, weights, phase_ff, target, mask, mcode, zw, scal,
                    *, rule, kim, stats_on, zero):
    """One MRAF iteration on the carry: :meth:`cols_mraf_fwd`,
    :meth:`cols_mraf_mix_inv`, :meth:`rows_normfwd` (same contract as
    :meth:`slmsuite_torch.ops.fft._mraf_carry_step`)."""
    fr, fi, uw, sums, maxs = cols_mraf_fwd(
        gr, gi, weights, target, mask, scal, rule=rule, stats_on=stats_on
    )
    hr, hi, pff_out, zw_out = cols_mraf_mix_inv(
        fr, fi, uw, mcode, phase_ff, zw, sums, scal, kim=kim, zero=zero
    )
    gr2, gi2 = rows_normfwd(hr, hi, amp)
    return gr2, gi2, uw, pff_out, zw_out, sums, maxs


def rows_fft(xr, xi, *, inverse, scale=1.0):
    """#5, rows half: the FFT (``inverse``: the unnormalized inverse FFT)
    of every row of the pair (of every plane of a (B, H, W) stack: B H
    rows), times ``scale``."""
    H, W = _check_planes(xr, xi, stack=True, rows=True)
    yr, yi = torch.empty_like(xr), torch.empty_like(xr)
    rc = _entry("slm_rows_fft", W)(
        _ptr(xr), _ptr(xi), _ptr(yr), _ptr(yi), _n_planes(xr) * H, W, int(bool(inverse)),
        _ptr(_twiddles(W, bool(inverse), xr.device)), float(scale), _stream(),
    )
    _raise_on(rc, "rows_fft")
    _launched("rows_fft", (xr, xi), (yr, yi))
    return yr, yi


def cols_fft(xr, xi, *, inverse, scale=1.0):
    """#5, cols half: the FFT (``inverse``: the unnormalized inverse FFT)
    of every column of the pair (of each plane of a (B, H, W) stack),
    times ``scale``."""
    H, W = _check_planes(xr, xi, stack=True)
    yr, yi = torch.empty_like(xr), torch.empty_like(xr)
    rc = _entry("slm_cols_fft", H)(
        _ptr(xr), _ptr(xi), _ptr(yr), _ptr(yi), _n_planes(xr), H, W, int(bool(inverse)),
        _ptr(_twiddles(H, bool(inverse), xr.device)), float(scale), _stream(),
    )
    _raise_on(rc, "cols_fft")
    _launched("cols_fft", (xr, xi), (yr, yi))
    return yr, yi


#: The kernels on the line FFT, in the order of ``LineKernel`` in
#: ``csrc/fft_shared.cuh``.
LINE_KERNELS = ("rows_fft", "cols_fft", "rows_normfwd", "cols_wgs_roundtrip", "carry_entry",
                "carry_exit", "cols_fwd_polar", "cols_wexp_inv", "cols_mraf_fwd",
                "cols_mraf_mix_inv", "cols_wgs_fwd")


def fft_launch_shape(kernel, n, other=0):
    """What the launcher of ``kernel`` (one of :data:`LINE_KERNELS`)
    launches on lines of ``n`` points where the plane's other side (a row
    kernel: the rows of all its planes) is ``other`` (0: a multiple of
    every tile), as the built library reports it: ``(rows a block or
    columns a tile, blocks that share a tile, threads a block, bytes of
    dynamic shared memory a block)``. Launches nothing."""
    out = (_I * 4)()
    rc = _lib().slm_fft_launch_shape(LINE_KERNELS.index(kernel), int(n), int(other), out)
    if rc != 0:
        raise ValueError(f"No {kernel} launch on lines of {n} points.")
    return tuple(out)


def _cols_blocks(kernel, H, W):
    """Blocks of a launch of the column kernel ``kernel`` (one of
    :data:`LINE_KERNELS`) on an (H, W) pair, as its launcher counts them:
    the rows of stats partials it writes. Launches nothing."""
    blocks = _lib().slm_cols_blocks(LINE_KERNELS.index(kernel), H, W)
    if blocks <= 0:
        raise ValueError(f"No {kernel} launch on a ({H}, {W}) pair.")
    return blocks


def cols_fwd_polar(xr, xi, scale):
    """#5 polar and #6, cols half: the forward FFT of every column (of
    each plane of a (B, H, W) stack), returned as ``(scale * |F|, arg F)``."""
    H, W = _check_planes(xr, xi, stack=True)
    amp, theta = torch.empty_like(xr), torch.empty_like(xr)
    rc = _entry("slm_cols_fwd_polar", H)(
        _ptr(xr), _ptr(xi), _ptr(amp), _ptr(theta), _n_planes(xr), H, W,
        _ptr(_twiddles(H, False, xr.device)), float(scale), _stream(),
    )
    _raise_on(rc, "cols_fwd_polar")
    _launched("cols_fwd_polar", (xr, xi), (amp, theta))
    return amp, theta


def cols_wexp_inv(weights, phase):
    """#11, cols half: ``weights * e^{i phase}``, then the unnormalized
    inverse FFT of every column (of each plane of a (B, H, W) stack)."""
    H, W = _check_planes(weights, phase, stack=True)
    yr, yi = torch.empty_like(weights), torch.empty_like(weights)
    rc = _entry("slm_cols_wexp_inv", H)(
        _ptr(weights), _ptr(phase), _ptr(yr), _ptr(yi), _n_planes(weights), H, W,
        _ptr(_twiddles(H, True, weights.device)), _stream(),
    )
    _raise_on(rc, "cols_wexp_inv")
    _launched("cols_wexp_inv", (weights, phase), (yr, yi))
    return yr, yi


def fft2(xr, xi):
    """Ortho 2D FFT: :meth:`rows_fft`, then :meth:`cols_fft` with the
    ortho scale (same contract as :meth:`slmsuite_torch.ops.fft._fft2`)."""
    hr, hi = rows_fft(xr, xi, inverse=False)
    return cols_fft(hr, hi, inverse=False, scale=ortho_scale(xr.shape))


def ifft2(xr, xi):
    """Ortho inverse 2D FFT: :meth:`cols_fft`, then :meth:`rows_fft`
    with the ortho scale."""
    hr, hi = cols_fft(xr, xi, inverse=True)
    return rows_fft(hr, hi, inverse=True, scale=ortho_scale(xr.shape))


def fft2_polar(xr, xi):
    """``(|F|, arg F)`` of the ortho 2D FFT: :meth:`rows_fft`, then
    :meth:`cols_fwd_polar`."""
    hr, hi = rows_fft(xr, xi, inverse=False)
    return cols_fwd_polar(hr, hi, ortho_scale(xr.shape))


def fft2_polar_from_phase(psi, amp):
    """``(|F|, arg F)`` of the ortho 2D FFT of ``amp * e^{i psi}``:
    :meth:`carry_entry`, then :meth:`cols_fwd_polar`."""
    scale = post_scale(amp, psi.shape)
    gr, gi = carry_entry(psi, amp)
    return cols_fwd_polar(gr, gi, scale)


def wexp_ifft2(weights, phase):
    """Ortho ``ifft2(weights * e^{i phase})`` as a pair:
    :meth:`cols_wexp_inv`, then :meth:`rows_fft` with the ortho scale."""
    hr, hi = cols_wexp_inv(weights, phase)
    return rows_fft(hr, hi, inverse=True, scale=ortho_scale(weights.shape))


def wexp_ifft2_phase(weights, phase):
    """``arg ifft2(weights * e^{i phase})``: :meth:`cols_wexp_inv`, then
    :meth:`carry_exit`."""
    return carry_exit(*cols_wexp_inv(weights, phase))


def ifft2_phase(xr, xi):
    """#13, ``arg ifft2``: :meth:`cols_fft` (inverse), then
    :meth:`carry_exit` (the inverse rows and atan2; the scale drops out)."""
    return carry_exit(*cols_fft(xr, xi, inverse=True))


def wgs_fused_forward(psi, amp, weights, phase_ff, target, mask, scal,
                      *, rule, kim, stats_on):
    """#7, psi -> constrained farfield: :meth:`carry_entry`, then
    :meth:`cols_wgs_fwd` with the ``post`` lane set from ``amp`` (same
    contract as :meth:`slmsuite_torch.ops.fft._wgs_fused_forward`)."""
    scal = _with_post(scal, post_scale(amp, psi.shape))
    gr, gi = carry_entry(psi, amp)
    return cols_wgs_fwd(gr, gi, weights, target, mask, phase_ff, scal,
                        rule=rule, kim=kim, stats_on=stats_on)


def wgs_fused_step(psi, amp, weights, phase_ff, target, mask, scal,
                   *, rule, kim, stats_on):
    """#8, psi -> psi: :meth:`carry_entry`, :meth:`cols_wgs_roundtrip`,
    :meth:`carry_exit`, with Kim's angle store converted to and from a
    phasor around the round trip (same contract as
    :meth:`slmsuite_torch.ops.fft._wgs_fused_step`)."""
    scal = _with_post(scal, post_scale(amp, psi.shape))
    gr, gi = carry_entry(psi, amp)
    hr, hi, wout, pff_out, sums, maxs = cols_wgs_roundtrip(
        gr, gi, weights, target, mask, wgs_phasor_entry(phase_ff) if kim else None,
        scal, rule=rule, kim=kim, stats_on=stats_on,
    )
    pff_out = wgs_phasor_exit(*pff_out) if kim else None
    return carry_exit(hr, hi), wout, pff_out, sums, maxs


def mraf_fused_step(psi, amp, weights, phase_ff, target, mask, mcode, scal,
                    *, rule, kim, stats_on):
    """#9, psi -> psi: :meth:`carry_entry`, :meth:`cols_mraf_fwd`,
    :meth:`cols_mraf_mix_inv` (no zero weights), :meth:`carry_exit` (same
    contract as :meth:`slmsuite_torch.ops.fft._mraf_fused_step`)."""
    scal = _with_post(scal, post_scale(amp, psi.shape))
    gr, gi = carry_entry(psi, amp)
    fr, fi, uw, sums, maxs = cols_mraf_fwd(
        gr, gi, weights, target, mask, scal, rule=rule, stats_on=stats_on
    )
    hr, hi, pff_out, _ = cols_mraf_mix_inv(
        fr, fi, uw, mcode, wgs_phasor_entry(phase_ff) if kim else None, None, sums,
        scal, kim=kim, zero=False,
    )
    pff_out = wgs_phasor_exit(*pff_out) if kim else None
    return carry_exit(hr, hi), uw, pff_out, sums, maxs
