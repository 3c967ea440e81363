r"""
The 2D transforms of the GS engine (PyTorch counterpart of
:mod:`slmsuite_tpu.ops.fft`): the carry-mode WGS step of the fused loop,
and the natural-order transforms of the natural (non-fused) step.

The loop carries the ROWS-TRANSFORMED field pair ``(gr, gi)``, the
unnormalized forward FFT along the last axis of ``amp * e^{i psi}``
(``e^{i psi}`` when the amplitude is a scalar; it folds into the step's
``post`` scale). One iteration is a column round trip (forward column
FFT, WGS epilogue, inverse column FFT) and a row round trip (inverse row
FFT, amplitude replacement ``Z/|Z|``, forward row FFT), so psi, ``|F|`` and
``arg F`` never exist inside the loop. The Kim phase store rides as a
unit-phasor pair ``(pffr, pffi)``; :meth:`wgs_phasor_entry` and
:meth:`wgs_phasor_exit` convert at the loop boundaries.

Everything is in natural order: the JAX package's scrambled layout
exists for the TPU's four-step FFT and is not ported. Two algebraic
substitutions make the update one-pass, as in the JAX package:

- deferred-by-one weight normalization: the weights are divided by the
  PREVIOUS iteration's norm (``inv_prev_norm``) and renormalized once on
  exit (every rule's correction is scale-free and psi is scale-invariant);
- the Parseval feedback norm: ``sum |F|^2 == sum amp^2`` for the ortho
  transform, so the feedback power is a precomputed constant.

The MRAF carry step (:meth:`mraf_carry_step`) runs on the same carry.
Its signal:noise mix needs the EXACT current weight norm, so its column
round trip is split in two around one device-side reduction: a forward
column pass that emits the scaled complex farfield ``F``, the
unnormalized updated weights ``uw`` and the stats (with ``sum uw^2``),
then the region mix and the inverse column pass, which read
``1/sqrt(sum uw^2)`` from the device sums. The row round trip is the WGS
step's.

The natural step takes :meth:`fft2_polar_from_phase` and
:meth:`wexp_ifft2_phase` when the farfield is the SLM plane, and
:meth:`fft2_polar` and :meth:`wexp_ifft2` on a padded canvas or with a
propagation kernel; its MRAF mix ends in :meth:`ifft2_phase` or
:meth:`ifft2`. Propagation outside the loop takes :meth:`fft2` and
:meth:`ifft2`. :meth:`wgs_fused_forward` is the forward half of a psi -> psi
WGS step (its backward half is :meth:`ifft2_phase`); :meth:`wgs_fused_step`
and :meth:`mraf_fused_step` are whole psi -> psi steps. No loop of the
engine runs these three: they are entry points of their own.

The underscored functions are the plain PyTorch versions of the CUDA
kernels in :mod:`slmsuite_torch.ops.cuda_fft` and of the dispatchers.
The dispatchers (:meth:`wgs_carry_entry`, :meth:`wgs_carry_step`,
:meth:`wgs_carry_exit`, :meth:`mraf_carry_step`, :meth:`fft2`,
:meth:`ifft2`, :meth:`ifft2_phase`, :meth:`fft2_polar`,
:meth:`fft2_polar_from_phase`, :meth:`wexp_ifft2`, :meth:`wexp_ifft2_phase`,
:meth:`wgs_fused_forward`, :meth:`wgs_fused_step`, :meth:`mraf_fused_step`) choose
a tier with :meth:`kernel_tier`, from the device and the shape alone, before
any launch. A CUDA tensor whose sides are multiples of 8 in [64, 8192]
launches the kernels. Any other CUDA shape takes the plain versions on the
card (the counterpart of the JAX package's einsum and ``jnp.fft`` tier for
shapes its Pallas kernels do not take), and each such dispatch adds one to
:data:`PLAIN_ON_DEVICE`. A CPU tensor takes the plain versions; a tensor on
any other device raises :class:`NotImplementedError`. The row-only
dispatchers (:meth:`wgs_carry_entry`, :meth:`wgs_carry_exit`,
:meth:`rows_fft`) read only the line length, and take any multiple of 8
rows (a row shard of a plane, :meth:`use_row_kernels`).

:meth:`fft2`, :meth:`ifft2`, :meth:`fft2_polar`, :meth:`fft2_polar_from_phase`
and :meth:`wexp_ifft2` also take a ``(B, H, W)`` stack of planes (the
batched multiplane engine's), transformed plane by plane: on the card one
launch of each kernel for all B planes, on the CPU the plain versions over
the last two dimensions. The gate reads the last two sides.
"""

import functools

import numpy as np
import torch

from slmsuite_torch.ops.stats import error_moments

#: Lane order of the step's device scalar buffer (see ``csrc/carry_shared.cuh``).
SCALAR_KEYS = (
    "post",               # 1/sqrt(HW), times the amplitude when it is a scalar
    "inv_prev_norm",      # 1 / previous iteration's weight norm
    "apply_update",       # 0/1: the WGS update is active (iteration > 0)
    "use_theta",          # 0/1: Kim takes the current farfield direction
    "feedback_exponent",
    "feedback_factor",
    "inv_fnorm",          # 1 / sqrt(Parseval feedback power)
    "inv_tsum",           # 1 / sum(target^2)
    "inv_fsum",           # 1 / Parseval feedback power
    "mraf_factor",        # MRAF noise-region factor k
    "zero_factor",        # MRAF zero-region weight step zf
)

#: Lanes only the MRAF step reads; :meth:`pack_scalars` sets them to 0
#: when they are not given.
_MRAF_KEYS = ("mraf_factor", "zero_factor")

_S = {key: lane for lane, key in enumerate(SCALAR_KEYS)}

#: Fill value standing in for -inf in the max partials.
_NEG_FILL = -3.0e38

#: Line lengths the CUDA kernels take: multiples of 8 in this range (the
#: column kernels' tiles are 8 columns wide; line_fft's plans reach 8192).
_KERNEL_MIN_LEN, _KERNEL_MAX_LEN = 64, 8192


def pack_scalars(values, device=None):
    """Stack ``values[key]`` for :data:`SCALAR_KEYS` into the f32 buffer
    the step reads (the MRAF-only lanes default to 0)."""
    values = {**dict.fromkeys(_MRAF_KEYS, 0.0), **values}
    return torch.stack(
        [torch.as_tensor(values[k], dtype=torch.float32, device=device)
         for k in SCALAR_KEYS]
    )


def is_scalar_amp(amp):
    """Whether the nearfield amplitude is a scalar (Python or 0-d)."""
    return not torch.is_tensor(amp) or amp.ndim == 0


@functools.lru_cache(maxsize=None)
def kernel_len_ok(n):
    """Whether a line of length ``n`` takes the CUDA kernels."""
    return _KERNEL_MIN_LEN <= n <= _KERNEL_MAX_LEN and n % 8 == 0


#: Dispatches that took the plain tier on a CUDA tensor (a plane whose sides
#: the kernels do not take). :meth:`reset_plain_count` zeroes it.
PLAIN_ON_DEVICE = 0


def reset_plain_count():
    """Zero :data:`PLAIN_ON_DEVICE`."""
    global PLAIN_ON_DEVICE
    PLAIN_ON_DEVICE = 0


def kernel_tier(device_type, shape, rows=False):
    """
    The tier a dispatcher takes, from the device type and the shape alone:
    ``"kernels"`` for a CUDA plane whose last two sides the kernels take
    (``rows``: whose last side they take, in a multiple of 8 rows), else
    ``"plain"``, the plain PyTorch versions (on the CPU, or on the card for
    the other shapes). Raises :class:`NotImplementedError` for a device
    other than the CPU or CUDA.
    """
    if device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise NotImplementedError(
            f"The transforms run on the CPU or on a CUDA device, not on {device_type}."
        )
    H, W = shape[-2:]
    ok = kernel_len_ok(W) and (H % 8 == 0 if rows else kernel_len_ok(H))
    return "kernels" if ok else "plain"


def _takes_kernels(x, rows):
    """Whether a dispatcher launches the kernels on ``x``; counts a plain
    dispatch on the card in :data:`PLAIN_ON_DEVICE`."""
    global PLAIN_ON_DEVICE
    if kernel_tier(x.device.type, x.shape, rows) == "kernels":
        return True
    if x.device.type != "cpu":
        PLAIN_ON_DEVICE += 1
    return False


def use_kernels(x):
    """The dispatchers' gate (:meth:`kernel_tier` of ``x``'s last two
    sides): True where the kernels launch, False where the plain versions
    run."""
    return _takes_kernels(x, rows=False)


def use_row_kernels(x):
    """The gate of the row-only dispatchers (:meth:`rows_fft`,
    :meth:`wgs_carry_entry`, :meth:`wgs_carry_exit`), which transform
    lines of the last side: True for a CUDA tensor whose last side the
    kernels take and whose rows (a plane's, or a row shard's of one) are a
    multiple of 8 in number, False where the plain versions run."""
    return _takes_kernels(x, rows=True)


def _cuda():
    """The kernels' module (imported on first use; importing builds nothing)."""
    from slmsuite_torch.ops import cuda_fft

    return cuda_fft


def _pair(z):
    return z.real.contiguous(), z.imag.contiguous()


def _ifft(z, dim):
    """Unnormalized inverse FFT (the kernels do not scale either)."""
    return torch.fft.ifft(z, dim=dim, norm="forward")


def _wgs_carry_entry(psi, amp):
    """psi -> rows-transformed carry of ``e^{i psi}`` (scalar amp) or
    ``amp * e^{i psi}`` (array amp). Unnormalized."""
    c, s = torch.cos(psi), torch.sin(psi)
    if not is_scalar_amp(amp):
        c, s = amp * c, amp * s
    return _pair(torch.fft.fft(torch.complex(c, s), dim=-1))


def _wgs_carry_exit(gr, gi):
    """Rows-transformed carry -> psi (the normalization drops out of atan2)."""
    z = _ifft(torch.complex(gr, gi), -1)
    return torch.atan2(z.imag, z.real)


def _wgs_correction(f, target, scal, rule):
    """Elementwise weight-correction factor ``c`` of the fusable rules
    (never depends on the weight scale)."""
    p = scal[_S["feedback_exponent"]]
    if rule in ("leonardo", "kim"):
        on = target != 0
        c = f / torch.where(on, target, 1.0)
        c = torch.where(on & (c > 0) & torch.isfinite(c), c, 1.0)
        c = torch.exp(-p * torch.log(c))
    elif rule in ("wu", "tanh"):
        term = p * (target - p * f * scal[_S["inv_fnorm"]])
        if rule == "wu":
            c = torch.exp(term)
        else:
            c = 1.0 + scal[_S["feedback_factor"]] * torch.tanh(term)
    else:
        raise ValueError(f"Unfusable rule '{rule}'.")
    return torch.where(torch.isinf(c), 1.0, c)


def _wgs_stats(f, target, mask, scal, norm_sq, stats_on):
    """Stats partials: sums = [overlap, err_sum, err_sq_sum, norm_sq]
    (float64; the overlap and norm summed in f32, the error moments in
    float64), maxs = [err_max, u_max, -err_min, -u_min] (float32)."""
    if not stats_on:
        zero = torch.zeros((), dtype=torch.float64, device=f.device)
        sums = torch.stack([zero, zero, zero, norm_sq.double()])
        return sums, torch.full((4,), _NEG_FILL, device=f.device)
    fsq = torch.square(f)
    tsq = torch.square(target)
    overlap = (target * f).sum()
    err_full = tsq * scal[_S["inv_tsum"]] - fsq * scal[_S["inv_fsum"]]
    err = err_full * mask
    on = mask > 0
    u = fsq / torch.where(on, tsq, 1.0)
    sums = torch.stack([overlap.double(), *error_moments(err), norm_sq.double()])
    maxs = torch.stack([
        torch.where(on, err_full, _NEG_FILL).max(),
        torch.where(on, u, _NEG_FILL).max(),
        torch.where(on, -err_full, _NEG_FILL).max(),
        torch.where(on, -u, _NEG_FILL).max(),
    ])
    return sums, maxs


def _unit_phasor(fr, fi):
    """``F/|F|`` without transcendentals; a zero field gives (1, 0), the
    ``atan2(0, 0) = 0`` convention."""
    f2 = torch.square(fr) + torch.square(fi)
    on = f2 > 0
    inv = torch.rsqrt(torch.where(on, f2, 1.0))
    return torch.where(on, fr * inv, 1.0), torch.where(on, fi * inv, 0.0)


def _cols_wgs_roundtrip(gr, gi, weights, target, mask, phase_ff, scal,
                        *, rule, kim, stats_on):
    """Column round trip of the step: forward column FFT (completing the
    2D transform), WGS epilogue, inverse column FFT. Returns ``(hr, hi,
    weights', phase_ff' | None, sums, maxs)``."""
    big = torch.fft.fft(torch.complex(gr, gi), dim=0)
    fr, fi = big.real, big.imag
    f2 = torch.square(fr) + torch.square(fi)
    f = torch.sqrt(f2) * scal[_S["post"]]

    uw = weights * _wgs_correction(f, target, scal, rule)
    uw = torch.where(torch.isnan(uw), 1e-4, uw)
    wout = torch.where(
        scal[_S["apply_update"]] > 0, uw * scal[_S["inv_prev_norm"]], weights
    )

    er, ei = _unit_phasor(fr, fi)
    if kim:
        use_theta = scal[_S["use_theta"]] > 0
        er = torch.where(use_theta, er, phase_ff[0])
        ei = torch.where(use_theta, ei, phase_ff[1])
        pff_out = (er, ei)
    else:
        pff_out = None

    sums, maxs = _wgs_stats(
        f, target, mask, scal, torch.square(wout).sum(), stats_on
    )

    hr, hi = _pair(_ifft(torch.complex(wout * er, wout * ei), 0))
    return hr, hi, wout, pff_out, sums, maxs


def _rows_normfwd(hr, hi, amp):
    """Row round trip of the step: inverse row FFT -> Z, amplitude
    replacement ``Z/|Z|`` or ``amp * Z/|Z|`` (zero -> 1 or amp, real),
    forward row FFT. Returns the next carry ``(gr, gi)``."""
    z = _ifft(torch.complex(hr, hi), -1)
    zr, zi = z.real, z.imag
    mag2 = torch.square(zr) + torch.square(zi)
    on = mag2 > 0
    inv = torch.rsqrt(torch.where(on, mag2, 1.0))
    if is_scalar_amp(amp):
        ur = torch.where(on, zr * inv, 1.0)
        ui = torch.where(on, zi * inv, 0.0)
    else:
        inv = amp * inv
        ur = torch.where(on, zr * inv, amp)
        ui = torch.where(on, zi * inv, 0.0)
    return _pair(torch.fft.fft(torch.complex(ur, ui), dim=-1))


def _wgs_carry_step(gr, gi, amp, weights, phase_ff, target, mask, scal,
                    *, rule, kim, stats_on):
    """Plain PyTorch version of one carry-mode WGS iteration (the two
    CUDA kernels of :meth:`slmsuite_torch.ops.cuda_fft.carry_step`).
    ``phase_ff`` is the Kim unit-phasor pair or None; ``scal`` the
    :data:`SCALAR_KEYS` buffer."""
    hr, hi, wout, pff_out, sums, maxs = _cols_wgs_roundtrip(
        gr, gi, weights, target, mask, phase_ff, scal,
        rule=rule, kim=kim, stats_on=stats_on,
    )
    gr2, gi2 = _rows_normfwd(hr, hi, amp)
    return gr2, gi2, wout, pff_out, sums, maxs


def _cols_mraf_fwd(gr, gi, weights, target, mask, scal, *, rule, stats_on):
    """Plain version of the ``cols_mraf_fwd`` kernel: the forward column
    FFT, the scaled complex farfield ``F = post * B``, the unnormalized
    weight update ``uw`` and the stats partials (``sums[3] = sum uw^2``).
    Returns ``(fr, fi, uw, sums, maxs)``."""
    fr, fi = _pair(torch.fft.fft(torch.complex(gr, gi), dim=0) * scal[_S["post"]])
    f = torch.sqrt(torch.square(fr) + torch.square(fi))
    uw = weights * _wgs_correction(f, target, scal, rule)
    uw = torch.where(torch.isnan(uw), 1e-4, uw)
    uw = torch.where(scal[_S["apply_update"]] > 0, uw * scal[_S["inv_prev_norm"]], weights)
    sums, maxs = _wgs_stats(f, target, mask, scal, torch.square(uw).sum(), stats_on)
    return fr, fi, uw, sums, maxs


def _cols_mraf_mix_inv(fr, fi, uw, mcode, phase_ff, zw, sums, scal, *, kim, zero):
    """Plain version of the ``cols_mraf_mix_inv`` kernel: the region mix
    on the free farfield ``F`` (region code 1: ``uw / ||uw|| * phasor``,
    2: ``k * F``, 0: 0, or with ``zero`` the updated zero weight ``zw' =
    zw - zf * |F| * F``), with ``||uw|| = sqrt(sums[3])``, then the
    unnormalized inverse column FFT. ``phase_ff`` is Kim's unit-phasor
    pair (None otherwise), ``zw`` the (2, H, W) zero weights (None
    without ``zero``). Returns ``(hr, hi, phase_ff' | None, zw' | None)``."""
    inv_norm = torch.rsqrt(sums[3].to(torch.float32))
    er, ei = _unit_phasor(fr, fi)
    pff_out = None
    if kim:
        use_theta = scal[_S["use_theta"]] > 0
        er = torch.where(use_theta, er, phase_ff[0])
        ei = torch.where(use_theta, ei, phase_ff[1])
        pff_out = (er, ei)
    k = scal[_S["mraf_factor"]]
    wn = uw * inv_norm
    sig, noi = mcode == 1.0, mcode == 2.0
    re = torch.where(sig, wn * er, torch.where(noi, k * fr, 0.0))
    im = torch.where(sig, wn * ei, torch.where(noi, k * fi, 0.0))
    zw_out = None
    if zero:
        zmask = mcode == 0.0
        step = scal[_S["zero_factor"]] * torch.sqrt(torch.square(fr) + torch.square(fi))
        zw_out = torch.stack([torch.where(zmask, zw[0] - step * fr, zw[0]),
                              torch.where(zmask, zw[1] - step * fi, zw[1])])
        re = torch.where(zmask, zw_out[0], re)
        im = torch.where(zmask, zw_out[1], im)
    hr, hi = _pair(_ifft(torch.complex(re, im), 0))
    return hr, hi, pff_out, zw_out


def _mraf_carry_step(gr, gi, amp, weights, phase_ff, target, mask, mcode, zw, scal,
                     *, rule, kim, stats_on, zero):
    """Plain PyTorch version of one carry-mode MRAF iteration (the three
    kernels of :meth:`slmsuite_torch.ops.cuda_fft.mraf_carry_step`)."""
    fr, fi, uw, sums, maxs = _cols_mraf_fwd(
        gr, gi, weights, target, mask, scal, rule=rule, stats_on=stats_on
    )
    hr, hi, pff_out, zw_out = _cols_mraf_mix_inv(
        fr, fi, uw, mcode, phase_ff, zw, sums, scal, kim=kim, zero=zero
    )
    gr2, gi2 = _rows_normfwd(hr, hi, amp)
    return gr2, gi2, uw, pff_out, zw_out, sums, maxs


def wgs_carry_entry(psi, amp):
    """psi (natural, unbounded range) -> rows-transformed field carry, of a
    plane or a row shard of one (the gate :meth:`use_row_kernels`)."""
    if use_row_kernels(psi):
        return _cuda().carry_entry(psi, amp)
    return _wgs_carry_entry(psi, amp)


def wgs_carry_exit(gr, gi):
    """Rows-transformed field carry -> psi, of a plane or a row shard of one
    (the gate :meth:`use_row_kernels`)."""
    if use_row_kernels(gr):
        return _cuda().carry_exit(gr, gi)
    return _wgs_carry_exit(gr, gi)


def rows_fft(xr, xi, *, inverse, scale=1.0):
    """The unnormalized FFT (``inverse``: inverse FFT) of every row of a pair,
    times ``scale``, on a plane, a row shard or a (B, H, W) stack (the gate
    :meth:`use_row_kernels`). Kernel: ``rows_fft``."""
    if use_row_kernels(xr):
        return _cuda().rows_fft(xr, xi, inverse=inverse, scale=scale)
    return _rows_fft(xr, xi, inverse=inverse, scale=scale)


def wgs_phasor_entry(phase_ff):
    """Kim phase-store angle plane -> unit-phasor pair."""
    return torch.cos(phase_ff), torch.sin(phase_ff)


def wgs_phasor_exit(pffr, pffi):
    """Unit-phasor pair -> angle plane."""
    return torch.atan2(pffi, pffr)


def wgs_carry_step(gr, gi, amp, weights, phase_ff, target, mask, scal,
                   *, rule, kim, stats_on):
    """
    One complete WGS iteration on the rows-transformed carry.

    Parameters
    ----------
    gr, gi : (H, W) f32 carry pair.
    amp : scalar or (H, W) nearfield amplitude.
    weights, target : (H, W) farfield weights and target amplitudes.
    phase_ff : Kim unit-phasor pair ``(pffr, pffi)`` or None.
    mask : (H, W) f32 0/1 stats mask, or None when ``stats_on`` is off.
    scal : f32 buffer in :data:`SCALAR_KEYS` order, on the device.
    rule : ``"leonardo"``, ``"kim"``, ``"wu"`` or ``"tanh"``.

    Returns
    -------
    ``(gr', gi', weights', phase_ff' | None, sums (4,), maxs (4,))`` with
    sums = [overlap, err_sum, err_sq_sum, |w'|^2] (float64) and maxs =
    [err_max, u_max, -err_min, -u_min] (float32).
    """
    if use_kernels(gr):
        return _cuda().carry_step(
            gr, gi, amp, weights, phase_ff, target, mask, scal,
            rule=rule, kim=kim, stats_on=stats_on,
        )
    return _wgs_carry_step(
        gr, gi, amp, weights, phase_ff, target, mask, scal,
        rule=rule, kim=kim, stats_on=stats_on,
    )


def mraf_carry_step(gr, gi, amp, weights, phase_ff, target, mask, mcode, zw, scal,
                    *, rule, kim, stats_on, zero):
    """
    One complete MRAF WGS iteration on the rows-transformed carry
    (``slmsuite_tpu.ops.fft.mraf_carry_step``).

    Parameters are those of :meth:`wgs_carry_step`, with ``target`` the
    cleaned target (noise region 0), plus ``mcode``, the (H, W) f32
    region code (1 signal, 2 noise, 0 zero), and ``zw``, the (2, H, W)
    zero-region weights (``zero=True``) or None. ``weights`` is the
    unnormalized carry; ``scal`` also carries ``mraf_factor`` and
    ``zero_factor``.

    Returns
    -------
    ``(gr', gi', uw, phase_ff' | None, zw' | None, sums (4,), maxs (4,))``
    with ``uw`` unnormalized and ``sums[3] = sum uw^2``. On the card: the
    kernels ``cols_mraf_fwd`` (with the stats reduction),
    ``cols_mraf_mix_inv`` (which reads the norm from the device sums: no
    host round trip) and ``rows_normfwd``.
    """
    if use_kernels(gr):
        return _cuda().mraf_carry_step(
            gr, gi, amp, weights, phase_ff, target, mask, mcode, zw, scal,
            rule=rule, kim=kim, stats_on=stats_on, zero=zero,
        )
    return _mraf_carry_step(
        gr, gi, amp, weights, phase_ff, target, mask, mcode, zw, scal,
        rule=rule, kim=kim, stats_on=stats_on, zero=zero,
    )


# ----------------------------------------------------------------------
# Natural-order 2D transforms of the engine's natural (non-fused) path.
# The JAX package's counterparts are its ``*_scrambled*`` functions; the
# port has no scrambled layout, so the names drop the word.
# ----------------------------------------------------------------------


def ortho_scale(shape):
    """``1 / sqrt(H W)``: the orthonormal 2D scale of an (H, W) plane."""
    return 1.0 / np.sqrt(shape[-2] * shape[-1])


def post_scale(amp, shape):
    """Scale of ``|F|`` after :meth:`wgs_carry_entry`, which leaves a
    scalar amplitude out: ``amp / sqrt(HW)`` for a scalar (which must not
    be negative), ``1 / sqrt(HW)`` for an amplitude plane."""
    if not is_scalar_amp(amp):
        return ortho_scale(shape)
    amp = float(amp)
    if amp < 0:
        raise ValueError(f"A scalar nearfield amplitude must be >= 0, not {amp}.")
    return amp * ortho_scale(shape)


def _polar(z):
    return torch.sqrt(torch.square(z.real) + torch.square(z.imag)), torch.atan2(z.imag, z.real)


def _rows_fft(xr, xi, *, inverse, scale=1.0):
    """Plain version of the ``rows_fft`` kernel: the unnormalized FFT
    (or inverse FFT) of every row, times ``scale``."""
    z = torch.complex(xr, xi)
    z = _ifft(z, -1) if inverse else torch.fft.fft(z, dim=-1)
    return _pair(z * scale)


def _cols_fft(xr, xi, *, inverse, scale=1.0):
    """Plain version of the ``cols_fft`` kernel: the unnormalized FFT (or
    inverse FFT) of every column, times ``scale``."""
    z = torch.complex(xr, xi)
    z = _ifft(z, -2) if inverse else torch.fft.fft(z, dim=-2)
    return _pair(z * scale)


def _cols_fwd_polar(xr, xi, scale):
    """Plain version of the ``cols_fwd_polar`` kernel: the forward FFT of
    every column, returned as ``(scale * |F|, arg F)``."""
    amp, theta = _polar(torch.fft.fft(torch.complex(xr, xi), dim=-2))
    return amp * scale, theta


def _cols_wgs_fwd(gr, gi, weights, target, mask, phase_ff, scal,
                  *, rule, kim, stats_on):
    """Plain version of the ``cols_wgs_fwd`` kernel: the forward column
    FFT of the rows-transformed carry (scaled by the ``post`` lane), then
    the WGS epilogue on the angle store. Returns ``(re, im, weights',
    phase_ff' | None, sums, maxs)``."""
    fr, fi = _pair(torch.fft.fft(torch.complex(gr, gi), dim=0) * scal[_S["post"]])
    f, theta, wout = _farfield_update(fr, fi, weights, target, scal, rule)
    phase, pff_out = _constraint_phase(theta, phase_ff, scal, kim)
    sums, maxs = _wgs_stats(f, target, mask, scal, torch.square(wout).sum(), stats_on)
    return wout * torch.cos(phase), wout * torch.sin(phase), wout, pff_out, sums, maxs


def _cols_wexp_inv(weights, phase):
    """Plain version of the ``cols_wexp_inv`` kernel: ``w * e^{i phase}``,
    then the unnormalized inverse FFT of every column."""
    z = torch.complex(weights * torch.cos(phase), weights * torch.sin(phase))
    return _pair(_ifft(z, -2))


def _fft2(xr, xi):
    """Plain version of :meth:`fft2` (``torch.fft.fft2``, ortho)."""
    return _pair(torch.fft.fft2(torch.complex(xr, xi), norm="ortho"))


def _ifft2(xr, xi):
    """Plain version of :meth:`ifft2` (``torch.fft.ifft2``, ortho)."""
    return _pair(torch.fft.ifft2(torch.complex(xr, xi), norm="ortho"))


def _fft2_polar(xr, xi):
    """Plain version of :meth:`fft2_polar`."""
    return _polar(torch.fft.fft2(torch.complex(xr, xi), norm="ortho"))


def _fft2_polar_from_phase(psi, amp):
    """Plain version of :meth:`fft2_polar_from_phase`."""
    z = torch.complex(amp * torch.cos(psi), amp * torch.sin(psi))
    return _polar(torch.fft.fft2(z, norm="ortho"))


def _wexp_ifft2(weights, phase):
    """Plain version of :meth:`wexp_ifft2`."""
    z = torch.complex(weights * torch.cos(phase), weights * torch.sin(phase))
    return _pair(torch.fft.ifft2(z, norm="ortho"))


def _wexp_ifft2_phase(weights, phase):
    """Plain version of :meth:`wexp_ifft2_phase`."""
    z = torch.complex(weights * torch.cos(phase), weights * torch.sin(phase))
    z = torch.fft.ifft2(z, norm="ortho")
    return torch.atan2(z.imag, z.real)


def _ifft2_phase(xr, xi):
    """Plain version of :meth:`ifft2_phase`."""
    z = torch.fft.ifft2(torch.complex(xr, xi), norm="ortho")
    return torch.atan2(z.imag, z.real)


def _farfield_update(fr, fi, weights, target, scal, rule):
    """The psi -> psi steps' forward half: ``(f, theta, uw)`` with ``uw``
    the weight update under the deferred norm (the weights themselves
    before the update is on)."""
    f = torch.sqrt(torch.square(fr) + torch.square(fi))
    theta = torch.atan2(fi, fr)
    uw = weights * _wgs_correction(f, target, scal, rule)
    uw = torch.where(torch.isnan(uw), 1e-4, uw)
    uw = torch.where(scal[_S["apply_update"]] > 0, uw * scal[_S["inv_prev_norm"]], weights)
    return f, theta, uw


def _constraint_phase(theta, phase_ff, scal, kim):
    """Kim's select on the angle store: the current angle while
    ``use_theta``, else the stored one. Returns ``(phase, phase_ff' |
    None)``."""
    if not kim:
        return theta, None
    phase = torch.where(scal[_S["use_theta"]] > 0, theta, phase_ff)
    return phase, phase


def _wgs_fused_forward(psi, amp, weights, phase_ff, target, mask, scal,
                       *, rule, kim, stats_on):
    """Plain version of :meth:`wgs_fused_forward`: ortho fft2 of ``amp *
    e^{i psi}``, the WGS epilogue on the angle store, and the constrained
    farfield ``w' e^{i phase}`` as an (re, im) pair."""
    fr, fi = _fft2(amp * torch.cos(psi), amp * torch.sin(psi))
    f, theta, wout = _farfield_update(fr, fi, weights, target, scal, rule)
    phase, pff_out = _constraint_phase(theta, phase_ff, scal, kim)
    sums, maxs = _wgs_stats(f, target, mask, scal, torch.square(wout).sum(), stats_on)
    return wout * torch.cos(phase), wout * torch.sin(phase), wout, pff_out, sums, maxs


def _wgs_fused_step(psi, amp, weights, phase_ff, target, mask, scal,
                    *, rule, kim, stats_on):
    """Plain version of :meth:`wgs_fused_step`: the forward half
    (:meth:`_wgs_fused_forward`), then ``arg ifft2`` of the constrained
    farfield."""
    re, im, wout, pff_out, sums, maxs = _wgs_fused_forward(
        psi, amp, weights, phase_ff, target, mask, scal,
        rule=rule, kim=kim, stats_on=stats_on,
    )
    return _ifft2_phase(re, im), wout, pff_out, sums, maxs


def _mraf_fused_step(psi, amp, weights, phase_ff, target, mask, mcode, scal,
                     *, rule, kim, stats_on):
    """Plain version of :meth:`mraf_fused_step`: as
    :meth:`_wgs_fused_step`, with the MRAF mix (signal ``uw / ||uw|| *
    e^{i phase}``, noise ``k |F| e^{i theta}``, zero 0) before the inverse
    transform."""
    fr, fi = _fft2(amp * torch.cos(psi), amp * torch.sin(psi))
    f, theta, uw = _farfield_update(fr, fi, weights, target, scal, rule)
    phase, pff_out = _constraint_phase(theta, phase_ff, scal, kim)
    norm_sq = torch.square(uw).sum()
    wn = uw * torch.rsqrt(norm_sq)
    kf = scal[_S["mraf_factor"]] * f
    sig, noi = mcode == 1.0, mcode == 2.0
    re = torch.where(sig, wn * torch.cos(phase), torch.where(noi, kf * torch.cos(theta), 0.0))
    im = torch.where(sig, wn * torch.sin(phase), torch.where(noi, kf * torch.sin(theta), 0.0))
    sums, maxs = _wgs_stats(f, target, mask, scal, norm_sq, stats_on)
    return _ifft2_phase(re, im), uw, pff_out, sums, maxs


def fft2(xr, xi):
    """Ortho 2D FFT of an (re, im) pair, in natural order
    (``slmsuite_tpu.ops.fft.fft2_scrambled``, whose output is scrambled).
    Kernels: ``rows_fft``, then ``cols_fft`` with the ortho scale."""
    if use_kernels(xr):
        return _cuda().fft2(xr, xi)
    return _fft2(xr, xi)


def ifft2(xr, xi):
    """Ortho inverse 2D FFT of an (re, im) pair, in natural order
    (``slmsuite_tpu.ops.fft.ifft2_scrambled``, whose input is scrambled), of
    an (H, W) plane or of each plane of a (B, H, W) stack. Kernels:
    ``cols_fft``, then ``rows_fft`` with the ortho scale."""
    if use_kernels(xr):
        return _cuda().ifft2(xr, xi)
    return _ifft2(xr, xi)


def fft2_polar(xr, xi):
    """``(|F|, arg F)`` of the ortho 2D FFT of an (re, im) pair
    (``slmsuite_tpu.ops.fft.fft2_scrambled_polar``). Kernels:
    ``rows_fft``, then ``cols_fwd_polar``."""
    if use_kernels(xr):
        return _cuda().fft2_polar(xr, xi)
    return _fft2_polar(xr, xi)


def fft2_polar_from_phase(psi, amp):
    """``(|F|, arg F)`` of the ortho 2D FFT of ``amp * e^{i psi}``, with
    a scalar or (H, W) ``amp``
    (``slmsuite_tpu.ops.fft.fft2_scrambled_polar_from_phase``); ``psi`` is
    an (H, W) plane or a (B, H, W) stack whose planes share ``amp``.
    Kernels: ``carry_entry``, then ``cols_fwd_polar``."""
    if use_kernels(psi):
        return _cuda().fft2_polar_from_phase(psi, amp)
    return _fft2_polar_from_phase(psi, amp)


def wexp_ifft2_phase(weights, phase):
    """``arg ifft2(weights * e^{i phase})``: the backward half of the
    natural step when the farfield is the SLM plane
    (``slmsuite_tpu.ops.fft.wexp_ifft2_scrambled_phase``). Kernels:
    ``cols_wexp_inv``, then ``carry_exit``."""
    if use_kernels(weights):
        return _cuda().wexp_ifft2_phase(weights, phase)
    return _wexp_ifft2_phase(weights, phase)


def wexp_ifft2(weights, phase):
    """Ortho inverse 2D FFT of ``weights * e^{i phase}`` as an (re, im)
    pair: the backward half of the natural step on a padded canvas or
    with a propagation kernel (``slmsuite_tpu.ops.fft.wexp_ifft2_scrambled``,
    whose input is scrambled), and of the multiplane engine on a (B, H, W)
    stack. Kernels: ``cols_wexp_inv``, then ``rows_fft`` with the ortho
    scale."""
    if use_kernels(weights):
        return _cuda().wexp_ifft2(weights, phase)
    return _wexp_ifft2(weights, phase)


def ifft2_phase(xr, xi):
    """``arg ifft2(xr + i xi)`` (ortho): the backward half of the natural
    MRAF step when the farfield is the SLM plane
    (``slmsuite_tpu.ops.fft.ifft2_scrambled_phase``). Kernels:
    ``cols_fft`` (inverse), then ``carry_exit``."""
    if use_kernels(xr):
        return _cuda().ifft2_phase(xr, xi)
    return _ifft2_phase(xr, xi)


def wgs_fused_forward(psi, amp, weights, phase_ff, target, mask, scal,
                      *, rule, kim, stats_on):
    """
    The forward half of one WGS iteration, psi in -> constrained farfield
    out (``slmsuite_tpu.ops.fft.wgs_fused_forward``, in natural order):
    ``F = fft2(amp e^{i psi})`` (ortho), the rule's weight update under
    the deferred norm, Kim's select on the angle store, ``(re, im) = w'
    (cos, sin)(phase)`` and the stats partials. :meth:`ifft2_phase` of
    ``(re, im)`` completes the iteration.

    Parameters
    ----------
    psi : (H, W) folded nearfield phase (any range).
    amp : scalar or (H, W) nearfield amplitude.
    weights, target : (H, W) farfield planes.
    phase_ff : (H, W) stored farfield angle (Kim) or None.
    mask : (H, W) f32 0/1 stats mask, or None when ``stats_on`` is off.
    scal : the :data:`SCALAR_KEYS` buffer; its ``post`` lane is not read
        (the function derives it from ``amp``).
    rule : ``"leonardo"``, ``"kim"``, ``"wu"`` or ``"tanh"``.

    Returns
    -------
    ``(re, im, weights', phase_ff' | None, sums (4,), maxs (4,))`` with
    sums = [overlap, err_sum, err_sq_sum, |w'|^2] (float64; ``[0, 0, 0,
    |w'|^2]`` without stats) and maxs = [err_max, u_max, -err_min, -u_min]
    (float32; all -3e38 without stats). Kernels: ``carry_entry``, then
    ``cols_wgs_fwd`` (with the stats reduction).
    """
    if use_kernels(psi):
        return _cuda().wgs_fused_forward(
            psi, amp, weights, phase_ff, target, mask, scal,
            rule=rule, kim=kim, stats_on=stats_on,
        )
    return _wgs_fused_forward(
        psi, amp, weights, phase_ff, target, mask, scal,
        rule=rule, kim=kim, stats_on=stats_on,
    )


def wgs_fused_step(psi, amp, weights, phase_ff, target, mask, scal,
                   *, rule, kim, stats_on):
    """
    One complete WGS iteration, psi in -> psi out
    (``slmsuite_tpu.ops.fft.wgs_fused_step``), with Kim's store as an
    angle plane. ``scal`` is the :data:`SCALAR_KEYS` buffer; its ``post``
    lane is not read (the step derives it from ``amp``). Returns ``(psi',
    weights', phase_ff' | None, sums, maxs)`` with the conventions of
    :meth:`wgs_carry_step`. Kernels: ``carry_entry``,
    ``cols_wgs_roundtrip``, ``carry_exit``.
    """
    if use_kernels(psi):
        return _cuda().wgs_fused_step(
            psi, amp, weights, phase_ff, target, mask, scal,
            rule=rule, kim=kim, stats_on=stats_on,
        )
    return _wgs_fused_step(
        psi, amp, weights, phase_ff, target, mask, scal,
        rule=rule, kim=kim, stats_on=stats_on,
    )


def mraf_fused_step(psi, amp, weights, phase_ff, target, mask, mcode, scal,
                    *, rule, kim, stats_on):
    """
    One complete MRAF iteration, psi in -> psi out
    (``slmsuite_tpu.ops.fft.mraf_fused_step``), with Kim's store as an
    angle plane and no zero-region weights. ``weights`` is the
    unnormalized carry; the exact norm of ``uw`` is ``sqrt(sums[3])``.
    Returns ``(psi', uw, phase_ff' | None, sums, maxs)``. Kernels:
    ``carry_entry``, ``cols_mraf_fwd``, ``cols_mraf_mix_inv``,
    ``carry_exit``.
    """
    if use_kernels(psi):
        return _cuda().mraf_fused_step(
            psi, amp, weights, phase_ff, target, mask, mcode, scal,
            rule=rule, kim=kim, stats_on=stats_on,
        )
    return _mraf_fused_step(
        psi, amp, weights, phase_ff, target, mask, mcode, scal,
        rule=rule, kim=kim, stats_on=stats_on,
    )
