r"""
Compressed (grid-free) spot transforms and the compressed GS engine
(PyTorch counterpart of :mod:`slmsuite_tpu.ops.compressed`).

The farfield is a length-``N`` complex vector of spot amplitudes and the
transform pair is

.. math::
    \text{nf}[p] = \sum_n \text{ff}[n]\, e^{i \Phi[n,p]} / \sqrt{P}
    \qquad
    \text{ff}[n] = \sum_p e^{-i \Phi[n,p]}\, \text{nf}[p] / \sqrt{P},
    \qquad \Phi[n, p] = \sum_d c[d,n] B[d,p]

with :math:`B` the ``(D, P)`` Zernike basis on the SLM grid
(:meth:`build_zernike_basis`) and :math:`c` the ``(D, N)`` per-spot
coefficients. Pairs are real ``(re, im)`` tensors.

The underscored functions are the plain PyTorch versions of the CUDA
kernels in :mod:`slmsuite_torch.ops.cuda_compressed`, on pixel tiles of at most
:data:`PIXEL_TILE`. The dispatchers :meth:`farfield_to_nearfield`,
:meth:`nearfield_to_farfield`, :meth:`fused_iteration` and
:meth:`fused_iteration_cached` take the plain versions for CPU tensors and
launch the kernels for CUDA tensors. The cached entry and exit
(:meth:`nearfield_to_farfield_cached`, :meth:`farfield_to_nearfield_cached`)
are matrix products on the cache, as in the JAX package.

The engine (:meth:`run_compressed_gs`) carries the farfield: the loop
state holds the unnormalized farfield entering an iteration and the last
constrained farfield, and each iteration is one fused round trip
(:meth:`fused_iteration`, or :meth:`fused_iteration_cached` streaming the
cos/sin cache of :meth:`build_kernel_cache`) around an O(N) epilogue in
PyTorch on device tensors: the norm, the stats, the weight update, Kim's
phase fixing and the per-spot MRAF mix. The fixed-phase flag, the streak
and the iteration stay device scalars: the loop never syncs with the host.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from slmsuite_torch.misc import profile as _profile
from slmsuite_torch.ops.stats import calculate_stats
from slmsuite_torch.ops.weights import update_weights_generic

#: Pixel-tile length of the plain versions and of the cache.
PIXEL_TILE = 8192


@_profile.spanned("compressed.basis")
def build_zernike_basis(indices, slm, dtype=np.float32):
    """
    The Zernike basis stack ``(D, H*W)`` (numpy) of the ANSI ``indices``
    (``-1`` is the vortex) on the SLM's grid, scaled by its source
    (``get_source_zernike_scaling``).
    """
    from slmsuite_torch.holography.toolbox import _process_grid
    from slmsuite_torch.holography.toolbox.phase import zernike_aperture, zernike_sum

    indices = np.ravel(indices)
    x_grid, y_grid = _process_grid(slm)
    x_scale, y_scale = zernike_aperture(slm, aperture=None)
    basis = zernike_sum(
        (np.asarray(x_grid) * x_scale, np.asarray(y_grid) * y_scale),
        indices,
        np.eye(len(indices)),
        aperture=1,
        use_mask=False,
    )
    return np.asarray(basis, dtype=dtype).reshape(len(indices), -1)


def _on_card(x):
    """The dispatchers' gate: False for a CPU tensor (the plain versions),
    True for a CUDA tensor (the kernels); raises for anything else."""
    if x.device.type == "cpu":
        return False
    if x.is_cuda:
        return True
    raise NotImplementedError(f"The compressed transforms take CPU or CUDA tensors, "
                              f"not {x.device}.")


def _cuda():
    """The kernels' module (imported on first use; importing builds nothing)."""
    from slmsuite_torch.ops import cuda_compressed

    return cuda_compressed


def _is_scalar(amp):
    return not torch.is_tensor(amp) or amp.ndim == 0


def _pad_to(x, size, dim):
    pad = size - x.shape[dim]
    if pad <= 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - dim % x.ndim) + [0, pad]
    return torch.nn.functional.pad(x, widths)


def _n_tiles(P, tile=PIXEL_TILE):
    return -(-P // tile)


def _transform_tile(P):
    """Pixel-tile length of the plain transforms: :data:`PIXEL_TILE`, or
    ``P`` where that is shorter (the tile's pad pixels add nothing)."""
    return min(PIXEL_TILE, P)


def _basis_tiles(basis, tile=PIXEL_TILE):
    """``(n_tiles, D, tile)``, zero-padded pixels."""
    D, P = basis.shape
    n = _n_tiles(P, tile)
    return _pad_to(basis, n * tile, 1).reshape(D, n, tile).transpose(0, 1)


def _pixel_tiles(x, n_tiles, tile=PIXEL_TILE):
    return _pad_to(x, n_tiles * tile, 0).reshape(n_tiles, tile)


def _tile_sincos(coeffs, basis_tile):
    """``(cos, sin)`` of the ``(N, T)`` phases ``c^T B`` of one tile."""
    phases = coeffs.T @ basis_tile
    return torch.cos(phases), torch.sin(phases)


def _amp_replace(re, im, amp, valid):
    """
    Amplitude replacement ``amp * nf/|nf|``, the one definition shared by
    the plain round trips (and by the kernels, ``compressed.cu``):

    - a zero field becomes unit real (the ``atan2(0, 0) = 0`` convention);
    - ``valid`` (0/1) masks padded pixels to zero;
    - the rsqrt is taken of a guarded ``|nf|^2``, so no ``0 * inf`` appears.

    ``amp`` is None for a scalar amplitude (unit modulus: the scale drops
    out in the caller's normalization). Returns ``(ur, ui)``.
    """
    mag2 = re * re + im * im
    on = mag2 > 0
    safe = torch.rsqrt(torch.where(on, mag2, 1.0))
    scale = valid if amp is None else valid * amp
    inv = scale * safe
    return torch.where(on, re * inv, scale), torch.where(on, im * inv, 0.0)


def _farfield_to_nearfield(ff_re, ff_im, coeffs, basis, amp=None):
    """Plain version of :meth:`farfield_to_nearfield`; given ``amp`` (a
    scalar or ``(P,)``), the amplitude replacement ``amp nf/|nf|`` of the
    unscaled sum instead (scalar: unit amplitude), as ``cuda_compressed.f2n``
    takes it."""
    P = basis.shape[1]
    scale = 1.0 / np.sqrt(P) if amp is None else 1.0
    out_re, out_im = [], []
    for basis_tile in _basis_tiles(basis, _transform_tile(P)):
        cos, sin = _tile_sincos(coeffs, basis_tile)
        out_re.append((ff_re @ cos - ff_im @ sin) * scale)
        out_im.append((ff_re @ sin + ff_im @ cos) * scale)
    re, im = torch.cat(out_re)[:P], torch.cat(out_im)[:P]
    if amp is None:
        return re, im
    return _amp_replace(re, im, None if _is_scalar(amp) else amp, 1.0)


def _nearfield_to_farfield_raw(nf_re, nf_im, coeffs, basis, scale=None):
    """The unnormalized ``(N,)`` overlap ``scale sum_p e^{-i Phi} nf``,
    ``scale`` by default ``P^-1/2``."""
    P = basis.shape[1]
    tile = _transform_tile(P)
    n = _n_tiles(P, tile)
    re_t, im_t = _pixel_tiles(nf_re, n, tile), _pixel_tiles(nf_im, n, tile)
    acc_re = torch.zeros(coeffs.shape[1], dtype=torch.float32, device=basis.device)
    acc_im = torch.zeros_like(acc_re)
    for t, basis_tile in enumerate(_basis_tiles(basis, tile)):
        cos, sin = _tile_sincos(coeffs, basis_tile)
        acc_re = acc_re + cos @ re_t[t] + sin @ im_t[t]
        acc_im = acc_im + cos @ im_t[t] - sin @ re_t[t]
    if scale is None:
        scale = 1.0 / np.sqrt(P)
    return acc_re * scale, acc_im * scale


def _unit(re, im):
    norm = torch.sqrt(torch.sum(torch.square(re) + torch.square(im)))
    return re / norm, im / norm


def _nearfield_to_farfield(nf_re, nf_im, coeffs, basis, normalize=True):
    """Plain version of :meth:`nearfield_to_farfield`; ``normalize`` False
    gives the sum ``sum_p e^{-i Phi} nf`` itself, neither scaled nor
    normalized, as ``cuda_compressed.n2f`` takes it."""
    if not normalize:
        return _nearfield_to_farfield_raw(nf_re, nf_im, coeffs, basis, scale=1.0)
    return _unit(*_nearfield_to_farfield_raw(nf_re, nf_im, coeffs, basis))


def build_kernel_cache(coeffs, basis):
    """
    The constant transform kernel as pixel-tiled cos/sin stacks ``(kc,
    ks)``, each ``(n_tiles, N8, PIXEL_TILE)``: the spot axis is padded to a
    multiple of 8 with zero coefficients (phase 0: cos 1, sin 0), which the
    consumers skip or zero, and the pixel axis to whole tiles (basis 0).
    The layout is the JAX package's.
    """
    N = coeffs.shape[1]
    coeffs = _pad_to(coeffs, -(-N // 8) * 8, 1)
    pairs = [_tile_sincos(coeffs, tile) for tile in _basis_tiles(basis)]
    return torch.stack([c for c, _ in pairs]), torch.stack([s for _, s in pairs])


#: Shared memory a block of ``fused_iter_cached``'s kernel may take on the
#: H100 (227 KiB), in bytes.
CACHED_SMEM_LIMIT = 227 * 1024


def fused_iter_cached_ok(n_spots):
    """Whether ``fused_iter_cached``'s kernel takes ``n_spots`` spots: their
    farfield and sums, four floats a spot, and 4 KiB more within a block's
    shared memory (up to 14,272 spots). The compressed hologram leaves the
    cache off past it, as the JAX package's dispatcher leaves its kernel
    (``fused_iter_cached_ok``)."""
    return n_spots >= 1 and 4 * n_spots * 4 + 4096 <= CACHED_SMEM_LIMIT


def kernel_cache_bytes(n_spots, n_pixels):
    """Device bytes of :meth:`build_kernel_cache` for a shape."""
    return 2 * 4 * (-(-n_spots // 8) * 8) * _n_tiles(n_pixels) * PIXEL_TILE


def farfield_to_nearfield_cached(ff_re, ff_im, kc, ks, n_pixels):
    """Cached twin of :meth:`farfield_to_nearfield`: the farfield is
    zero-padded to the cache's spot axis, so the pad rows add nothing."""
    N8 = kc.shape[1]
    ff_re, ff_im = _pad_to(ff_re, N8, 0), _pad_to(ff_im, N8, 0)
    scale = 1.0 / np.sqrt(n_pixels)
    # Batched products over the tiles read the cache in place (an einsum
    # over its middle axis would copy it).
    re = torch.matmul(ff_re, kc) - torch.matmul(ff_im, ks)
    im = torch.matmul(ff_re, ks) + torch.matmul(ff_im, kc)
    return (re.reshape(-1)[:n_pixels] * scale, im.reshape(-1)[:n_pixels] * scale)


def nearfield_to_farfield_cached(nf_re, nf_im, kc, ks, n_pixels, n_spots=None):
    """Cached twin of :meth:`nearfield_to_farfield` (unit norm). The pad
    rows of the spot axis are sliced off (``n_spots``) before the norm:
    they synthesize phase 0 and would count in it."""
    n_tiles, _, T = kc.shape
    re_t, im_t = _pixel_tiles(nf_re, n_tiles, T), _pixel_tiles(nf_im, n_tiles, T)

    def project(k, x):
        return torch.matmul(k, x.unsqueeze(-1)).sum(dim=0).squeeze(-1)

    ff_re = project(kc, re_t) + project(ks, im_t)
    ff_im = project(kc, im_t) - project(ks, re_t)
    if n_spots is not None:
        ff_re, ff_im = ff_re[:n_spots], ff_im[:n_spots]
    scale = 1.0 / np.sqrt(n_pixels)
    return _unit(ff_re * scale, ff_im * scale)


def _valid_tiles(P, n_tiles, tile, device):
    index = torch.arange(n_tiles * tile, device=device).reshape(n_tiles, tile)
    return (index < P).to(torch.float32)


def _roundtrip_tile(ff_re, ff_im, cos, sin, amp_tile, valid):
    """One tile's share of the round trip: expand, replace, reduce."""
    re = ff_re @ cos - ff_im @ sin
    im = ff_re @ sin + ff_im @ cos
    ur, ui = _amp_replace(re, im, amp_tile, valid)
    return cos @ ur + sin @ ui, cos @ ui - sin @ ur


def _fused_iteration(ff_re, ff_im, coeffs, basis, amp):
    """Plain version of :meth:`fused_iteration`: one round trip ff -> nf
    -> amp nf/|nf| -> ff' on one phase and sincos evaluation per tile,
    unnormalized (no ``P^-1/2`` scales)."""
    P = basis.shape[1]
    tile = _transform_tile(P)
    n = _n_tiles(P, tile)
    valid = _valid_tiles(P, n, tile, basis.device)
    amp_t = None if _is_scalar(amp) else _pixel_tiles(amp, n, tile)
    acc_re = torch.zeros(coeffs.shape[1], dtype=torch.float32, device=basis.device)
    acc_im = torch.zeros_like(acc_re)
    for t, basis_tile in enumerate(_basis_tiles(basis, tile)):
        cos, sin = _tile_sincos(coeffs, basis_tile)
        fr, fi = _roundtrip_tile(ff_re, ff_im, cos, sin,
                                 None if amp_t is None else amp_t[t], valid[t])
        acc_re, acc_im = acc_re + fr, acc_im + fi
    return acc_re, acc_im


def _fused_iteration_cached(ff_re, ff_im, kc, ks, amp, n_spots, n_pixels):
    """Plain version of :meth:`fused_iteration_cached`: the round trip of
    :meth:`_fused_iteration` with cos/sin read from the cache (its pad
    spots see a zero farfield and are sliced off)."""
    n_tiles, N8, T = kc.shape
    ff_re, ff_im = _pad_to(ff_re, N8, 0), _pad_to(ff_im, N8, 0)
    valid = _valid_tiles(n_pixels, n_tiles, T, kc.device)
    amp_t = None if _is_scalar(amp) else _pixel_tiles(amp, n_tiles, T)
    acc_re = torch.zeros(N8, dtype=torch.float32, device=kc.device)
    acc_im = torch.zeros_like(acc_re)
    for t in range(n_tiles):
        fr, fi = _roundtrip_tile(ff_re, ff_im, kc[t], ks[t],
                                 None if amp_t is None else amp_t[t], valid[t])
        acc_re, acc_im = acc_re + fr, acc_im + fi
    return acc_re[:n_spots], acc_im[:n_spots]


def farfield_to_nearfield(ff_re, ff_im, coeffs, basis):
    """
    The ``(P,)`` nearfield pair of the ``(N,)`` farfield pair, ``coeffs (D,
    N)``, ``basis (D, P)`` (``slmsuite_tpu.ops.compressed.
    farfield_to_nearfield``). Kernel: ``f2n``.
    """
    if _on_card(basis):
        return _cuda().f2n(ff_re, ff_im, coeffs, basis)
    return _farfield_to_nearfield(ff_re, ff_im, coeffs, basis)


def nearfield_to_farfield(nf_re, nf_im, coeffs, basis):
    """
    The unit-norm ``(N,)`` farfield pair of the ``(P,)`` nearfield pair
    (``slmsuite_tpu.ops.compressed.nearfield_to_farfield``). Kernel:
    ``n2f``.
    """
    if _on_card(basis):
        return _cuda().n2f(nf_re, nf_im, coeffs, basis)
    return _nearfield_to_farfield(nf_re, nf_im, coeffs, basis)


def nearfield_overlap(nf_re, nf_im, coeffs, basis):
    """
    The ``(N,)`` sum ``sum_p e^{-i Phi} nf`` itself, neither scaled nor
    normalized: a pixel slab's share of :meth:`nearfield_to_farfield`
    (``slmsuite_tpu.ops.compressed.nearfield_to_farfield_raw`` without its
    scale). Kernel: ``n2f`` unnormalized.
    """
    if _on_card(basis):
        return _cuda().n2f(nf_re, nf_im, coeffs, basis, normalize=False)
    return _nearfield_to_farfield(nf_re, nf_im, coeffs, basis, normalize=False)


def fused_iteration(ff_re, ff_im, coeffs, basis, amp):
    """
    One round trip ``ff -> nf -> amp nf/|nf| -> ff'`` on one phase
    evaluation, ``amp`` a scalar or ``(P,)``; returns the unnormalized
    farfield pair (``slmsuite_tpu.ops.compressed.fused_iteration``).
    Kernel: ``fused_iter``.
    """
    if _on_card(basis):
        return _cuda().fused_iter(ff_re, ff_im, coeffs, basis, amp)
    return _fused_iteration(ff_re, ff_im, coeffs, basis, amp)


def fused_iteration_cached(ff_re, ff_im, kc, ks, amp, n_spots, n_pixels):
    """
    The round trip of :meth:`fused_iteration` on the cos/sin cache of
    :meth:`build_kernel_cache` (``slmsuite_tpu.ops.compressed.
    fused_iteration_cached``). Kernel: ``fused_iter_cached``.
    """
    if _on_card(kc):
        return _cuda().fused_iter_cached(ff_re, ff_im, kc, ks, amp, n_spots, n_pixels)
    return _fused_iteration_cached(ff_re, ff_im, kc, ks, amp, n_spots, n_pixels)


def apply_compressed_mraf_mix(ffp_re, ffp_im, ff_re, ff_im, consts,
                              zero_re=None, zero_im=None):
    """Per-spot MRAF: signal spots take the constraint (``ffp``), noise
    (nan ``spot_amp``) spots keep the unit-norm farfield times
    ``consts["mraf_k"]``, null (zero) spots take ``zero_re``/``zero_im``
    (the host loop's evolving ``zero_factor`` weights) when given, else 0."""
    sig, noi = consts["signal_mask"], consts["noise_mask"]
    k = consts["mraf_k"]
    zr = 0.0 if zero_re is None else zero_re
    zi = 0.0 if zero_im is None else zero_im
    return (
        torch.where(sig, ffp_re, torch.where(noi, k * ff_re, zr)),
        torch.where(sig, ffp_im, torch.where(noi, k * ff_im, zi)),
    )


# --------------------------------------------------------------------------
# Compressed GS engine.
# --------------------------------------------------------------------------


class CompressedGSState(NamedTuple):
    """Loop state. Between runs ``psi`` is the ``(P,)`` nearfield phase; in
    the loop it is ``(raw_re, raw_im, ffp_re, ffp_im)``: the unnormalized
    farfield entering the iteration and the last constrained farfield."""

    psi: object
    weights: torch.Tensor        # (N,) spot weights
    phase_ff: torch.Tensor       # (N,) stored farfield phase
    fixed_phase: torch.Tensor    # bool
    unfixed_streak: torch.Tensor  # int32
    iteration: torch.Tensor      # int32


@dataclasses.dataclass(frozen=True)
class CompressedGSConfig:
    """Static configuration of the compressed engine."""

    method: str
    n_pixels: int
    n_spots: int
    stat_groups: tuple = ()
    kim_efficiency_trigger: bool = False
    #: Per-spot MRAF: nan ``spot_amp`` entries are noise spots, zeros null.
    mraf: bool = False
    #: Stream the cos/sin cache (``consts["kc_tiles"]``/``["ks_tiles"]``)
    #: instead of recomputing the sincos each iteration.
    kernel_cache: bool = False

    @property
    def is_wgs(self):
        return self.method.startswith("WGS")

    @property
    def is_kim(self):
        return "Kim" in self.method


def _spot_stats(amp_ff, consts):
    return calculate_stats(amp_ff, consts["target"], mask=consts["stat_mask"],
                           efficiency_compensation=False)


def make_compressed_carry_step(config: CompressedGSConfig, round_trip=None):
    """
    The loop step ``step(state, consts) -> (state, stats (n_groups + 1,
    4))`` on the farfield carry; the trailing stats row is ``[efficiency
    or nan, fixed_phase, 0, 0]``. The epilogue is O(N) PyTorch; the O(N P)
    round trip is one :meth:`fused_iteration` or
    :meth:`fused_iteration_cached`, or ``round_trip(ffp_re, ffp_im)`` where
    given (the pixel-sharded engine's: every shard's round trip, summed).
    """

    def step(state, consts):
        raw_re, raw_im, _, _ = state.psi
        ff_re, ff_im = _unit(raw_re, raw_im)
        amp_ff = torch.sqrt(torch.square(ff_re) + torch.square(ff_im))
        theta = torch.atan2(ff_im, ff_re)

        stats_rows = []
        if "computational_spot" in config.stat_groups:
            stats_rows.append(_spot_stats(amp_ff, consts))

        weights = state.weights
        if config.is_wgs:
            updated = update_weights_generic(
                weights, amp_ff, consts["target"], config.method,
                consts["feedback_exponent"], consts["feedback_factor"],
            )
            weights = torch.where(state.iteration > 0, updated, weights)

        was_not_fixed = torch.logical_not(state.fixed_phase)
        if config.is_kim:
            fixed = state.fixed_phase
            if config.kim_efficiency_trigger:
                eff = stats_rows[-1][0] if stats_rows else _spot_stats(amp_ff, consts)[0]
                fixed = fixed | (eff > consts["fix_phase_efficiency"])
            streak = torch.where(was_not_fixed, state.unfixed_streak + 1,
                                 state.unfixed_streak)
            fixed = fixed | (
                was_not_fixed
                & (state.iteration >= consts["fix_phase_iteration"] - 1)
                & (streak >= consts["fix_phase_iteration"])
            )
            fixed = fixed & (state.iteration > 0)
            phase_ff = torch.where(was_not_fixed, theta, state.phase_ff)
        else:
            fixed = torch.zeros_like(state.fixed_phase)
            streak = state.unfixed_streak
            phase_ff = theta

        ffp_re = weights * torch.cos(phase_ff)
        ffp_im = weights * torch.sin(phase_ff)
        if config.mraf:
            # The mix keeps the NORMALIZED farfield at noise spots.
            ffp_re, ffp_im = apply_compressed_mraf_mix(ffp_re, ffp_im, ff_re, ff_im, consts)

        if round_trip is not None:
            next_re, next_im = round_trip(ffp_re, ffp_im)
        elif config.kernel_cache:
            next_re, next_im = fused_iteration_cached(
                ffp_re, ffp_im, consts["kc_tiles"], consts["ks_tiles"], consts["amp"],
                config.n_spots, config.n_pixels,
            )
        else:
            next_re, next_im = fused_iteration(
                ffp_re, ffp_im, consts["coeffs"], consts["basis"], consts["amp"]
            )

        new_state = CompressedGSState(
            psi=(next_re, next_im, ffp_re, ffp_im),
            weights=weights,
            phase_ff=phase_ff,
            fixed_phase=fixed,
            unfixed_streak=streak,
            iteration=state.iteration + 1,
        )
        efficiency = stats_rows[-1][0] if stats_rows else consts["_nan"]
        zero = consts["_zero"]
        internal = torch.stack([efficiency, state.fixed_phase.to(torch.float32), zero, zero])
        return new_state, torch.stack(stats_rows + [internal])

    return step


def nearfield(psi, amp):
    """``amp e^{i psi}`` as a pair (``amp`` a scalar or ``(P,)``)."""
    return amp * torch.cos(psi), amp * torch.sin(psi)


@_profile.spanned("gs.loop")
def run_compressed_gs(config, state, consts, n_iterations):
    """
    ``n_iterations`` of compressed-spot GS from ``state`` (whose ``psi`` is
    the ``(P,)`` nearfield phase): the entry transform to the farfield, the
    loop, and the exit transform of the last constrained farfield back to
    the phase. Returns ``(state, stats (n, n_groups + 1, 4))``.
    """
    n_iterations = int(n_iterations)
    device = state.weights.device
    if n_iterations == 0:
        return state, torch.zeros((0, len(config.stat_groups) + 1, 4), device=device)
    consts = {
        **consts,
        "_zero": torch.zeros((), dtype=torch.float32, device=device),
        "_nan": torch.full((), float("nan"), dtype=torch.float32, device=device),
    }
    step = make_compressed_carry_step(config)

    # The step divides by the carry's norm, so the loop is scale-free.
    nf_re, nf_im = nearfield(state.psi, consts["amp"])
    if config.kernel_cache:
        ff0 = nearfield_to_farfield_cached(nf_re, nf_im, consts["kc_tiles"],
                                           consts["ks_tiles"], config.n_pixels,
                                           n_spots=config.n_spots)
    else:
        ff0 = nearfield_to_farfield(nf_re, nf_im, consts["coeffs"], consts["basis"])
    state = state._replace(psi=(*ff0, *ff0))

    rows = []
    for _ in range(n_iterations):
        with _profile.span("gs.iter"):
            state, stats = step(state, consts)
        rows.append(stats)

    _, _, ffp_re, ffp_im = state.psi
    if config.kernel_cache:
        nfp = farfield_to_nearfield_cached(ffp_re, ffp_im, consts["kc_tiles"],
                                           consts["ks_tiles"], config.n_pixels)
    else:
        nfp = farfield_to_nearfield(ffp_re, ffp_im, consts["coeffs"], consts["basis"])
    state = state._replace(psi=torch.atan2(nfp[1], nfp[0]))
    return state, torch.stack(rows)
