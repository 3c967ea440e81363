r"""
Pixel-sharded compressed-spot GS over a mesh axis (PyTorch counterpart of
:mod:`slmsuite_tpu.parallel.compressed`).

The compressed transforms contract a ``(D, P)`` Zernike basis against
``(N,)`` spots. With the pixel axis cut over the mesh, each shard holds a
slab of the basis, the amplitude and psi; the spot-space state (weights,
farfield phase, Kim flags) is one, on the first shard's device, and the
O(N) epilogue of the port's compressed carry
(:meth:`slmsuite_torch.ops.compressed.make_compressed_carry_step`) runs
there once.

The split point is where the carry holds the raw (unnormalized) farfield:
each iteration, every shard runs the round trip of its slab
(:meth:`~slmsuite_torch.ops.compressed.fused_iteration`, kernel
``fused_iter``: ``f2n`` of the constrained farfield, the amplitude
replacement, ``n2f`` unnormalized), and the shards' ``(N,)`` partial sums
add in rank order (:mod:`slmsuite_torch.ops.collectives`) into the
next raw farfield, which the epilogue normalizes. The amplitude replacement
drops the nearfield's scale, so the slab's ``1/sqrt(P/D)`` needs no
correction there. The entry is ``n2f`` unnormalized on each slab (kernel
``n2f``), summed and normalized; the exit ``f2n`` on each slab (kernel
``f2n``) and the angle, which no positive scale moves, so the slab's scale
needs no correction there either. The cos/sin cache is off under a mesh, as
in the JAX package.
"""

import dataclasses

import torch

from slmsuite_torch.ops import collectives as C
from slmsuite_torch.ops import compressed as _comp

__all__ = ["run_sharded_compressed_gs", "shard_compressed_consts"]


def shard_compressed_consts(consts, mesh, axis_name="pixels"):
    """
    The consts dict cut over ``axis_name`` of ``mesh``: a list of per-shard
    dicts, ``basis`` and an amplitude plane as pixel slabs, everything else
    on every shard's device (a scalar amplitude stays one: every slab takes
    it). Raises ValueError where the pixel count does not divide the axis.
    """
    n_pixels = consts["basis"].shape[1]
    devices = mesh.axis_devices(axis_name)
    if n_pixels % len(devices):
        raise ValueError(
            f"Pixel count {n_pixels} must divide the mesh axis ({len(devices)})."
        )
    shards = [{} for _ in devices]
    for key, value in consts.items():
        if key == "basis":
            parts = C.split(value, devices, axis=1)
        elif key == "amp" and not _comp._is_scalar(value):
            parts = C.split(value, devices)
        elif key in ("kc_tiles", "ks_tiles"):
            continue  # The cache is off under a mesh.
        elif torch.is_tensor(value):
            parts = C.broadcast(value, devices)
        else:
            parts = [value] * len(devices)
        for sh, part in zip(shards, parts):
            sh[key] = part
    return shards


def _each(shards, fn, *per_shard):
    """``fn(shard, *its entries of per_shard)`` on every shard, each with
    its device current."""
    out = []
    for sh, *args in zip(shards, *per_shard):
        with C.on_device(sh["basis"].device):
            out.append(fn(sh, *args))
    return out


def run_sharded_compressed_gs(config, state, consts, mesh, n_iterations, axis_name="pixels"):
    """
    Run ``n_iterations`` of compressed GS with the pixel axis cut over
    ``axis_name`` of ``mesh``. ``consts`` come from
    :meth:`shard_compressed_consts`; ``state.psi`` is the whole ``(P,)``
    phase, cut here and gathered back on the device of ``state.weights``.

    Returns ``(state, stats)`` like
    :meth:`slmsuite_torch.ops.compressed.run_compressed_gs`.
    """
    n_iterations = int(n_iterations)
    devices = mesh.axis_devices(axis_name)
    if len(consts) != len(devices):
        raise ValueError("consts must come from shard_compressed_consts on this mesh axis.")
    home = state.weights.device
    if n_iterations == 0:
        return state, torch.zeros((0, len(config.stat_groups) + 1, 4), device=home)
    first = devices[0]
    spot = {
        **consts[0],
        "_zero": torch.zeros((), dtype=torch.float32, device=first),
        "_nan": torch.full((), float("nan"), dtype=torch.float32, device=first),
    }
    config = dataclasses.replace(config, kernel_cache=False)

    def total(parts):
        re, im = zip(*parts)
        return C.reduce_sum(list(re)), C.reduce_sum(list(im))

    def round_trip(ffp_re, ffp_im):
        return total(_each(
            consts,
            lambda sh, re, im: _comp.fused_iteration(re, im, sh["coeffs"], sh["basis"],
                                                     sh["amp"]),
            C.broadcast(ffp_re, devices), C.broadcast(ffp_im, devices),
        ))

    raw = total(_each(
        consts,
        lambda sh, psi: _comp.nearfield_overlap(*_comp.nearfield(psi, sh["amp"]),
                                                sh["coeffs"], sh["basis"]),
        C.split(state.psi, devices),
    ))
    ff0 = _comp._unit(*raw)
    carry = _comp.CompressedGSState(
        psi=(*ff0, *ff0),
        weights=state.weights.to(first),
        phase_ff=state.phase_ff.to(first),
        fixed_phase=state.fixed_phase.to(first),
        unfixed_streak=state.unfixed_streak.to(first),
        iteration=state.iteration.to(first),
    )
    step = _comp.make_compressed_carry_step(config, round_trip=round_trip)
    rows = []
    for _ in range(n_iterations):
        carry, stats = step(carry, spot)
        rows.append(stats)

    _, _, ffp_re, ffp_im = carry.psi
    nearfields = _each(
        consts,
        lambda sh, re, im: _comp.farfield_to_nearfield(re, im, sh["coeffs"], sh["basis"]),
        C.broadcast(ffp_re, devices), C.broadcast(ffp_im, devices),
    )
    psi = [torch.atan2(im, re) for re, im in nearfields]
    final = carry._replace(
        psi=C.gather(psi, home),
        weights=carry.weights.to(home),
        phase_ff=carry.phase_ff.to(home),
        fixed_phase=carry.fixed_phase.to(home),
        unfixed_streak=carry.unfixed_streak.to(home),
        iteration=carry.iteration.to(home),
    )
    return final, torch.stack(rows).to(home)
