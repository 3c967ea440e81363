"""
Collectives of the mesh engines (the port's stand-in for ``jax.lax.psum``,
``pmin``, ``pmax`` and ``all_to_all``).

A sharded value is a list of per-shard tensors, shard ``d`` on the ``d``-th
device of the mesh axis. One host thread runs every shard: an engine's step
is written in lockstep, shard-local stages with a collective between them,
and a collective is explicit cross-device copies and reductions. No thread,
process or ``torch.distributed`` group is involved.

Reductions run in rank order on the first shard's device, so they repeat bit
for bit (they are not XLA's psum order: hold results to tolerances).
:func:`reduce_sum`, :func:`reduce_min` and :func:`reduce_max` leave the one
result there; :func:`psum`, :func:`pmin` and :func:`pmax` give each shard a
copy on its device (on a device that repeats, the same tensor).
"""

import contextlib

import torch


def devices_of(shards):
    return [x.device for x in shards]


def on_device(device):
    """The context that makes ``device`` current for the kernels' launches
    (a CUDA device), or no context."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def broadcast(x, devices):
    """``x`` on each of ``devices`` (no copy where it already lies there)."""
    return [x.to(device, non_blocking=True) for device in devices]


def _reduce(shards, op):
    total = shards[0]
    for x in shards[1:]:
        total = op(total, x.to(total.device, non_blocking=True))
    return total


def reduce_sum(shards):
    """The sum of the shards, in rank order, on the first shard's device."""
    return _reduce(shards, torch.add)


def reduce_min(shards):
    return _reduce(shards, torch.minimum)


def reduce_max(shards):
    return _reduce(shards, torch.maximum)


def psum(shards):
    return broadcast(reduce_sum(shards), devices_of(shards))


def pmin(shards):
    return broadcast(reduce_min(shards), devices_of(shards))


def pmax(shards):
    return broadcast(reduce_max(shards), devices_of(shards))


def all_to_all(shards, split_axis, concat_axis, tiled=True):
    """
    ``jax.lax.all_to_all`` over the shards: each shard splits its tensor
    into D chunks along ``split_axis``, and shard ``d`` receives chunk ``d``
    of every shard, joined in rank order along ``concat_axis`` (``tiled``)
    or stacked there on a new axis (untiled: ``split_axis`` has D entries,
    and it is dropped). Each result is one copy on its shard's device.
    """
    D = len(shards)
    if shards[0].shape[split_axis] % D:
        raise ValueError(
            f"all_to_all splits axis {split_axis} of {tuple(shards[0].shape)} into "
            f"{D} equal chunks."
        )
    if not tiled and shards[0].shape[split_axis] != D:
        raise ValueError(f"An untiled all_to_all takes {D} entries on axis {split_axis}.")
    chunks = [x.chunk(D, dim=split_axis) for x in shards]
    out = []
    for d, device in enumerate(devices_of(shards)):
        parts = [chunks[j][d].to(device, non_blocking=True) for j in range(D)]
        if tiled:
            out.append(torch.cat(parts, dim=concat_axis).contiguous())
        else:
            out.append(torch.stack([p.squeeze(split_axis) for p in parts], dim=concat_axis))
    return out


def split(x, devices, axis=0):
    """``x`` cut into ``len(devices)`` equal contiguous blocks along ``axis``,
    block ``d`` on ``devices[d]``. Raises where the axis does not divide."""
    D = len(devices)
    if x.shape[axis] % D:
        raise ValueError(f"Axis {axis} of {tuple(x.shape)} does not divide into {D} shards.")
    return [block.to(device).contiguous() for block, device in zip(x.chunk(D, dim=axis), devices)]


def gather(shards, device, axis=0):
    """The shards joined in rank order along ``axis``, on ``device``."""
    return torch.cat([x.to(device) for x in shards], dim=axis)
