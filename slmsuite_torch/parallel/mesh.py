"""
The device mesh of the port (counterpart of :mod:`slmsuite_tpu.parallel.mesh`).

A :class:`Mesh` is an array of :class:`torch.device` with named axes, held
by one Python process: the mesh engines run every shard from that one
thread, in lockstep (:mod:`slmsuite_torch.ops.collectives`). A device
may appear more than once, so one card (``[cuda:0] * 4``) or the CPU
(``[cpu] * 4``) can hold several shards and run every exchange; the port's
counterpart of ``--xla_force_host_platform_device_count``.
"""

import collections
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices (an object ndarray of :class:`torch.device`) with one name
    per axis."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self):
        """Ordered dict from axis name to size (``jax.sharding.Mesh.shape``)."""
        return collections.OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def axis_devices(self, axis_name):
        """The devices along ``axis_name``, at index 0 of every other axis
        (the other axes hold replicas)."""
        if axis_name not in self.axis_names:
            raise ValueError(f"Mesh has no axis '{axis_name}'; its axes are {self.axis_names}.")
        axis = self.axis_names.index(axis_name)
        along = np.moveaxis(self.devices, axis, 0)
        return list(along.reshape(along.shape[0], -1)[:, 0])


def make_mesh(axis_sizes=None, axis_names=("data",), devices=None):
    """
    Build a :class:`Mesh`.

    Parameters
    ----------
    axis_sizes : tuple of int OR None
        Size per axis; ``None`` puts all devices on the first axis.
    axis_names : tuple of str
        Mesh axis names (default a single ``"data"`` axis).
    devices : list OR None
        Devices to use (default every CUDA device). A device may repeat.

    Returns
    -------
    Mesh
    """
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh found no CUDA device; pass devices=.")
    devices = [torch.device(d) for d in devices]
    axis_names = tuple(axis_names)
    if axis_sizes is None:
        axis_sizes = (len(devices),) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != len(devices):
        raise ValueError(
            f"Mesh axes {axis_sizes} do not multiply to device count {len(devices)}."
        )
    array = np.empty(len(devices), dtype=object)
    array[:] = devices
    return Mesh(array.reshape(tuple(axis_sizes)), axis_names)
