"""
The mesh engines of the port (counterpart of :mod:`slmsuite_tpu.parallel`):
a device mesh held by one process (:mod:`~slmsuite_torch.parallel.mesh`),
its collectives on per-shard tensors (:mod:`~slmsuite_torch.ops.collectives`),
the distributed 2D FFT (:mod:`~slmsuite_torch.parallel.fft2d`), the
row-sharded plane (:mod:`~slmsuite_torch.parallel.plane`), the batched
multiplane engine with its planes over a ``data`` axis
(:mod:`~slmsuite_torch.parallel.multiplane`) and the pixel-sharded
compressed spots (:mod:`~slmsuite_torch.parallel.compressed`).
"""

from slmsuite_torch.parallel.fft2d import distributed_fft2, distributed_ifft2  # noqa: F401
from slmsuite_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from slmsuite_torch.parallel.multiplane import (  # noqa: F401
    BatchedGSConfig,
    make_batched_gs_step,
    make_multiplane_consts,
    run_batched_gs,
)
from slmsuite_torch.parallel.plane import run_sharded_plane_gs  # noqa: F401

__all__ = [
    "BatchedGSConfig",
    "Mesh",
    "distributed_fft2",
    "distributed_ifft2",
    "make_batched_gs_step",
    "make_mesh",
    "make_multiplane_consts",
    "run_batched_gs",
    "run_sharded_plane_gs",
]
