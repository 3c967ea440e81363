"""
Multiplane engines of the port (counterpart of :mod:`slmsuite_tpu.parallel`).

Only the single-device batched multiplane engine is ported
(:mod:`slmsuite_torch.parallel.multiplane`); the mesh-sharded engines
(``mesh``, ``fft2d``, ``plane``, the mesh part of ``multiplane``,
``compressed``) come with ROADMAP.md queue 1, item 11.
"""

from slmsuite_torch.parallel.multiplane import (  # noqa: F401
    BatchedGSConfig,
    make_batched_gs_step,
    make_multiplane_consts,
    run_batched_gs,
)

__all__ = [
    "BatchedGSConfig",
    "make_batched_gs_step",
    "make_multiplane_consts",
    "run_batched_gs",
]
