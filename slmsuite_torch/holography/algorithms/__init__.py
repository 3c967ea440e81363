r"""
Iterative phase-retrieval holography on PyTorch / CUDA.

- :class:`Hologram`: core DFT phase retrieval.
- :class:`SpotHologram`: DFT-based optical focus arrays.
- :class:`CompressedSpotHologram`: grid-free spot arrays in a Zernike basis.
- :class:`MultiplaneHologram`: several holograms sharing one nearfield.
- :func:`optimize_batch`: K independent holograms advanced in one call.
"""

from slmsuite_torch.holography.algorithms._header import (  # noqa: F401
    ALGORITHM_DEFAULTS,
    ALGORITHM_INDEX,
    FEEDBACK_OPTIONS,
)
from slmsuite_torch.holography.algorithms._hologram import Hologram  # noqa: F401
from slmsuite_torch.holography.algorithms._feedback import FeedbackHologram  # noqa: F401
from slmsuite_torch.holography.algorithms._spots import (  # noqa: F401
    CompressedSpotHologram,
    SpotHologram,
)
from slmsuite_torch.holography.algorithms._multiplane import MultiplaneHologram  # noqa: F401
from slmsuite_torch.holography.algorithms._batch import optimize_batch  # noqa: F401

__all__ = [
    "ALGORITHM_DEFAULTS",
    "ALGORITHM_INDEX",
    "FEEDBACK_OPTIONS",
    "Hologram",
    "FeedbackHologram",
    "SpotHologram",
    "CompressedSpotHologram",
    "MultiplaneHologram",
    "optimize_batch",
]
