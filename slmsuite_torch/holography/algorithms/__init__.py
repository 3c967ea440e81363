r"""
Iterative phase-retrieval holography on PyTorch / CUDA.

- :class:`Hologram`: core DFT phase retrieval.
- :class:`SpotHologram`: DFT-based optical focus arrays.
- :class:`CompressedSpotHologram`: grid-free spot arrays in a Zernike basis.
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

__all__ = [
    "ALGORITHM_DEFAULTS",
    "ALGORITHM_INDEX",
    "FEEDBACK_OPTIONS",
    "Hologram",
    "FeedbackHologram",
    "SpotHologram",
    "CompressedSpotHologram",
]
