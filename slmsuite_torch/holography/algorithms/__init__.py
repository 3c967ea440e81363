r"""
Iterative phase-retrieval holography on PyTorch / CUDA.

- :class:`Hologram`: core DFT phase retrieval.
- :class:`SpotHologram`: DFT-based optical focus arrays.
"""

from slmsuite_torch.holography.algorithms._header import (  # noqa: F401
    ALGORITHM_DEFAULTS,
    ALGORITHM_INDEX,
    FEEDBACK_OPTIONS,
)
from slmsuite_torch.holography.algorithms._hologram import Hologram  # noqa: F401
from slmsuite_torch.holography.algorithms._feedback import FeedbackHologram  # noqa: F401
from slmsuite_torch.holography.algorithms._spots import SpotHologram  # noqa: F401

__all__ = [
    "ALGORITHM_DEFAULTS",
    "ALGORITHM_INDEX",
    "FEEDBACK_OPTIONS",
    "Hologram",
    "FeedbackHologram",
    "SpotHologram",
]
