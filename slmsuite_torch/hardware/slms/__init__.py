"""Spatial light modulators: the :class:`SLM` interface and :class:`SimulatedSLM`."""

from slmsuite_torch.hardware.slms.simulated import SimulatedSLM  # noqa: F401
from slmsuite_torch.hardware.slms.slm import SLM  # noqa: F401

__all__ = ["SLM", "SimulatedSLM"]
