"""Cameras: the :class:`Camera` interface and :class:`SimulatedCamera`."""

from slmsuite_torch.hardware.cameras.camera import Camera  # noqa: F401
from slmsuite_torch.hardware.cameras.simulated import SimulatedCamera  # noqa: F401

__all__ = ["Camera", "SimulatedCamera"]
