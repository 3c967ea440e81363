"""
Thorlabs Exulus SLMs enumerate as monitors: use
:class:`~slmsuite_torch.hardware.slms.screenmirrored.ScreenMirrored`.

Parity: reference ``slmsuite/hardware/slms/thorlabs.py``.
"""

from slmsuite_torch.hardware.slms.screenmirrored import ScreenMirrored as Thorlabs  # noqa: F401
