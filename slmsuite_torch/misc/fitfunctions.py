"""
Re-export of :mod:`slmsuite_torch.holography.analysis.fitfunctions` under
the older module name (``slmsuite_tpu.misc.fitfunctions``'s counterpart).
"""

from slmsuite_torch.holography.analysis.fitfunctions import *  # noqa: F401,F403
