"""
The one conversion by which the port's tensors reach the host's plotting
and file code: :meth:`as_numpy`.
"""

import numpy as np


def as_numpy(x):
    """A numpy array of ``x``: a tensor on any device is detached and copied
    to the host; anything else goes through :func:`numpy.asarray`."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
