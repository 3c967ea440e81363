"""
Carry state and constants across from ``slmsuite_tpu`` to the port.

The JAX package's arrays come in as numpy (the caller runs
``np.asarray(...)`` on them), so this module imports nothing of JAX; the
result is the port's state on a given device. With these the tests start
both packages from identical psi, weights, Kim phase store and constants.
For a hologram's planes, see :meth:`slmsuite_torch.holography.algorithms.Hologram.load_arrays`.
"""

import numpy as np
import torch

from slmsuite_torch import resolve_device
from slmsuite_torch.ops.engine import GSState


def _tensor(value, device):
    array = np.asarray(value)
    if array.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(array.dtype, np.integer):
        dtype = torch.int32
    else:
        dtype = torch.float32
    return torch.as_tensor(array, dtype=dtype, device=device)


def gs_state_from_numpy(arrays, device=None):
    """
    A :class:`~slmsuite_torch.ops.engine.GSState` from a dict of numpy
    arrays with the fields of ``slmsuite_tpu.ops.engine.GSState``:
    ``psi``, ``weights``, ``phase_ff``, ``fixed_phase``,
    ``unfixed_streak``, ``iteration``, and optionally ``zero_weights``
    (the (2, H, W) MRAF zero-region pair; the empty (2, 0, 0) pair when
    missing) and ``w_norm``.
    """
    device = resolve_device(device)
    w_norm = arrays.get("w_norm")
    zero_weights = arrays.get("zero_weights", np.zeros((2, 0, 0)))
    return GSState(
        psi=_tensor(np.asarray(arrays["psi"], np.float32), device),
        weights=_tensor(np.asarray(arrays["weights"], np.float32), device),
        phase_ff=_tensor(np.asarray(arrays["phase_ff"], np.float32), device),
        zero_weights=_tensor(np.asarray(zero_weights, np.float32), device),
        fixed_phase=_tensor(np.asarray(arrays["fixed_phase"], bool), device),
        unfixed_streak=_tensor(np.asarray(arrays["unfixed_streak"], np.int32), device),
        iteration=_tensor(np.asarray(arrays["iteration"], np.int32), device),
        w_norm=None if w_norm is None else _tensor(np.asarray(w_norm, np.float32), device),
    )


def consts_from_numpy(consts, device=None):
    """
    The engine's constants dict from numpy values (floats become f32,
    integers int32, booleans bool). A 0-d ``"amp"`` stays a Python float,
    as the port's engine takes a scalar amplitude.
    """
    device = resolve_device(device)
    out = {}
    for key, value in consts.items():
        if key == "amp" and np.ndim(value) == 0:
            out[key] = float(value)
        else:
            out[key] = _tensor(value, device)
    return out


def compressed_state_from_numpy(arrays, device=None):
    """
    A :class:`~slmsuite_torch.ops.compressed.CompressedGSState` from a dict
    of numpy arrays with the fields of
    ``slmsuite_tpu.ops.compressed.CompressedGSState`` between runs:
    ``psi`` (the ``(P,)`` nearfield phase), ``weights``, ``phase_ff``,
    ``fixed_phase``, ``unfixed_streak`` and ``iteration``.
    """
    from slmsuite_torch.ops.compressed import CompressedGSState

    device = resolve_device(device)
    return CompressedGSState(
        psi=_tensor(np.asarray(arrays["psi"], np.float32), device),
        weights=_tensor(np.asarray(arrays["weights"], np.float32), device),
        phase_ff=_tensor(np.asarray(arrays["phase_ff"], np.float32), device),
        fixed_phase=_tensor(np.asarray(arrays["fixed_phase"], bool), device),
        unfixed_streak=_tensor(np.asarray(arrays["unfixed_streak"], np.int32), device),
        iteration=_tensor(np.asarray(arrays["iteration"], np.int32), device),
    )
