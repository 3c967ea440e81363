"""
Carry state and constants across from ``slmsuite_tpu`` to the port.

The JAX package's arrays come in as numpy (the caller runs
``np.asarray(...)`` on them), so this module imports nothing of JAX; the
result is the port's state on a given device. With these the tests start
both packages from identical psi, weights, Kim phase store and constants.
For a hologram's planes, see :meth:`slmsuite_torch.holography.algorithms.Hologram.load_arrays`.
A simulated rig crosses with :meth:`rig_from_jax`, a spot hologram on it
with :meth:`spot_hologram_from_jax`, a compressed one with
:meth:`compressed_hologram_from_jax`, a multiplane hologram with
:meth:`multiplane_hologram_from_jax`, and the batched multiplane engine's
config and consts with :meth:`batched_config_from_jax` and
:meth:`multiplane_consts_from_numpy`: they read the JAX objects' numpy
attributes only.
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


def rig_from_jax(cameraslm, device=None):
    """
    The port's :class:`~slmsuite_torch.hardware.cameraslms.FourierSLM` from
    a JAX-package ``FourierSLM`` on a ``SimulatedSLM`` and a
    ``SimulatedCamera``: geometry, bit depths, the source dictionary (the
    measured ``amplitude``, ``phase`` and ``r2`` beside the simulation's
    keys), the display, the camera's affine, exposure, gain, noise,
    averaging and HDR, and every calibration dict (``"fourier"``,
    ``"wavefront_zernike"``, ``"wavefront_superpixel"``, ``"settle"``,
    ``"pixel"``, ..., so that a resumed calibration starts from the same
    state and stored raw data processes to the same correction), all
    copied as numpy.
    """
    from slmsuite_torch.hardware.cameras.simulated import SimulatedCamera
    from slmsuite_torch.hardware.cameraslms import FourierSLM
    from slmsuite_torch.hardware.slms.simulated import SimulatedSLM

    jslm, jcam = cameraslm.slm, cameraslm.cam
    slm = SimulatedSLM(
        tuple(jslm.shape[::-1]), pitch_um=tuple(jslm.pitch_um), bitdepth=jslm.bitdepth,
        name=jslm.name, wav_um=jslm.wav_um, wav_design_um=jslm.wav_design_um,
    )
    slm.source = {key: np.array(value) for key, value in jslm.source.items()}
    slm.phase = np.array(jslm.phase)
    slm.display = np.array(jslm.display)

    interpolates = getattr(jcam, "_interpolate", False)
    cam = SimulatedCamera(
        slm, resolution=tuple(jcam.default_shape[::-1]),
        M=np.array(jcam.M) if interpolates else None,
        b=np.array(jcam.b) if interpolates else None,
        noise=jcam.noise, pitch_um=None if jcam.pitch_um is None else tuple(jcam.pitch_um),
        gain=jcam.gain, device=device, bitdepth=jcam.bitdepth, name=jcam.name,
        averaging=jcam.averaging, hdr=jcam.hdr,
    )
    cam.transform = jcam.transform
    cam.shape = tuple(jcam.shape)
    cam.set_exposure(jcam.exposure_s)

    fs = FourierSLM(cam, slm, mag=cameraslm.mag)
    fs.calibrations = _numpy_copy(cameraslm.calibrations)
    fs._wavefront_calibration_window_multiplier = getattr(
        cameraslm, "_wavefront_calibration_window_multiplier", 4)
    return fs


def _numpy_copy(value):
    """A deep copy of nested dicts and lists of arrays and scalars, with
    every array as numpy."""
    if isinstance(value, dict):
        return {key: _numpy_copy(item) for key, item in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_numpy_copy(item) for item in value)
    if hasattr(value, "__array__") and not np.isscalar(value):
        return np.array(value)
    return value


def compressed_hologram_from_jax(holo, cameraslm, device=None):
    """
    The port's :class:`~slmsuite_torch.holography.algorithms.CompressedSpotHologram`
    from a JAX-package one on a ``FourierSLM`` (``cameraslm`` is the port's,
    from :meth:`rig_from_jax`): the ``(D, N)`` vectors in the Zernike basis,
    the spot amplitudes, then the camera positions ``spot_ij`` and
    integration width, the weights, the phase, Kim's phase store, the
    iteration count and the fixed-phase flag, all as numpy.
    """
    from slmsuite_torch.holography.algorithms import CompressedSpotHologram

    out = CompressedSpotHologram(
        np.array(holo.spot_zernike), basis=np.array(holo.zernike_basis),
        spot_amp=np.array(holo.spot_amp), cameraslm=cameraslm, device=device,
    )
    out.spot_ij = None if holo.spot_ij is None else np.array(holo.spot_ij)
    out.spot_integration_width_ij = holo.spot_integration_width_ij
    arrays = {"psi": np.asarray(holo.phase), "weights": np.asarray(holo.weights),
              "iter": holo.iter}
    if holo._phase_ff_folded is not None:
        arrays["phase_ff_folded"] = np.asarray(holo._phase_ff_folded)
    if "fixed_phase" in holo.flags:
        arrays["fixed_phase"] = holo.flags["fixed_phase"]
    out.load_arrays(arrays)
    return out


def spot_hologram_from_jax(holo, cameraslm, device=None):
    """
    The port's :class:`~slmsuite_torch.holography.algorithms.SpotHologram`
    from a JAX-package one on the rig ``cameraslm`` (the port's, from
    :meth:`rig_from_jax`): the same spots in the camera basis when it has
    them (else ``"knm"``), spot amplitudes, phase, weights, Kim's phase
    store, iteration count and flags.
    """
    from slmsuite_torch.holography.algorithms import SpotHologram

    if holo.spot_ij is not None:
        vectors, basis = np.array(holo.spot_ij), "ij"
    else:
        vectors, basis = np.array(holo.spot_knm), "knm"
    out = SpotHologram(
        tuple(holo.shape), vectors, basis=basis, spot_amp=np.array(holo.spot_amp),
        cameraslm=cameraslm, phase=np.array(holo.phase), device=device,
    )
    arrays = {"psi": np.asarray(holo._psi), "weights": np.asarray(holo.weights),
              "iter": holo.iter}
    if holo._phase_ff_folded is not None:
        arrays["phase_ff_folded"] = np.asarray(holo._phase_ff_folded)
    if "fixed_phase" in holo.flags:
        arrays["fixed_phase"] = holo.flags["fixed_phase"]
    out.load_arrays(arrays)
    return out


def hologram_from_jax(holo, device=None):
    """
    The port's plain :class:`~slmsuite_torch.holography.algorithms.Hologram`
    from a JAX-package one: its target, SLM shape, amplitude, propagation
    kernel, phase, weights, Kim's phase store, farfield amplitude,
    iteration count, flags and stats, so that both packages plot or
    measure the same state.
    """
    import copy

    from slmsuite_torch.holography.algorithms import Hologram

    kernel = holo.propagation_kernel
    out = Hologram(
        target=np.array(holo.target), slm_shape=tuple(holo.slm_shape), dtype=holo.dtype,
        propagation_kernel=None if kernel is None else np.array(kernel), device=device,
    )
    arrays = {"amp": np.asarray(holo.amp), "psi": np.asarray(holo._psi),
              "weights": np.asarray(holo.weights), "iter": holo.iter}
    if holo._phase_ff_folded is not None:
        arrays["phase_ff_folded"] = np.asarray(holo._phase_ff_folded)
    out.load_arrays(arrays)
    if holo.amp_ff is not None:
        out.amp_ff = np.array(holo.amp_ff)
    out.flags.update(copy.deepcopy(holo.flags))
    out.stats = copy.deepcopy(holo.stats)
    return out


def batched_config_from_jax(config):
    """The port's :class:`~slmsuite_torch.parallel.multiplane.BatchedGSConfig`
    from a ``slmsuite_tpu.parallel.multiplane.BatchedGSConfig`` (its
    ``scrambled`` field, the TPU's layout, is left out)."""
    import dataclasses

    from slmsuite_torch.parallel.multiplane import BatchedGSConfig

    return BatchedGSConfig(**{
        field.name: getattr(config, field.name) for field in dataclasses.fields(BatchedGSConfig)
    })


def multiplane_consts_from_numpy(consts, device=None):
    """
    The batched multiplane engine's consts from those of
    ``slmsuite_tpu.parallel.multiplane.make_multiplane_consts`` as numpy
    (floats become f32, ``fix_phase_iteration`` int32, the MRAF region
    codes uint8; a 0-d ``"amp"`` stays a Python float).
    """
    device = resolve_device(device)
    out = {}
    for key, value in consts.items():
        value = np.array(value)  # A writable copy.
        if key == "amp" and value.ndim == 0:
            out[key] = float(value)
        elif key == "mcodes":
            out[key] = torch.as_tensor(value.astype(np.uint8), device=device)
        else:
            out[key] = _tensor(value, device)
    return out


def multiplane_hologram_from_jax(holo, device=None):
    """
    The port's :class:`~slmsuite_torch.holography.algorithms.MultiplaneHologram`
    from a JAX-package one: each child (a ``Hologram``, or a ``SpotHologram``
    in the ``knm`` basis through :meth:`spot_hologram_from_jax`) with its
    target, amplitude, propagation kernel, weights, Kim phase store,
    iteration count and flags, the plane weights, and the shared psi.
    """
    from slmsuite_torch.holography.algorithms import Hologram, MultiplaneHologram

    children = []
    for h in holo.holograms:
        if type(h).__name__ == "SpotHologram":
            child = spot_hologram_from_jax(h, None, device=device)
        else:
            kernel = h.propagation_kernel
            child = Hologram(
                target=tuple(h.shape), slm_shape=tuple(h.slm_shape), dtype=h.dtype,
                propagation_kernel=None if kernel is None else np.array(kernel),
                device=device,
            )
        children.append(child)
    out = MultiplaneHologram(children, weights=np.array(holo.weights))
    out.weights = np.array(holo.weights, dtype=out.dtype)
    out.load_arrays({"psi": np.asarray(holo._psi), "amp": np.asarray(holo.amp),
                     "iter": holo.iter})
    out.flags.update(holo.flags)
    for child, h in zip(children, holo.holograms):
        arrays = {"target": np.asarray(h.target), "psi": np.asarray(h._psi),
                  "weights": np.asarray(h.weights), "iter": h.iter}
        if h._phase_ff_folded is not None:
            arrays["phase_ff_folded"] = np.asarray(h._phase_ff_folded)
        child.load_arrays(arrays)
        child.amp = out.amp
        child.flags.update(h.flags)
    return out
