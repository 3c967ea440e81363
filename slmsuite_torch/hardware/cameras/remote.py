"""
Camera client for a remote :class:`~slmsuite_torch.hardware.remote.Server`.

Parity: reference ``slmsuite/hardware/cameras/remote.py``.
"""

import warnings

from slmsuite_torch.hardware.cameras.camera import Camera
from slmsuite_torch.hardware.remote import DEFAULT_HOST, DEFAULT_PORT, DEFAULT_TIMEOUT, _Client


class RemoteCamera(_Client, Camera):
    """
    Forwards capture/exposure/flush commands to a served camera; attributes
    are read once at connect time (not kept concurrent).
    """

    _pickle = Camera._pickle + ["server_attributes", "host", "port", "timeout", "latency_s"]

    def __init__(self, name, host=DEFAULT_HOST, port=DEFAULT_PORT, timeout=DEFAULT_TIMEOUT, **kwargs):
        _Client.__init__(self, name, "camera", host, port, timeout)

        pickled = self.server_attributes["__meta__"]
        Camera.__init__(
            self,
            resolution=(pickled["shape"][1], pickled["shape"][0]),
            bitdepth=pickled["bitdepth"],
            pitch_um=pickled["pitch_um"],
            name=self.name,
            **kwargs,
        )

    def close(self):
        pass

    def flush(self, timeout_s=1):
        """Flush the remote buffer."""
        return self._com(command="flush", kwargs=dict(timeout_s=timeout_s))

    def _get_exposure_hw(self):
        return self._com(command="_get_exposure_hw")

    def _set_exposure_hw(self, exposure_s):
        return self._com(command="_set_exposure_hw", kwargs=dict(exposure_s=exposure_s))

    def _get_image_hw(self, timeout_s=1):
        return self._com(command="_get_image_hw", kwargs=dict(timeout_s=timeout_s))

    def _get_images_hw(self, image_count, timeout_s=1, out=None):
        if out is not None:
            warnings.warn("Remote camera does not support in-place operations.")
        return self._com(
            command="_get_images_hw",
            kwargs=dict(image_count=image_count, timeout_s=timeout_s),
        )
