"""
SLM client for a remote :class:`~slmsuite_torch.hardware.remote.Server`.

Parity: reference ``slmsuite/hardware/slms/remote.py``.
"""

from slmsuite_torch.hardware.remote import DEFAULT_HOST, DEFAULT_PORT, DEFAULT_TIMEOUT, _Client
from slmsuite_torch.hardware.slms.slm import SLM


class RemoteSLM(_Client, SLM):
    """
    Forwards ``_set_phase_hw`` to a served SLM; attributes are read once at
    connect time (not kept concurrent). Vendor-specific functionality
    beyond the write must run on the server (security).
    """

    _pickle = SLM._pickle + ["server_attributes", "host", "port", "timeout", "latency_s"]

    def __init__(
        self,
        name,
        host=DEFAULT_HOST,
        port=DEFAULT_PORT,
        timeout=DEFAULT_TIMEOUT,
        wav_um=None,
        settle_time_s=None,
    ):
        _Client.__init__(self, name, "slm", host, port, timeout)

        pickled = self.server_attributes["__meta__"]
        SLM.__init__(
            self,
            resolution=(pickled["shape"][1], pickled["shape"][0]),
            bitdepth=pickled["bitdepth"],
            name=self.name,
            wav_um=pickled["wav_um"] if wav_um is None else wav_um,
            wav_design_um=pickled["wav_design_um"],
            pitch_um=pickled["pitch_um"],
            settle_time_s=(
                pickled["settle_time_s"] if settle_time_s is None else settle_time_s
            ),
        )

    def close(self):
        pass

    def _set_phase_hw(self, display, **kwargs):
        """Forward the integer display data over TCP."""
        self._com(command="_set_phase_hw", kwargs=dict(display=display, **kwargs))
