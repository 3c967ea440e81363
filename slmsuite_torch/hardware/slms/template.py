"""
Template for writing a new SLM driver subclass.

Copy this file, rename the class, and fill in the ``TODO`` blocks with
your vendor SDK calls. Only :meth:`__init__`, :meth:`close`, and
:meth:`_set_phase_hw` are required; everything else (phase conversion,
wavefront correction, padding, settle timing) is inherited from
:class:`~slmsuite_torch.hardware.slms.slm.SLM`.

Parity: reference ``slmsuite/hardware/slms/template.py``.
"""

from slmsuite_torch.hardware.slms.slm import SLM

# TODO: import your vendor SDK here, guarded so the package imports
# without the SDK installed:
#
# try:
#     import vendor_sdk
# except ImportError:
#     vendor_sdk = None


class Template(SLM):
    """Template SLM driver. Rename and fill in the TODOs."""

    def __init__(
        self,
        serial="",
        verbose=True,
        **kwargs,
    ):
        """
        Initialize the SLM and connect to the hardware.

        Parameters
        ----------
        serial : str
            Serial number or identifier of the device to connect to.
        verbose : bool
            Whether to print connection progress.
        **kwargs
            Passed to :meth:`.SLM.__init__` (``wav_um``, ``settle_time_s``, ...).
        """
        # TODO: connect to the hardware and query its properties.
        if verbose:
            print(f"Template SLM '{serial}' initializing... ", end="")
        # self.sdk = vendor_sdk.open(serial)
        width, height = 1920, 1080   # TODO: query from hardware.
        bitdepth = 8                 # TODO: query from hardware.
        if verbose:
            print("success")

        super().__init__(
            (width, height),
            bitdepth=bitdepth,
            name=f"Template_{serial}",
            **kwargs,
        )

        # Display a blank phase pattern on startup.
        self.set_phase(None)

    def close(self):
        """Disconnect from the hardware."""
        # TODO: e.g. self.sdk.close()

    @staticmethod
    def info(verbose=True):
        """Discover connected devices; return a list of identifiers."""
        # TODO: query the SDK for connected devices.
        serial_list = []
        if verbose:
            print("Template serials:", serial_list)
        return serial_list

    def _set_phase_hw(self, display):
        """
        Write integer ``display`` data (shape :attr:`shape`, dtype
        :attr:`display`.dtype) to the hardware.
        """
        # TODO: e.g. self.sdk.write_image(display)
