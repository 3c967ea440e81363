"""
Template for writing a new camera driver subclass.

Copy this file, rename the class, and fill in the ``TODO`` blocks with
your vendor SDK calls. Required: :meth:`__init__`, :meth:`close`,
:meth:`_get_exposure_hw`, :meth:`_set_exposure_hw`, and
:meth:`_get_image_hw`. Averaging, HDR, transforms, retries,
autoexposure, and autofocus are inherited from
:class:`~slmsuite_torch.hardware.cameras.camera.Camera`.

Parity: reference ``slmsuite/hardware/cameras/template.py``.
"""

from slmsuite_torch.hardware.cameras.camera import Camera

# TODO: import your vendor SDK here, guarded:
#
# try:
#     import vendor_sdk
# except ImportError:
#     vendor_sdk = None


class Template(Camera):
    """Template camera driver. Rename and fill in the TODOs."""

    def __init__(self, serial="", verbose=True, **kwargs):
        """
        Initialize the camera and connect to the hardware.

        Parameters
        ----------
        serial : str
            Serial number or identifier of the camera to connect to.
        verbose : bool
            Whether to print connection progress.
        **kwargs
            Passed to :meth:`.Camera.__init__` (``pitch_um``, ``rot``, ...).
        """
        if verbose:
            print(f"Template camera '{serial}' initializing... ", end="")
        # TODO: self.sdk = vendor_sdk.open(serial)
        width, height = 1280, 1024   # TODO: query from hardware.
        bitdepth = 8                 # TODO: query from hardware.
        if verbose:
            print("success")

        super().__init__(
            (width, height),
            bitdepth=bitdepth,
            name=f"Template_{serial}",
            **kwargs,
        )

    def close(self):
        """Disconnect from the hardware."""
        # TODO: e.g. self.sdk.close()

    @staticmethod
    def info(verbose=True):
        """Discover connected devices; return a list of identifiers."""
        serial_list = []  # TODO: query the SDK.
        if verbose:
            print("Template camera serials:", serial_list)
        return serial_list

    def _get_exposure_hw(self):
        """Read the integration time in seconds from the hardware."""
        # TODO: return self.sdk.get_exposure() / 1e3
        return self.exposure_s

    def _set_exposure_hw(self, exposure_s):
        """Write the integration time in seconds to the hardware."""
        # TODO: self.sdk.set_exposure(exposure_s * 1e3)
        self.exposure_s = exposure_s

    def set_woi(self, woi=None):
        """(Optional) Set a hardware window of interest."""
        raise NotImplementedError()

    def _get_image_hw(self, timeout_s):
        """Capture and return one frame of shape :attr:`default_shape`."""
        # TODO: return self.sdk.grab_frame(timeout=timeout_s)
        raise NotImplementedError()
