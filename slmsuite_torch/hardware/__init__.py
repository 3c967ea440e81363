"""
Hardware of the port: the SLM and camera interfaces, their simulated
versions, the vendor drivers, the screen-mirrored window (``_pyglet``), and
their pairing (:mod:`slmsuite_torch.hardware.cameraslms`).
"""

import datetime
import importlib
import warnings

from slmsuite_torch import __version__


def _optional_import(name):
    """The module ``name`` (a vendor SDK, pyglet, OpenCV), imported when the
    hardware that needs it is built, or None where it is not installed: no
    module of the port imports one when it is itself imported."""
    try:
        return importlib.import_module(name)
    except ImportError:
        return None


class _Picklable:
    """Attribute-selective snapshots of hardware objects (the port's copy
    of ``slmsuite_tpu.hardware._Picklable``)."""

    _pickle = []       # Light, scalar attributes.
    _pickle_data = []  # Heavy attributes (images, calibrations).

    def pickle(self, attributes=True, metadata=True):
        """
        Dictionary snapshot of selected attributes.

        Parameters
        ----------
        attributes : bool OR list of str
            ``False``: the light attributes only; ``True``: the heavy data
            too; a list: those keys.
        metadata : bool
            Wrap as ``{"__version__", "__time__", "__timestamp__",
            "__meta__"}``.
        """
        recursive = attributes is True
        if isinstance(attributes, bool):
            attributes = self._pickle + (self._pickle_data if attributes else [])

        pickled = {"__class__": str(self)}
        for key in attributes:
            if not hasattr(self, key):
                warnings.warn(f"Expected attribute '{key}' not present in {self}.")
                continue
            attr = getattr(self, key)
            if hasattr(attr, "pickle"):
                pickled[key] = attr.pickle(attributes=recursive, metadata=False)
            else:
                pickled[key] = attr

        if metadata:
            now = datetime.datetime.now()
            return {
                "__version__": __version__,
                "__time__": str(now),
                "__timestamp__": now.timestamp(),
                "__meta__": pickled,
            }
        return pickled

    def save(self, path=".", name=None, **kwargs):
        """Save :meth:`pickle` to ``path/name_#####.h5``; returns the path."""
        from slmsuite_torch.misc.files import generate_path, save_h5

        if name is None:
            name = getattr(self, "name", type(self).__name__) + "-pickle"
        file_path = generate_path(path, name, extension="h5")
        save_h5(file_path, self.pickle(**kwargs))
        return file_path
