"""
Auto-numbered save paths, and HDF5 save and load of nested dictionaries
(the port's copy of ``generate_path``, ``latest_path``, ``save_h5`` and
``load_h5`` in :mod:`slmsuite_tpu.misc.files`). ``h5py`` is imported when
a file is read or written, never on import.
"""

import os
import re

import numpy as np


def _numbered(path, name, numeric_id, extension, digit_count):
    stem = "{}_{:0{}d}".format(name, numeric_id, int(digit_count))
    if extension is not None:
        stem += "." + extension
    return os.path.join(path, stem)


def _largest_id(path, name, extension, digit_count):
    """The largest id among the files ``path/name_#####[.extension]``, or -1."""
    if not os.path.isdir(path):
        return -1
    pattern = re.escape(name) + r"_(\d{" + str(int(digit_count)) + r"})"
    if extension is not None:
        pattern += re.escape("." + extension)
    regex = re.compile(pattern + r"$")
    best = -1
    for entry in os.listdir(path):
        match = regex.match(entry)
        if match and os.path.isfile(os.path.join(path, entry)):
            best = max(best, int(match.group(1)))
    return best


def generate_path(path, name, extension=None, digit_count=5):
    """A fresh auto-numbered file path ``path/name_00001.extension``, one
    past the largest id there (``path`` is created if missing)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    start = _largest_id(path, name, extension, digit_count) + 1
    return _numbered(path, name, start, extension, digit_count)


def latest_path(path, name, extension=None, digit_count=5):
    """The auto-numbered file path with the largest id, or None."""
    path = os.path.abspath(path)
    best = _largest_id(path, name, extension, digit_count)
    return None if best < 0 else _numbered(path, name, best, extension, digit_count)


def load_h5(file_path, decode_bytes=True):
    """
    Load an HDF5 file into a (possibly nested) dictionary.

    Parameters
    ----------
    file_path : str
        Path of the file to read.
    decode_bytes : bool
        Decode ``bytes`` scalars/arrays back into ``str``.

    Returns
    -------
    dict
    """
    import h5py

    def visit(group):
        out = {}
        for key, item in group.items():
            if isinstance(item, h5py.Group):
                out[key] = visit(item)
                continue
            value = item[()]
            if decode_bytes:
                if isinstance(value, bytes):
                    value = value.decode()
                elif (
                    isinstance(value, np.ndarray)
                    and value.size > 0
                    and isinstance(value.reshape(-1)[0], bytes)
                ):
                    value = np.vectorize(bytes.decode)(value)
            out[key] = value
        return out

    with h5py.File(file_path, "r") as handle:
        return visit(handle)


def save_h5(file_path, data, mode="w"):
    """
    Save a (possibly nested) dictionary into an HDF5 file.

    Supported leaf types: uniform numeric/string arrays, scalars, ``str``
    (stored as utf-8 bytes), and ``None`` (stored as ``False``).

    Parameters
    ----------
    file_path : str
        Path of the file to write.
    data : dict
        Data to store; nested dicts become HDF5 groups.
    mode : str
        h5py file mode (default overwrite).
    """
    import h5py

    def visit(group, mapping):
        for key, value in mapping.items():
            if isinstance(value, dict):
                visit(group.create_group(key), value)
            elif isinstance(value, str):
                group[key] = value.encode("utf-8")
            elif value is None:
                group[key] = False
            else:
                try:
                    array = np.asarray(value)
                except Exception as err:
                    raise ValueError(
                        "save_h5() requires uniform array-like leaves; "
                        f"could not convert key '{key}': {err}"
                    )
                if array.dtype.kind == "U":
                    array = np.vectorize(str.encode)(array)
                if array.dtype == object:
                    raise ValueError(
                        f"save_h5() does not support object arrays (key '{key}'); "
                        "arrays must be uniform."
                    )
                group[key] = array

    with h5py.File(file_path, mode) as handle:
        visit(handle, data)
