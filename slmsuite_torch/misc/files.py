"""
HDF5 save and load of nested dictionaries (the port's copy of
``save_h5``/``load_h5`` in :mod:`slmsuite_tpu.misc.files`). ``h5py`` is
imported when a file is read or written, never on import.
"""

import numpy as np


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
