"""
Auto-numbered save paths, HDF5 save and load of nested dictionaries and
image export (the port's copy of :mod:`slmsuite_tpu.misc.files`). ``h5py``,
``cv2``, matplotlib and ``imageio`` are imported when a function needs
them, never on import.
"""

import os
import re
import warnings

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


def read_h5(file_path, decode_bytes=True):
    """Backwards-compatible alias of :meth:`load_h5`."""
    return load_h5(file_path, decode_bytes)



def write_h5(file_path, data, mode="w"):
    """Backwards-compatible alias of :meth:`save_h5`."""
    return save_h5(file_path, data, mode)



def _load_image(path, shape, target_shape=None, angle=0, shift=(-225, -170)):
    """
    Load a grayscale image as a padded amplitude target (example helper).

    The image is dark-majority-normalized (inverted if mostly bright),
    optionally rotated and zoomed to ``target_shape``, square-rooted into
    amplitude, padded to ``shape``, and rolled by ``shift``.
    """
    import cv2
    from scipy import ndimage

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise ValueError(f"Image not found at path '{path}'.")

    if np.mean(img) > 255 / 2:
        img = 255 - img
    if angle != 0:
        img = ndimage.rotate(img, angle)
    if target_shape is not None:
        zoom = min(
            target_shape[0] / img.shape[0], target_shape[1] / img.shape[1]
        )
        img = ndimage.zoom(img, zoom)

    from slmsuite_torch.holography.toolbox import pad

    target = pad(np.sqrt(np.clip(img, 0, None)), shape)
    return np.roll(target, shift, axis=(0, 1))



def _gray2rgb(images, cmap=False, lut=None, normalize=True, border=None):
    """
    Convert a stack of grayscale images to ``(N, h, w, 4)`` RGBA uint8
    via a matplotlib colormap. ``np.nan`` pixels become transparent;
    ``border`` paints the one-pixel frame with the given color.
    """
    import matplotlib as mpl

    images = np.array(images, copy=True)
    if images.ndim == 2:
        images = images[None]
    elif images.ndim >= 3 and images.shape[-1] in (3, 4):
        return images  # Already color.
    elif images.ndim > 3:
        raise RuntimeError(f"Images shape {images.shape} could not be parsed.")

    isfloat = np.issubdtype(images.dtype, np.floating)
    if cmap == "default":
        cmap = True
    if cmap == "grayscale":
        cmap = False
    if not isinstance(cmap, str) and not hasattr(cmap, "N"):
        if cmap is True:
            cmap = mpl.rcParams["image.cmap"]
        elif lut is None or lut > 256:
            lut = 256  # Grayscale output is 8-bit.

    if lut is None:
        lut = mpl.rcParams["image.lut"] - 1 if isfloat else np.nanmax(images)
    lut = float(lut)

    nanmask = np.isnan(images) if isfloat else None
    if nanmask is not None and nanmask.any():
        images = np.where(nanmask, 0, images)
    else:
        nanmask = None

    scale = (lut - 1) / max(float(np.max(images)), 1e-30) if normalize else (
        (lut - 1) if isfloat else 1.0
    )
    indexed = np.clip(np.rint(images * scale), 0, int(lut)).astype(int)

    if isinstance(cmap, str) or hasattr(cmap, "N"):
        import matplotlib.pyplot as plt

        colormap = plt.get_cmap(cmap, int(lut) + 1) if isinstance(cmap, str) else cmap
        colors = getattr(colormap, "colors", None)
        if colors is None:
            colors = colormap(np.arange(colormap.N))
        rgba = (255 * np.asarray(colors)[indexed]).astype(np.uint8)
    else:
        gray = np.clip(indexed * (255 / lut), 0, 255).astype(np.uint8)
        rgba = np.stack(
            [gray, gray, gray, np.full_like(gray, 255)], axis=-1
        )
    if nanmask is not None:
        rgba[nanmask, 3] = 0

    if border is not None:
        border = [border] if np.isscalar(border) else list(border)
        n = len(border)
        rgba[:, 0, :, :n] = border
        rgba[:, -1, :, :n] = border
        rgba[:, :, 0, :n] = border
        rgba[:, :, -1, :n] = border
    return rgba



def save_image(
    file_path, images, cmap=False, lut=None, normalize=True, border=None, **kwargs
):
    """
    Save grayscale image(s) through :mod:`imageio` with matplotlib
    colormapping; a stack becomes a video/animation (e.g. ``.gif``).
    ``.gif`` files are size-optimized if :mod:`pygifsicle` is installed.
    """
    rgba = _gray2rgb(images, cmap=cmap, lut=lut, normalize=normalize, border=border)

    try:
        from imageio import imsave, mimsave
    except ImportError:
        raise ValueError("imageio is required for save_image().")

    if rgba.shape[0] == 1:
        imsave(file_path, rgba[0], **kwargs)
    else:
        mimsave(file_path, rgba, **kwargs)

    if file_path.rsplit(".", 1)[-1] == "gif":
        try:
            from pygifsicle import optimize

            optimize(file_path)
        except ImportError:
            pass
        except Exception as err:
            warnings.warn(f"pygifsicle optimization failed: {err}")

