"""
File I/O re-exported under the analysis package, as
``slmsuite_tpu.holography.analysis.files`` does; the implementations live
in :mod:`slmsuite_torch.misc.files`.
"""

from slmsuite_torch.misc.files import (  # noqa: F401
    _gray2rgb,
    _load_image,
    generate_path,
    latest_path,
    load_h5,
    read_h5,
    save_h5,
    save_image,
    write_h5,
)

__all__ = ["generate_path", "latest_path", "load_h5", "read_h5", "save_h5", "save_image", "write_h5"]
