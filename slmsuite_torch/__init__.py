"""
slmsuite-torch: the PyTorch / CUDA port of ``slmsuite_tpu``.

The JAX package stays the reference; each module here mirrors the module
of the same name there and is held against it on the same inputs. The
loop kernels are hand-written CUDA for Hopper (``slmsuite_torch/csrc``),
built with ``nvcc`` on the first launch; ``import slmsuite_torch`` never
needs ``nvcc``, ``triton`` or a GPU.

Tensors default to the ``cuda`` device. CPU runs (the plain PyTorch
versions of the kernels) are asked for explicitly, with ``device="cpu"``
or :func:`set_default_device`.
"""

import torch

__version__ = "0.1.0"

_DEFAULT_DEVICE = torch.device("cuda")


def set_default_device(device):
    """Set the device that port objects use when none is given."""
    global _DEFAULT_DEVICE
    _DEFAULT_DEVICE = torch.device(device)


def resolve_device(device=None):
    """``device`` as a :class:`torch.device`, or the default when None."""
    return _DEFAULT_DEVICE if device is None else torch.device(device)
