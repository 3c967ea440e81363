"""Rounding of float32 tensors to the precisions below it, for the controls
that hold the comparison to account: ``float32`` leaves a tensor as it is,
``tf32`` rounds its mantissa to 10 bits (the operands of a tensor-core
product), ``bfloat16`` rounds it to bfloat16 and back."""

import torch

PRECISIONS = ("float32", "tf32", "bfloat16")


def rounder(precision):
    """The rounding of ``precision`` as a function of a float32 tensor."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
    if precision == "float32":
        return lambda x: x
    if precision == "bfloat16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32)

    def tf32(x):
        # Round to nearest on the 13 bits that TF32 drops.
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)

    return tf32
