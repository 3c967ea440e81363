"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit): float32 outside the tensor cores and HBM3 bandwidth.
Shares of a roofline are stated against these, with the card's power limit
beside them."""

H100_SXM = {"flops": 67e12, "bytes_per_s": 3.35e12}


def peaks(device_name):
    """The peaks of the card named ``device_name``; the H100's table, which
    is the only card the benchmark is defined for."""
    if "H100" not in device_name:
        raise RuntimeError(f"No table of peaks for {device_name!r}: the benchmark is "
                           "defined for the NVIDIA H100.")
    return H100_SXM
