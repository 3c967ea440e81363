"""Device time per iteration of the kernels PyTorch launched (under an
``aten::`` operator, cuFFT included), told apart from the program's own
kernels by the profiler's launch correlation, not by kernel names."""


def read(record):
    if not any(op[1] == "kernel" for op in record["device_ops"]) or not record["iterations"]:
        return None
    glue_us = sum(op[3] for op in record["device_ops"] if op[4])
    return glue_us * 1e-3 / record["iterations"]
