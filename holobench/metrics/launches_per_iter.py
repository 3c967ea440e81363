"""Device kernels of the profiled requests per optimizer iteration."""


def read(record):
    kernels = sum(1 for op in record["device_ops"] if op[1] == "kernel")
    if not kernels or not record["iterations"]:
        return None
    return kernels / record["iterations"]
