"""The share of the profiled requests' window in which no operation ran on
the device."""


def read(record):
    if record["window_s"] <= 0 or record["busy_s"] <= 0:
        return None
    return 1.0 - record["busy_s"] / record["window_s"]
