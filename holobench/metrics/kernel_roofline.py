"""The least time of one iteration over the device's busy time per
iteration, in percent. The least time is the larger of the iteration's
float32 operations over the peak rate and its bytes over the peak
bandwidth (``holobench.work``), so it reads the same work whatever
implements it."""


def read(record):
    if record["busy_s"] <= 0 or not record["iterations"]:
        return None
    work, peaks = record["work"], record["peaks"]
    least = max(work["flops"] / peaks["flops"], work["bytes"] / peaks["bytes_per_s"])
    return 100.0 * least / (record["busy_s"] / record["iterations"])
