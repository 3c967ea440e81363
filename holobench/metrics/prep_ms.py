"""Mean host time of a request outside ``optimize``: the target update,
the reset and the initial phase (``prep``), and ``get_phase`` with its copy
to the host (``readback``), from the benchmark's spans."""


def read(record):
    prep, back = record["spans_ms"].get("prep", []), record["spans_ms"].get("readback", [])
    if not prep or len(prep) != len(back):
        return None
    return (sum(prep) + sum(back)) / len(prep)
