"""The comparison that decides ``correct``: the program's outputs of a
sample of the window's requests against the plain reference's, as numbers
each held to a limit of its configuration (``limits`` in its file).

The numbers, the worst over the sample:

- ``phase_rms_rad``: the root mean square over the SLM's pixels of the
  wrapped difference of the two phases;
- ``spot_amp_gap``: the largest difference of the final farfield's spot
  amplitudes, over the reference's largest;
- ``weight_gap``: the same of the spot weights;
- ``efficiency_gap``, ``uniformity_gap``: the absolute differences of the
  last iteration's stats.
"""

import numpy as np

NUMBERS = ("phase_rms_rad", "spot_amp_gap", "weight_gap", "efficiency_gap", "uniformity_gap")


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def compare(phase, outputs, ref):
    """The numbers of one request: the program's ``phase`` and ``outputs``
    (``spot_amp``, ``weights``, ``efficiency``, ``uniformity``) against
    the reference's ``ref``."""
    rp = _host(ref["phase"]).astype(np.float64)
    d = np.angle(np.exp(1j * (np.asarray(phase, np.float64) - rp)))
    ra, rw = _host(ref["spot_amp"]), _host(ref["weights"])
    return {
        "phase_rms_rad": float(np.sqrt(np.mean(np.square(d)))),
        "spot_amp_gap": float(np.max(np.abs(_host(outputs["spot_amp"]) - ra)) / np.max(ra)),
        "weight_gap": float(np.max(np.abs(_host(outputs["weights"]) - rw)) / np.max(rw)),
        "efficiency_gap": abs(float(outputs["efficiency"]) - float(ref["efficiency"])),
        "uniformity_gap": abs(float(outputs["uniformity"]) - float(ref["uniformity"])),
    }


def worst(readings):
    """The largest of each number over a list of readings (nan wins)."""
    out = {}
    for name in NUMBERS:
        values = [r[name] for r in readings]
        out[name] = float("nan") if any(np.isnan(values)) else max(values)
    return out


def checks(numbers, limits):
    """``{name: {"value", "limit"}}`` of every number that has a limit."""
    return {name: {"value": numbers[name], "limit": float(limits[name])}
            for name in NUMBERS if name in limits}


def passed(checked):
    """Whether every checked number is within its limit (nan fails)."""
    return all(c["value"] <= c["limit"] for c in checked.values())
