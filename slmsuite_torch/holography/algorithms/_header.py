"""
Algorithm registry and defaults of the algorithms subpackage (the same
tables as :mod:`slmsuite_tpu.holography.algorithms._header`).
"""

# Default flags per optimization method. Order matters: ALGORITHM_INDEX
# numerically encodes methods.
ALGORITHM_DEFAULTS = {
    "GS": {"feedback": "computational"},
    "WGS-Leonardo": {"feedback": "computational", "feedback_exponent": 0.8},
    "WGS-Kim": {
        "feedback": "computational",
        "fix_phase_efficiency": None,
        "fix_phase_iteration": 10,
        "feedback_exponent": 0.8,
    },
    "WGS-Nogrette": {"feedback": "computational", "feedback_factor": 0.1},
    "WGS-Wu": {"feedback": "computational", "feedback_exponent": 0.5},
    "WGS-tanh": {
        "feedback": "computational",
        "feedback_factor": 0.2,
        "feedback_exponent": 0.5,
    },
    "CG": {
        "feedback": "computational",
        "optimizer": "adam",
        "optimizer_kwargs": {"learning_rate": 0.1},
        "loss": None,
    },
}

ALGORITHM_INDEX = {key: i for i, key in enumerate(ALGORITHM_DEFAULTS.keys())}

FEEDBACK_OPTIONS = [
    "computational",
    "computational_spot",
    "experimental",
    "experimental_spot",
    "external_spot",
]
