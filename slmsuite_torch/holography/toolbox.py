"""
The few vector helpers the port's hologram classes need, with the
semantics of :mod:`slmsuite_tpu.holography.toolbox` (numpy and scipy only).
"""

import numpy as np

#: Real scalar types.
REAL_TYPES = (int, float, np.integer, np.floating)


def format_2vectors(vectors):
    """Clean an array of 2-vectors into shape ``(2, N)`` (tuples, row
    vectors and singletons handled; extra dimensions cropped)."""
    vectors = np.squeeze(np.asarray(vectors))
    if vectors.ndim == 1:
        vectors = vectors[:, np.newaxis]
    elif vectors.ndim == 2 and vectors.shape[0] == 1:
        vectors = vectors.T
    if vectors.ndim != 2:
        raise ValueError(f"Wrong dimension {vectors.shape} for vectors.")
    if vectors.shape[0] < 2:
        raise ValueError(f"Expected 2-vectors; found {vectors.shape[0]}-vectors.")
    return vectors[:2, :]

