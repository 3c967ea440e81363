"""
Numeric type tuples for isinstance-based argument parsing (the port's
copy of :mod:`slmsuite_tpu.misc.math`).
"""

import numpy as np

#: Integer scalar types (python and numpy).
INTEGER_TYPES = (int, np.integer)

#: Floating scalar types (python and numpy).
FLOAT_TYPES = (float, np.floating)

#: Real scalar types.
REAL_TYPES = INTEGER_TYPES + FLOAT_TYPES

#: All scalar types including complex.
SCALAR_TYPES = REAL_TYPES + (complex, np.complexfloating)


def iseven(x):
    """Return ``True`` if the integer ``x`` is even."""
    return int(x) % 2 == 0
