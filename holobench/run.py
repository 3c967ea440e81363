"""Run one cell of the benchmark of ``slmsuite_torch`` on the card.

    python holobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``checks``, the numbers compared with
the plain reference beside their limits, which also end standard error.
Exits non-zero, printing no result, where no card (or too few) is found.
``--rehearse`` runs the cell on the CPU at tiny shapes, for the tests.
"""

import os
import sys
import time

T_START = time.perf_counter()

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# Build and kernel caches at fixed paths inside the checkout, so that a
# checkout's later runs find what its first run built.
os.environ["TRITON_CACHE_DIR"] = os.path.join(BENCH, "out", "cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BENCH, "out", "cache", "torch_extensions")
# The checkout's root, not this folder, is where the packages are found.
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != BENCH]

from holobench import harness  # noqa: E402

if __name__ == "__main__":
    try:
        sys.exit(harness.main(sys.argv[1:], T_START))
    except harness.Refused as exc:
        print(f"holobench: {exc}", file=sys.stderr)
        sys.exit(2)
