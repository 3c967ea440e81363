"""The least work of one WGS iteration of the ``compressed`` kind: the two
transforms, farfield to nearfield and back, each over every pair of a spot
and a pixel: the phase ``sum_d c[d, n] B[d, p]`` (2 D operations), its
sincos, and the complex multiply-accumulate (8). The bytes: the basis
(D x P) and the phase (P) read once and the phase written once. A cos/sin
cache is not counted, so the cached and the recomputing loops are held to
the same work."""

from holobench.drivers.compressed import indices
from holobench.work import SINCOS_FLOPS


def per_iteration(config, traffic):
    h, w = config["slm"]["shape"]
    pixels = h * w
    cols, rows = traffic["spots"]
    d = len(indices(traffic))
    return {"flops": 2 * cols * rows * pixels * (2 * d + SINCOS_FLOPS + 8),
            "bytes": 4 * pixels * (d + 2)}
