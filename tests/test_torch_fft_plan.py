"""
The register-resident line FFT of ``rows_fft`` and ``cols_fft``
(``slmsuite_torch/csrc/fft_shared.cuh: line_fft``), as far as it can be
held without a card: its plan, its index arithmetic, and the plain
PyTorch model that follows the kernel pass by pass
(``slmsuite_torch.ops.cuda_fft.line_fft_model``), against ``torch.fft`` in
float64 and against the JAX package's ``fft2``/``ifft2`` on the CPU.

Lines that are not a power of two (mixed lines, ``n = 8 * m``) run ``m``
interleaved 8-point lines, then one pass per prime factor of ``m``; the
model follows them too, at every side that ``chip_smoke.py``'s X0 runs on
the card.

Tolerances: the model runs in f32 with an f32 twiddle table, so against a
float64 transform of the same input it is held to ``2e-6 * log2(n)`` of
the largest output value (an f32 FFT's error grows with the number of
passes; measured 1e-7 to 3e-7, and 1.3e-6 at 8168 = 8 * 1021, a direct
1021-term sum). Against the JAX package (f32, another algorithm) a plane
is held to 2e-5 of its largest value.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slmsuite_torch.ops import cuda_fft
from slmsuite_torch.ops import fft as TF
from slmsuite_tpu.ops import fft as JF


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Numpy's global generator left as the test found it."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


SIDES = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
#: The sides chip_smoke.py's X0 holds every line kernel at on the card.
X0_SIDES = (96, 792, 1080, 1152, 1272, 1536, 1792, 1920, 4160, 6144, 8192)
MIXED = tuple(n for n in X0_SIDES if n & (n - 1))
JAX_RTOL = 2e-5


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("n", SIDES + MIXED)
def test_plan_multiplies_to_the_length(n):
    """The register passes of the power of two P (two up to 256, three up
    to 4096, four at 8192; radix 8 first; a mixed line: P = 8, one pass),
    then the primes of m, smallest first."""
    plan = cuda_fft.fft_plan(n)
    assert int(np.prod(plan)) == n
    p, m = cuda_fft.line_split(n)
    assert p * m == n and p >= 8 and p & (p - 1) == 0
    primes = cuda_fft._factors(m)
    pow2 = plan[:len(plan) - len(primes)]
    assert int(np.prod(pow2)) == p and int(np.prod(primes)) == m
    assert list(primes) == sorted(primes)
    if m > 1:
        assert pow2 == (8,) and m & (m - 1) != 0
    else:
        assert set(pow2) <= {8, 16} and len(pow2) == (2 if p <= 256 else 3 if p <= 4096 else 4)
        assert list(pow2) == sorted(pow2)
    assert cuda_fft.line_points(n) == max(pow2)


@pytest.mark.parametrize("n", [32, 100, 1021, 16384])
def test_plan_refuses_other_lengths(n):
    with pytest.raises(ValueError, match="No plan"):
        cuda_fft.fft_plan(n)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", SIDES + MIXED)
def test_model_matches_float64_fft(n, inverse):
    xr, xi = _pair((3, n), n)
    yr, yi = cuda_fft.line_fft_model(torch.from_numpy(xr), torch.from_numpy(xi), inverse=inverse)
    z = torch.complex(torch.from_numpy(xr).double(), torch.from_numpy(xi).double())
    ref = torch.fft.ifft(z, norm="forward") if inverse else torch.fft.fft(z)
    got = torch.complex(yr.double(), yi.double())
    assert _rel(got.numpy(), ref.numpy()) <= 2e-6 * np.log2(n)


@pytest.mark.parametrize("n,blocks", [(1024, 2), (2048, 2), (4096, 2), (8192, 2), (8192, 4)])
def test_model_through_a_cluster_of_two_is_the_same(n, blocks):
    """The exchange through two blocks' buffers (cols_fft at 4096 points)
    or four (at 8192) moves the same values: bit-identical to one
    block's."""
    xr, xi = (torch.from_numpy(x) for x in _pair((2, n), 7))
    one = cuda_fft.line_fft_model(xr, xi, inverse=False)
    two = cuda_fft.line_fft_model(xr, xi, inverse=False, blocks=blocks)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("n", SIDES)
def test_exchange_writes_every_point_once(n):
    """Each pass's output map (i - k) R + k + r p is a permutation of the
    line, and the padded slots are distinct and fit the pitch."""
    p = 1
    for radix in cuda_fft.fft_plan(n):
        i = np.arange(n // radix)
        k = i & (p - 1)
        out = np.concatenate([(i - k) * radix + k + r * p for r in range(radix)])
        assert sorted(out) == list(range(n))
        p *= radix
    slots = cuda_fft.line_pad(np.arange(n))
    assert len(set(slots)) == n and slots.max() < cuda_fft.line_pitch(n)


@pytest.mark.parametrize("n,blocks", [(n, b) for n in SIDES if n >= 256 for b in (1, 2, 4)
                                      if n // cuda_fft.line_points(n) >= 8 * b])
def test_cluster_slots(n, blocks):
    """Point m goes to the block whose thread m mod T reads it (the blocks
    take a line's threads in groups of 8 in turn), to a slot of its own
    there; thread s of the line is thread t = s / (8 blocks) * 8 + s mod 8
    of its block and finds its q-th point, s + q T, at the padded local
    index q * T / blocks + t, where the kernel reads it. Lines of at least
    16 threads (32 on four blocks): each block takes whole groups of 8."""
    threads = n // cuda_fft.line_points(n)
    per_block = threads // blocks
    m = np.arange(n)
    block, slot = cuda_fft.line_slot(n, m, blocks)
    assert (block == (m % threads) // 8 % blocks).all()
    assert len(set(zip(block, slot))) == n
    assert slot.max() < cuda_fft.line_pitch(n) // blocks
    s = np.arange(threads)
    t = s // (8 * blocks) * 8 + s % 8
    for q in range(cuda_fft.line_points(n)):
        owner, at = cuda_fft.line_slot(n, s + q * threads, blocks)
        assert (owner == s // 8 % blocks).all()
        assert (at == cuda_fft.line_pad(q * per_block + t)).all()


@pytest.mark.parametrize("n,blocks,local", [(4096, 2, [False, True]),
                                            (8192, 4, [False, False, True])])
def test_cluster_exchange_after_a_wide_pass_is_local(n, blocks, local):
    """After a pass whose stride p is a multiple of 8 * blocks every output
    of a thread is read in the thread's own block, so 4096 = 16 * 16 * 16 on
    two blocks crosses blocks in its first exchange only, and 8192 = 8 * 8 *
    8 * 16 on four blocks in its first two."""
    threads = n // cuda_fft.line_points(n)
    p, stays_local = 1, []
    for radix in cuda_fft.fft_plan(n)[:-1]:
        i = np.arange(n // radix)
        k = i & (p - 1)
        writer = (i % threads) // 8 % blocks
        stays = all(
            (cuda_fft.line_slot(n, (i - k) * radix + k + r * p, blocks)[0] == writer).all()
            for r in range(radix))
        assert stays == (p % (8 * blocks) == 0)
        stays_local.append(stays)
        p *= radix
    assert stays_local == local


@pytest.mark.parametrize("n", MIXED + (8168, 8184))
def test_m_passes_read_every_point_once(n):
    """A mixed line's passes of m: the four-step rotation writes slot k1 m
    + b once for every point, each pass's output-driven sum reads the r
    points i + j m / r of its own m-point line, and over a pass every point
    is read r times (each by r outputs); the last pass's outputs k1 + P o
    are the line's points in order. The slots fit the line's pitch."""
    p2, m = cuda_fft.line_split(n)
    b, k1 = np.meshgrid(np.arange(m), np.arange(p2), indexing="ij")
    assert sorted((k1 * m + b).ravel()) == list(range(n))
    idx, p = np.arange(n), 1
    for r in cuda_fft._factors(m):
        pr = p * r
        last = pr == m
        line, o = (idx % p2, idx // p2) if last else (idx // m, idx % m)
        at = line * m + (o // pr) * p + o % p
        reads = np.concatenate([at + j * (m // r) for j in range(r)])
        assert (reads // m == np.tile(line, r)).all()
        assert (np.bincount(reads, minlength=n) == r).all()
        if last:
            assert (line + p2 * o == idx).all()
        p = pr
    assert cuda_fft.line_pad(np.arange(n)).max() < cuda_fft.line_pitch(n)


def test_line_kernel_enum_names_the_line_kernels_in_order():
    """The library takes a kernel by its place in ``enum LineKernel``
    (``csrc/fft_shared.cuh``; ``slm_fft_launch_shape``, ``slm_cols_blocks``)
    and the wrappers give it its place in ``LINE_KERNELS``: a kernel out of
    place would get another kernel's launch shape without any error. The
    enum, read from the source, names the same kernels in the same order,
    counts from 0 and ends with its count."""
    source = (cuda_fft._CSRC / "fft_shared.cuh").read_text()
    body = re.search(r"enum LineKernel \{(.*?)\};", source, re.S).group(1)
    entries = [e.strip() for e in body.split(",")]
    assert entries[0] == "kRowsFft = 0" and entries[-1] == "kNumLineKernels"
    assert all(re.fullmatch(r"k[A-Za-z0-9]+", e) for e in entries[1:])
    names = [re.sub(r"(?<!^)([A-Z])", r"_\1", e.split(" ")[0][1:]).lower()
             for e in entries[:-1]]
    assert tuple(names) == cuda_fft.LINE_KERNELS
    # Every kernel of the port's FFT is on the line FFT, the forward half's
    # column pass last; cols_kernel() takes the column kernels (a tile,
    # launch_cols, cols_blocks) and only those.
    assert cuda_fft.LINE_KERNELS[-1] == "cols_wgs_fwd" and "kColsWgsFwd" in entries
    body = re.search(r"constexpr bool cols_kernel\(int kernel\) \{(.*?)\}", source, re.S)
    taken = re.findall(r"kernel == (k[A-Za-z0-9]+)", body.group(1))
    assert sorted(taken) == sorted(e for e in entries[:-1] if e.startswith("kCols"))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(64, 4096), (4096, 64), (96, 128), (384, 1536)])
@pytest.mark.parametrize("route", ["plain", "model"])
def test_rectangles_match_jax(route, shape, inverse):
    """Rows then columns (inverse: columns then rows) of the two extreme
    rectangles and of two planes whose sides are not all powers of two
    (96 = 32 * 3; 384 = 128 * 3 and 1536 = 512 * 3, sides the JAX
    package's own kernels take), through the kernels' plain versions and
    through the model of their line FFT, against the JAX package's ortho
    fft2 / ifft2."""
    xr, xi = _pair(shape, 11)
    ref = (JF.ifft2 if inverse else JF.fft2)(jnp.asarray(xr) + 1j * jnp.asarray(xi))
    ref = np.asarray(ref)
    a, b = torch.from_numpy(xr), torch.from_numpy(xi)
    if route == "plain":
        rows = lambda a, b, scale=1.0: TF._rows_fft(a, b, inverse=inverse, scale=scale)
        cols = lambda a, b, scale=1.0: TF._cols_fft(a, b, inverse=inverse, scale=scale)
    else:
        def rows(a, b, scale=1.0):
            yr, yi = cuda_fft.line_fft_model(a, b, inverse=inverse)
            return yr * scale, yi * scale

        def cols(a, b, scale=1.0):
            yr, yi = cuda_fft.line_fft_model(a.T.contiguous(), b.T.contiguous(),
                                             inverse=inverse)
            return yr.T * scale, yi.T * scale
    scale = TF.ortho_scale(shape)
    got = rows(*cols(a, b), scale) if inverse else cols(*rows(a, b), scale)
    assert _rel(got[0].numpy(), ref.real) <= JAX_RTOL
    assert _rel(got[1].numpy(), ref.imag) <= JAX_RTOL
