"""
The register-resident line FFT of ``rows_fft`` and ``cols_fft``
(``slmsuite_torch/csrc/fft_shared.cuh: line_fft``), as far as it can be
held without a card: its plan, its index arithmetic, and the plain
PyTorch model that follows the kernel pass by pass
(``slmsuite_torch.ops.cuda_fft.line_fft_model``), against ``torch.fft`` in
float64 and against the JAX package's ``fft2``/``ifft2`` on the CPU.

Lines that are not a power of two (mixed lines, ``n = P * m``, P = 8 or
16) run ``m`` interleaved P-point lines in registers, then the passes over
``m`` through shared memory: its power of two in radices 4, 8 and 16, its
odd primes as butterflies (3, 5, 7) or direct sums (11 and above); the
model follows them too, at every side that ``chip_smoke.py``'s X0 runs on
the card and at a seeded sample of other sides.

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
#: More mixed sides for the model: real panels' sides and the plans'
#: extremes (1200; 8168 = 8 * 1021, a prime; 8184 = 8 * 3 * 11 * 31, a
#: direct pass before the last), and a sample of 40 other multiples of 8 in
#: [64, 8192] that are not powers of two, drawn with a fixed seed.
NAMED = (1080, 1200, 1272, 4160, 6144, 8168, 8184)
_OTHERS = [n for n in range(64, 8193, 8) if n & (n - 1) and n not in MIXED + NAMED]
SAMPLE = tuple(sorted(set(NAMED) | {int(n) for n in
                                    np.random.default_rng(22).choice(_OTHERS, 40, replace=False)}))
JAX_RTOL = 2e-5


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("n", SIDES + MIXED)
def test_plan_multiplies_to_the_length(n):
    """The register passes of the power of two P (two up to 256, three up
    to 4096, four at 8192; radix 8 first), then for a mixed line (P = 8
    where n has three or five factors of 2, else 16: one register pass) the
    passes over m: its power of two in radices 16, 8 and 4, the fewest
    passes and never a 2 (a radix of 8 or 16 only with P = 16, so that a
    thread takes whole butterflies), then its odd part, smallest radix
    first: its 3s in pairs as 9, a 3 left over with a 5 as 15 (so at most
    one 3, and not beside a 5), the other odd primes as they are."""
    plan = cuda_fft.fft_plan(n)
    assert int(np.prod(plan)) == n
    p, m = cuda_fft.line_split(n)
    assert p * m == n and p >= 8 and p & (p - 1) == 0
    radices = cuda_fft.m_radices(m)
    pow2 = plan[:len(plan) - len(radices)]
    assert int(np.prod(pow2)) == p and int(np.prod(radices)) == m
    if m > 1:
        twos = (n & -n).bit_length() - 1
        assert pow2 == ((8,) if twos in (3, 5) else (16,)) and m & (m - 1) != 0
        evens = [r for r in radices if r % 2 == 0]
        odds = radices[len(evens):]
        assert set(evens) <= ({4} if p == 8 else {4, 8, 16})
        assert int(np.prod(evens)) == m & -m
        assert len(evens) == {1: 0, 4: 1, 8: 1, 16: 1, 32: 2, 64: 2, 128: 2}[m & -m]
        assert list(odds) == sorted(odds) and int(np.prod(odds)) == m // (m & -m)
        primes = [r for r in odds if r not in (9, 15)]
        assert all(r > 2 and all(r % d for d in range(2, int(r ** 0.5) + 1)) for r in primes)
        assert primes.count(3) <= 1 and not (3 in primes and 5 in primes)
        assert all(r in cuda_fft.M_BUTTERFLIES or r > 10 for r in odds)
    else:
        assert set(pow2) <= {8, 16} and len(pow2) == (2 if p <= 256 else 3 if p <= 4096 else 4)
        assert list(pow2) == sorted(pow2)
    assert cuda_fft.line_points(n) == max(pow2)


@pytest.mark.parametrize("n", [32, 100, 1021, 16384])
def test_plan_refuses_other_lengths(n):
    with pytest.raises(ValueError, match="No plan"):
        cuda_fft.fft_plan(n)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", SIDES + MIXED + tuple(n for n in SAMPLE if n not in MIXED))
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
    """A mixed line's passes over m, slot by slot (``m_slot``: point j of
    the m-point line k1 in slot j (P + 1) + k1 of either half of the
    buffer; the slots distinct and within a half of the pitch, each pass
    reading one half and writing the other). The rotation writes every
    slot once (thread s: point
    s of each line k1). Each butterfly pass of radix r writes every slot
    once and reads every slot once, r points a butterfly, all of one
    m-point line, and a thread takes at most ceil(P / r) of the n / r
    butterflies (b = s + c m); each direct pass (a prime of 11 or more)
    reads every slot r times, each output's r points of its own line, and
    writes every slot once. The line's output k1 + P k2 is read last from
    slot x + x / P. The multipliers divide every index of the
    pass exactly, and the strides and counts multiply to the lengths."""
    p2, m = cuda_fft.line_split(n)
    pitch = cuda_fft.line_pitch(n)
    k1, j = np.meshgrid(np.arange(p2), np.arange(m), indexing="ij")
    slots = cuda_fft.m_slot(n, k1, j).ravel()
    assert len(set(slots)) == n and slots.max() < pitch // 2

    def each_slot_once(at, times=1):
        counts = np.bincount(np.concatenate(at), minlength=pitch)
        return (counts[slots] == times).all() and counts.sum() == times * n

    s = np.arange(m)
    assert each_slot_once([cuda_fft.m_slot(n, q, s) for q in range(p2)])
    passes = cuda_fft.m_passes(n)
    assert tuple(q["r"] for q in passes) == cuda_fft.m_radices(m)
    for q in passes:
        r, p, mr = q["r"], q["p"], q["mr"]
        assert mr * r == m and q["nb"] * r == n and q["tws"] * p * r == n
        if r in cuda_fft.M_BUTTERFLIES:
            b = np.arange(q["nb"])
            line, i = b % p2, b // p2
            jj = cuda_fft.m_div(i, q["div_p"])
            assert (jj == i // p).all()
            k = i - jj * p
            reads = [cuda_fft.m_slot(n, line, i + t * mr) for t in range(r)]
            assert each_slot_once(reads)
            assert each_slot_once([cuda_fft.m_slot(n, line, jj * p * r + k + t * p)
                                   for t in range(r)])
            assert -(-q["nb"] // m) <= -(-p2 // r)
        else:
            x = np.arange(n)
            line, o = x % p2, x // p2
            q1 = cuda_fft.m_div(o, q["div_pr"])
            assert (q1 == o // (p * r)).all()
            e0 = o - q1 * p * r
            assert (cuda_fft.m_div(e0, q["div_p"]) == e0 // p).all()
            i = q1 * p + e0 % p
            reads = [cuda_fft.m_slot(n, line, i + t * mr) for t in range(r)]
            assert each_slot_once(reads, times=r)
            assert each_slot_once([cuda_fft.m_slot(n, line, o)])
    x = np.arange(n)
    assert (cuda_fft.m_slot(n, x % p2, x // p2) == x + x // p2).all()


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
