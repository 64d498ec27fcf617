"""The rounding identity behind the bf16-accumulate SpMM kernels, on the CPU.

The plain versions (and the executor's bf16 path) compute each product and
each sum of two bf16 values in f32 and round the f32 result to bf16. The
kernels issue ``mul.rn.bf16x2`` and ``add.rn.bf16x2``, which round the exact
result to bf16 once. Rounding twice is harmless when the first format has
p >= 2q + 2 significant bits for a second of q (Figueroa): f32's 24 against
bf16's 8. These tests hold the two routes to each other bit for bit on over
a million seeded pairs: random patterns, signed zeros, subnormals,
the largest finite values (overflow to inf), ties, and sums over exponent
gaps of 0 to 40 and beyond. The once-rounded reference rounds a float64
result: exact for every product of two bf16 values and for sums over gaps
up to 44 (past that a first rounding to 53 bits, harmless by the same
rule); the sums past that gap are also rounded from exact Python integers.
The card's exhaustive check over all 2^32 pairs is
``spmm_cuda.bf16_rounding_check`` (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import spmm_cuda  # noqa: E402

#: the largest finite bf16, (2 - 2^-7) * 2^127, and its quantum
BF16_MAX = float(np.uint32(0x7F7F0000).view(np.float32))


def f32_of(bits):
    """bf16 bit patterns (uint16) as the f32 values they stand for."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def bf16_rn(x) -> np.ndarray:
    """Round exact values (float64) to bf16 bit patterns, to nearest even,
    with bf16's subnormals (quantum 2^-133) and overflow to inf; NaN stays
    NaN. Scaling by a power of two and ``np.rint`` (ties to even) are exact
    in float64."""
    x = np.asarray(x, np.float64)
    out = np.empty(x.shape, np.float64)
    finite = np.isfinite(x) & (x != 0)
    _, e = np.frexp(x[finite])  # |x| = m * 2^e, m in [0.5, 1)
    q = np.ldexp(1.0, np.maximum(e - 8, -133))
    r = np.rint(x[finite] / q) * q
    r[np.abs(r) > BF16_MAX] = np.copysign(np.inf, r[np.abs(r) > BF16_MAX])
    out[finite] = r
    out[~finite] = x[~finite]  # zeros keep their sign; inf and NaN stay
    return (out.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)


def same(a, b) -> np.ndarray:
    """Bitwise equal, or both NaN."""
    nan = lambda v: (v & 0x7FFF) > 0x7F80  # noqa: E731
    return (a == b) | (nan(a) & nan(b))


def f32_route(a, b, op):
    """The plain versions' route: the f32 result rounded to bf16."""
    with np.errstate(over="ignore", invalid="ignore"):
        r = op(f32_of(a), f32_of(b))  # float32 arithmetic, round to nearest
    return bf16_rn(r.astype(np.float64))


def exact_route(a, b, op):
    """The packed instructions' route: the exact result rounded once."""
    with np.errstate(over="ignore", invalid="ignore"):
        r = op(f32_of(a).astype(np.float64), f32_of(b).astype(np.float64))
    return bf16_rn(r)


def assert_routes_agree(a, b, op):
    got, want = f32_route(a, b, op), exact_route(a, b, op)
    bad = np.flatnonzero(~same(got, want))
    assert bad.size == 0, (
        f"{bad.size} pairs differ, first a={a[bad[0]]:#06x} b={b[bad[0]]:#06x}: "
        f"f32 route {got[bad[0]]:#06x}, exact {want[bad[0]]:#06x}")


def random_patterns(rng, n):
    """Uniform 16-bit patterns, NaNs included."""
    return rng.integers(0, 1 << 16, n, dtype=np.uint32).astype(np.uint16)


def special_patterns():
    """Signed zeros, the smallest and largest subnormals, the smallest
    normal, one, the largest finite values, and infinities, with both
    signs."""
    pos = np.array([0x0000, 0x0001, 0x0002, 0x003F, 0x0040, 0x007F, 0x0080,
                    0x0081, 0x00FF, 0x3F80, 0x3F81, 0x3FFF, 0x7F00, 0x7F7E,
                    0x7F7F, 0x7F80, 0x7FC0], np.uint16)
    return np.concatenate([pos, pos | np.uint16(0x8000)])


def pairs(x, y):
    return np.repeat(x, y.size), np.tile(y, x.size)


@pytest.mark.parametrize("op", [np.multiply, np.add], ids=["mul", "add"])
def test_random_pairs(op):
    rng = np.random.default_rng(25)
    a, b = random_patterns(rng, 200_000), random_patterns(rng, 200_000)
    assert_routes_agree(a, b, op)


@pytest.mark.parametrize("op", [np.multiply, np.add], ids=["mul", "add"])
def test_special_values_against_everything(op):
    """Every special pattern against 8,192 random ones and against each
    other: zeros' signs, subnormal products that underflow f32's range,
    and sums and products that overflow to inf."""
    rng = np.random.default_rng(7)
    special = special_patterns()
    a, b = pairs(special, np.concatenate([special, random_patterns(rng, 8192)]))
    assert_routes_agree(a, b, op)
    assert_routes_agree(b, a, op)


def test_products_of_all_significands_hit_ties():
    """All 2^14 pairs of 7-bit significands at exponents that keep the
    product normal, subnormal or overflowing: exact products of 9 or more
    significant bits land on bf16 ties and near them."""
    sig = np.arange(128, dtype=np.uint16)
    sa, sb = pairs(sig, sig)
    for ea, eb in ((127, 127), (1, 127), (60, 12), (190, 190), (254, 127), (64, 0)):
        a = (np.uint16(ea) << 7) | sa
        b = (np.uint16(eb) << 7) | sb
        exact = f32_of(a).astype(np.float64) * f32_of(b).astype(np.float64)
        if ea + eb == 254:  # both in [1, 4): a tie needs bit 8 of the product
            q = np.ldexp(1.0, np.frexp(exact)[1] - 8)
            assert (np.abs(exact / q - np.rint(exact / q)) == 0.5).any()
        assert_routes_agree(a, b, np.multiply)
        assert_routes_agree(a, b | np.uint16(0x8000), np.multiply)


@pytest.mark.parametrize("gap", list(range(0, 41, 4)) + [1, 7, 8, 9, 23, 24, 25])
def test_sums_over_exponent_gaps(gap):
    """a + b with b's exponent ``gap`` below a's, both signs, random
    significands: cancellation at small gaps, ties at gap 8 (b's leading
    bit half an ulp of a), sticky bits at larger ones."""
    rng = np.random.default_rng(gap)
    n = 20_000
    ea = rng.integers(gap + 1, 255, n).astype(np.uint16)
    eb = ea - np.uint16(gap)
    sign = lambda: (rng.integers(0, 2, n) << 15).astype(np.uint16)  # noqa: E731
    sig = lambda: rng.integers(0, 128, n).astype(np.uint16)  # noqa: E731
    a = sign() | (ea << 7) | sig()
    b = sign() | (eb << 7) | sig()
    assert_routes_agree(a, b, np.add)


def test_sums_past_float64_exactness_by_integers():
    """Sums over exponent gaps of 45 to 253, where a float64 no longer
    holds the exact sum, rounded by integer arithmetic: the exact sum
    ``(ma * 2^ea + mb * 2^eb)`` as a Python integer times a power of two."""
    rng = np.random.default_rng(45)
    n = 2_000
    gaps = rng.integers(45, 254, n)
    ea = rng.integers(gaps + 1, 255)  # b's exponent ea - gap stays >= 1
    eb = ea - gaps
    a = ((rng.integers(0, 2, ea.size) << 15) | (ea << 7)
         | rng.integers(0, 128, ea.size)).astype(np.uint16)
    b = ((rng.integers(0, 2, ea.size) << 15) | (eb << 7)
         | rng.integers(0, 128, ea.size)).astype(np.uint16)

    def parts(bits):
        """(signed integer significand, exponent) with value m * 2^e."""
        bits = int(bits)
        e, m = (bits >> 7) & 0xFF, bits & 0x7F
        m, e = (m | 0x80, e - 134) if e else (m, -133)
        return (-m if bits >> 15 else m), e

    def round_int(m: int, e: int) -> int:
        """bf16 bits of m * 2^e (m a nonzero integer), nearest even."""
        sign = 0x8000 if m < 0 else 0
        m = abs(m)
        shift = max(m.bit_length() - 8, -133 - e)  # drop bits below the quantum
        if shift > 0:
            q, r = divmod(m, 1 << shift)
            half = 1 << (shift - 1)
            q += (r > half) or (r == half and q & 1)
            m, e = q, e + shift
        value = float(m) * 2.0 ** e
        if value > BF16_MAX:
            return sign | 0x7F80
        return sign | int(np.float32(value).view(np.uint32) >> 16)

    want = []
    for x, y in zip(a, b):
        (mx, ex), (my, ey) = parts(x), parts(y)
        lo = min(ex, ey)
        m = (mx << (ex - lo)) + (my << (ey - lo))
        want.append(round_int(m, lo) if m else (int(x) & int(y) & 0x8000))
    got = f32_route(a, b, np.add)
    assert np.array_equal(got, np.array(want, np.uint16))


def test_a_fused_multiply_add_would_not_agree():
    """Why the kernels keep the multiply and the add apart (``.rn`` on
    each, no contraction into an fma): one rounding of ``a * b + c`` parts
    from the executor's two roundings on some inputs."""
    rng = np.random.default_rng(3)
    a, b, c = (random_patterns(rng, 50_000) & np.uint16(0x3FFF) | np.uint16(0x3800)
               for _ in range(3))
    two = f32_route(f32_route(a, b, np.multiply), c, np.add)
    fused = bf16_rn(f32_of(a).astype(np.float64) * f32_of(b).astype(np.float64)
                    + f32_of(c).astype(np.float64))
    assert (two != fused).any()


def test_plain_window_rounds_by_the_f32_route():
    """The plain bf16-accumulate window on one slot is the f32 route: the
    slot value and B rounded to bf16, their product rounded, then added
    to +0."""
    from repro_torch.core import executor as texe
    from repro_torch.core import schedule as tsched
    from repro_torch.core.csc import coo_from_dense

    rng = np.random.default_rng(11)
    vals = random_patterns(rng, 64) & np.uint16(0x7F7F)  # finite, positive
    a = coo_from_dense(np.diag(f32_of(vals)))  # one slot a row
    steps = texe.device_step_arrays(tsched.build_balanced_schedule(a, 8, 4), "cpu")
    x = random_patterns(rng, 64 * 3).reshape(64, 3) & np.uint16(0x7F7F)
    b = torch.from_numpy(f32_of(x))
    out = spmm_cuda.spmm_balanced_plain(steps, b, acc_dtype=torch.bfloat16)
    live = f32_of(vals) != 0
    want = f32_route(np.repeat(vals, 3), x.reshape(-1), np.multiply).reshape(64, 3)
    got = (out.view(torch.int32).numpy().astype(np.uint32) >> 16).astype(np.uint16)
    assert np.array_equal(got[live], want[live])
    # the exhaustive check of the packed instructions needs the card
    with pytest.raises(ValueError, match="CUDA"):
        spmm_cuda.bf16_rounding_check("cpu")
