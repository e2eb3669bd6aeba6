"""Montgomery arithmetic parity tests against Python ints."""

import random

import numpy as np
import pytest

from vmn_tpu.arith import MontCtx, ints_to_limbs, limbs_to_ints, num_limbs
from vmn_tpu.arith.limbs import (
    bytes_be_to_limbs,
    int_to_limbs,
    limbs_to_bytes_be,
    limbs_to_int,
)

# Primes for tests: a small 61-bit prime-ish, a 256-bit safe prime pair.
P61 = (1 << 61) - 1  # Mersenne prime
# 256-bit safe prime (q = (p-1)/2 prime)
P256 = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF72EF
Q256 = (P256 - 1) // 2

rng = random.Random(12345)


def _rand_ints(n, m):
    return [rng.randrange(m) for _ in range(n)]


@pytest.mark.parametrize("m", [P61, P256])
def test_limb_conversion_roundtrip(m):
    L = num_limbs(m.bit_length())
    xs = _rand_ints(10, m)
    arr = ints_to_limbs(xs, L)
    assert limbs_to_ints(arr) == xs
    assert limbs_to_int(int_to_limbs(xs[0], L)) == xs[0]


def test_bytes_be_roundtrip():
    L = 16
    xs = _rand_ints(8, 1 << 250)
    arr = ints_to_limbs(xs, L)
    b = limbs_to_bytes_be(arr, 32)
    assert b.shape == (8, 32)
    for i, x in enumerate(xs):
        assert b[i].tobytes() == x.to_bytes(32, "big")
    back = bytes_be_to_limbs(b, L)
    assert limbs_to_ints(back) == xs
    # wider and narrower targets
    b33 = limbs_to_bytes_be(arr, 33)
    assert limbs_to_ints(bytes_be_to_limbs(b33, L)) == xs


@pytest.mark.parametrize("m", [P61, P256])
def test_mont_mul(m):
    ctx = MontCtx(m)
    xs = _rand_ints(32, m)
    ys = _rand_ints(32, m)
    a = ctx.encode(xs)
    b = ctx.encode(ys)
    got = ctx.decode(ctx.mul(a, b))
    assert got == [(x * y) % m for x, y in zip(xs, ys)]


def test_mont_mul_edge_cases():
    m = P256
    ctx = MontCtx(m)
    xs = [0, 1, m - 1, m - 1, 1, 0]
    ys = [0, 1, m - 1, 1, m - 1, m - 1]
    got = ctx.decode(ctx.mul(ctx.encode(xs), ctx.encode(ys)))
    assert got == [(x * y) % m for x, y in zip(xs, ys)]


def test_add_sub_mod():
    m = P256
    ctx = MontCtx(m)
    xs = _rand_ints(16, m) + [0, m - 1, 0, m - 1]
    ys = _rand_ints(16, m) + [0, m - 1, m - 1, 0]
    a = ctx.encode_std(xs)
    b = ctx.encode_std(ys)
    assert ctx.decode_std(ctx.add(a, b)) == [(x + y) % m for x, y in zip(xs, ys)]
    assert ctx.decode_std(ctx.sub(a, b)) == [(x - y) % m for x, y in zip(xs, ys)]
    assert ctx.decode_std(ctx.neg(a)) == [(-x) % m for x in xs]


@pytest.mark.parametrize("m", [P61, P256])
def test_mont_exp(m):
    ctx = MontCtx(m)
    n = 8
    xs = _rand_ints(n, m)
    es = _rand_ints(n, m) + [0, 1]
    xs += [5, 7]
    ebits = m.bit_length()
    base = ctx.encode(xs)
    e = ctx.encode_std(es)
    got = ctx.decode(ctx.exp(base, e, ebits))
    assert got == [pow(x, ee, m) for x, ee in zip(xs, es)]


def test_mont_exp_small_exponent_bits():
    m = P256
    ctx = MontCtx(m)
    es = _rand_ints(6, 1 << 64)
    xs = _rand_ints(6, m)
    e = ints_to_limbs(es, 4)
    got = ctx.decode(ctx.exp(ctx.encode(xs), np.asarray(e), 64))
    assert got == [pow(x, ee, m) for x, ee in zip(xs, es)]


def test_expprod():
    m = P256
    ctx = MontCtx(m)
    n = 13  # odd on purpose (product-tree edge)
    xs = _rand_ints(n, m)
    es = _rand_ints(n, 1 << 128)
    got = ctx.decode(
        ctx.expprod(ctx.encode(xs), np.asarray(ints_to_limbs(es, 8)), 128)[
            None
        ]
    )[0]
    want = 1
    for x, ee in zip(xs, es):
        want = want * pow(x, ee, m) % m
    assert got == want


def test_prod_reduce():
    m = P61
    ctx = MontCtx(m)
    for n in (1, 2, 7, 16):
        xs = _rand_ints(n, m)
        got = ctx.decode(ctx.prod(ctx.encode(xs))[None])[0]
        want = 1
        for x in xs:
            want = want * x % m
        assert got == want


def test_inv():
    m = P256
    ctx = MontCtx(m)
    xs = _rand_ints(8, m - 1)
    xs = [x + 1 for x in xs]  # nonzero
    got = ctx.decode(ctx.inv(ctx.encode(xs)))
    assert got == [pow(x, -1, m) for x in xs]


def test_fixed_base_exp():
    m = P256
    ctx = MontCtx(m)
    g = 0x1234567
    es = _rand_ints(9, Q256)
    ebits = Q256.bit_length()
    e = np.asarray(ints_to_limbs(es, num_limbs(ebits)))
    got = ctx.decode(ctx.exp_fixed(g, e, ebits))
    assert got == [pow(g, ee, m) for ee in es]


def test_is_lt():
    m = P256
    ctx = MontCtx(m)
    import vmn_tpu.arith.mont as mont

    a = ctx.encode_std([5, 10, 10, m - 1])
    b = ctx.encode_std([10, 5, 10, m - 2])
    got = np.asarray(mont.is_lt(a, b))
    assert got.tolist() == [True, False, False, False]


def test_broadcasting_scalar_base():
    m = P256
    ctx = MontCtx(m)
    g = ctx.encode([7])[0]  # (L,)
    es = _rand_ints(5, 1 << 200)
    e = np.asarray(ints_to_limbs(es, 13))
    got = ctx.decode(ctx.exp(g, e, 200))
    assert got == [pow(7, ee, m) for ee in es]


def test_chunked_scans_match_plain():
    """The huge-batch chunked scan drivers agree with the one-jit scans
    (exercised with a tiny chunk size)."""
    import numpy as np

    import jax.numpy as jnp

    from vmn_tpu.arith import mont as M
    from vmn_tpu.arith.limbs import int_to_limbs

    ctx = M.MontCtx((1 << 61) - 1)
    rng = np.random.default_rng(5)
    n = 37
    xs = [int(rng.integers(1, (1 << 61) - 1)) for _ in range(n)]
    bs = [int(rng.integers(0, (1 << 61) - 1)) for _ in range(n)]
    xm = ctx.to_mont(jnp.asarray(np.stack(
        [int_to_limbs(v, ctx.L) for v in xs]
    )))
    bstd = jnp.asarray(np.stack([int_to_limbs(v, ctx.L) for v in bs]))

    old = M._SCAN_CHUNK
    M._SCAN_CHUNK = 8
    try:
        got = M._prods_scan_chunked(
            xm, ctx.m_limbs, ctx.mprime, ctx.one_mont
        )
        want = M._prods_scan(
            xm, ctx.m_limbs, ctx.mprime, ctx.one_mont
        )
        assert np.array_equal(np.asarray(got), np.asarray(want))
        got = M._rec_lin_chunked(
            xm, bstd, ctx.m_limbs, ctx.mprime, ctx.one_mont
        )
        want = M._rec_lin_scan(
            xm, bstd, ctx.m_limbs, ctx.mprime, ctx.one_mont
        )
        assert np.array_equal(np.asarray(got), np.asarray(want))
    finally:
        M._SCAN_CHUNK = old
