"""Montgomery core and EC point-arithmetic tests against Python bignums.

The core (vmn_tpu/ops/mont_core.h) is the whole performance story on the
GPU.  Its arithmetic is checked here through its host build — a CPU FFI
target compiled with g++ from the same header — limb for limb against
Python bignum arithmetic, including edge values (0, 1, m-1, zero and
maximal exponents), odd limb counts and broadcast rows.  The same entry
points run the CUDA kernels on the card (`gpu`-marked parity test in
tests/test_scale.py).  The EC tests check the XLA point formulas that
the NIST-curve groups use.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from vmn_tpu.arith.limbs import int_to_limbs, limbs_to_int
from vmn_tpu.arith.mont import MontCtx
from vmn_tpu.ops import core

P256 = int(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff72ef",
    16,
)
P521 = (1 << 521) - 1  # 33 limbs: exercises the odd-limb shift


@pytest.fixture(scope="module", autouse=True)
def _host_core():
    core.load("cpu")


@pytest.fixture(scope="module")
def ctx():
    return MontCtx(P256)


def _to_mont_np(ctx, xs):
    return np.asarray(
        ctx.to_mont(jnp.asarray(
            np.stack([int_to_limbs(x % ctx.m, ctx.L) for x in xs])
        ))
    )


def _from_mont_ints(ctx, arr):
    out = np.asarray(ctx.from_mont(jnp.asarray(arr)))
    return [limbs_to_int(row) for row in out]


def _edge_values(m):
    return [0, 1, 2, m - 1, m - 2, m // 2, 3, m // 3, 12345, m - 12345]


@pytest.mark.parametrize("modulus", [P256, P521], ids=["even_L", "odd_L"])
def test_core_mont_mul(modulus):
    ctx = MontCtx(modulus)
    m = ctx.m
    vals = _edge_values(m)
    a_ints = vals + vals[::-1]
    b_ints = vals[::-1] + vals
    a = jnp.asarray(_to_mont_np(ctx, a_ints))
    b = jnp.asarray(_to_mont_np(ctx, b_ints))
    out = core.mont_mul(a, b, ctx.m_limbs)
    got = _from_mont_ints(ctx, np.asarray(out))
    # mont_mul of Montgomery forms yields Montgomery form of product
    want = [(x % m) * (y % m) % m for x, y in zip(a_ints, b_ints)]
    assert got == want
    # a single (1, L) row broadcasts against the batch
    row = core.mont_mul(a, b[3:4], ctx.m_limbs)
    assert _from_mont_ints(ctx, np.asarray(row)) == [
        x % m * (b_ints[3] % m) % m for x in a_ints
    ]


@pytest.mark.parametrize("modulus", [P256, P521], ids=["even_L", "odd_L"])
def test_core_mont_exp(modulus):
    ctx = MontCtx(modulus)
    m = ctx.m
    bases = [2, 1, m - 1, 3, 12345, m - 2, 7, 1 << 60]
    exps = [0, 1, 2, m - 2, (1 << 255) - 1, 65537, 50, 3]
    a = jnp.asarray(_to_mont_np(ctx, bases))
    e = jnp.asarray(
        np.stack([int_to_limbs(x, ctx.L) for x in exps])
    )
    out = core.mont_exp(a, e, ctx.m_limbs, ctx.one_mont, m.bit_length())
    got = _from_mont_ints(ctx, np.asarray(out))
    want = [pow(b % m, x, m) for b, x in zip(bases, exps)]
    assert got == want


@pytest.mark.parametrize("window", [4, 8])
def test_core_fb_exp(ctx, window):
    m = ctx.m
    g = 4
    exps = [0, 1, 2, m - 2, (1 << 255) - 1, 65537, 50, 3]
    tbl = ctx.fixed_base_table(g, 256, window)
    assert tbl.shape == (256 // window, 1 << window, ctx.L)
    e = jnp.asarray(np.stack([int_to_limbs(x, ctx.L) for x in exps]))
    out = core.fb_exp(tbl, e, ctx.m_limbs, ctx.one_mont)
    got = _from_mont_ints(ctx, np.asarray(out))
    want = [pow(g, x, m) for x in exps]
    assert got == want


def test_core_matches_xla_path(ctx):
    """The core and the portable XLA path agree on random batches (the
    dispatch layer switches between them by platform)."""
    from vmn_tpu.arith import mont as mont_mod

    rng = np.random.default_rng(7)
    N = 160
    a_ints = [int.from_bytes(rng.bytes(31), "big") % ctx.m
              for _ in range(N)]
    e_ints = [int.from_bytes(rng.bytes(31), "big") for _ in range(N)]
    a = jnp.asarray(_to_mont_np(ctx, a_ints))
    e = jnp.asarray(np.stack([int_to_limbs(x, ctx.L) for x in e_ints]))

    xla = mont_mod.mont_exp(
        a, e, ctx.m_limbs, ctx.mprime, ctx.one_mont, 256
    )
    got = core.mont_exp(a, e, ctx.m_limbs, ctx.one_mont, 256)
    assert np.array_equal(np.asarray(xla), np.asarray(got))
    assert np.array_equal(
        np.asarray(mont_mod.mont_mul(a, a, ctx.m_limbs, ctx.mprime)),
        np.asarray(core.mont_mul(a, a, ctx.m_limbs)),
    )


def test_core_expprod(ctx):
    """Digit-position multi-exp vs Python bignum, over several batch
    sizes (chunking paths) and exponent bit bounds."""
    m = ctx.m
    rng = np.random.default_rng(11)
    for N, nbits in [(5, 256), (160, 256), (300, 100), (64, 16), (1, 8)]:
        b_ints = [int.from_bytes(rng.bytes(31), "big") % m
                  for _ in range(N)]
        e_ints = [
            int.from_bytes(rng.bytes((nbits + 7) // 8), "big")
            % (1 << nbits)
            for _ in range(N)
        ]
        # edge exponents: zero and the max bound
        e_ints[0] = 0
        e_ints[-1] = (1 << nbits) - 1
        b = jnp.asarray(_to_mont_np(ctx, b_ints))
        e = jnp.asarray(np.stack([int_to_limbs(x, ctx.L) for x in e_ints]))
        out = core.expprod(b, e, ctx.m_limbs, ctx.one_mont, nbits)
        got = _from_mont_ints(ctx, np.asarray(out)[None])[0]
        want = 1
        for x, k in zip(b_ints, e_ints):
            want = want * pow(x, k, m) % m
        assert got == want, (N, nbits)


def test_core_expprod_matches_host_straus(ctx):
    """Core multi-exp and its positions vs the XLA Straus path and the
    XLA per-position products on a random batch."""
    from vmn_tpu.arith import mont as mont_mod

    rng = np.random.default_rng(13)
    N = 200
    a_ints = [int.from_bytes(rng.bytes(31), "big") % ctx.m
              for _ in range(N)]
    e_ints = [int.from_bytes(rng.bytes(32), "big") for _ in range(N)]
    a = jnp.asarray(_to_mont_np(ctx, a_ints))
    e = jnp.asarray(np.stack([int_to_limbs(x, ctx.L) for x in e_ints]))
    host = mont_mod._expprod_shared(
        a, e, ctx.m_limbs, ctx.mprime, ctx.one_mont, 256
    )
    got = core.expprod(a, e, ctx.m_limbs, ctx.one_mont, 256)
    assert np.array_equal(np.asarray(host), np.asarray(got))
    pos_xla = mont_mod._expprod_positions(
        a, e, ctx.m_limbs, ctx.mprime, ctx.one_mont, 64
    )
    pos = core.expprod_positions(a, e, ctx.m_limbs, ctx.one_mont, 64)
    assert pos.shape == (16, ctx.L)
    assert np.array_equal(np.asarray(pos_xla), np.asarray(pos))


def test_core_widths():
    """The wrapper's width table and the library's agree: every listed
    width runs, an unlisted one is refused by the handler."""
    for W in core.WIDTHS:
        assert core.supports(2 * W) and core.supports(2 * W - 1)
    assert not core.supports(2 * 9)
    m = (1 << (16 * 18 - 1)) + 1  # 18 limbs -> 9 words: no build
    ctx = MontCtx(m)
    one = jnp.asarray(int_to_limbs(1, ctx.L))[None]
    with pytest.raises(Exception, match="no build"):
        np.asarray(core.mont_mul(one, one, ctx.m_limbs))


# ---------------------------------------------------------- EC formulas


def _host_ec_add(p, a, P, Q):
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2 and (y1 + y2) % p == 0:
        return None
    if P == Q:
        lam = (3 * x1 * x1 + a) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return (x3, y3)


def _host_ec_mul(p, a, P, k):
    acc = None
    add = P
    while k:
        if k & 1:
            acc = _host_ec_add(p, a, acc, add)
        add = _host_ec_add(p, a, add, add)
        k >>= 1
    return acc


def _check_points(ctx, x_aff, y_aff, inf_out, want):
    got_x = _from_mont_ints(ctx, np.asarray(x_aff))
    got_y = _from_mont_ints(ctx, np.asarray(y_aff))
    infs = np.asarray(inf_out)
    for i, w in enumerate(want):
        if w is None:
            assert infs[i], f"row {i}: expected infinity"
        else:
            assert not infs[i] and (got_x[i], got_y[i]) == w, f"row {i}"


def test_ec_scalar_mul():
    """Windowed Jacobian scalar multiplication vs host affine arithmetic,
    including identity scalars and the infinity input point."""
    from vmn_tpu.arith.ec import ECqPGroup, _scalar_mul

    grp = ECqPGroup.named("P-256")
    ctx = grp.ctx
    p, a = grp.p, grp.a
    G = (grp.gx, grp.gy)
    scalars = [0, 1, 2, 3, grp.n - 1, grp.n - 2, 12345,
               (1 << 255) + 99, grp.n // 3, 7]
    pts = [_host_ec_mul(p, a, G, i + 2) for i in range(len(scalars))]
    want = [_host_ec_mul(p, a, pt, k) for pt, k in zip(pts, scalars)]

    xs = ctx.encode([pt[0] for pt in pts])
    ys = ctx.encode([pt[1] for pt in pts])
    inf = jnp.zeros((len(pts),), bool)
    Le = (256 + 15) // 16
    e = jnp.asarray(np.stack([
        int_to_limbs(k, Le) for k in scalars
    ]))
    _check_points(ctx, *_scalar_mul(grp.curve, xs, ys, inf, e, 256), want)

    # infinity input point stays infinity under any scalar
    _, _, inf_out = _scalar_mul(
        grp.curve, ctx.encode([0]), ctx.encode([0]), jnp.ones((1,), bool),
        e[:1], 256,
    )
    assert bool(np.asarray(inf_out)[0])


def test_ec_point_add():
    """Jacobian addition vs host affine arithmetic, incl. P+P, P+(-P),
    inf+P and P+inf."""
    from vmn_tpu.arith.ec import ECqPGroup

    grp = ECqPGroup.named("P-256")
    ctx = grp.ctx
    p, a = grp.p, grp.a
    G = (grp.gx, grp.gy)
    P2 = _host_ec_add(p, a, G, G)
    P3 = _host_ec_add(p, a, P2, G)
    negG = (G[0], p - G[1])
    cases = [
        (G, P2),      # general
        (G, G),       # double
        (G, negG),    # inverse -> inf
        (None, P3),   # inf + P
        (P3, None),   # P + inf
        (None, None),  # inf + inf
        (P2, P3),
        (P3, P3),
    ]
    want = [_host_ec_add(p, a, u, v) for u, v in cases]

    def enc(col):
        xs = ctx.encode([0 if q is None else q[0] for q in col])
        ys = ctx.encode([0 if q is None else q[1] for q in col])
        z = jnp.stack([
            jnp.zeros((ctx.L,), jnp.uint32) if q is None
            else jnp.asarray(ctx.one_mont) for q in col
        ])
        return xs, ys, z

    x1, y1, z1 = enc([c[0] for c in cases])
    x2, y2, z2 = enc([c[1] for c in cases])
    X, Y, Z = grp.curve.point_add(x1, y1, z1, x2, y2, z2)
    _check_points(ctx, *grp.curve.normalize(X, Y, Z), want)


def test_ec_multiexp():
    """Multi-exponentiation sum_i k_i P_i vs host arithmetic, over batch
    sizes exercising odd tree levels and a zero/max scalar."""
    from vmn_tpu.arith.ec import ECArray, ECqPGroup
    from vmn_tpu.arith.pgroup import FArray

    grp = ECqPGroup.named("P-256")
    ctx = grp.ctx
    p, a = grp.p, grp.a
    G = (grp.gx, grp.gy)
    rng = np.random.default_rng(17)
    for N, nbits in [(5, 64), (7, 32)]:
        pts = [_host_ec_mul(p, a, G, i + 2) for i in range(N)]
        ks = [int.from_bytes(rng.bytes((nbits + 7) // 8), "big")
              % (1 << nbits) for _ in range(N)]
        ks[0] = 0
        ks[-1] = (1 << nbits) - 1
        want = None
        for pt, k in zip(pts, ks):
            want = _host_ec_add(p, a, want, _host_ec_mul(p, a, pt, k))
        arr = ECArray(grp, ctx.encode([pt[0] for pt in pts]),
                      ctx.encode([pt[1] for pt in pts]),
                      jnp.zeros((N,), bool))
        e = FArray(grp.ring, jnp.asarray(np.stack([
            int_to_limbs(k, grp.ring.L) for k in ks
        ])))
        assert arr.exp_prod(e, nbits).to_affine() == [want], (N, nbits)


def test_ec_fixed_base():
    """A shared base point raised to a batch of scalars (the g.exp path)
    vs host arithmetic, incl. scalar 0 -> infinity."""
    from vmn_tpu.arith.ec import ECqPGroup

    grp = ECqPGroup.named("P-256")
    p, a = grp.p, grp.a
    G = (grp.gx, grp.gy)
    scalars = [0, 1, 2, (1 << 64) - 1, 12345, (1 << 63) + 99, 7]
    want = [_host_ec_mul(p, a, G, k) for k in scalars]
    e = grp.ring.from_ints(scalars)
    assert grp.g.exp_bits(e, 64).to_affine() == want
