"""Group/field/ring layer tests on the small 256-bit safe-prime group."""

import numpy as np
import pytest

from vmn_tpu.arith.pgroup import (
    FArray,
    ModPGroup,
    Permutation,
    PPGroup,
    PPRing,
)
from vmn_tpu.crypto.prg import PRGHeuristic
from vmn_tpu.crypto.hash import SHA256
from vmn_tpu.crypto.randomsource import SeededSource


@pytest.fixture(scope="module")
def grp():
    return ModPGroup.named("test256")


@pytest.fixture()
def rs():
    return SeededSource(b"pgroup-tests")


def test_generator_in_group(grp):
    assert pow(grp.g_int, grp.q, grp.p) == 1
    assert grp.g.is_in_group()


def test_field_ops(grp, rs):
    f = grp.ring
    a = f.random((8,), rs, 32)
    b = f.random((8,), rs, 32)
    ai, bi = a.to_ints(), b.to_ints()
    q = f.q
    assert a.add(b).to_ints() == [(x + y) % q for x, y in zip(ai, bi)]
    assert a.sub(b).to_ints() == [(x - y) % q for x, y in zip(ai, bi)]
    assert a.mul(b).to_ints() == [(x * y) % q for x, y in zip(ai, bi)]
    assert a.neg().to_ints() == [(-x) % q for x in ai]
    assert a.sum().to_int() == sum(ai) % q
    want_ip = sum(x * y for x, y in zip(ai, bi)) % q
    assert a.inner_product(b).to_int() == want_ip
    assert a.inv().to_ints() == [pow(x, -1, q) for x in ai]


def test_field_prods_and_reclin(grp, rs):
    f = grp.ring
    q = f.q
    b = f.random((7,), rs, 32)
    e = f.random((7,), rs, 32)
    bi, ei = b.to_ints(), e.to_ints()

    # prods: cumulative products of e
    got = e.prods().to_ints()
    want, acc = [], 1
    for x in ei:
        acc = acc * x % q
        want.append(acc)
    assert got == want

    # recLin: x_0 = b_0; x_i = x_{i-1} e_i + b_i
    x, d = b.rec_lin(e)
    want_x = [bi[0]]
    for i in range(1, 7):
        want_x.append((want_x[-1] * ei[i] + bi[i]) % q)
    assert x.to_ints() == want_x
    assert d.to_int() == want_x[-1]


def test_group_ops(grp, rs):
    p, q = grp.p, grp.q
    prg = PRGHeuristic(SHA256)
    prg.set_seed(b"\x01" * 32)
    h = grp.random_array(6, prg, 20)
    assert h.is_in_group()
    hi = h.to_ints()
    assert len(set(hi)) == 6

    e = grp.ring.random((6,), rs, 32)
    ei = e.to_ints()
    assert h.exp(e).to_ints() == [pow(x, y, p) for x, y in zip(hi, ei)]

    want = 1
    for x, y in zip(hi, ei):
        want = want * pow(x, y, p) % p
    assert h.exp_prod(e).to_ints() == [want]

    prodv = 1
    for x in hi:
        prodv = prodv * x % p
    assert h.prod().to_ints() == [prodv]

    assert h.mul(h).to_ints() == [x * x % p for x in hi]
    assert h.inv().to_ints() == [pow(x, -1, p) for x in hi]
    assert h.div(h).to_ints() == [1] * 6


def test_permute_roundtrip(grp, rs):
    prg = PRGHeuristic(SHA256)
    prg.set_seed(b"\x02" * 32)
    h = grp.random_array(10, prg, 20)
    pi = Permutation.random(10, rs)
    hp = h.permute(pi)
    # out[i] = in[pi[i]]
    assert hp.to_ints() == [h.to_ints()[pi.tbl[i]] for i in range(10)]
    assert hp.permute(pi.inv()).equals(h)
    assert np.array_equal(pi.inv().inv().tbl, pi.tbl)


def test_shift_push(grp, rs):
    prg = PRGHeuristic(SHA256)
    prg.set_seed(b"\x03" * 32)
    h = grp.random_array(5, prg, 20)
    s = h.shift_push(grp.g)
    assert s.to_ints() == [grp.g_int % grp.p] + h.to_ints()[:-1]


def test_elem_bytetree_roundtrip(grp):
    prg = PRGHeuristic(SHA256)
    prg.set_seed(b"\x04" * 32)
    h = grp.random_array(4, prg, 20)
    bt = h.to_bytetree()
    assert len(bt.children) == 4
    assert all(len(c.data) == grp.bytelen for c in bt.children)
    back = grp.elem_from_bytetree(bt, 4)
    assert back.equals(h)
    # scalar
    g2 = grp.elem_from_bytetree(grp.g.to_bytetree())
    assert g2.equals(grp.g)


def test_group_bytetree_roundtrip(grp):
    bt = grp.to_bytetree()
    back = ModPGroup.from_bytetree(bt)
    assert back.p == grp.p and back.q == grp.q and back.g_int == grp.g_int


def test_product_group(grp, rs):
    pp = PPGroup(grp, 3)
    prg = PRGHeuristic(SHA256)
    prg.set_seed(b"\x05" * 32)
    x = pp.random_array(4, prg, 20)
    e_shared = grp.ring.random((4,), rs, 32)
    y = x.exp(e_shared)
    for c in range(3):
        assert y.project(c).equals(x.project(c).exp(e_shared))
    # componentwise exponent
    e_pp = pp.ring.random((4,), rs, 32)
    z = x.exp(e_pp)
    for c in range(3):
        assert z.project(c).equals(x.project(c).exp(e_pp.project(c)))
    # byte-tree round-trip
    bt = x.to_bytetree()
    back = pp.elem_from_bytetree(bt, 4)
    assert back.equals(x)


def test_message_encoding(grp):
    for msg in (b"", b"hello world", b"x" * (grp.nbits // 8 - 4)):
        m = grp.encode_message(msg)
        assert pow(m, grp.q, grp.p) == 1
        assert grp.decode_message(m) == msg


def test_native_jacobi_membership_matches_euler():
    """The native batch Jacobi (host, parse-time membership for
    safe-prime groups) agrees with the Euler criterion x^q mod p,
    including non-members, zero padding columns, and rejects are
    surfaced as ByteTreeError on parse (reference: VCR ModPGroup
    element verification via GMP mpz_jacobi, SURVEY.md §2.3)."""
    import random

    import numpy as np
    import pytest as _pytest

    from vmn_tpu.arith.pgroup import ModPGroup
    from vmn_tpu.eio.bytetree import ByteTreeError
    from vmn_tpu.native.build import jacobi_batch

    group = ModPGroup.named("test256")
    p, q = group.p, group.q
    rnd = random.Random(11)
    vals = [rnd.randrange(1, p) for _ in range(64)]
    vals = [pow(v, 2, p) if i % 2 else v for i, v in enumerate(vals)]
    raw = np.stack([
        np.frombuffer(v.to_bytes(group.bytelen, "big"), np.uint8)
        for v in vals
    ])
    out = jacobi_batch(raw, group._p_bytes)
    if out is None:
        _pytest.skip("native toolchain unavailable")
    want = np.array(
        [1 if pow(v, q, p) == 1 else 0 for v in vals], np.uint8
    )
    assert np.array_equal(out, want)

    # parse path: an array with one non-member must be rejected
    members = [pow(v, 2, p) for v in vals]
    nr = 2
    while pow(nr, q, p) == 1:
        nr += 1
    bad = list(members)
    bad[17] = nr
    ok_arr = group.elem_from_bytetree(
        group.elem_to_bytetree(group.from_ints(members))
    )
    assert ok_arr.size == len(members)
    from vmn_tpu.eio.bytetree import array_leaf_node

    bad_bt = array_leaf_node(
        np.stack([
            np.frombuffer(v.to_bytes(group.bytelen, "big"), np.uint8)
            for v in bad
        ])
    )
    with _pytest.raises(ByteTreeError):
        group.elem_from_bytetree(bad_bt)


@pytest.mark.parametrize("route", ["xla", "core"])
def test_qr_check_device_accepts_members_rejects_nonmembers(route, request):
    """Randomized device QR test on either kernel route (the core through
    its host build): all-members pass; a single planted non-residue is
    caught (prob 1 - 2^-100)."""
    import numpy as np

    import jax.numpy as jnp

    from vmn_tpu.arith.pgroup import ModPGroup

    if route == "core":
        request.getfixturevalue("core_on_cpu")

    from vmn_tpu.arith.limbs import int_to_limbs

    grp = ModPGroup.named("test256")
    prg_vals = []
    x = 5
    for _ in range(80):
        x = x * x % grp.p  # squares: guaranteed members
        prg_vals.append(x)
    limbs = grp.ctx.to_mont(
        jnp.asarray(np.stack([int_to_limbs(v, grp.L) for v in prg_vals]))
    )
    assert grp._qr_check_device(limbs)() is True

    # plant one quadratic non-residue
    nr = 2
    while pow(nr, grp.q, grp.p) == 1:
        nr += 1
    bad = list(prg_vals)
    bad[37] = nr
    limbs_bad = grp.ctx.to_mont(
        jnp.asarray(np.stack([int_to_limbs(v, grp.L) for v in bad]))
    )
    assert grp._qr_check_device(limbs_bad)() is False
