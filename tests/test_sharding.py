"""Sharded protocol-layer tests on the virtual 8-device CPU mesh.

Validates SURVEY §2.5's dominant scaling axis: the ciphertext batch N
sharded across devices via `jax.sharding` + GSPMD, with the protocol
producing BIT-IDENTICAL results to the single-device run — elementwise
ops shard trivially, reductions combine over the mesh, `permute`
becomes a cross-shard gather.
"""

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from vmn_tpu.arith.pgroup import ModPGroup, Permutation
from vmn_tpu.crypto.randomsource import SeededSource
from vmn_tpu.parallel.mesh import ciph_mesh, shard_array, shard_limbs
from vmn_tpu.protocol import elgamal
from vmn_tpu.protocol.com.board import LocalBoardHub
from vmn_tpu.protocol.context import ProtocolParams
from vmn_tpu.protocol.mixnet.party import MixNetParty
from vmn_tpu.protocol.mixnet.verifier import FiatShamirVerifier

N = 16


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return ciph_mesh(8)


def test_sharded_group_ops_match_single_device(mesh):
    group = ModPGroup.named("test256")
    rs = SeededSource(b"shard-ops")
    xs = group.ring.random((N,), rs, 64)
    g = group.g
    arr = g.exp(xs)

    sharded = shard_array(arr, mesh)
    assert sharded.limbs.sharding.spec == P("ciph", None)

    e = group.ring.random((N,), rs, 64)
    # elementwise exp and mul
    a1 = arr.exp(e)
    a2 = sharded.exp(shard_array(e, mesh))
    assert np.array_equal(np.asarray(a1.limbs), np.asarray(a2.limbs))

    m1 = arr.mul(arr)
    m2 = sharded.mul(sharded)
    assert np.array_equal(np.asarray(m1.limbs), np.asarray(m2.limbs))

    # reductions: prod and exp_prod combine across shards
    p1 = arr.prod()
    p2 = sharded.prod()
    assert np.array_equal(np.asarray(p1.limbs), np.asarray(p2.limbs))

    ep1 = arr.exp_prod(e, 128)
    ep2 = sharded.exp_prod(shard_array(e, mesh), 128)
    assert np.array_equal(np.asarray(ep1.limbs), np.asarray(ep2.limbs))

    # scans used by the proofs
    s1 = e.prods()
    s2 = shard_array(e, mesh).prods()
    assert np.array_equal(np.asarray(s1.limbs), np.asarray(s2.limbs))

    b = group.ring.random((N,), SeededSource(b"b"), 64)
    r1, last1 = b.rec_lin(e)
    r2, last2 = shard_array(b, mesh).rec_lin(shard_array(e, mesh))
    assert np.array_equal(np.asarray(r1.limbs), np.asarray(r2.limbs))

    # cross-shard permutation (all-to-all gather)
    pi = Permutation.random(N, SeededSource(b"pi"))
    pm1 = arr.permute(pi)
    pm2 = sharded.permute(pi)
    assert np.array_equal(np.asarray(pm1.limbs), np.asarray(pm2.limbs))


def test_sharded_core_ops(mesh, core_on_cpu, monkeypatch):
    """The core path is shard-capable: with the Montgomery core routed
    in (its host build stands in for the CUDA build on CPU), sharded
    inputs go through the shard_map-wrapped core calls in
    parallel/mesh.py and give bit-identical results to the
    single-device XLA run (reference analogue: VCR's transparent
    array-op thread parallelism, SURVEY.md §2.5)."""
    from vmn_tpu.arith import mont
    from vmn_tpu.parallel import mesh as pmesh

    group = ModPGroup.named("test256")
    rs = SeededSource(b"shard-pallas")
    xs = group.ring.random((N,), rs, 64)
    arr = group.g.exp(xs)
    e = group.ring.random((N,), rs, 64)
    b = group.ring.random((N,), SeededSource(b"b2"), 64)

    # Single-device references on the XLA path.
    monkeypatch.setattr(mont, "_use_core", lambda L: False)
    ref_exp = np.asarray(arr.exp(e).limbs)
    ref_mul = np.asarray(arr.mul(arr).limbs)
    ref_prod = np.asarray(arr.prod().limbs)
    ref_ep = np.asarray(arr.exp_prod(e, 128).limbs)
    ref_scan = np.asarray(e.prods().limbs)
    ref_rl = np.asarray(b.rec_lin(e)[0].limbs)
    ref_sum = np.asarray(e.sum().limbs)
    ref_fb = np.asarray(group.g.exp(e).limbs)
    ctx = group.ctx
    ref_pos = np.asarray(ctx.expprod_positions(arr.limbs, e.limbs, 64))
    monkeypatch.setattr(mont, "_use_core", core_on_cpu.supports)
    jax.clear_caches()

    sharded = shard_array(arr, mesh)
    e_sh = shard_array(e, mesh)
    b_sh = shard_array(b, mesh)

    # Every Montgomery op below must route through parallel/mesh.py.
    calls = set()
    names = ("sharded_mul", "sharded_exp", "sharded_prod",
             "sharded_exp_prod", "sharded_prods_scan", "sharded_rec_lin",
             "sharded_fb_exp", "sharded_exp_prod_positions")
    for name in names:
        def counted(*a, _fn=getattr(pmesh, name), _name=name):
            calls.add(_name)
            return _fn(*a)

        monkeypatch.setattr(pmesh, name, counted)

    assert np.array_equal(np.asarray(sharded.exp(e_sh).limbs), ref_exp)
    assert np.array_equal(np.asarray(sharded.mul(sharded).limbs), ref_mul)
    assert np.array_equal(np.asarray(sharded.prod().limbs), ref_prod)
    assert np.array_equal(
        np.asarray(sharded.exp_prod(e_sh, 128).limbs), ref_ep
    )
    assert np.array_equal(np.asarray(e_sh.prods().limbs), ref_scan)
    assert np.array_equal(
        np.asarray(b_sh.rec_lin(e_sh)[0].limbs), ref_rl
    )
    assert np.array_equal(np.asarray(e_sh.sum().limbs), ref_sum)
    # fixed-base route (shared host-known base, sharded e)
    assert np.array_equal(
        np.asarray(group.g.exp(e_sh).limbs), ref_fb
    )
    assert np.array_equal(
        np.asarray(ctx.expprod_positions(sharded.limbs, e_sh.limbs, 64)),
        ref_pos,
    )
    assert calls == set(names)


@pytest.mark.parametrize("sharded", [False, True], ids=["one", "mesh"])
def test_core_lone_row_operands(mesh, core_on_cpu, monkeypatch, sharded):
    """A lone (L,) operand — a shared factor or base — reaches the core as
    one stride-0 row, and is broadcast only for the per-shard calls;
    either way the result is bit-identical to XLA."""
    from vmn_tpu.arith import mont

    group = ModPGroup.named("test256")
    ctx = group.ctx
    rs = SeededSource(b"lone-row")
    x = group.g.exp(group.ring.random((N,), rs, 64)).limbs
    e = group.ring.random((N,), rs, 64).limbs
    row, erow = x[3], e[5]

    def run():
        return [ctx.mul(x, row), ctx.mul(row, x), ctx.mul(row, row),
                ctx.exp(row, erow, 64), ctx.exp(x, erow, 64),
                jax.jit(lambda b, y: ctx.exp(b, y, 64))(row, e)]

    monkeypatch.setattr(mont, "_use_core", lambda L: False)
    ref = [np.asarray(r) for r in run()]
    monkeypatch.setattr(mont, "_use_core", core_on_cpu.supports)
    jax.clear_caches()
    rows = []
    mul = core_on_cpu.mont_mul

    def counted(a, b, m):
        rows.append((a.shape[0], b.shape[0]))
        return mul(a, b, m)

    monkeypatch.setattr(core_on_cpu, "mont_mul", counted)
    if sharded:
        x, e = shard_limbs(x, mesh), shard_limbs(e, mesh)
    got = run()
    shard = N // mesh.size
    assert rows == ([(shard, shard)] * 2 if sharded
                    else [(N, 1), (1, N)]) + [(1, 1)]
    for r, g in zip(ref, got):
        assert r.shape == g.shape
        assert np.array_equal(r, np.asarray(g))


def test_gpu_width_without_core_warns(monkeypatch):
    """On the GPU a width the core has no build for runs XLA, with a
    warning that names the width; built widths take the core."""
    from vmn_tpu.arith import mont
    from vmn_tpu.ops import core

    monkeypatch.setattr(mont.jax, "default_backend", lambda: "gpu")
    mont._warn_no_core.cache_clear()
    assert mont._use_core(128) and core.supports(128)
    assert not core.supports(64)
    with pytest.warns(RuntimeWarning, match="1024-bit"):
        assert not mont._use_core(64)


def _mix_once(tmp_path, tag, ciphs):
    params = ProtocolParams(
        sid="ShardSID", k=1, threshold=1,
        pgroup=ModPGroup.named("test256"),
    )
    hub = LocalBoardHub(1)
    rs = SeededSource(b"shard-party")
    party = MixNetParty(params, hub.board(1), rs, str(tmp_path / tag))
    party.keygen()
    session = party.session("aux", 1)
    out = session.mix(ciphs)
    return params, party, out


def test_sharded_mix_bit_identical(tmp_path, mesh):
    """A full k=1 mix (shuffle + TW proof + decryption) over sharded
    inputs is bit-identical to the single-device run, and its
    transcript verifies."""
    group = ModPGroup.named("test256")
    # Build the public key once to encrypt the common input.
    params = ProtocolParams(
        sid="ShardSID", k=1, threshold=1, pgroup=group,
    )
    hub = LocalBoardHub(1)
    pk_party = MixNetParty(
        params, hub.board(1), SeededSource(b"shard-party"),
        str(tmp_path / "pk"),
    )
    pk = pk_party.keygen()

    enc_rs = SeededSource(b"ciphs")
    msgs = [group.encode_message(f"{i:08d}".encode()) for i in range(N)]
    m = group.from_ints(msgs)
    r = group.ring.random((N,), enc_rs, 0)
    ciphs = elgamal.encrypt(pk, m, r)

    _, _, out_plain = _mix_once(tmp_path, "single", ciphs)
    params2, _, out_shard = _mix_once(
        tmp_path, "sharded", shard_array(ciphs, mesh)
    )

    assert np.array_equal(
        np.asarray(out_plain.limbs), np.asarray(out_shard.limbs)
    )
    assert sorted(out_shard.to_ints()) == sorted(msgs)

    # Transcripts byte-identical.
    f1 = (tmp_path / "single" / "nizkp.aux" / "ShuffledCiphertexts.bt")
    f2 = (tmp_path / "sharded" / "nizkp.aux" / "ShuffledCiphertexts.bt")
    assert f1.read_bytes() == f2.read_bytes()

    res = FiatShamirVerifier(
        params2, tmp_path / "sharded" / "nizkp.aux"
    ).verify(expected_type="mixing")
    assert res.ok


def test_sharded_mix_core_bit_identical(tmp_path, mesh, core_on_cpu,
                                        monkeypatch):
    """The FULL k=1 mix over sharded inputs with the core path routed in
    (its host build on the CPU mesh) — what a multi-card GPU run
    executes — is bit-identical to the plain single-device XLA run."""
    from vmn_tpu.arith import mont
    from vmn_tpu.parallel import mesh as pmesh

    monkeypatch.setattr(mont, "_use_core", lambda L: False)
    group = ModPGroup.named("test256")
    params = ProtocolParams(
        sid="ShardSID", k=1, threshold=1, pgroup=group,
    )
    hub = LocalBoardHub(1)
    pk_party = MixNetParty(
        params, hub.board(1), SeededSource(b"shard-party"),
        str(tmp_path / "pk"),
    )
    pk = pk_party.keygen()
    enc_rs = SeededSource(b"ciphs")
    msgs = [group.encode_message(f"{i:08d}".encode()) for i in range(N)]
    m = group.from_ints(msgs)
    r = group.ring.random((N,), enc_rs, 0)
    ciphs = elgamal.encrypt(pk, m, r)

    _, _, out_plain = _mix_once(tmp_path, "single2", ciphs)

    monkeypatch.setattr(mont, "_use_core", core_on_cpu.supports)
    jax.clear_caches()
    routed = set()
    for name in ("sharded_mul", "sharded_exp", "sharded_fb_exp",
                 "sharded_exp_prod", "sharded_prod", "sharded_prods_scan",
                 "sharded_rec_lin"):
        def counted(*a, _fn=getattr(pmesh, name), _name=name):
            routed.add(_name)
            return _fn(*a)

        monkeypatch.setattr(pmesh, name, counted)
    _, _, out_shard = _mix_once(
        tmp_path, "sharded2", shard_array(ciphs, mesh)
    )
    assert "sharded_mul" in routed
    assert np.array_equal(
        np.asarray(out_plain.limbs), np.asarray(out_shard.limbs)
    )
    f1 = (tmp_path / "single2" / "nizkp.aux" / "ShuffledCiphertexts.bt")
    f2 = (tmp_path / "sharded2" / "nizkp.aux" / "ShuffledCiphertexts.bt")
    assert f1.read_bytes() == f2.read_bytes()
