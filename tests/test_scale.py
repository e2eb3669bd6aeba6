"""Four-digit-N end-to-end tests (reference: the check matrix runs
N in {100, 10000} and forced-maxciph configs, demo/mixnet/check:84,
.checkbaseconf:1-120).  Exercises the regimes tiny-N tests never
reach: batches spanning many kernel blocks, real disk-spill thresholds,
and keep-list shrink at scale.

Set VMN_SKIP_SLOW=1 to skip locally; CI runs them.
"""

import os

import pytest

from vmn_tpu.arith.pgroup import ModPGroup
from vmn_tpu.crypto.randomsource import SeededSource
from vmn_tpu.protocol import elgamal
from vmn_tpu.protocol.com.board import LocalBoardHub
from vmn_tpu.protocol.context import ProtocolParams
from vmn_tpu.protocol.mixnet.party import MixNetParty
from vmn_tpu.protocol.mixnet.verifier import FiatShamirVerifier

slow = pytest.mark.skipif(
    os.environ.get("VMN_SKIP_SLOW") == "1",
    reason="VMN_SKIP_SLOW=1",
)

N = 1024


def _encrypt(group, pk, n, tag=b"scale-encr"):
    from vmn_tpu.crypto.hash import SHA256
    from vmn_tpu.crypto.prg import PRGHeuristic

    # PRG-derived plaintexts: encode_message would cost n host pows
    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(tag))
    m = group.random_array(n, prg, 8)
    r = group.ring.random((n,), SeededSource(tag + b"-r"), 0)
    return m.to_ints(), elgamal.encrypt(pk, m, r)


@slow
def test_plain_mix_n1024_arrays_file(tmp_path):
    """k=1 mix + standalone verification at N=1024 with the file
    backend at its REAL spill threshold (tiny-N tests force
    MIN_SPILL_BYTES=0 and never hit the memmap paths at size)."""
    from vmn_tpu.arith import storage

    storage.set_backend("file", tmp_path / "arrays")
    try:
        group = ModPGroup.named("test256")
        params = ProtocolParams(
            sid="Scale", k=1, threshold=1, pgroup=group,
        )
        hub = LocalBoardHub(1)
        party = MixNetParty(
            params, hub.board(1), SeededSource(b"scale-party"),
            str(tmp_path / "P1"),
        )
        pk = party.keygen()
        msgs, ciphs = _encrypt(group, pk, N)
        out = party.session("scale", 1).mix(ciphs)
        assert sorted(out.to_ints()) == sorted(msgs)
        res = FiatShamirVerifier(
            params, tmp_path / "P1" / "nizkp.scale"
        ).verify(expected_type="mixing")
        assert res.ok
    finally:
        storage.set_backend("ram")


@slow
def test_precomp_shrink_n1024(tmp_path):
    """Precomputation for maxciph=1280 shrunk to N=1024 via the
    keep-list protocol — boundary behavior of shrink/spill at a size
    where tile-boundary off-by-ones would actually show
    (reference: forcedmaxciph config; PermutationCommitment.java:
    390-471)."""
    group = ModPGroup.named("test256")
    params = ProtocolParams(
        sid="ScaleP", k=1, threshold=1, pgroup=group,
    )
    hub = LocalBoardHub(1)
    party = MixNetParty(
        params, hub.board(1), SeededSource(b"scalep-party"),
        str(tmp_path / "P1"),
    )
    pk = party.keygen()
    session = party.session("scalep", 1)
    session.precomp(1280)
    msgs, ciphs = _encrypt(group, pk, N, tag=b"scalep")
    out = session.mix(ciphs)
    assert sorted(out.to_ints()) == sorted(msgs)
    nizkp = tmp_path / "P1" / "nizkp.scalep"
    assert (nizkp / "proofs" / "KeepList01.bt").exists()
    res = FiatShamirVerifier(params, nizkp).verify(
        expected_type="mixing"
    )
    assert res.ok


@pytest.mark.gpu
def test_core_parity_modp2048():
    """Every CUDA core entry point at modp2048 (L=128) on a batch that
    spans many blocks and ends in a partial one, bit-identical to Python
    `pow` and to the XLA path, incl. zero/one/m-1/maximal exponents and
    the full-size window-8 table (the check `chip_smoke.py` runs)."""
    from vmn_tpu.ops import parity

    parity.check_core(ModPGroup.named("modp2048"), (1 << 16) + 37,
                      log=lambda *_: None)
