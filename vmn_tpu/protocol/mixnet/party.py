"""A mix-server: key generation, shuffling, decryption, proof export.

Rebuild of the reference's MixNetElGamal / MixNetElGamalSession /
ShufflerElGamalSession / DistrElGamalSession call chain
(reference: SURVEY.md §3.2) against the bulletin-board abstraction.
Each party runs this code; the test/demo harness runs k instances over
an in-memory board (threads), the distributed runtime over signed HTTP.

The heavy work — re-encryption, permutation, proof commitments,
multi-exponentiations — happens in batched device ops through the
arith layer; this module is orchestration + transcript I/O.

Proof-directory layout (reference: MixNetElGamalSession.java:381-446,
PoSTW.java:281-307, DistrElGamalSession.java:540-601):

    nizkp/
      version auxsid type width
      FullPublicKey.bt
      Ciphertexts.bt ShuffledCiphertexts.bt Plaintexts.bt
      proofs/
        activethreshold
        PolynomialInExponent.bt
        Ciphertexts{l:02d}.bt            (intermediate shuffle outputs)
        PermutationCommitment{l:02d}.bt
        PoSCommitment{l:02d}.bt  PoSReply{l:02d}.bt
        DecryptionFactors{l:02d}.bt
        DecrFactCommitment{l:02d}.bt  DecrFactReply{l:02d}.bt
        CorrectIndices.bt
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

from vmn_tpu import VCR_COMPAT_VERSION
from vmn_tpu.arith.pgroup import FArray, GArray, Permutation, PPArray, PPGroup
from vmn_tpu.eio.bytetree import (
    ByteTree, ByteTreeError, int_leaf, lazy_from_bytes, leaf, node,
)
from vmn_tpu.protocol import elgamal
from vmn_tpu.protocol.com.board import BulletinBoard
from vmn_tpu.protocol.context import ProtocolContext, ProtocolParams
from vmn_tpu.protocol.distr import dkg as dkg_mod
from vmn_tpu.protocol.state import StateDir
from vmn_tpu.protocol.hvzk.pos_tw import (
    PoSParams,
    PoSProver,
    PoSVerifier,
    pos_challenge_data,
    pos_seed_data,
)
from vmn_tpu.protocol.hvzk.posc_tw import (
    PoSCProver,
    PoSCVerifier,
    posc_challenge_data,
    posc_seed_data,
)
from vmn_tpu.protocol.hvzk.ccpos_w import (
    CCPoSProver,
    CCPoSVerifier,
    ccpos_challenge_data,
    ccpos_seed_data,
)


class ProtocolError(Exception):
    pass


def _write(path: Path, data) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(data, str):
        path.write_text(data)
    else:
        path.write_bytes(data)


class MixNetParty:
    """One mix-server (reference: MixNetElGamal.java:46)."""

    def __init__(
        self,
        params: ProtocolParams,
        board: BulletinBoard,
        randomsource,
        directory: Optional[str] = None,
        cipher=None,
        log=None,
    ):
        from vmn_tpu.protocol.log import Log

        self.log = log if log is not None else Log.silent()
        self.par = params
        self.ctx = ProtocolContext(params)
        self.board = board
        self.j = board.j
        self.k = board.k
        self.rs = randomsource
        self.directory = Path(directory) if directory else None
        self.state = (
            StateDir(self.directory / "state")
            if self.directory is not None
            else None
        )
        self.cipher = cipher
        self.plainkeys = None
        self.dkg: Optional[dkg_mod.DKGResult] = None
        self.external_pk: Optional["elgamal.ElGamalPublicKey"] = None
        self.active = [True] * (self.k + 1)  # 1-based; [0] unused

    # ------------------------------------------------------------- setup

    def setup(self) -> None:
        """Establish the point-to-point CCA2 keys (PlainKeys) used to
        protect VSS shares, once per protocol instance (reference:
        ProtocolElGamal.setup:807-832 runs PlainKeys ->
        IndependentGenerator -> CoinFlipPRingSource -> challenger)."""
        if self.cipher is None and self.k > 1:
            self.log.info("Exchange plain (CCA2) keys.")
            from vmn_tpu.protocol.distr.plainkeys import run_plainkeys

            self.plainkeys = run_plainkeys(self.ctx, self.board, self.rs)
            self.cipher = self.plainkeys.cipher(self.rs)

    # ------------------------------------------------------------ keygen

    def keygen(self) -> "elgamal.ElGamalPublicKey":
        """Run DKG; returns the full public key (g, y).  Idempotent: the
        result is cached on disk as byte trees and reloaded on restart
        (reference: MixNetElGamal.generatePublicKey:195-209; the
        KeyAndPoly disk cache DKG.java:147-175)."""
        if self.state is not None and self.load_keys(required=False):
            self.log.info("Read cached key state.")
            return self.full_public_key()
        self.setup()
        self.log.info("Generate public key (distributed key generation).")
        self.dkg = dkg_mod.run_dkg(self.ctx, self.board, self.rs, self.cipher)
        if self.state is not None:
            self.state.write_bytetree(
                "KeyAndPoly.bt",
                node(
                    self.dkg.secret_share.to_bytetree(),
                    self.dkg.poly_bytetree(),
                    int_leaf(self.dkg.k),
                ),
            )
            self.state.write_bytetree(
                "FullPublicKey.bt", self.full_public_key().to_bytetree()
            )
        return self.full_public_key()

    def load_keys(self, required: bool = True) -> bool:
        """Reload persisted key state (DKG result or external key) from
        the working directory (reference: DKG.java:147-175 cache path).
        Returns True when key state was found."""
        if self.state is not None:
            bt = self.state.read_bytetree("KeyAndPoly.bt")
            if bt is not None:
                group = self.ctx.key_group()
                self.dkg = dkg_mod.DKGResult(
                    group,
                    group.ring.from_bytetree(bt[0]),
                    group.elem_from_bytetree(bt[1], validate=False),
                    bt[2].to_u32(),
                )
                return True
            ext = self.state.read_bytetree("ExternalPublicKey.bt")
            if ext is not None:
                self.external_pk = elgamal.ElGamalPublicKey.from_bytetree(
                    self.ctx.key_group(), ext
                )
                return True
        if required:
            raise ProtocolError(
                "no key state; run keygen or set a public key first"
            )
        return False

    def set_public_key(self, pk: "elgamal.ElGamalPublicKey") -> None:
        """External-key mode: shuffle against a key generated elsewhere
        — no secret shares, so only shuffle sessions are allowed
        (reference: MixNetElGamal.setPublicKey:227-242)."""
        self.external_pk = pk
        self.dkg = None
        if self.state is not None:
            self.state.write_bytetree(
                "ExternalPublicKey.bt", pk.to_bytetree()
            )

    def full_public_key(self) -> "elgamal.ElGamalPublicKey":
        if self.external_pk is not None:
            return self.external_pk
        g = self.ctx.key_group().g
        return elgamal.ElGamalPublicKey(g, self.dkg.joint_public_key)

    # ------------------------------------------------------ active set

    def set_active(self, active: List[bool]) -> None:
        """Reference: MixNetElGamalTool -sact (SURVEY.md §2.5 elasticity)."""
        self.active = list(active)

    def active_threshold(self) -> int:
        """Smallest index L such that parties 1..L include `threshold`
        active ones (reference: ProtocolBBT.getActiveThreshold)."""
        t = 0
        for l in range(1, self.k + 1):
            if self.active[l]:
                t += 1
                if t == self.par.threshold:
                    return l
        raise ProtocolError("fewer than threshold active parties")

    # ----------------------------------------------------------- session

    def session(self, auxsid: str, width: int) -> "MixSession":
        nizkp = None
        if self.directory is not None:
            nizkp = self.directory / f"nizkp.{auxsid}"
        return MixSession(self, auxsid, width, nizkp)


class _OptimisticOutput:
    """Own-turn output computed concurrently with verification of the
    previous party's proof (reference: optimistic pipelining,
    ShufflerElGamalSession.committedShuffleVerifyOptim:839-859, joined
    at :937-944).  The worker computes re-encrypt+permute AND the
    byte-tree serialization (the host-side cost), overlapping them with
    the verifier's multi-exps; the result is discarded when the
    verification rejects (the chain input changes to the passthrough).
    """

    def __init__(self, inp, compute):
        import threading

        self.based_on = inp
        self.out = None
        self.out_bytes = None
        self.error = None

        def work():
            try:
                out = compute(inp)
                self.out = out
                self.out_bytes = out.to_bytetree().to_bytes()
            except Exception as e:  # noqa: BLE001 - surfaced on join
                self.error = e

        self.thread = threading.Thread(target=work, daemon=True)
        self.thread.start()

    def join(self, inp):
        """Result if it was computed from `inp`, else None."""
        self.thread.join()
        if self.error is not None:
            raise self.error
        if self.based_on is inp:
            return self.out, self.out_bytes
        return None, None


def _next_active(party, l, active_threshold):
    """Next active party index after l in the chain, or 0."""
    for m in range(l + 1, active_threshold + 1):
        if party.active[m]:
            return m
    return 0


class _PrecompState:
    """Precomputed per-session state (reference: the cached arrays of
    ShufflerElGamalSession + PermutationCommitment)."""

    def __init__(self, maxciph, generators, raised_generators, raised_exp,
                 active_threshold):
        self.maxciph = maxciph
        self.generators = generators
        self.raised_generators = raised_generators
        self.raised_exp = raised_exp
        self.active_threshold = active_threshold
        self.commitments = {}  # l -> GArray (permuted commitments)
        self.raised_commitments = {}  # l -> GArray (others only)
        self.exponents = None  # own commitment exponents r
        self.permutation = None  # own permutation
        self.reenc_exponents = None
        self.reenc_factors = None
        self.shrunk_n = None

    def __contains__(self, l):
        return l in self.commitments


class MixSession:
    """One mixing session (reference: MixNetElGamalSession.java:48)."""

    def __init__(self, party: MixNetParty, auxsid: str, width: int,
                 nizkp: Optional[Path]):
        self.party = party
        self.auxsid = auxsid
        self.width = width
        self.ctx = party.ctx.session(auxsid)
        self.board = party.board.scope(f"session.{auxsid}")
        self.state = (
            party.state.sub(f"session.{auxsid}")
            if party.state is not None
            else None
        )
        # Session randomness is drawn from a dedicated source seeded by
        # a PERSISTED secret: a crashed party restarted with any random
        # source regenerates identical contributions (re-encryption
        # exponents, permutation, prover blinders, coin dealings), so
        # its republished bytes match and the board's idempotent-put
        # turns replay into resume (reference: every generated secret
        # is cached on disk — PermutationCommitment.java:156-218,
        # ShufflerElGamalSession.java:548-663, DKG.java:147-175).
        if self.state is not None:
            from vmn_tpu.crypto.randomsource import SeededSource

            seed_file = self.state.file("session_seed")
            if seed_file.exists():
                seed = seed_file.read_bytes()
            else:
                seed = party.rs.read_bytes(32)
                self.state.path.mkdir(parents=True, exist_ok=True)
                seed_file.touch(mode=0o600)
                seed_file.write_bytes(seed)
            self.rs = SeededSource(seed)
        else:
            self.rs = party.rs
        if not party.par.noninteractive:
            # Interactive mode: challenges are jointly flipped coins
            # (reference: ChallengerI.java:53-60; selected by the
            # `corr` info field, ProtocolElGamal.java:825-831).
            from vmn_tpu.protocol.coinflip import (
                ChallengerI,
                CoinFlipPRingSource,
            )

            source = CoinFlipPRingSource(
                self.ctx, self.board.scope("coins"), self.rs,
                cipher=party.cipher,
            )
            # Pre-deal the coins an entire mix is expected to consume
            # (k PoS proofs + decryption, each one PRG seed + one
            # challenge): the first challenge triggers one batched
            # dealing burst, and every challenge costs a single open
            # round (reference: prepareCoins during idle time,
            # CoinFlipPRingSource.java:153-232).  Deferred to first
            # use so constructing a session stays network-free.
            q = self.ctx.pgroup.ring.q
            per = max(1, (q.bit_length() - party.par.rbitlen) // 8)
            seed_b = 32
            v_b = (party.par.vbitlen + 7) // 8
            per_proof = -(-seed_b // per) + -(-v_b // per)
            source.pre_target = (party.k + 1) * per_proof
            self.ctx.challenger = ChallengerI(source)
        self.nizkp = nizkp
        self._precomp: Optional[_PrecompState] = None
        self.proofs = nizkp / "proofs" if nizkp else None
        if nizkp is not None:
            _write(nizkp / "version", VCR_COMPAT_VERSION)
            _write(nizkp / "auxsid", auxsid)
            _write(nizkp / "width", str(width))

    # ----------------------------------------------------------- helpers

    @property
    def j(self) -> int:
        return self.party.j

    @property
    def k(self) -> int:
        return self.party.k

    def _pf(self, name: str, l: Optional[int] = None) -> Optional[Path]:
        if self.proofs is None:
            return None
        if l is None:
            return self.proofs / name
        return self.proofs / f"{name}{l:02d}.bt"

    def _export(self, path: Optional[Path], bt: ByteTree) -> None:
        if path is not None:
            _write(path, bt.to_bytes())

    def _wide_pk(self):
        """Wide public key as a ciphertext-group element."""
        pk = self.party.full_public_key().widen(self.width)
        return pk.as_ciph_elem()

    def _ciph_group(self) -> PPGroup:
        return self.ctx.ciph_group(self.width)

    # ------------------------------------------------------------ precomp

    def precomp(self, maxciph: int) -> None:
        """Offline phase: independent generators, permutation
        commitments with PoSC proofs, re-encryption factors — all for
        the maximum anticipated N (reference:
        ShufflerElGamalSession.precomp:534-664).

        Idempotent across processes: the full state is persisted as
        byte trees under the session state directory and reloaded when
        the `.precomp` marker is present (reference: disk caches
        ShufflerElGamalSession.java:548-663,
        PermutationCommitment.java:156-218)."""
        if self.state is not None and self.state.has_marker(".precomp"):
            self.party.log.info("Read cached pre-computation.")
            self._precomp = self._load_precomp()
            return
        party = self.party
        party.log.info(f"Perform pre-computation for {maxciph} ciphertexts.")
        ctx = self.ctx
        b = self.board.scope("precomp")

        generators = ctx.independent_generators("generators", maxciph)
        g = ctx.pgroup.g
        field = ctx.pgroup.ring

        active_threshold = party.active_threshold()
        if self.proofs is not None:
            _write(self.proofs / "activethreshold", str(active_threshold))
            _write(self.proofs / "maxciph", str(maxciph))

        # Raised values: verifier-local CCPoS speedup
        # (reference: raisedGenerators :475-510, RAISED_BITLENGTH=50).
        raised_exp = field.from_int(self.rs.random_int(50))
        raised_generators = generators.exp_bits(raised_exp, 64)

        pos_par = PoSParams(ctx.vbitlen, ctx.ebitlen, ctx.rbitlen, ctx.prg)

        # --- own permutation commitment (precompute) -------------------
        st = _PrecompState(maxciph, generators, raised_generators,
                           raised_exp, active_threshold)
        if self.j <= active_threshold and party.active[self.j]:
            st.exponents = field.random((maxciph,), self.rs, ctx.rbitlen)
            st.permutation = Permutation.random(maxciph, self.rs)
            identity_commitment = generators.mul(g.exp(st.exponents))
            st.commitments[self.j] = identity_commitment.permute(
                st.permutation
            )

        # --- generate: publish + PoSC prove/verify ---------------------
        for l in range(1, active_threshold + 1):
            if not party.active[l]:
                continue
            if l == self.j:
                u = st.commitments[self.j]
                u_bt = u.to_bytetree()
                b.publish(f"PermutationCommitment{l}", u_bt.to_bytes())
                self._export(self._pf("PermutationCommitment", l), u_bt)
                P = PoSCProver(pos_par, self.rs)
                P.set_instance(g, generators, u, st.exponents,
                               st.permutation)
                seed = ctx.challenger.challenge(
                    posc_seed_data(g, generators, u),
                    8 * ctx.prg.min_seed_bytes, ctx.rbitlen,
                )
                commitment = P.commit(seed)
                self._export(self._pf("PoSCCommitment", l), commitment)
                b.publish(f"PoSCCommitment{l}", commitment.to_bytes())
                v_bytes = ctx.challenger.challenge(
                    posc_challenge_data(seed, commitment),
                    ctx.vbitlen, ctx.rbitlen,
                )
                reply = P.reply(int.from_bytes(v_bytes, "big"))
                self._export(self._pf("PoSCReply", l), reply)
                b.publish(f"PoSCReply{l}", reply.to_bytes())
            else:
                u_bt = lazy_from_bytes(
                    b.wait_for(l, f"PermutationCommitment{l}")
                )
                V = PoSCVerifier(pos_par)
                try:
                    u = ctx.pgroup.elem_from_bytetree(u_bt, maxciph)
                except (ByteTreeError, ValueError):
                    u = generators.copy_of_range(0, maxciph)
                V.set_instance(g, generators, u)
                self._export(self._pf("PermutationCommitment", l),
                             u.to_bytetree())
                seed = ctx.challenger.challenge(
                    posc_seed_data(g, generators, u),
                    8 * ctx.prg.min_seed_bytes, ctx.rbitlen,
                )
                V.set_batch_vector(seed)
                com_bt = lazy_from_bytes(
                    b.wait_for(l, f"PoSCCommitment{l}")
                )
                commitment = V.set_commitment(com_bt)
                self._export(self._pf("PoSCCommitment", l), commitment)
                v_bytes = ctx.challenger.challenge(
                    posc_challenge_data(seed, commitment),
                    ctx.vbitlen, ctx.rbitlen,
                )
                reply_bt = lazy_from_bytes(
                    b.wait_for(l, f"PoSCReply{l}")
                )
                ok = V.verify(reply_bt, int.from_bytes(v_bytes, "big"))
                if ok:
                    self._export(self._pf("PoSCReply", l), reply_bt)
                    st.commitments[l] = u
                else:
                    # trivial identity commitment
                    # (reference: PermutationCommitment.java:343-349)
                    st.commitments[l] = generators.copy_of_range(0, maxciph)
                st.raised_commitments[l] = st.commitments[l].exp_bits(
                    raised_exp, 64
                )

        # --- re-encryption exponents/factors ---------------------------
        if self.j <= active_threshold and party.active[self.j]:
            plain_ring = _plain_ring_of(ctx, self.width)
            st.reenc_exponents = plain_ring.random(
                (maxciph,), self.rs, ctx.rbitlen
            )
            wide_pk = party.full_public_key().widen(self.width)
            st.reenc_factors = elgamal.reencryption_factors(
                wide_pk, st.reenc_exponents
            )

        # Out-of-core: spill the big resident arrays to disk memmaps in
        # arrays=file mode (reference: file-mapped arrays for N beyond
        # RAM, ProtocolElGamal.java:332-345; device equivalent SURVEY §2.5
        # "host-RAM/disk spill with streamed device transfers").
        from vmn_tpu.arith import storage

        if storage.backend() == "file":
            st.generators = st.generators.spill()
            st.raised_generators = st.raised_generators.spill()
            st.commitments = {
                l: c.spill() for l, c in st.commitments.items()
            }
            st.raised_commitments = {
                l: (c.spill() if c is not None else None)
                for l, c in st.raised_commitments.items()
            }
            if st.reenc_exponents is not None:
                st.reenc_exponents = st.reenc_exponents.spill()
                st.reenc_factors = st.reenc_factors.spill()
        self._save_precomp(st)
        self._precomp = st

    # ------------------------------------------------ precomp persistence

    def _save_precomp(self, st: "_PrecompState") -> None:
        """Persist every precomputed array as byte-tree files + the
        one-way `.precomp` marker, so `vmn -precomp` survives into a
        later `vmn -mix` process and a crash loses nothing (reference:
        ShufflerElGamalSession.java:548-663)."""
        sd = self.state
        if sd is None:
            return
        sd.write_int("maxciph", st.maxciph)
        sd.write_int("activethreshold", st.active_threshold)
        sd.write_bytetree("Generators.bt", st.generators.to_bytetree())
        sd.write_bytetree(
            "RaisedGenerators.bt", st.raised_generators.to_bytetree()
        )
        sd.write_bytetree("RaisedExponent.bt", st.raised_exp.to_bytetree())
        for l, c in st.commitments.items():
            sd.write_bytetree(
                f"PermutationCommitment{l:02d}.bt", c.to_bytetree()
            )
        for l, c in st.raised_commitments.items():
            if c is not None:
                sd.write_bytetree(
                    f"RaisedCommitment{l:02d}.bt", c.to_bytetree()
                )
        if st.exponents is not None:
            sd.write_bytetree("Exponents.bt", st.exponents.to_bytetree())
            sd.write_indices("Permutation.bt", st.permutation.tbl)
        if st.reenc_exponents is not None:
            sd.write_bytetree(
                "ReencExponents.bt", st.reenc_exponents.to_bytetree()
            )
            sd.write_bytetree(
                "ReencFactors.bt", st.reenc_factors.to_bytetree()
            )
        sd.write_marker(".precomp")

    def _load_precomp(self) -> "_PrecompState":
        """Rebuild `_PrecompState` from the session state directory
        (our own trusted cache: parsed without subgroup re-validation)."""
        sd = self.state
        ctx = self.ctx
        field = ctx.pgroup.ring
        maxciph = sd.read_int("maxciph")
        active_threshold = sd.read_int("activethreshold")
        gens = ctx.pgroup.elem_from_bytetree(
            sd.read_bytetree("Generators.bt"), maxciph, validate=False
        )
        raised = ctx.pgroup.elem_from_bytetree(
            sd.read_bytetree("RaisedGenerators.bt"), maxciph, validate=False
        )
        raised_exp = field.from_bytetree(sd.read_bytetree("RaisedExponent.bt"))
        st = _PrecompState(maxciph, gens, raised, raised_exp,
                           active_threshold)
        for l in range(1, active_threshold + 1):
            bt = sd.read_bytetree(f"PermutationCommitment{l:02d}.bt")
            if bt is not None:
                st.commitments[l] = ctx.pgroup.elem_from_bytetree(
                    bt, maxciph, validate=False
                )
            rbt = sd.read_bytetree(f"RaisedCommitment{l:02d}.bt")
            if rbt is not None:
                st.raised_commitments[l] = ctx.pgroup.elem_from_bytetree(
                    rbt, maxciph, validate=False
                )
        ebt = sd.read_bytetree("Exponents.bt")
        if ebt is not None:
            st.exponents = field.from_bytetree(ebt, maxciph)
            st.permutation = Permutation(sd.read_indices("Permutation.bt"))
        rbt = sd.read_bytetree("ReencExponents.bt")
        if rbt is not None:
            plain_ring = _plain_ring_of(ctx, self.width)
            st.reenc_exponents = plain_ring.from_bytetree(rbt, maxciph)
            st.reenc_factors = self._ciph_group().elem_from_bytetree(
                sd.read_bytetree("ReencFactors.bt"), maxciph, validate=False
            )
        return st

    def _shrink(self, n: int) -> "_PrecompState":
        """Shrink precomputed state to the actual number of ciphertexts
        via published keep lists (reference:
        ShufflerElGamalSession.shrink:673-712,
        PermutationCommitment.shrink:390-471)."""
        st = self._precomp
        party = self.party
        b = self.board.scope("shrink")
        if st.shrunk_n == n:
            return st
        import numpy as np

        sh = _PrecompState(
            n,
            st.generators.copy_of_range(0, n),
            st.raised_generators.copy_of_range(0, n),
            st.raised_exp,
            st.active_threshold,
        )
        sh.shrunk_n = n
        for l in range(1, st.active_threshold + 1):
            if not party.active[l]:
                continue
            if l == self.j:
                keep = st.permutation.tbl < n
                bt = _bool_array_bt(keep.tolist())
                b.publish(f"KeepList{l}", bt.to_bytes())
                self._export(self._pf("KeepList", l), bt)
                sh.exponents = st.exponents.copy_of_range(0, n)
                sh.permutation = st.permutation.shrink(n)
            else:
                raw = lazy_from_bytes(b.wait_for(l, f"KeepList{l}"))
                try:
                    keep = np.frombuffer(raw.data, np.uint8).astype(bool)
                    if keep.shape[0] != st.maxciph or keep.sum() != n:
                        raise ByteTreeError("bad keep list")
                except (ByteTreeError, ValueError):
                    keep = np.zeros(st.maxciph, bool)
                    keep[:n] = True
                self._export(self._pf("KeepList", l),
                             _bool_array_bt(keep.tolist()))
            idx = np.nonzero(keep)[0]
            sh.commitments[l] = st.commitments[l].take(idx)
            if l != self.j and st.raised_commitments[l] is not None:
                sh.raised_commitments[l] = st.raised_commitments[l].take(idx)
        if self.j <= st.active_threshold and party.active[self.j]:
            sh.reenc_exponents = st.reenc_exponents.copy_of_range(0, n)
            sh.reenc_factors = st.reenc_factors.copy_of_range(0, n)
        return sh

    def committed_shuffle(self, ciphertexts: PPArray,
                          write_type: bool = True) -> PPArray:
        """Online phase after precomputation: shrink + per-party CCPoS
        (reference: ShufflerElGamalSession.committedShuffle:972-1038)."""
        party = self.party
        party.log.info(
            f"Shuffle {ciphertexts.size} ciphertexts "
            "(commitment-consistent chain)."
        )
        ctx = self.ctx
        n = ciphertexts.size
        b = self.board.scope("ccshuffle")

        if self.nizkp is not None and write_type:
            _write(self.nizkp / "type", "shuffling")
        if self.nizkp is not None:
            _write(self.nizkp / "FullPublicKey.bt",
                   party.full_public_key().to_bytetree().to_bytes())
            _write(self.nizkp / "Ciphertexts.bt",
                   ciphertexts.to_bytetree().to_bytes())

        st = self._shrink(n)
        g = ctx.pgroup.g
        wide_pk_elem = self._wide_pk()
        pos_par = PoSParams(ctx.vbitlen, ctx.ebitlen, ctx.rbitlen, ctx.prg)
        active_threshold = st.active_threshold

        def _own_output(x):
            return x.mul(st.reenc_factors).permute(st.permutation.inv())

        inp = ciphertexts
        valid_proofs = 0
        optimistic: Optional[_OptimisticOutput] = None
        for l in range(1, active_threshold + 1):
            if not party.active[l]:
                continue
            if l == self.j:
                out = out_bytes = None
                if optimistic is not None:
                    out, out_bytes = optimistic.join(inp)
                    optimistic = None
                if out is None:
                    out = _own_output(inp)
                    out_bytes = out.to_bytetree().to_bytes()
                # re-encryption factors are dead once the output list
                # exists (the prover keeps only the exponents)
                reenc_factors = None
                b.publish(f"Ciphertext{l}", out_bytes)
                party.log.child().info(
                    "Re-encrypt, permute and prove (CCPoS)."
                )
                P = CCPoSProver(pos_par, self.rs)
                P.set_instance(
                    g, st.generators, st.commitments[l], wide_pk_elem,
                    inp, out, st.exponents, st.permutation,
                    st.reenc_exponents,
                )
                seed = ctx.challenger.challenge(
                    ccpos_seed_data(g, st.generators, st.commitments[l],
                                    wide_pk_elem, inp, out),
                    8 * ctx.prg.min_seed_bytes, ctx.rbitlen,
                )
                commitment = P.commit(seed)
                self._export(self._pf("CCPoSCommitment", l), commitment)
                b.publish(f"CCPoSCommitment{l}", commitment.to_bytes())
                v_bytes = ctx.challenger.challenge(
                    ccpos_challenge_data(seed, commitment),
                    ctx.vbitlen, ctx.rbitlen,
                )
                reply = P.reply(int.from_bytes(v_bytes, "big"))
                self._export(self._pf("CCPoSReply", l), reply)
                b.publish(f"CCPoSReply{l}", reply.to_bytes())
                valid_proofs += 1
            else:
                out_bt = lazy_from_bytes(b.wait_for(l, f"Ciphertext{l}"))
                try:
                    out = self._ciph_group().elem_from_bytetree(out_bt, n)
                except (ByteTreeError, ValueError):
                    out = inp.copy_of_range(0, n)
                # Optimistic: our own turn is next — compute our output
                # from l's claimed output while verifying l's proof.
                if (
                    _next_active(party, l, active_threshold) == self.j
                    and st.reenc_factors is not None
                ):
                    optimistic = _OptimisticOutput(out, _own_output)
                party.log.child().info(
                    f"Verify shuffle of party {l} (CCPoS)."
                )
                ok = self._verify_ccpos(
                    b, l, pos_par, g, st, wide_pk_elem, inp, out
                )
                if ok:
                    valid_proofs += 1
                else:
                    out = inp.copy_of_range(0, n)
            if self.nizkp is not None:
                if l == active_threshold:
                    _write(self.nizkp / "ShuffledCiphertexts.bt",
                           out.to_bytetree().to_bytes())
                else:
                    self._export(self._pf("Ciphertexts", l),
                                 out.to_bytetree())
            # Out-of-core: intermediate ciphertext lists spill to disk
            # memmaps in arrays=file mode (reference: file-mapped
            # arrays, ProtocolElGamal.java:332-345).
            from vmn_tpu.arith import storage as _storage

            if _storage.backend() == "file":
                out = out.spill()
            inp = out

        if valid_proofs < party.par.threshold:
            raise ProtocolError(f"too few valid proofs ({valid_proofs})")
        return inp

    def _verify_ccpos(self, b, l, pos_par, g, st, pkey, w, wp) -> bool:
        """CCPoS verification with the precomputed 50-bit raised values
        — the A-side multi-exps fold into the ciphertext side for ~1/3
        lower online cost (reference: CCPoS.java:75-96,
        ShufflerElGamalSession.java:875-959)."""
        ctx = self.ctx
        raisedu = st.raised_commitments.get(l)
        V = CCPoSVerifier(pos_par)
        V.set_instance(g, st.generators, st.commitments[l], pkey, w, wp)
        seed = ctx.challenger.challenge(
            ccpos_seed_data(g, st.generators, st.commitments[l], pkey, w,
                            wp),
            8 * ctx.prg.min_seed_bytes, ctx.rbitlen,
        )
        V.set_batch_vector(seed)
        V.compute_AB(raisedu)
        com_bt = lazy_from_bytes(b.wait_for(l, f"CCPoSCommitment{l}"))
        commitment = V.set_commitment(com_bt)
        self._export(self._pf("CCPoSCommitment", l), commitment)
        v_bytes = ctx.challenger.challenge(
            ccpos_challenge_data(seed, commitment), ctx.vbitlen, ctx.rbitlen
        )
        reply_bt = lazy_from_bytes(b.wait_for(l, f"CCPoSReply{l}"))
        verdict = V.verify(
            reply_bt, int.from_bytes(v_bytes, "big"),
            raisedh=st.raised_generators if raisedu is not None else None,
            raised_exponent=st.raised_exp if raisedu is not None else None,
        )
        if verdict:
            self._export(self._pf("CCPoSReply", l), reply_bt)
        return verdict

    # ----------------------------------------------------------- shuffle

    def shuffle(self, ciphertexts: PPArray, write_type: bool = True
                ) -> PPArray:
        """Online shuffle: commitment-consistent chain when
        precomputation was run, plain PoS chain otherwise
        (reference: MixNetElGamalSession.shuffle:208-246 dispatch;
        ShufflerElGamalSession.shuffle:362-433 +
        performShuffling:250-352).

        One-shot per session (marker `.shuffle`,
        reference: MixNetElGamalSession.java:212-215): a re-run after
        completion returns the recorded output (crash resume); precomp
        state persisted by an earlier process is picked up here."""
        if self.state is not None:
            if self.state.has_marker(".shuffle"):
                out = self._reload_ciphertexts("ShuffledCiphertexts.bt",
                                               ciphertexts.size)
                if out is not None:
                    return out
                raise ProtocolError(
                    "session already used for shuffling (vmn -delete to "
                    "reset)"
                )
            if self._precomp is None and self.state.has_marker(".precomp"):
                self._precomp = self._load_precomp()
        if self._precomp is not None:
            out = self.committed_shuffle(ciphertexts, write_type)
            if self.state is not None:
                self.state.write_marker(".shuffle")
            return out
        party = self.party
        party.log.info(f"Shuffle {ciphertexts.size} ciphertexts.")
        ctx = self.ctx
        n = ciphertexts.size
        width = self.width
        b = self.board.scope("shuffle")

        if self.nizkp is not None and write_type:
            _write(self.nizkp / "type", "shuffling")
        if self.nizkp is not None:
            _write(self.nizkp / "FullPublicKey.bt",
                   party.full_public_key().to_bytetree().to_bytes())
            _write(self.nizkp / "Ciphertexts.bt",
                   ciphertexts.to_bytetree().to_bytes())

        wide_pk_elem = self._wide_pk()
        plain_ring = _plain_ring_of(ctx, width)

        # Independent generators (reference: sid "generators").
        generators = ctx.independent_generators("generators", n)
        g = ctx.pgroup.g

        active_threshold = party.active_threshold()
        if self.proofs is not None:
            _write(self.proofs / "activethreshold", str(active_threshold))

        pos_par = PoSParams(ctx.vbitlen, ctx.ebitlen, ctx.rbitlen, ctx.prg)

        # Local precomputation (own permutation commitment).
        prover = None
        permutation = None
        reenc_exponents = None
        reenc_factors = None
        if self.j <= active_threshold and party.active[self.j]:
            reenc_exponents = plain_ring.random((n,), self.rs, ctx.rbitlen)
            wide_pk = party.full_public_key().widen(width)
            reenc_factors = elgamal.reencryption_factors(
                wide_pk, reenc_exponents
            )
            permutation = Permutation.random(n, self.rs)
            from vmn_tpu.arith.mont import backpressure

            backpressure(reenc_factors)
            prover = PoSProver(pos_par, self.rs)
            prover.precompute(g, generators, permutation)

        # Sequential chain over parties, with optimistic own-output
        # computation overlapping the previous verification
        # (reference: ShufflerElGamalSession.java:839-944).
        def _own_output(x):
            return x.mul(reenc_factors).permute(permutation.inv())

        inp = ciphertexts
        valid_proofs = 0
        optimistic: Optional[_OptimisticOutput] = None
        for l in range(1, active_threshold + 1):
            if not party.active[l]:
                continue
            if l == self.j:
                out = out_bytes = None
                if optimistic is not None:
                    out, out_bytes = optimistic.join(inp)
                    optimistic = None
                if out is None:
                    out = _own_output(inp)
                    out_bytes = out.to_bytetree().to_bytes()
                # re-encryption factors are dead once the output list
                # exists (the prover keeps only the exponents)
                reenc_factors = None
                b.publish(f"Ciphertext{l}", out_bytes)
                party.log.child().info(
                    "Re-encrypt, permute and prove shuffle (PoS)."
                )
                self._prove_pos(
                    b, l, prover, wide_pk_elem, inp, out, reenc_exponents
                )
                valid_proofs += 1
                # own turn done: the re-encryption arrays (1.5 GB at
                # N=2^20, 2048-bit) are dead — release them so the
                # remaining chain fits in HBM
                reenc_factors = None
                reenc_exponents = None
            else:
                out_bt = lazy_from_bytes(b.wait_for(l, f"Ciphertext{l}"))
                try:
                    out = self._ciph_group().elem_from_bytetree(out_bt, n)
                except (ByteTreeError, ValueError):
                    out = inp.copy_of_range(0, n)
                if (
                    _next_active(party, l, active_threshold) == self.j
                    and self.j <= active_threshold
                    and permutation is not None
                ):
                    optimistic = _OptimisticOutput(out, _own_output)
                party.log.child().info(
                    f"Verify shuffle of party {l} (PoS)."
                )
                ok = self._verify_pos(
                    b, l, pos_par, g, generators, wide_pk_elem, inp, out
                )
                if ok:
                    valid_proofs += 1
                else:
                    out = inp.copy_of_range(0, n)
            # Export this party's output list.
            if self.nizkp is not None:
                if l == active_threshold:
                    _write(self.nizkp / "ShuffledCiphertexts.bt",
                           out.to_bytetree().to_bytes())
                else:
                    self._export(self._pf("Ciphertexts", l),
                                 out.to_bytetree())
            # Out-of-core: intermediate ciphertext lists spill to disk
            # memmaps in arrays=file mode (reference: file-mapped
            # arrays, ProtocolElGamal.java:332-345).
            from vmn_tpu.arith import storage as _storage

            if _storage.backend() == "file":
                out = out.spill()
            inp = out

        if valid_proofs < self.party.par.threshold:
            raise ProtocolError(
                f"too few valid proofs ({valid_proofs})"
            )
        if self.state is not None:
            self.state.write_marker(".shuffle")
        return inp

    def _reload_ciphertexts(self, name: str, n: int):
        """Recorded transcript output for idempotent resume, or None."""
        if self.nizkp is None or not (self.nizkp / name).exists():
            return None
        bt = lazy_from_bytes((self.nizkp / name).read_bytes())
        return self._ciph_group().elem_from_bytetree(bt, n, validate=False)

    def _prove_pos(self, b, l, prover, pkey, w, wp, s):
        """Fiat–Shamir PoS prover side (reference: PoSTW.prove:94-165)."""
        ctx = self.ctx
        prover.set_instance(pkey, w, wp, s)
        u_bt = prover.u.to_bytetree()
        b.publish(f"PermutationCommitment{l}", u_bt.to_bytes())
        self._export(self._pf("PermutationCommitment", l), u_bt)

        seed = ctx.challenger.challenge(
            pos_seed_data(prover.g, prover.h, prover.u, pkey, w, wp),
            8 * ctx.prg.min_seed_bytes,
            ctx.rbitlen,
        )
        # u's device copy is dead after the seed hash (its bytes are
        # memoized above) — 0.5 GB back at N=2^20
        prover.u = None
        commitment = prover.commit(seed)
        self._export(self._pf("PoSCommitment", l), commitment)
        b.publish(f"PoSCommitment{l}", commitment.to_bytes())

        v_bytes = ctx.challenger.challenge(
            pos_challenge_data(seed, commitment), ctx.vbitlen, ctx.rbitlen
        )
        v = int.from_bytes(v_bytes, "big")
        reply = prover.reply(v)
        self._export(self._pf("PoSReply", l), reply)
        b.publish(f"PoSReply{l}", reply.to_bytes())

    def _verify_pos(self, b, l, pos_par, g, generators, pkey, w, wp) -> bool:
        """Fiat–Shamir PoS verifier side (reference: PoSTW.verify:176-272)."""
        ctx = self.ctx
        V = PoSVerifier(pos_par)
        V.precompute(g, generators)
        V.set_instance(pkey, w, wp)

        u_bt = lazy_from_bytes(b.wait_for(l, f"PermutationCommitment{l}"))
        V.set_permutation_commitment(u_bt)
        self._export(self._pf("PermutationCommitment", l), V.u.to_bytetree())

        seed = ctx.challenger.challenge(
            pos_seed_data(g, generators, V.u, pkey, w, wp),
            8 * ctx.prg.min_seed_bytes,
            ctx.rbitlen,
        )
        V.set_batch_vector(seed)
        V.compute_AF()

        com_bt = lazy_from_bytes(b.wait_for(l, f"PoSCommitment{l}"))
        commitment = V.set_commitment(com_bt)
        self._export(self._pf("PoSCommitment", l), commitment)

        v_bytes = ctx.challenger.challenge(
            pos_challenge_data(seed, commitment), ctx.vbitlen, ctx.rbitlen
        )
        v = int.from_bytes(v_bytes, "big")

        reply_bt = lazy_from_bytes(b.wait_for(l, f"PoSReply{l}"))
        verdict = V.verify(reply_bt, v)
        if verdict:
            self._export(self._pf("PoSReply", l), reply_bt)
        return verdict

    # ----------------------------------------------------------- decrypt

    def decrypt(self, ciphertexts: PPArray, write_type: bool = True):
        """Distributed verifiable decryption
        (reference: DistrElGamalSession.decrypt:344-540)."""
        party = self.party
        if party.external_pk is not None:
            raise ProtocolError(
                "decryption impossible with an externally set public key"
            )
        ctx = self.ctx
        k = self.k
        threshold = party.par.threshold
        b = self.board.scope("decrypt")
        n = ciphertexts.size

        if self.state is not None and self.state.has_marker(".decrypt"):
            out = self._reload_plaintexts(n)
            if out is not None:
                return out
            raise ProtocolError(
                "session already used for decryption (vmn -delete to reset)"
            )

        party.log.info(
            f"Perform distributed decryption of {n} ciphertexts."
        )
        # Exchange only with ACTIVE parties; a deactivated server's
        # factors default to all-ones and are excluded from the combine
        # via the correct-indices machinery (reference:
        # DistrElGamalSession.java:112-187 + ProtocolBBT active set;
        # round-1 waited on every party and deadlocked on -sact).
        is_active = [False] + [party.active[l] for l in range(1, k + 1)]
        if sum(is_active) < threshold:
            raise ProtocolError("fewer than threshold active parties")

        if self.nizkp is not None:
            if write_type:
                _write(self.nizkp / "type", "decryption")
                _write(self.nizkp / "Ciphertexts.bt",
                       ciphertexts.to_bytetree().to_bytes())
            _write(self.nizkp / "FullPublicKey.bt",
                   party.full_public_key().to_bytetree().to_bytes())
        poly_bt = party.dkg.poly_bytetree()
        self._export(self._pf("PolynomialInExponent.bt"), poly_bt)

        u = ciphertexts.project(0)
        v_comp = ciphertexts.project(1)
        field = ctx.pgroup.ring
        # The sigma protocol runs over the KEY group (reference:
        # DistrElGamalSessionBasic over keyPGroup): for keywidth > 1 the
        # generator, commitments and replies are product-group objects.
        key_group = ctx.key_group()
        key_ring = key_group.ring
        inv_factor = _inverse_factor(field, k)

        correct = list(is_active)

        # --- own factors: f_j = u^{-x_j * invFactor} -------------------
        x = party.dkg.secret_share
        exp_own = x.neg().mul(field.from_int(inv_factor))
        f_own = u.exp(exp_own)
        from vmn_tpu.arith.mont import backpressure

        backpressure(f_own)
        if is_active[self.j]:
            b.publish(f"DecryptionFactors{self.j}",
                      f_own.to_bytetree().to_bytes())

        # --- exchange factors (active parties only) --------------------
        factors = [None] * (k + 1)
        for l in range(1, k + 1):
            if not is_active[l]:
                factors[l] = _plain_group_of(ctx, self.width).one((n,))
            elif l == self.j:
                factors[l] = f_own
            else:
                bt = lazy_from_bytes(
                    b.wait_for(l, f"DecryptionFactors{l}")
                )
                try:
                    factors[l] = _plain_group_of(ctx, self.width
                                                 ).elem_from_bytetree(bt, n)
                except (ByteTreeError, ValueError):
                    factors[l] = _plain_group_of(ctx, self.width).one((n,))
                    correct[l] = False
            self._export(self._pf("DecryptionFactors", l),
                         factors[l].to_bytetree())

        # --- seed: node(node(g, ciphs), node(poly, node(factors...)))
        # (reference: DistrElGamalSession.java:430-456) -----------------
        g_basic = key_group.g
        seed_data = node(
            node(g_basic.to_bytetree(), ciphertexts.to_bytetree()),
            node(poly_bt,
                 node(*[factors[l].to_bytetree() for l in range(1, k + 1)])),
        )
        seed = ctx.challenger.challenge(
            seed_data, 8 * ctx.prg.min_seed_bytes, ctx.rbitlen
        )
        e = _batch_vector(field, n, ctx.ebitlen, ctx.prg, seed)

        # Batch input A = prod u^e  (componentwise for width > 1).
        A = u.exp_prod(e, ctx.ebitlen)

        # --- commitments: yp = g^r, Bp = A^r ---------------------------
        r = key_ring.random((), self.rs, ctx.rbitlen)
        yp_own = g_basic.exp(r)
        Bp_own = A.exp(r)
        com_own = node(yp_own.to_bytetree(), Bp_own.to_bytetree())
        if is_active[self.j]:
            b.publish(f"DecrCommitment{self.j}", com_own.to_bytes())

        yps = [None] * (k + 1)
        Bps = [None] * (k + 1)
        for l in range(1, k + 1):
            if not is_active[l]:
                yps[l] = key_group.one()
                Bps[l] = _plain_group_of(ctx, self.width).one()
                com_bt = node(yps[l].to_bytetree(), Bps[l].to_bytetree())
            elif l == self.j:
                yps[l], Bps[l] = yp_own, Bp_own
                com_bt = com_own
            else:
                com_bt = lazy_from_bytes(
                    b.wait_for(l, f"DecrCommitment{l}")
                )
                try:
                    yps[l] = key_group.elem_from_bytetree(com_bt[0])
                    Bps[l] = _plain_group_of(ctx, self.width
                                             ).elem_from_bytetree(com_bt[1])
                except (ByteTreeError, ValueError, IndexError):
                    yps[l] = key_group.one()
                    Bps[l] = _plain_group_of(ctx, self.width).one()
                    correct[l] = False
                    com_bt = node(yps[l].to_bytetree(), Bps[l].to_bytetree())
            self._export(self._pf("DecrFactCommitment", l), com_bt)

        # --- challenge -------------------------------------------------
        all_coms = node(*[
            node(yps[l].to_bytetree(), Bps[l].to_bytetree())
            for l in range(1, k + 1)
        ])
        v_bytes = ctx.challenger.challenge(
            node(leaf(seed), all_coms), ctx.vbitlen, ctx.rbitlen
        )
        v_int = int.from_bytes(v_bytes, "big")
        v_f = field.from_int(v_int)

        # --- replies: k_x = -x*invFactor*v + r -------------------------
        kx_own = exp_own.mul(v_f).add(r)
        if is_active[self.j]:
            b.publish(f"DecrReply{self.j}", kx_own.to_bytetree().to_bytes())
        kxs = [None] * (k + 1)
        for l in range(1, k + 1):
            if not is_active[l]:
                kxs[l] = key_ring.from_int(0)
            elif l == self.j:
                kxs[l] = kx_own
            else:
                bt = lazy_from_bytes(b.wait_for(l, f"DecrReply{l}"))
                try:
                    kxs[l] = key_ring.from_bytetree(bt)
                except (ByteTreeError, ValueError):
                    kxs[l] = key_ring.from_int(0)
                    correct[l] = False
            self._export(self._pf("DecrFactReply", l),
                         kxs[l].to_bytetree())

        # --- optimistic combined verification --------------------------
        # (reference: DistrElGamalSession.java:488-515)
        y_parties = [None] + [
            party.dkg.public_key_of(l) for l in range(1, k + 1)
        ]
        joint_y = party.dkg.joint_public_key
        combined_f = _combine_factors(factors, correct, k, threshold, field)
        ok = _verify_combined(
            field, g_basic, A, joint_y, combined_f, e, ctx.ebitlen,
            yps, Bps, kxs, correct, k, threshold, v_f,
        )
        if not ok:
            # fall back to per-party verification
            for l in range(1, k + 1):
                if correct[l] and l != self.j:
                    correct[l] = _verify_party(
                        field, g_basic, A, y_parties[l], factors[l], e,
                        ctx.ebitlen, yps[l], Bps[l], kxs[l],
                        inv_factor, v_f,
                    )
            combined_f = _combine_factors(
                factors, correct, k, threshold, field
            )

        # --- plaintexts ------------------------------------------------
        plaintexts = v_comp.mul(combined_f)
        if self.proofs is not None:
            _write(self.proofs / "CorrectIndices.bt",
                   _bool_array_bt(correct).to_bytes())
        if self.nizkp is not None:
            _write(self.nizkp / "Plaintexts.bt",
                   plaintexts.to_bytetree().to_bytes())
        if self.state is not None:
            self.state.write_marker(".decrypt")
        return plaintexts

    def _reload_plaintexts(self, n: int):
        """Recorded plaintexts for idempotent resume, or None."""
        if self.nizkp is None or not (self.nizkp / "Plaintexts.bt").exists():
            return None
        bt = lazy_from_bytes((self.nizkp / "Plaintexts.bt").read_bytes())
        return _plain_group_of(self.ctx, self.width).elem_from_bytetree(
            bt, n, validate=False
        )

    # --------------------------------------------------------------- mix

    def mix(self, ciphertexts: PPArray):
        """shuffle then decrypt (reference:
        MixNetElGamalSession.mix:345-352)."""
        if self.nizkp is not None:
            _write(self.nizkp / "type", "mixing")
            _write(self.nizkp / "Ciphertexts.bt",
                   ciphertexts.to_bytetree().to_bytes())
        shuffled = self.shuffle(ciphertexts, write_type=False)
        return self.decrypt(shuffled, write_type=False)


# --------------------------------------------------------------- helpers


def _plain_group_of(ctx, width):
    return ctx.plain_group(width)


def _plain_ring_of(ctx, width):
    grp = ctx.plain_group(width)
    return grp.ring


def _batch_vector(field, n, ebitlen, prg, seed):
    prg.set_seed(seed)
    return field.random_bits_prg(n, ebitlen, prg)


def _prod_factor(k: int) -> int:
    """Square of prod of maximal prime powers <= k
    (reference: DistrElGamalSessionBasic.prodFactor:318-344)."""
    res = 1
    p = 2
    while p <= k:
        pw = 1
        while pw * p <= k:
            pw *= p
        res *= pw
        p = _next_prime(p)
    return res * res


def _next_prime(p: int) -> int:
    n = p + 1
    while True:
        if all(n % d for d in range(2, int(n ** 0.5) + 1)):
            return n
        n += 1


def _inverse_factor(field, k: int) -> int:
    return pow(_prod_factor(k), -1, field.q)


def _lagrange_ints(field, correct, k, threshold):
    """Modified Lagrange coefficients (signed ints)
    (reference: DistrElGamalSessionBasic:358-452)."""
    pf = _prod_factor(k)
    q = field.q
    out = []
    idxs = [l for l in range(1, k + 1) if correct[l]][:threshold]
    if len(idxs) < threshold:
        raise ProtocolError("too few correct decryption factors")
    for i in idxs:
        res = pf % q
        for l in idxs:
            if l != i:
                res = res * l % q
                res = res * pow(l - i, -1, q) % q
        # smallest absolute value representative
        alt = res - q
        out.append(alt if abs(alt) < res else res)
    return idxs, out


def _exp_small(arr, lam: int, field):
    """arr^lam for a small SIGNED host-known integer lam — the whole
    point of the reference's modified Lagrange coefficients
    (DistrElGamalSessionBasic:358-452) is that they are small ints, so
    exponentiate with |lam|'s actual bit length instead of a full-size
    field exponent (lam=1 at k=1 cost a full 2048-bit N-array
    exponentiation, ~12 s at N=65536)."""
    if lam < 0:
        arr = arr.inv()
        lam = -lam
    if lam == 1:
        return arr
    return arr.exp_bits(field.from_int(lam), max(1, lam.bit_length()))


def _combine_factors(factors, correct, k, threshold, field):
    """prod_l f_l^{lambda_l} over the first `threshold` correct parties
    (reference: combineDecryptionFactors:465-503)."""
    idxs, lags = _lagrange_ints(field, correct, k, threshold)
    acc = None
    for i, lam in zip(idxs, lags):
        term = _exp_small(factors[i], lam, field)
        acc = term if acc is None else acc.mul(term)
    return acc


def _verify_combined(field, g, A, joint_y, combined_f, e, ebitlen,
                     yps, Bps, kxs, correct, k, threshold, v_f):
    """Combined sigma verification (reference: verifyCombined:693-700 +
    combine:642-678)."""
    idxs, lags = _lagrange_ints(field, correct, k, threshold)
    cyp = None
    cBp = None
    ckx = None
    for i, lam in zip(idxs, lags):
        typ = _exp_small(yps[i], lam, field)
        tBp = _exp_small(Bps[i], lam, field)
        cyp = typ if cyp is None else cyp.mul(typ)
        cBp = tBp if cBp is None else cBp.mul(tBp)
        term = kxs[i].mul(field.from_int(lam))
        ckx = term if ckx is None else ckx.add(term)
    combined_B = combined_f.exp_prod(e, ebitlen)
    from vmn_tpu.protocol.hvzk.pos_tw import (
        _all_checks, _batched_one_check,
    )

    # Both sigma equations collapse into ONE stacked multi-exp against
    # the identity (each former term was a latency-bound single-element
    # dispatch):
    #   y^{-v} cyp g^{-ckx}        == 1
    #   B^{v}  cBp A^{-ckx}        == 1
    one = field.from_int(1)
    return _all_checks([_batched_one_check(field, [
        [(joint_y, v_f.neg()), (cyp, one), (g, ckx.neg())],
        [(combined_B, v_f), (cBp, one), (A, ckx.neg())],
    ])])


def _verify_party(field, g, A, y_l, f_l, e, ebitlen, yp, Bp, kx,
                  inv_factor, v_f):
    """Per-party sigma verification (reference: verify:718-727)."""
    B_l = f_l.exp_prod(e, ebitlen)
    ivf = field.from_int(inv_factor)
    from vmn_tpu.protocol.hvzk.pos_tw import _all_checks, _eq_device

    return _all_checks([
        _eq_device(y_l.inv().exp(ivf.mul(v_f)).mul(yp), g.exp(kx)),
        _eq_device(B_l.exp(v_f).mul(Bp), A.exp(kx)),
    ])


def _bool_array_bt(correct) -> ByteTree:
    """boolean[] -> leaf of 0/1 bytes
    (reference: ByteTree.booleanArrayToByteTree)."""
    return leaf(bytes(1 if c else 0 for c in correct))
