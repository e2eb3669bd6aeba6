"""Terelius–Wikström proof of a shuffle — the mathematical heart.

Batched device rebuild of the reference's PoSBasicTW + PoSTW
(reference: PoSBasicTW.java:66 — commitment/reply machinery;
PoSTW.java:94-272 — Fiat–Shamir plumbing and transcript layout).

Statement: for public (g, h, u, pk, w, w') the prover knows (pi, r, s)
with u_i = g^{r_{pi(i)}} h_{pi(i)} and w'_i = w_{pi^{-1}(i)} Enc_pk(1,
s_{pi^{-1}(i)}).

All array math is a handful of fused batched device ops per phase:
  prover commit:  recLin scan + prods scan + 4 batched fixed-base exps +
                  2 multi-exps;
  verifier:       2 multi-exps (A, F — computable concurrently with the
                  prover, reference PoSTW.java:219-223) + 3 batched exps.

Permutation convention: `x.permute(pi)` yields out[i] = x[pi[i]] — with
u = (g^r h).permute(pi) and ipe = e.permute(pi.inv()), matching the
reference's equations (see PoSBasicTW.java:444,553).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from vmn_tpu.arith.pgroup import FArray, GArray, Permutation
from vmn_tpu.eio.bytetree import ByteTree, ByteTreeError, leaf, node


@dataclass
class PoSParams:
    """Security parameters (reference: PoSBasicTW ctor)."""

    vbitlen: int  # challenge bits
    ebitlen: int  # batching-vector component bits
    rbitlen: int  # statistical distance
    prg: object  # PRG instance for batching-vector expansion


class PoSProver:
    """Prover state machine: precompute -> commit(seed) -> reply(v)."""

    def __init__(self, params: PoSParams, randomsource):
        self.par = params
        self.rs = randomsource

    # -------------------------------------------------- precompute

    def precompute(self, g: GArray, h: GArray, pi: Permutation):
        """Permutation commitment u and the A'-blinder
        (reference: PoSBasicTW.java:436-482)."""
        self.g = g
        self.h = h
        self.pi = pi
        self.size = h.size
        grp = g.grp
        ring = grp.ring

        # u_i = g^{r_{pi(i)}} h_{pi(i)}
        self.r = ring.random((self.size,), self.rs, self.par.rbitlen)
        self.u = h.mul(g.exp(self.r)).permute(pi)

        self.alpha = ring.random((), self.rs, self.par.rbitlen)
        ebl = self.par.ebitlen + self.par.vbitlen + self.par.rbitlen
        # epsilon: random (ebitlen+vbitlen+rbitlen)-bit integers as field
        # elements (reference: PoSBasicTW.java:470-474).  Its bit bound
        # (ebl, or the field size when reduction kicked in) is passed to
        # every multi-exp — at 2048-bit groups ebl is ~3.3x smaller than
        # the field, directly cutting the exponentiation work.
        self.eps_bits = min(ebl, ring.nbits)
        self.epsilon = _random_bits_field(
            ring, self.size, ebl, self.rs
        )
        self.Ap = g.exp(self.alpha).mul(
            h.exp_prod(self.epsilon, self.eps_bits)
        )
        # drain the device queue between phases at huge N (see
        # mont.backpressure: enqueue-time allocation OOMs at 2^20)
        from vmn_tpu.arith.mont import backpressure

        backpressure(self.u)

    # ------------------------------------------------------ instance

    def set_instance(self, pkey, w, wp, s):
        """pkey: wide public key as ciphertext-group element ((g..),(y..));
        w, wp: ciphertext arrays; s: re-encryption exponents (plain-ring
        array, unpermuted order)."""
        self.pkey = pkey
        self.w = w
        self.wp = wp
        self.s = s

    # -------------------------------------------------------- commit

    def commit(self, prg_seed: bytes) -> ByteTree:
        """Bridging commitments and blinders
        (reference: PoSBasicTW.commit :546-700)."""
        par = self.par
        grp = self.g.grp
        ring = grp.ring
        n = self.size

        self.e = _batch_vector(ring, n, par.ebitlen, par.prg, prg_seed)
        self.ipe = self.e.permute(self.pi.inv())

        h0 = self.h.get(0)

        # b random; x = recLin(b, ipe); y = prods(ipe)
        from vmn_tpu.arith.mont import backpressure

        self.b = ring.random((n,), self.rs, par.rbitlen)
        x, self.d = self.b.rec_lin(self.ipe)
        backpressure(x)
        y = self.ipe.prods()
        backpressure(y)

        # B_i = g^{x_i} h0^{y_i}
        # h0 stays scalar-shaped: ctx.exp broadcasts a 1-D base and
        # routes it to the fixed-base kernel (an explicit broadcast(n)
        # hid the shared base and forced variable-base windowed exps —
        # ~5x the products).
        self.B = self.g.exp(x).mul(h0.exp(y))
        from vmn_tpu.arith.mont import backpressure

        backpressure(self.B)

        # blinders: B'_i = g^{beta_i + xp_i eps_i} h0^{yp_i eps_i}
        self.beta = ring.random((n,), self.rs, par.rbitlen)
        xp = x.shift_push(ring.zeros(()))
        yp = y.shift_push(ring.ones(()))
        del x, y  # only the shifted copies are live from here
        self.Bp = self.g.exp(self.beta.add(xp.mul(self.epsilon))).mul(
            h0.exp(yp.mul(self.epsilon))
        )
        backpressure(self.Bp)
        del xp, yp

        self.gamma = ring.random((), self.rs, par.rbitlen)
        self.Cp = self.g.exp(self.gamma)
        self.delta = ring.random((), self.rs, par.rbitlen)
        self.Dp = self.g.exp(self.delta)

        # F' = pk^{-phi} prod wp_i^{eps_i}   (phi in the plain ring)
        self.phi = _plain_ring(self.pkey).random((), self.rs, par.rbitlen)
        self.Fp = self.pkey.exp(self.phi.neg()).mul(
            self.wp.exp_prod(self.epsilon, self.eps_bits)
        )
        backpressure(self.B)

        return node(
            self.B.to_bytetree(),
            self.Ap.to_bytetree(),
            self.Bp.to_bytetree(),
            self.Cp.to_bytetree(),
            self.Dp.to_bytetree(),
            self.Fp.to_bytetree(),
        )

    # --------------------------------------------------------- reply

    def reply(self, v_int: int) -> ByteTree:
        """k_X = x*v + blinder (reference: PoSBasicTW.reply :856-888)."""
        ring = self.g.grp.ring
        v = ring.from_int(v_int)

        a = self.r.inner_product(self.ipe)
        c = self.r.sum()
        f = self.s.inner_product(self.e)

        k_A = a.mul_add(v, self.alpha)
        k_B = self.b.mul_add(v, self.beta)
        k_C = c.mul_add(v, self.gamma)
        k_D = self.d.mul_add(v, self.delta)
        k_E = self.ipe.mul_add(v, self.epsilon)
        k_F = f.mul_add(v, self.phi)

        return node(
            k_A.to_bytetree(),
            k_B.to_bytetree(),
            k_C.to_bytetree(),
            k_D.to_bytetree(),
            k_E.to_bytetree(),
            k_F.to_bytetree(),
        )


class PoSVerifier:
    """Verifier: precompute -> set_instance -> set u -> batch -> verify
    (reference: PoSBasicTW verifier methods + PoSTW.verify)."""

    def __init__(self, params: PoSParams):
        self.par = params

    def precompute(self, g: GArray, h: GArray):
        self.g = g
        self.h = h
        self.size = h.size

    def set_instance(self, pkey, w, wp):
        self.pkey = pkey
        self.w = w
        self.wp = wp

    def set_permutation_commitment(self, bt: Optional[ByteTree]) -> GArray:
        """Parse u; malformed -> trivial identity commitment u = h
        (reference: PoSBasicTW.setPermutationCommitment :505-514)."""
        grp = self.g.grp
        try:
            if bt is None:
                raise ByteTreeError("missing")
            self.u = grp.elem_from_bytetree(bt, self.size)
        except (ByteTreeError, ValueError):
            self.u = self.h.copy_of_range(0, self.size)
        return self.u

    def set_batch_vector(self, prg_seed: bytes):
        ring = self.g.grp.ring
        self.e = _batch_vector(
            ring, self.size, self.par.ebitlen, self.par.prg, prg_seed
        )

    def compute_AF(self):
        """A = prod u^e, F = prod w^e — can overlap with the prover's
        commit phase (reference: PoSBasicTW.computeAF :407-410)."""
        self.A = self.u.exp_prod(self.e, self.par.ebitlen)
        self.F = self.w.exp_prod(self.e, self.par.ebitlen)

    def set_commitment(self, bt: Optional[ByteTree]) -> ByteTree:
        """Parse (B, Ap, Bp, Cp, Dp, Fp); malformed -> all-ones
        (reference: PoSBasicTW.setCommitment :780-823)."""
        grp = self.g.grp
        ciph = _ciph_group_of(self.pkey)
        n = self.size
        try:
            if bt is None or bt.is_leaf or len(bt.children) != 6:
                raise ByteTreeError("malformed commitment")
            self.B = grp.elem_from_bytetree(bt[0], n)
            self.Ap = grp.elem_from_bytetree(bt[1])
            self.Bp = grp.elem_from_bytetree(bt[2], n)
            self.Cp = grp.elem_from_bytetree(bt[3])
            self.Dp = grp.elem_from_bytetree(bt[4])
            self.Fp = ciph.elem_from_bytetree(bt[5])
        except (ByteTreeError, ValueError):
            self.B = grp.one((n,))
            self.Ap = grp.one()
            self.Bp = grp.one((n,))
            self.Cp = grp.one()
            self.Dp = grp.one()
            self.Fp = ciph.one()
        return node(
            self.B.to_bytetree(),
            self.Ap.to_bytetree(),
            self.Bp.to_bytetree(),
            self.Cp.to_bytetree(),
            self.Dp.to_bytetree(),
            self.Fp.to_bytetree(),
        )

    def verify(self, reply_bt: ByteTree, v_int: int) -> bool:
        """The five verification equations
        (reference: PoSBasicTW.verify :1000-1066)."""
        grp = self.g.grp
        ring = grp.ring
        n = self.size
        try:
            if reply_bt.is_leaf or len(reply_bt.children) != 6:
                raise ByteTreeError("malformed reply")
            k_A = ring.from_bytetree(reply_bt[0])
            k_B = ring.from_bytetree(reply_bt[1], n)
            k_C = ring.from_bytetree(reply_bt[2])
            k_D = ring.from_bytetree(reply_bt[3])
            k_E = ring.from_bytetree(reply_bt[4], n)
            k_F = _plain_ring(self.pkey).from_bytetree(reply_bt[5])
        except (ByteTreeError, ValueError):
            return False

        v = ring.from_int(v_int)
        h0 = self.h.get(0)
        self.k_A, self.k_B, self.k_C = k_A, k_B, k_C
        self.k_D, self.k_E, self.k_F = k_D, k_E, k_F

        # ALL equations — C, D, and the A/B/F random linear combination
        # — are checked as ONE product that must equal the array
        # multi-exp R, with verifier-LOCAL 100-bit weights rho
        # (soundness 2^-100, the protocol's statistical parameter; the
        # reference checks five separate equations with the same array
        # ops, PoSBasicTW.java:1000-1066 — the random combination is
        # the batched equivalent, see docs/DEVIATIONS.md).
        #
        #   C:   C^v Cp       == g^{k_C}
        #   D:   D^v Dp       == g^{k_D}
        #   A:   A^v Ap       == g^{k_A} prod_i h_i^{k_E_i}
        #   B_i: B_i^v Bp_i   == g^{k_B_i} Bshift_i^{k_E_i}  (i < n)
        #   F_c: F_c^v Fp_c   == S_c prod_i wp_c,i^{k_E_i},  S = pk^{-k_F}
        #
        # The B rows fold with per-row weights alpha_i; every k_E-power
        # collapses into ONE full-size array multi-exp over the merged
        # base M_i = h_i · Bshift_i^{rho_B alpha_i} · prod_c
        # wp_c,i^{rho_c}, and every remaining SINGLE-element power —
        # the former per-equation dispatches, each latency-bound on a
        # remote device — collapses into ONE batched multi-exp over a
        # ~dozen stacked bases:
        #
        #   prod_j base_j^{e_j} · Ap == R = prod_i M_i^{k_E_i}
        #
        # with C = u_prod/h_prod and D = B_{n-1}/h0^{e_prod} expanded
        # into their factors so no single-element inversion or
        # exponentiation ever dispatches alone.
        rs = _local_rs()
        alpha = ring.random_bits(n, _BATCH_CHECK_BITS, rs)
        rho_bits = min(2 * _BATCH_CHECK_BITS, ring.nbits)

        def rho():
            return ring.random_bits(1, _BATCH_CHECK_BITS, rs).get(0)

        bshift = self.B.shift_push(h0)
        rho_B, rho_C, rho_D = rho(), rho(), rho()
        wp_flat = _flat_garrays(self.wp)
        F_flat = _flat_garrays(self.F)
        Fp_flat = _flat_garrays(self.Fp)
        pk_flat = _flat_garrays(self.pkey)
        kf_flat = _flat_farrays(k_F)
        kf_flat = kf_flat * (len(pk_flat) // len(kf_flat))
        rho_F = [rho() for _ in wp_flat]

        merged = self.h.mul(bshift.exp_bits(alpha.mul(rho_B), rho_bits))
        for rc, wpc in zip(rho_F, wp_flat):
            merged = merged.mul(wpc.exp_bits(rc, _BATCH_CHECK_BITS))
        R = merged.exp_prod(k_E)

        u_prod = self.u.prod()
        h_prod = self.h.prod()
        Bn1 = self.B.get(n - 1)
        e_prod = self.e.prod()
        P1 = self.B.exp_prod(alpha, _BATCH_CHECK_BITS)
        P2 = self.Bp.exp_prod(alpha, _BATCH_CHECK_BITS)
        # retained for test-vector output (reference: vmnv -t names
        # PoS.C/PoS.D; ...FiatShamirSession.java:925-932); the limbs
        # are only ever fetched when test vectors are requested.
        self.C = u_prod.div(h_prod)
        self.D = Bn1.div(h0.exp(e_prod))

        v_rho_C = v.mul(rho_C)
        v_rho_D = v.mul(rho_D)
        e_g = (
            k_A.add(k_B.inner_product(alpha).mul(rho_B))
            .add(k_C.mul(rho_C)).add(k_D.mul(rho_D)).neg()
        )
        bases = [u_prod, h_prod, self.Cp, Bn1, h0, self.Dp,
                 self.A, P1, P2, self.g]
        exps = [v_rho_C, v_rho_C.neg(), rho_C,
                v_rho_D, e_prod.mul(v_rho_D).neg(), rho_D,
                v, v.mul(rho_B), rho_B, e_g]
        for rc, Fc, Fpc, pkc, kfc in zip(
            rho_F, F_flat, Fp_flat, pk_flat, kf_flat
        ):
            bases.extend([Fc, Fpc, pkc])
            exps.extend([v.mul(rc), rc, kfc.mul(rc)])
        lhs = _stack_elems(grp, bases).exp_prod(
            _stack_farrays(ring, exps)
        ).mul(self.Ap)

        return _all_checks([_eq_device(lhs, R)])


# ---------------------------------------------------------------- helpers


_BATCH_CHECK_BITS = 100  # statistical soundness of batched equation checks


def _flat_garrays(x):
    """Flatten a (possibly nested) product-group array into its base
    group components — every leaf lives in the same base group, so the
    merged batch equation can combine them directly."""
    if hasattr(x, "components"):
        out = []
        for c in x.components:
            out.extend(_flat_garrays(c))
        return out
    return [x]


def _flat_farrays(x):
    """Flatten a (possibly nested) product-ring element into base-ring
    components, mirroring `_flat_garrays` ordering."""
    if hasattr(x, "components"):
        out = []
        for c in x.components:
            out.extend(_flat_farrays(c))
        return out
    return [x]


def _stack_elems(grp, elems):
    """Stack single base-group elements into one group array — the
    scalar sides of all verification equations ride ONE multi-exp
    dispatch instead of a latency-bound dispatch per power."""
    import jax.numpy as jnp

    first = elems[0]
    if hasattr(first, "inf"):  # EC points
        from vmn_tpu.arith.ec import ECArray

        return ECArray(
            grp,
            jnp.stack([e.x for e in elems]),
            jnp.stack([e.y for e in elems]),
            jnp.stack([jnp.asarray(e.inf) for e in elems]),
        )
    from vmn_tpu.arith.pgroup import GArray

    return GArray(grp, jnp.stack([e.limbs for e in elems]))


def _stack_farrays(ring, elems):
    """Stack single ring elements into one (M, L) exponent array."""
    import jax.numpy as jnp

    from vmn_tpu.arith.pgroup import FArray

    return FArray(ring, jnp.stack([e.limbs for e in elems]))


def _flat_pairs(el, ex):
    """Flatten a (possibly product) group element together with its
    (possibly product) ring exponent into aligned base-group pairs,
    mirroring the product-exp zip-or-map semantics (PPArray.exp)."""
    if hasattr(el, "components"):
        if el._ring_matches(ex):
            sub = ex.components
        else:
            sub = [ex] * len(el.components)
        out = []
        for e2, x2 in zip(el.components, sub):
            out.extend(_flat_pairs(e2, x2))
        return out
    return [(el, ex)]


def _batched_one_check(field, equations):
    """equations: list of [(elem, exponent), ...] rows, each asserting
    prod_j elem_j^{exp_j} == 1 (elements may be product-group, with
    product-ring or scalar exponents).  Every row gets a verifier-local
    100-bit weight and the whole system collapses into ONE stacked
    multi-exp dispatch compared against the identity — soundness
    2^-100 per row, the same statistical argument as the PoS batching
    (docs/DEVIATIONS.md)."""
    rs = _local_rs()
    bases, exps = [], []
    for row in equations:
        w = field.random_bits(1, _BATCH_CHECK_BITS, rs).get(0)
        for el, ex in row:
            for b, x in _flat_pairs(el, ex):
                bases.append(b)
                exps.append(x.mul(w))
    grp = bases[0].grp
    lhs = _stack_elems(grp, bases).exp_prod(_stack_farrays(field, exps))
    return _eq_device(lhs, grp.one())


def _local_rs():
    """Verifier-local randomness for batched equation checks (never
    protocol-visible; distinct from any seeded session source)."""
    from vmn_tpu.crypto.randomsource import RandomDevice

    return RandomDevice()


def _eq_device(a, b):
    """Element equality as a LAZY device scalar (list of jnp bools) —
    no host sync; combine with _all_checks."""
    import jax.numpy as jnp

    if hasattr(a, "components"):
        out = []
        for ca, cb in zip(a.components, b.components):
            out.extend(_eq_device(ca, cb))
        return out
    if hasattr(a, "inf"):  # EC arrays
        return [
            jnp.array_equal(a.x, b.x),
            jnp.array_equal(a.y, b.y),
            jnp.array_equal(a.inf, b.inf),
        ]
    return [jnp.array_equal(a.limbs, b.limbs)]


def _all_checks(checks) -> bool:
    """AND of nested _eq_device results with ONE device fetch."""
    import jax.numpy as jnp

    flat = []
    for c in checks:
        flat.extend(c if isinstance(c, list) else [c])
    return bool(jnp.all(jnp.stack(flat)))


def _random_bits_field(ring, n, bits, randomsource):
    """n uniform `bits`-bit integers as field elements (mod q),
    vectorized (bulk source bytes -> device reduction)."""
    return ring.random_bits(n, bits, randomsource)


def _batch_vector(ring, n, ebitlen, prg, seed: bytes):
    """Batching vector e from a PRG seed
    (reference: PoSBasicTW.setBatchVector :533-538)."""
    prg.set_seed(seed)
    return ring.random_bits_prg(n, ebitlen, prg)


def _plain_ring(pkey):
    """The ring of the plaintext group: pkey = ((g..),(y..)) in
    PPGroup(plain, 2); its first component's group ring
    (reference: PoSBasicTW.java:687 pkey.project(0).getPGroup().getPRing())."""
    return pkey.project(0).grp.ring


def _ciph_group_of(pkey):
    """The group that Fp lives in = pkey's own (ciphertext) group."""
    return pkey.grp


def pos_seed_data(g, h, u, pkey, w, wp) -> ByteTree:
    """Challenge data for the batching seed
    (reference: PoSTW.java:118-124)."""
    return node(
        g.to_bytetree(),
        h.to_bytetree(),
        u.to_bytetree(),
        pkey.to_bytetree(),
        w.to_bytetree(),
        wp.to_bytetree(),
    )


def pos_challenge_data(prg_seed: bytes, commitment_bt: ByteTree) -> ByteTree:
    """Challenge data for v (reference: PoSTW.java:146-147)."""
    return node(leaf(prg_seed), commitment_bt)
