"""Warm, step-level profile of PoS commit internals (2 iterations;
read the second — the first pays compiles/caches).

Usage: python tools/profile_commit.py [N]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16384

    from vmn_tpu.arith.pgroup import ModPGroup, Permutation
    from vmn_tpu.crypto.hash import SHA256
    from vmn_tpu.crypto.prg import PRGHeuristic
    from vmn_tpu.crypto.randomsource import SeededSource
    from vmn_tpu.protocol import elgamal
    from vmn_tpu.protocol.hvzk.pos_tw import (
        PoSParams, PoSProver, _batch_vector, _plain_ring,
    )

    group = ModPGroup.named("modp2048")
    ring = group.ring
    rs = SeededSource(b"steps")
    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(b"steps-msgs"))

    kp = elgamal.keygen(group, rs)
    x_sk, pk = kp.sk, kp.pk
    m = group.random_array(n, prg, 128)
    r = ring.random((n,), rs, 0)
    w = elgamal.encrypt(pk, m, r)
    pk_elem = pk.as_ciph_elem()
    par = PoSParams(128, 256, 128, prg)

    t0 = [time.perf_counter()]

    def mark(name, obj=None):
        if obj is not None:
            jax.block_until_ready(obj)
        t = time.perf_counter()
        print(f"  {name:30s} {t - t0[0]:7.2f}s", flush=True)
        t0[0] = time.perf_counter()

    for it in range(2):
        print(f"--- iteration {it}", flush=True)
        s = ring.random((n,), rs, 128)
        rf = elgamal.reencryption_factors(pk, s)
        perm = Permutation.random(n, rs)
        wp = w.mul(rf).permute(perm.inv())
        h = group.random_array(n, prg, 128)
        mark("setup (reenc+perm+h)", wp.project(0).limbs)

        prover = PoSProver(par, rs)
        prover.precompute(group.g, h, perm)
        mark("precompute u,Ap", prover.u.limbs)
        prover.set_instance(pk_elem, w, wp, s)

        # --- commit, inlined step by step ---
        e = _batch_vector(ring, n, par.ebitlen, par.prg, b"\x42" * 32)
        ipe = e.permute(perm.inv())
        mark("batch vector + permute", ipe.limbs)

        h0 = h.get(0)
        b = ring.random((n,), rs, par.rbitlen)
        mark("sample b", b.limbs)
        x, d = b.rec_lin(ipe)
        mark("recLin scan", x.limbs)
        y = ipe.prods()
        mark("prods scan", y.limbs)

        gx = prover.g.exp(x)
        mark("g^x fixed-base full", gx.limbs)
        h0y = h0.exp(y)
        mark("h0^y (h0 table + exp)", h0y.limbs)
        B = gx.mul(h0y)
        mark("B mul", B.limbs)

        beta = ring.random((n,), rs, par.rbitlen)
        xp = x.shift_push(ring.zeros(()))
        yp = y.shift_push(ring.ones(()))
        eb = beta.add(xp.mul(prover.epsilon))
        mark("beta+xp*eps (ring ops)", eb.limbs)
        Bp = prover.g.exp(eb).mul(h0.exp(yp.mul(prover.epsilon)))
        mark("Bp 2x fixed-base full", Bp.limbs)

        phi = _plain_ring(pk_elem).random((), rs, par.rbitlen)
        Fp = pk_elem.exp(phi.neg()).mul(
            wp.exp_prod(prover.epsilon, prover.eps_bits)
        )
        mark("Fp exp_prod(eps)", Fp.project(0).limbs)

        bts = B.to_bytetree().to_bytes() + Bp.to_bytetree().to_bytes()
        mark(f"fetch B,Bp ({len(bts)>>20}MB)")

        prover.e, prover.ipe, prover.b = e, ipe, b
        prover.B, prover.d = B, d
        prover.beta, prover.Bp = beta, Bp
        prover.gamma = ring.random((), rs, par.rbitlen)
        prover.Cp = prover.g.exp(prover.gamma)
        prover.delta = ring.random((), rs, par.rbitlen)
        prover.Dp = prover.g.exp(prover.delta)
        prover.phi, prover.Fp = phi, Fp
        rep = prover.reply(12345678901234567890)
        mark("reply compute+fetch", None)
        _ = rep.to_bytes()
        mark("reply to_bytes")


if __name__ == "__main__":
    main()
