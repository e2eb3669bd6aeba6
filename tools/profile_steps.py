"""Step-level profile of the k=1 mix primitives (device vs host split).

Times each hot primitive with a sync point after it, so per-step cost
is visible: re-encryption, PoS precompute/commit/reply, serialization
fetches, decryption exp, exp_prod.

Usage: python tools/profile_steps.py [N]
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
    from vmn_tpu.protocol.hvzk.pos_tw import PoSParams, PoSProver

    group = ModPGroup.named("modp2048")
    ring = group.ring
    rs = SeededSource(b"steps")
    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(b"steps-msgs"))

    t0 = [time.perf_counter()]

    def mark(name, obj=None):
        if obj is not None:
            jax.block_until_ready(obj)
        t = time.perf_counter()
        print(f"  {name:28s} {t - t0[0]:7.2f}s", flush=True)
        t0[0] = time.perf_counter()

    # setup
    kp = elgamal.keygen(group, rs)
    x, pk = kp.sk, kp.pk
    m = group.random_array(n, prg, 128)
    r = ring.random((n,), rs, 0)
    w = elgamal.encrypt(pk, m, r)
    mark("setup: encrypt", w.project(0).limbs)

    # --- shuffle own-output -------------------------------------------
    s = ring.random((n,), rs, 128)
    mark("sample s (reenc exps)", s.limbs)
    rf = elgamal.reencryption_factors(pk, s)
    mark("reenc factors 2N fb-exp", rf.project(0).limbs)
    perm = Permutation.random(n, rs)
    wp = w.mul(rf).permute(perm.inv())
    mark("mul+permute", wp.project(0).limbs)
    bts = wp.to_bytetree().to_bytes()
    mark(f"fetch+encode out ({len(bts)>>20}MB)")

    # --- PoS ----------------------------------------------------------
    par = PoSParams(128, 256, 128, prg)
    h = group.random_array(n, prg, 128)
    mark("generators h", h.limbs)
    prover = PoSProver(par, rs)
    prover.precompute(group.g, h, perm)
    mark("PoS precompute (u, Ap)", prover.u.limbs)
    ub = prover.u.to_bytetree().to_bytes()
    mark(f"fetch+encode u ({len(ub)>>20}MB)")
    pk_elem = pk.as_ciph_elem()
    prover.set_instance(pk_elem, w, wp, s)
    com = prover.commit(b"\x42" * 32)
    mark("PoS commit (compute)", prover.B.limbs)
    cb = com.to_bytes()
    mark(f"fetch+encode commit ({len(cb)>>20}MB)")
    rep = prover.reply(12345678901234567890)
    rb = rep.to_bytes()
    mark(f"reply+fetch ({len(rb)>>20}MB)")

    # --- verifier-side heavy ops --------------------------------------
    e = ring.random_bits_prg(n, 256, prg)
    mark("batch vector e", e.limbs)
    A = prover.u.exp_prod(e, 256)
    mark("exp_prod u^e (256b)", A.limbs)
    F0 = w.project(0).exp_prod(e, 256)
    mark("exp_prod w^e (256b)", F0.limbs)

    # --- decryption ---------------------------------------------------
    u_comp = wp.project(0)
    f = u_comp.exp(x.neg())
    mark("decrypt exp u^-x (full)", f.limbs)
    fb = f.to_bytetree().to_bytes()
    mark(f"fetch+encode factors ({len(fb)>>20}MB)")
    pl = wp.project(1).mul(f)
    mark("plaintext mul", pl.limbs)

    print(f"n={n} done")


if __name__ == "__main__":
    main()
