"""`vmnd` — demo key and ciphertext generator.

Rebuild of the reference demo tool (reference:
ProtocolElGamalDemo.java:82-117 — `-pkey` makes a demo key pair,
`-ciphs` encrypts counter plaintexts for any interface).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vmnd", description=__doc__)
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("-pkey", action="store_true",
                      help="generate a demo public key")
    mode.add_argument("-ciphs", metavar="PUBLICKEY",
                      help="encrypt demo plaintexts under PUBLICKEY")
    p.add_argument("out")
    p.add_argument("-N", type=int, default=10, help="number of ciphertexts")
    p.add_argument("-width", type=int, default=1)
    p.add_argument("-pgroup", default="named:modp2048")
    p.add_argument("-i", default="raw", help="interface name")
    p.add_argument("-seed", default="demo", help="deterministic seed")
    args = p.parse_args(argv)

    from vmn_tpu.arith.pgroup import ModPGroup
    from vmn_tpu.crypto.randomsource import SeededSource
    from vmn_tpu.eio.marshal import unmarshal_hex
    from vmn_tpu.protocol import elgamal
    from vmn_tpu.protocol.interfaces import get_interface

    if args.pgroup.startswith("named:"):
        group = ModPGroup.named(args.pgroup[len("named:"):])
    else:
        group = unmarshal_hex(args.pgroup)
    iface = get_interface(args.i)
    rs = SeededSource(args.seed.encode())

    if args.pkey:
        kp = elgamal.keygen(group, rs)
        iface.write_public_key(kp.pk, args.out)
        print(f"wrote demo public key to {args.out}")
        return 0

    pk = iface.read_public_key(group, args.ciphs)
    wide = pk.widen(args.width)
    plain = elgamal.plain_group(group, args.width)
    n = args.N
    msgs = [f"{i:08d}".encode() for i in range(n)]
    if args.width == 1:
        m = group.from_ints(group.encode_messages(msgs))
    else:
        from vmn_tpu.arith.pgroup import PPArray

        m = PPArray(plain, tuple(
            group.from_ints(group.encode_messages(msgs))
            for _ in range(args.width)
        ))
    r = plain.ring.random((n,), rs, 0)
    ciphs = elgamal.encrypt(wide, m, r)
    iface.write_ciphertexts(ciphs, args.out)
    print(f"wrote {n} demo ciphertexts to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
