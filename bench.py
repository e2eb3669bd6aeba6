"""Headline benchmark: ciphertexts mixed+proved per second, 2048-bit ModP.

Runs a complete k=1 mix — re-encryption shuffle + Terelius-Wikström
proof + verifiable decryption, full Fiat-Shamir transcript written to a
nizkp directory — on the real device, then verifies the transcript with
the standalone verifier (the north star is mix+prove+VERIFY), and
reports ONE JSON line with both timings and the device they ran on.
Exits non-zero, printing no result, when JAX finds no GPU.

Methodology mirrors the reference's benchmark harness, which times the
`vmn -mix` operation end to end (reference: demo/mixnet/bench:33-86 and
the postlude report, MixNetElGamalTool.java:130-207).

Env knobs: VMN_BENCH_N (default 65536), VMN_BENCH_GROUP (modp2048).
"""

import json
import os
import sys
import tempfile
import time



def main():
    n = int(os.environ.get("VMN_BENCH_N", "65536"))
    group_name = os.environ.get("VMN_BENCH_GROUP", "modp2048")

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench: no GPU (JAX found {devices[0].platform})",
              file=sys.stderr)
        return 1

    from vmn_tpu.parallel import dist

    dist.init_from_env()  # multi-host when VMN_DIST_* is set

    import numpy as np

    from vmn_tpu.arith.pgroup import ModPGroup
    from vmn_tpu.crypto.hash import SHA256
    from vmn_tpu.crypto.prg import PRGHeuristic
    from vmn_tpu.crypto.randomsource import DeviceSource, SeededSource
    from vmn_tpu.protocol import elgamal
    from vmn_tpu.protocol.com.board import LocalBoardHub
    from vmn_tpu.protocol.context import ProtocolParams
    from vmn_tpu.protocol.mixnet.party import MixNetParty

    group = ModPGroup.named(group_name)
    params = ProtocolParams(sid="Bench", k=1, threshold=1, pgroup=group)

    hub = LocalBoardHub(1)
    # Prover randomness expands on-device (DeviceSource): bulk
    # random exponent arrays cost no host->device upload.
    rs = DeviceSource(b"bench-party")
    with tempfile.TemporaryDirectory() as tmp:
        party = MixNetParty(params, hub.board(1), rs, tmp)
        pk = party.keygen()

        enc_rs = SeededSource(b"bench-ciphs")
        # Demo plaintexts: PRG-derived group elements (device-side batch;
        # string-encoded messages would cost one host-side 2048-bit pow
        # per element just to set up the bench).
        prg = PRGHeuristic(SHA256)
        prg.set_seed(SHA256.hash(b"bench-msgs"))
        m = group.random_array(n, prg, params.rbitlen)
        r = group.ring.random((n,), enc_rs, 0)
        ciphs = elgamal.encrypt(pk, m, r)
        msgs = m.to_ints()  # untimed reference for the correctness check
        # materialize inputs before timing
        np.asarray(ciphs.project(0).limbs)

        # Warmup pass: a full mix on identical shapes populates the JIT
        # caches, so the timed pass measures steady-state
        # throughput (compilation is a one-time cost in production; the
        # reference's JVM warm-up is likewise excluded from its bench,
        # demo/mixnet/bench:33-86).
        warm = party.session("benchwarm", 1)
        jax.block_until_ready(warm.mix(ciphs).limbs)

        session = party.session("bench", 1)
        t0 = time.time()
        plaintexts = session.mix(ciphs)
        jax.block_until_ready(plaintexts.limbs)
        dt = time.time() - t0

        ok = sorted(plaintexts.to_ints()) == sorted(msgs)

        # Standalone universal verification of the transcript
        # (vmnv equivalent; warm pass on the "benchwarm" transcript
        # populates its compile cache).
        from pathlib import Path

        from vmn_tpu.protocol.mixnet.verifier import FiatShamirVerifier

        FiatShamirVerifier(
            params, Path(tmp) / "nizkp.benchwarm"
        ).verify(expected_type="mixing")
        t0 = time.time()
        vres = FiatShamirVerifier(
            params, Path(tmp) / "nizkp.bench"
        ).verify(expected_type="mixing")
        dt_verify = time.time() - t0

        # Proof size + communication — the reference postlude's report
        # surface (MixNetElGamalTool.java:150-207,
        # ProtocolElGamal.java:591-602).
        nizkp_bytes = sum(
            f.stat().st_size
            for f in (Path(tmp) / "nizkp.bench").rglob("*")
            if f.is_file()
        )
        board = party.board
        sent_bytes = getattr(board, "sent_bytes", 0)
        received_bytes = getattr(board, "received_bytes", 0)

    result = {
        "metric": "ciphertexts_mixed_proved_per_sec_2048bit_modp",
        "value": round(n / dt, 3),
        "unit": "ciphertexts/s",
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
        "n": n,
        "group": group_name,
        "seconds": round(dt, 3),
        "correct": bool(ok),
        "verify_seconds": round(dt_verify, 3),
        "verify_cps": round(n / dt_verify, 3),
        "mix_prove_verify_cps": round(n / (dt + dt_verify), 3),
        "verify_ok": bool(vres.ok),
        "nizkp_bytes": nizkp_bytes,
        "nizkp_bytes_per_ciph": round(nizkp_bytes / n, 1),
        "sent_bytes": sent_bytes,
        "received_bytes": received_bytes,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
