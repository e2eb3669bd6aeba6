"""Benchmark suite: scaling curves of the mix.

The §6 measurement surface (reference: demo/mixnet/benchmarks —
`*_lengths`, `*_parties`, `*_keywidths_widths` scaling runs + report
extraction).

Writes chiprun_out/bench_suite.json (a directory `.gitignore` lists):

    {"mix_lengths": [{"n": N, "cps": ...}, ...],
     "mix_parties": [{"k": K, "cps": ...}, ...],
     "mix_widths": [{"width": W, "cps": ...}, ...], ...}

Run on the GPU machine:  python -m tools.bench_suite [sections]
sections ⊆ {lengths, parties, widths, p256, verify, northstar,
interactive} (default: all but northstar).
"""

import json
import os
import sys
import time
from pathlib import Path


import jax
import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _mix_once(n, k=1, threshold=1, width=1, group_name="modp2048",
              time_verify=False, noninteractive=True,
              check_correct=False):
    """One timed in-process mix (threads for k>1); returns ciphs/s."""
    import tempfile
    import threading
    from pathlib import Path

    from vmn_tpu.arith.pgroup import ModPGroup, PPArray
    from vmn_tpu.crypto.hash import SHA256
    from vmn_tpu.crypto.prg import PRGHeuristic
    from vmn_tpu.crypto.randomsource import DeviceSource, SeededSource
    from vmn_tpu.protocol import elgamal
    from vmn_tpu.protocol.com.board import LocalBoardHub
    from vmn_tpu.protocol.context import ProtocolParams
    from vmn_tpu.protocol.mixnet.party import MixNetParty

    if group_name.startswith("P-"):
        from vmn_tpu.arith.ec import ECqPGroup

        group = ECqPGroup.named(group_name)
    else:
        group = ModPGroup.named(group_name)
    params = ProtocolParams(
        sid=f"BS{n}.{k}.{width}.{group_name}.{int(noninteractive)}",
        k=k, threshold=threshold, pgroup=group,
        noninteractive=noninteractive,
    )
    hub = LocalBoardHub(k)
    with tempfile.TemporaryDirectory() as tmp:
        parties = [None] * (k + 1)
        errs = []

        def keyg(j):
            try:
                p = MixNetParty(params, hub.board(j),
                                DeviceSource(f"bs{j}".encode()),
                                f"{tmp}/P{j}")
                p.keygen()
                parties[j] = p
            except Exception:  # noqa: BLE001
                import traceback

                errs.append(traceback.format_exc())

        ths = [threading.Thread(target=keyg, args=(j,))
               for j in range(1, k + 1)]
        [t.start() for t in ths]
        [t.join() for t in ths]
        assert not errs, errs[0]
        pk = parties[1].full_public_key()

        prg = PRGHeuristic(SHA256)
        prg.set_seed(SHA256.hash(b"bs-msgs"))
        m = group.random_array(n, prg, params.rbitlen)
        if width > 1:
            plain = elgamal.plain_group(group, width)
            m = PPArray(plain, tuple([m] * width))
        r = elgamal.plain_group(group, width).ring.random(
            (n,), SeededSource(b"bs-enc"), 0
        )
        ciphs = elgamal.encrypt(pk.widen(width), m, r)
        del r  # 0.5 GB at N=2^20 — dead after encryption
        jax.block_until_ready(jax.tree_util.tree_leaves(
            [getattr(c, "limbs", getattr(c, "x", None))
             for c in _leaves(ciphs)]
        ))

        # warm pass
        hub2 = LocalBoardHub(k)
        _run_mix(parties, hub2, "warm", width, ciphs, k)
        import gc

        gc.collect()  # free warm-pass device buffers before timing
        hub3 = LocalBoardHub(k)
        t0 = time.time()
        outs = _run_mix(parties, hub3, "timed", width, ciphs, k)
        leaf = outs[1]
        while hasattr(leaf, "components"):
            leaf = leaf.project(0)
        np.asarray(getattr(leaf, "limbs", getattr(leaf, "x", None)))
        dt = time.time() - t0
        correct = None
        if check_correct:
            correct = sorted(leaf.to_ints()) == sorted(m.to_ints())
        dt_verify = None
        if time_verify:
            from vmn_tpu.protocol.mixnet.verifier import (
                FiatShamirVerifier,
            )

            # warm, then timed (vmnv equivalent on the nizkp transcript)
            FiatShamirVerifier(
                params, Path(tmp) / "P1" / "nizkp.warm"
            ).verify(expected_type="mixing")
            t0 = time.time()
            vres = FiatShamirVerifier(
                params, Path(tmp) / "P1" / "nizkp.timed"
            ).verify(expected_type="mixing")
            assert vres.ok
            dt_verify = time.time() - t0
    if check_correct and time_verify:
        return n / dt, dt, dt_verify, correct
    if time_verify:
        return n / dt, dt, dt_verify
    return n / dt, dt


def _leaves(pp):
    if hasattr(pp, "components"):
        out = []
        for c in pp.components:
            out.extend(_leaves(c))
        return out
    return [pp]


def _run_mix(parties, hub, aux, width, ciphs, k):
    import threading

    outs = [None] * (k + 1)
    errs = []

    def mix(j):
        try:
            parties[j].board = hub.board(j)
            outs[j] = parties[j].session(aux, width).mix(ciphs)
        except Exception:  # noqa: BLE001
            import traceback

            errs.append(traceback.format_exc())

    ths = [threading.Thread(target=mix, args=(j,))
           for j in range(1, k + 1)]
    [t.start() for t in ths]
    [t.join() for t in ths]
    assert not errs, errs[0]
    return outs


def main():
    sections = sys.argv[1:] or [
        "lengths", "parties", "widths", "p256", "verify", "interactive",
    ]
    path = ROOT / "chiprun_out" / "bench_suite.json"
    path.parent.mkdir(exist_ok=True)
    report = {}
    if path.exists():
        report = json.loads(path.read_text())

    def _flush():
        dev = jax.devices()[0]
        report["meta"] = {
            "group": "modp2048",
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
        }
        path.write_text(json.dumps(report, indent=1) + "\n")

    if "lengths" in sections:
        rows = []
        for n in (4096, 16384, 65536):
            cps, dt = _mix_once(n)
            rows.append({"n": n, "cps": round(cps, 1),
                         "seconds": round(dt, 1)})
            print(rows[-1])
        report["mix_lengths"] = rows
        _flush()

    if "parties" in sections:
        rows = []
        for k in (1, 3):
            cps, dt = _mix_once(8192, k=k, threshold=max(1, k - 1))
            rows.append({"k": k, "n": 8192, "cps": round(cps, 1),
                         "seconds": round(dt, 1)})
            print(rows[-1])
        report["mix_parties"] = rows
        _flush()

    if "widths" in sections:
        rows = []
        for w in (1, 2):
            cps, dt = _mix_once(8192, width=w)
            rows.append({"width": w, "n": 8192, "cps": round(cps, 1),
                         "seconds": round(dt, 1)})
            print(rows[-1])
        report["mix_widths"] = rows
        _flush()

    if "p256" in sections:
        cps, dt, dtv = _mix_once(16384, group_name="P-256",
                                 time_verify=True)
        report["mix_p256"] = {
            "n": 16384, "cps": round(cps, 1), "seconds": round(dt, 1),
            "verify_seconds": round(dtv, 1),
            "verify_cps": round(16384 / dtv, 1),
        }
        print(report["mix_p256"])
        _flush()

    if "verify" in sections:
        cps, dt, dtv = _mix_once(65536, time_verify=True)
        report["mix_verify_2048"] = {
            "n": 65536, "cps": round(cps, 1), "seconds": round(dt, 1),
            "verify_seconds": round(dtv, 1),
            "verify_cps": round(65536 / dtv, 1),
            "mix_prove_verify_cps": round(65536 / (dt + dtv), 1),
        }
        print(report["mix_verify_2048"])
        _flush()

    if "northstar" in sections:
        # The north star: full mix+prove+verify at N=2^20 (pushable to
        # 10^6 via VMN_NORTHSTAR_N), 2048-bit, on the card — the
        # reference's mixing_lengths axis taken to production scale
        # (demo/mixnet/benchmarks/bench_config:33-46).
        n = int(os.environ.get("VMN_NORTHSTAR_N", str(1 << 20)))
        cps, dt, dtv, ok = _mix_once(n, time_verify=True,
                                     check_correct=True)
        report["northstar"] = {
            "n": n, "cps": round(cps, 1), "seconds": round(dt, 1),
            "verify_seconds": round(dtv, 1),
            "verify_cps": round(n / dtv, 1),
            "mix_prove_verify_cps": round(n / (dt + dtv), 1),
            "correct": bool(ok), "verify_ok": True,
        }
        print(report["northstar"])
        _flush()

    if "interactive" in sections:
        # Interactive vs Fiat-Shamir correctness proofs, k=3 at two
        # sizes (reference: `interactive` row of .checkbaseconf; the
        # interactive path adds the coin-flipping challenge rounds)
        rows = []
        for n in (4096, 16384):
            cps_fs, dt_fs = _mix_once(n, k=3, threshold=2)
            cps_int, dt_int = _mix_once(
                n, k=3, threshold=2, noninteractive=False
            )
            rows.append({
                "n": n, "k": 3,
                "fs_seconds": round(dt_fs, 1),
                "interactive_seconds": round(dt_int, 1),
                "interactive_over_fs": round(dt_int / dt_fs, 2),
            })
            print(rows[-1])
        report["interactive"] = rows
        _flush()

    _flush()
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
