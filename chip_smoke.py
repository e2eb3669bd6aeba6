#!/usr/bin/env python3
"""Smoke test of the mix-net on one NVIDIA GPU, in one process.

    python chip_smoke.py [--n 10000] [--group modp2048]   # one card
    python chip_smoke.py --four [--n 10000]               # four cards

Phases (one card), each failing the run on any error:

  1. device  — JAX must see a GPU; the card's name and power limit come
               from `nvidia-smi` in a child process that stays off JAX;
  2. build   — compile the CUDA Montgomery core from the committed sources;
  3. parity  — every core entry point at modp2048 (L=128) on N = 2^16 + 37,
               bit-identical to Python `pow` and to the XLA path
               (`vmn_tpu.ops.parity.check_core`);
  4. mix     — a k=1 election of N ciphertexts through the CLI entry points
               (vmni -prot/-party/-merge, vmn -keygen, vmnd -ciphs,
               vmn -mix, vmnv -mix), twice: a cold pass that compiles and a
               warm one that is timed; the plaintext multiset must be
               preserved and the proof valid;
  5. P-256   — a short k=1 P-256 mix and verification (N = 1000).

`--four` runs only the multi-card phase: the same N-ciphertext modp2048
mix sharded over a 4-card `ciph_mesh` and on one card, from the same
seeded randomness; outputs and transcripts must be byte-identical and
both proofs valid.

The last line of standard output is one JSON object, printed only when
every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def card_line() -> str:
    """`nvidia-smi`'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except OSError as e:
        return f"nvidia-smi unavailable: {e}"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _vtm(*argv) -> float:
    """Run one CLI command in-process; returns its wall seconds."""
    from vmn_tpu.cli.main import main as vtm

    t0 = time.perf_counter()
    rc = vtm([str(a) for a in argv])
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{' '.join(map(str, argv))} exited {rc}")
    return dt


def cli_mix(n: int, group_name: str, passes=("cold", "warm"),
            verify: bool = True) -> dict:
    """The k=1 main path through the CLI entry points, one mix and (with
    `verify`) one verification per pass; returns seconds under "enc",
    "mix_<pass>" and "verify_<pass>".  Raises when a pass loses a
    plaintext or a command fails (`vmnv` exits non-zero on a rejected
    proof)."""
    from vmn_tpu.arith.pgroup import ModPGroup
    from vmn_tpu.protocol.interfaces import decode_plaintexts, get_interface

    group = ModPGroup.named(group_name)
    want = sorted(f"{i:08d}".encode() for i in range(n))
    times = {}
    with tempfile.TemporaryDirectory() as d, _cwd(d):
        pg = f"named:{group_name}"
        _vtm("vmni", "-prot", "-sid", "Smoke", "-nopart", 1, "-thres", 1,
             "-pgroup", pg, "-stub", "stub.xml")
        _vtm("vmni", "-party", "-name", "Party01", "-stub", "stub.xml",
             "-dir", Path(d) / "p1", "-out", "lpi.xml")
        _vtm("vmni", "-merge", "lpi.xml", "-out", "protInfo.xml")
        _vtm("vmn", "-keygen", "privInfo.xml", "protInfo.xml",
             "publicKey.bt")
        times["enc"] = _vtm("vmnd", "-ciphs", "publicKey.bt",
                            "ciphertexts.bt", "-N", n, "-pgroup", pg)
        for aux in passes:
            times[f"mix_{aux}"] = _vtm(
                "vmn", "-mix", "-auxsid", aux, "privInfo.xml",
                "protInfo.xml", "ciphertexts.bt", f"plain_{aux}.bt")
            if verify:
                times[f"verify_{aux}"] = _vtm(
                    "vmnv", "protInfo.xml", Path(d) / "p1" / f"nizkp.{aux}",
                    "-mix", "-auxsid", aux)
            plain = get_interface("raw").read_plaintexts(
                group, f"plain_{aux}.bt")
            if sorted(decode_plaintexts(plain)) != want:
                raise AssertionError(f"{aux} mix lost plaintexts")
    return times


def cache_entries() -> str:
    """Where JAX keeps compiled programs, and how many it holds now."""
    import jax

    d = jax.config.jax_compilation_cache_dir
    n = len(os.listdir(d)) if d and os.path.isdir(d) else 0
    return f"{d} holds {n} files"


def phase_mix(n: int, group_name: str, card: str, cache: str) -> None:
    t = cli_mix(n, group_name)
    print(f"  {group_name} k=1 N={n}: plaintext multiset preserved, "
          f"vmnv: proof valid (both passes)")
    print(f"  ciphertext generation (vmnd): {t['enc']:.2f} s")
    for what in ("mix", "verify"):
        warm, cold = t[f"{what}_warm"], t[f"{what}_cold"]
        print(f"  {what:<6} {warm:.2f} s warm = {n / warm:.1f} "
              f"ciphertexts/s; cold pass {cold:.2f} s")
    print(f"  cold minus warm is compile time only over an empty compile "
          f"cache; at start the cache {cache}")
    print(f"  card: {card}")


def _session_mix(group, n: int, root: Path, tag: str, ciphs_fn):
    """k=1 party from fixed seeds: returns (params, plaintexts)."""
    from vmn_tpu.crypto.randomsource import SeededSource
    from vmn_tpu.protocol.com.board import LocalBoardHub
    from vmn_tpu.protocol.context import ProtocolParams
    from vmn_tpu.protocol.mixnet.party import MixNetParty

    params = ProtocolParams(sid="Smoke", k=1, threshold=1, pgroup=group)
    party = MixNetParty(params, LocalBoardHub(1).board(1),
                        SeededSource(b"smoke-party"), str(root / tag))
    pk = party.keygen()
    out = party.session("aux", 1).mix(ciphs_fn(pk))
    return params, out


def _verify(params, nizkp: Path) -> bool:
    from vmn_tpu.protocol.mixnet.verifier import FiatShamirVerifier

    return FiatShamirVerifier(params, nizkp).verify(
        expected_type="mixing").ok


def phase_p256(n: int) -> None:
    from vmn_tpu.arith.ec import ECqPGroup
    from vmn_tpu.crypto.randomsource import SeededSource
    from vmn_tpu.protocol import elgamal

    group = ECqPGroup.named("P-256")
    msgs = [f"m{i:06d}".encode() for i in range(n)]

    def ciphs(pk):
        m = group.from_affine([group.encode_message(s) for s in msgs])
        r = group.ring.random((n,), SeededSource(b"smoke-enc"), 0)
        return elgamal.encrypt(pk, m, r)

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        params, out = _session_mix(group, n, Path(d), "p1", ciphs)
        got = sorted(group.decode_message(p) for p in group.to_affine(out))
        t_mix = time.perf_counter() - t0
        if got != sorted(msgs):
            raise AssertionError("P-256 mix lost plaintexts")
        t0 = time.perf_counter()
        if not _verify(params, Path(d) / "p1" / "nizkp.aux"):
            raise AssertionError("P-256 proof rejected")
        t_ver = time.perf_counter() - t0
    print(f"  P-256 k=1 N={n}: plaintext multiset preserved, proof valid "
          f"(mix {t_mix:.1f} s, verify {t_ver:.1f} s, compile included)")


def phase_four(n: int, group_name: str, n_cards: int = 4) -> None:
    """The same mix sharded over `n_cards` and on one card."""
    import jax
    import numpy as np

    from vmn_tpu.arith.pgroup import ModPGroup
    from vmn_tpu.crypto.hash import SHA256
    from vmn_tpu.crypto.prg import PRGHeuristic
    from vmn_tpu.crypto.randomsource import SeededSource
    from vmn_tpu.parallel.mesh import ciph_mesh, shard_array
    from vmn_tpu.protocol import elgamal

    if len(jax.devices()) < n_cards:
        raise RuntimeError(f"--four needs {n_cards} devices, "
                           f"JAX sees {len(jax.devices())}")
    group = ModPGroup.named(group_name)
    mesh = ciph_mesh(n_cards)
    # PRG-derived plaintexts (string encoding costs a host pow each)
    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(b"smoke-msgs"))
    m = group.random_array(n, prg, 8)
    msgs = sorted(m.to_ints())
    cache = {}

    def ciphs(pk):
        if "c" not in cache:
            r = group.ring.random((n,), SeededSource(b"smoke-enc"), 0)
            cache["c"] = elgamal.encrypt(pk, m, r)
        return cache["c"]

    with tempfile.TemporaryDirectory() as d:
        root = Path(d)
        res = {}
        for tag, place in (("one", lambda c: c),
                           ("four", lambda c: shard_array(c, mesh))):
            for rnd in ("cold", "warm"):
                t0 = time.perf_counter()
                params, out = _session_mix(
                    group, n, root, f"{tag}_{rnd}",
                    lambda pk: place(ciphs(pk)))
                limbs = np.asarray(out.limbs)
                dt = time.perf_counter() - t0
                res[tag, rnd] = (params, limbs, dt)
            res[tag, "ints"] = out.to_ints()
            # The verifier reads the transcript from disk and runs on one
            # card: verify the cold pass's transcript first, time the warm.
            for rnd in ("cold", "warm"):
                t0 = time.perf_counter()
                if not _verify(params, root / f"{tag}_{rnd}" / "nizkp.aux"):
                    raise AssertionError(f"{tag} {rnd}: proof rejected")
            print(f"  {tag} card(s): mix {res[tag, 'warm'][2]:.2f} s warm "
                  f"({n / res[tag, 'warm'][2]:.1f} ciphertexts/s, "
                  f"cold {res[tag, 'cold'][2]:.2f} s); its transcript "
                  f"verified on one card in {time.perf_counter() - t0:.2f} "
                  f"s warm: proof valid")
        one, four = res["one", "warm"][1], res["four", "warm"][1]
        if not np.array_equal(one, four):
            raise AssertionError("sharded plaintexts differ from one card")
        if sorted(res["four", "ints"]) != msgs:
            raise AssertionError("sharded mix lost plaintexts")
        bt = [(root / f"{t}_warm" / "nizkp.aux"
               / "ShuffledCiphertexts.bt").read_bytes()
              for t in ("one", "four")]
        if bt[0] != bt[1]:
            raise AssertionError("ShuffledCiphertexts.bt differ")
    print(f"  {group_name} k=1 N={n}: {n_cards}-card plaintexts and "
          f"ShuffledCiphertexts.bt byte-identical to one card; plaintext "
          f"multiset preserved")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--group", default="modp2048")
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded mix phase")
    args = ap.parse_args(argv)

    card = card_line()
    print(f"card: {card}", flush=True)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform})",
              file=sys.stderr)
        return 1

    from vmn_tpu.ops import core

    cache = cache_entries()
    print(f"[cache] compile cache {cache}", flush=True)
    t0 = time.perf_counter()
    core.load("gpu")
    print(f"[build] CUDA Montgomery core built and loaded in "
          f"{time.perf_counter() - t0:.1f} s (set-up)", flush=True)

    if args.four:
        print(f"[four] {args.group} N={args.n} on 4 cards vs 1", flush=True)
        phase_four(args.n, args.group)
    else:
        from vmn_tpu.arith.pgroup import ModPGroup
        from vmn_tpu.ops import parity

        print("[parity] modp2048, N = 2^16 + 37", flush=True)
        parity.check_core(ModPGroup.named("modp2048"), (1 << 16) + 37,
                          log=lambda s: print(s, flush=True))
        print(f"[mix] {args.group} k=1 N={args.n} via the CLI", flush=True)
        phase_mix(args.n, args.group, card, cache)
        print("[p256] P-256 k=1 N=1000", flush=True)
        phase_p256(1000)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
