"""Time the CUDA Montgomery core against XLA's plain product loop.

    python tools/core_vs_xla.py [--n-batch 65536] [--n-mix 10000]
                                [--limit 420]

Each route runs in a child process of its own, one after the other (the
kernel choice is fixed once a program is traced): `core` is the normal
GPU route; `xla` makes `mont._use_core` false, so every Montgomery
product runs `mont._mont_mul`.  Each child times, at modp2048:

  * one product batch of n-batch elements (warm; median of 5);
  * one exponentiation batch of n-batch 2048-bit exponents (cold, warm);
  * the `chip_smoke.py` main-path mix of n-mix ciphertexts through the
    CLI: on the core a cold and a warm pass, each with its verification;
    on XLA one cold mix (its verification and warm pass would take
    minutes more).

A child still running after --limit seconds is killed; what it printed
stands.  Every measurement is one JSON line on standard output, and all
of them go to chiprun_out/core_vs_xla.json, beside the card's name and
power limit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def child(route: str, n_batch: int, n_mix: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from chip_smoke import cache_entries, cli_mix
    from vmn_tpu.arith import mont
    from vmn_tpu.arith.pgroup import ModPGroup
    from vmn_tpu.ops import core, parity

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("core_vs_xla: needs a GPU")
    _emit(route=route, what="cache", state=cache_entries())
    if route == "xla":
        mont._use_core = lambda L: False
    else:
        core.load("gpu")
    ctx = ModPGroup.named("modp2048").ctx
    rng = np.random.default_rng(0)
    a = jnp.asarray(parity._random_below(rng, ctx.m, n_batch, ctx.L))
    b = jnp.asarray(parity._random_below(rng, ctx.m, n_batch, ctx.L))
    e = jnp.asarray(parity._random_below(rng, ctx.m, n_batch, ctx.L))

    def timed(fn):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        return time.perf_counter() - t0

    mul = lambda: ctx.mul(a, b)  # noqa: E731
    timed(mul)
    _emit(route=route, what="mul", n=n_batch,
          warm_s=statistics.median(timed(mul) for _ in range(5)))
    exp = lambda: ctx.exp(a, e)  # noqa: E731
    _emit(route=route, what="exp", n=n_batch, cold_s=timed(exp),
          warm_s=timed(exp))
    if route == "core":
        times = cli_mix(n_mix, "modp2048")
    else:
        times = cli_mix(n_mix, "modp2048", ("cold",), verify=False)
    _emit(route=route, what="mix", n=n_mix, **times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-batch", type=int, default=1 << 16)
    ap.add_argument("--n-mix", type=int, default=10000)
    ap.add_argument("--limit", type=int, default=420,
                    help="seconds each route may take")
    ap.add_argument("--route", choices=("core", "xla"),
                    help="run one route in this process")
    args = ap.parse_args(argv)
    if args.route:
        child(args.route, args.n_batch, args.n_mix)
        return 0

    from chip_smoke import card_line

    card = card_line()
    print(f"card: {card}", flush=True)
    records = []
    for route in ("core", "xla"):
        cmd = [sys.executable, __file__, "--route", route,
               "--n-batch", str(args.n_batch), "--n-mix", str(args.n_mix)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                  text=True, timeout=args.limit)
            out = proc.stdout
            status = "done" if proc.returncode == 0 else (
                f"exit {proc.returncode}")
            if proc.returncode:
                print(proc.stderr[-3000:], file=sys.stderr)
        except subprocess.TimeoutExpired as ex:
            out = (ex.stdout or b"").decode() if isinstance(
                ex.stdout, bytes) else (ex.stdout or "")
            status = f"killed after {args.limit} s"
        for ln in out.splitlines():
            if ln.startswith("{"):
                records.append(json.loads(ln))
                print(ln, flush=True)
        print(f"{route}: {status}, {time.perf_counter() - t0:.1f} s",
              flush=True)
        records.append({"route": route, "status": status})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "core_vs_xla.json").write_text(
        json.dumps({"card": card, "records": records}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
