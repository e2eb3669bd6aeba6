"""Run the driver bench 3x and record the spread (VERDICT round-3 item:
pin down run-to-run variance under the driver's own conditions).

Writes chiprun_out/bench_spread.json.  Run on the GPU machine with
nothing else using the card or the host CPUs.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    runs = []
    for i in range(reps):
        out = subprocess.run(
            [sys.executable, "bench.py"], cwd=ROOT,
            capture_output=True, text=True, timeout=3600,
        )
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("{")][-1]
        runs.append(json.loads(line))
        print(runs[-1])

    def spread(key):
        vals = [r[key] for r in runs]
        mid = sorted(vals)[len(vals) // 2]
        return {
            "min": min(vals), "median": mid, "max": max(vals),
            "spread_pct": round(100 * (max(vals) - min(vals)) / mid, 1),
        }

    report = {
        "runs": runs,
        "mix_cps": spread("value"),
        "verify_cps": spread("verify_cps"),
        "combined_cps": spread("mix_prove_verify_cps"),
    }
    out = ROOT / "chiprun_out" / "bench_spread.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(
        json.dumps(report, indent=1) + "\n"
    )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
