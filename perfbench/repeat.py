"""Run cells several times, each run its own process, and summarize.

    python3 perfbench/repeat.py --workload <name> --seeds 11,12,13 \
        [--seconds S] [--trace 0|1] [--out chiprun_out/runs.jsonl]

Each run is ``perfbench/run.py`` with one seed; its result line (with
the seed, the wall time and the exit code) is appended to ``--out``.
The summary gives, per metric, the median and the spread: the distance
between the first and the third quartile (``statistics.quantiles(n=4)``)
as a share of the median, which is how the bounds in ``BENCHMARK.json``
were set (about five times the widest spread), and each compared
number's largest reading.  ``--seconds`` defaults to ``run_seconds``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default="chiprun_out/runs.jsonl")
    args = p.parse_args(argv)
    seconds = args.seconds or json.loads(
        (ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "perfbench" / "run.py"),
             "--workload", args.workload, "--seed", str(seed),
             "--seconds", str(seconds), "--trace", str(args.trace)],
            cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t
        tail = proc.stderr.strip().splitlines()[-12:]
        lines = proc.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            res = None
        row = {"workload": args.workload, "seed": seed, "rc": proc.returncode,
               "wall_s": wall, "seconds": seconds, "trace": args.trace,
               "result": res, "stderr_tail": tail}
        rows.append(row)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(f"seed {seed} rc {proc.returncode} wall {wall:.1f} s", flush=True)
        print("\n".join("  " + x for x in tail), flush=True)
        if res is not None:
            print("  " + json.dumps({k: v for k, v in res.items()
                                     if k != "breakdown"}), flush=True)
    good = [r["result"] for r in rows if r["result"] is not None]
    names = sorted({m for r in good for m in r["metrics"]})
    for m in names:
        vals = [r["metrics"][m]["value"] for r in good if m in r["metrics"]]
        line = f"{m}: n {len(vals)} median {statistics.median(vals)!r}"
        if len(vals) >= 2:
            line += f" spread {spread(vals)!r}"
        print(line + f" values {vals}")
    for c in sorted({c for r in good for c in r["checks"]}):
        vals = [r["checks"][c]["value"] for r in good]
        print(f"check {c}: max {max(vals)!r} values {vals}")
    print(f"correct {sum(r['correct'] for r in good)} of {len(rows)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
