"""Find a served cell's knee once: offer several rates to one set-up.

    python3 perfbench/sweep.py --workload gem_r50.query_image_r1m \
        --seed 5 --seconds 20 --rates 1,2,3,4

Prints one JSON line per rate (completed rate, latency quantiles, how
late the generator ran, the first and last third's median latency).  A
rate is sustained when every request completes and the last third does
not wait longer than the first.  The cell's mix then takes a fixed rate
below the knee; the benchmark's runs never search for one.
"""

from __future__ import annotations

import argparse
import importlib
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench.harness import make_cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    cell = make_cell(args.workload, args.seed, args.seconds, False)[0]
    driver = importlib.import_module(
        f"perfbench.drivers.{cell.traffic['kind']}")
    driver.sweep(cell, [float(r) for r in args.rates.split(",")],
                 args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
