"""The sweep that fixed a traffic mix's ranks a card: one run of a cell at
each P, untraced.

    python3 bench_port/sweep.py --workload <cell> --ranks 2,4,8 --seed 7 --seconds 40

Each run prints its result line, preceded by "== P <p>". The benchmark's own
runs never run this; the cell takes the P in its traffic file.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--ranks", required=True)
    p.add_argument("--seed", required=True)
    p.add_argument("--seconds", default="40")
    a = p.parse_args()
    worst = 0
    for n in a.ranks.split(","):
        print(f"== P {n}", flush=True)
        try:
            rc = run.main(["--workload", a.workload, "--seed", a.seed, "--seconds", a.seconds,
                           "--trace", "0"], ranks_per_card=int(n))
        except Exception as e:  # a P that does not fit the card
            print(f"P {n} failed: {type(e).__name__}: {e}", flush=True)
            rc = 1
        worst = max(worst, rc)
    return worst


if __name__ == "__main__":
    sys.exit(main())
