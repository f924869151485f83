"""The benchmark's control, and its planted faults, at a cell's own size.

    python3 bench_port/control.py --workload <cell> --seeds 11,12,13 --seconds 20 [--fault control]

Runs the cell once a seed with the timed path broken underneath (bp/pool.py
FAULTS; `control`: each proof is of a witness with one input cell changed,
the guarantee that a proof stands for a satisfying witness broken), and
prints each run's result line. Every run has to come out `correct: false`.
The benchmark's own runs never run this.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run  # noqa: E402
from bp.pool import FAULTS  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", default="20")
    p.add_argument("--fault", default="control", choices=FAULTS)
    a = p.parse_args()
    worst = 0
    for seed in a.seeds.split(","):
        print(f"== {a.fault} seed {seed}", flush=True)
        rc = run.main(["--workload", a.workload, "--seed", seed, "--seconds", a.seconds,
                       "--trace", "0"], fault=a.fault)
        worst = max(worst, rc)
    return worst


if __name__ == "__main__":
    sys.exit(main())
