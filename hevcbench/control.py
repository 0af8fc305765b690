"""Readings of the check's numbers under the control and the planted
faults (faults.py), on the card at the cell's own size: what the limits in
check.py were set from. Not part of a benchmark run.

    python3 -m hevcbench.control --workload <cell> --seeds 1,2,3 \
        --faults bf16,tf32,stale,half,altered --seconds 3

One process runs every (fault, seed) pair in turn, each a whole run of the
cell (its set-up, a short window at the cell's load, the check)
with the fault planted; "none" runs the program as it is. One JSON line a
run: the fault, the seed, `correct` and the numbers compared.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    from hevcbench import cells, run
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    a = ap.parse_args(argv)
    cell = cells.load_cell(a.workload,
                           os.path.join(os.getcwd(), "BENCHMARK.json"))
    run.require_cards(cell.chips)
    for fault in a.faults.split(","):
        for seed in (int(s) for s in a.seeds.split(",")):
            res = run.run_cell(cell, seed, a.seconds, False,
                               fault=None if fault == "none" else fault,
                               t_start=time.perf_counter())
            print(json.dumps({"workload": a.workload, "fault": fault,
                              "seed": seed, "correct": res["correct"],
                              "attempted": res["attempted"],
                              "numbers": {k: v["value"] for k, v in
                                          res["limits"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
