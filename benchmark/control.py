"""The readings a cell's correctness limit is set from, on the card: for
each seed, one run of the cell (its own traffic and sizes, a short
window), the program's widest served-token logit gap, and the widest gap
of the token that the int4 control puts first at the same positions, with
the run's verdict when the control takes the program's place
(`control_correct`, which has to come out false).
Many seeds run in one process, so the kernels build once.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 5
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import run  # noqa: F401 -- the checkout's root on sys.path, caches inside it


def main(argv=None) -> int:
    from benchmark import harness

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    finder = harness.Finder([os.path.join(run.ROOT, "benchmark")])
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run_cell(bench, finder, args.workload, seed, args.seconds, False, "cuda",
                                  harness.process_start(), lambda line: None, control=True)
        readings = result["readings"]
        row = {"seed": seed, "control_correct": result["correct"],
               "gap": readings["program_max_logit_gap"],
               "control_gap": readings["control_max_logit_gap"],
               "answers_wrong": result["checks"]["answers_wrong"]["value"],
               "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "program_gap_max": max(r["gap"] for r in rows),
                      "program_gaps": sorted(r["gap"] for r in rows),
                      "control_gap_min": min(r["control_gap"] for r in rows),
                      "control_gaps": sorted(r["control_gap"] for r in rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
