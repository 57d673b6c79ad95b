"""Run one cell of the benchmark of slimt_tpu_torch on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), `device`,
with --trace 1 `breakdown`, and last `checks`, each number compared
beside its limit (also the last lines of standard error). Without a card,
with fewer cards than the cell asks for, or with JAX or the JAX package
loaded once the window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The checkout's root, not this directory, is where modules come from.
sys.path[0] = ROOT

# Every build and kernel cache of the program stays inside the checkout,
# at fixed paths, so that only a checkout's first run builds.
_CACHE = os.path.join(ROOT, "build", "bench-cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "nv")


def main(argv=None) -> int:
    from benchmark import harness

    started = harness.process_start()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cells[args.workload]["chips"]:
        print(f"{args.workload} needs {cells[args.workload]['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    finder = harness.Finder([os.path.join(ROOT, "benchmark")])

    def log(line: str) -> None:
        print(line, flush=True)

    result = harness.run_cell(bench, finder, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", started, log)
    bad = harness.forbidden_modules()
    if bad:
        print("forbidden modules loaded: " + ", ".join(bad), file=sys.stderr)
        return 3
    checks = result.pop("checks")
    for name, check in checks.items():
        print(f"check {name}: {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    line = {key: result[key] for key in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
