"""The program's own spans in a run's window, for the readers in `metrics/`
that read them, and the phase table of a traced run.

slimt_tpu_torch records its spans (`utils.span`) while a torch profiler
runs, so a traced run (`--trace 1`) has them with no switch of its own.
They are on time.perf_counter_ns(), which `DeviceTrace.to_ns` maps onto
the device trace's clock. A program that records no spans (one older
than them) gives every reader here None.

    python benchmark/spans.py --workload <cell> --seed <n> --seconds <s>

runs one traced run of the cell, prints its result line, then the phase
table: the card's idle time in the window split into in-job (the
dispatch worker inside a `model.job`), by the worker's deepest span open
at the time, and starved (outside every job), by the callers' spans open
at the time (several threads may hold one each), as JSON, also written
to chiprun_out/spans-<cell>-<seed>.json.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Tuple

import numpy as np

JOB = "model.job"
# The dispatch worker's host work that launches the device's (whose CPU
# share says whether it ran or waited for the interpreter lock).
WORKER_LAUNCH = ("model.h2d", "decode.encoder", "decode.cross_kv", "decode.bind")
# The worker's spans, deepest first (the in-job idle goes to the first open).
WORKER = ("decode.flag_wait", "decode.capture", "decode.loop", "decode.bind",
          "decode.cross_kv", "decode.encoder", "model.h2d", "model.d2h", JOB)
# The callers' and the pool's spans.
CALLER = ("bulk.ingest", "model.shortlist", "model.prepare", "bulk.assemble",
          "model.finish", "bulk.detokenize")


def window_spans(ctx) -> Optional[list]:
    """The spans that overlap the window, or None where the program
    recorded none."""
    try:
        from slimt_tpu_torch.utils import spans_between
    except ImportError:
        return None
    return spans_between(ctx.window.start, ctx.window.end) or None


def jobs(ctx) -> Optional[list]:
    spans = window_spans(ctx)
    found = [s for s in spans or () if s.name == JOB]
    return found or None


def device_ns(ctx, span) -> Tuple[int, int]:
    """A span's start and end on the device trace's clock."""
    return ctx.trace.to_ns(span.start_ns / 1e9), ctx.trace.to_ns(span.end_ns / 1e9)


def union(intervals) -> np.ndarray:
    """Sorted, disjoint [n, 2] intervals covering `intervals`."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return np.array(out, np.int64).reshape(-1, 2)


def intersect(first: np.ndarray, second: np.ndarray) -> np.ndarray:
    """The intersection of two unions."""
    out, j = [], 0
    for a, b in first.tolist():
        while j < len(second) and second[j, 1] <= a:
            j += 1
        k = j
        while k < len(second) and second[k, 0] < b:
            out.append((max(a, int(second[k, 0])), min(b, int(second[k, 1]))))
            k += 1
    return union(out)


def subtract(first: np.ndarray, second: np.ndarray) -> np.ndarray:
    """What of the union `first` lies outside the union `second`."""
    out, j = [], 0
    for a, b in first.tolist():
        while j < len(second) and second[j, 1] <= a:
            j += 1
        k, at = j, a
        while k < len(second) and second[k, 0] < b:
            if second[k, 0] > at:
                out.append((at, int(second[k, 0])))
            at = max(at, int(second[k, 1]))
            k += 1
        if at < b:
            out.append((at, b))
    return union(out)


def length(intervals: np.ndarray) -> int:
    return int((intervals[:, 1] - intervals[:, 0]).sum())


def idle_split(ctx) -> Optional[Tuple[int, int]]:
    """(starved, in-job) idle ns of the window: the card running nothing
    (the gaps of `idle_share.bulk`) while the worker was outside every
    model.job, and inside one. They sum to the window's idle ns."""
    if ctx.trace is None or ctx.window_s <= 0:
        return None
    found = jobs(ctx)
    if found is None:
        return None
    gaps = union(ctx.trace.gaps(ctx.window.start, ctx.window.end))
    in_job = length(intersect(gaps, union(device_ns(ctx, j) for j in found)))
    return length(gaps) - in_job, in_job


def window_share(ns: int, ctx) -> float:
    return 100.0 * ns / 1e9 / ctx.window_s


def job_fields(ctx, *names) -> Optional[List[tuple]]:
    """The fields `names` of each of the window's jobs that carries them
    all (None without such a job)."""
    found = [tuple(j.fields[n] for n in names) for j in jobs(ctx) or ()
             if all(n in j.fields for n in names)]
    return found or None


def phase_table(ctx) -> Optional[dict]:
    """The window's idle seconds: in-job by the worker's deepest open span
    ("model.job" alone: between its children), starved by each caller
    span open at the time (several threads may hold one each) and by
    none open ("none")."""
    found = jobs(ctx)
    if ctx.trace is None or found is None:
        return None
    spans = window_spans(ctx)
    worker = {j.thread for j in found}

    def intervals(names, on_worker):
        return union(device_ns(ctx, s) for s in spans
                     if s.name in names and (s.thread in worker) == on_worker)

    gaps = union(ctx.trace.gaps(ctx.window.start, ctx.window.end))
    in_job = intersect(gaps, intervals({JOB}, True))
    starved = subtract(gaps, in_job)
    left, by_worker = in_job, {}
    for name in WORKER:
        open_ = intervals({name}, True)
        by_worker[name] = length(intersect(left, open_)) / 1e9
        left = subtract(left, open_)
    by_caller = {name: length(intersect(starved, intervals({name}, False))) / 1e9
                 for name in CALLER}
    by_caller["none"] = length(subtract(starved, intervals(set(CALLER), False))) / 1e9
    return {"window_s": ctx.window_s, "idle_s": length(gaps) / 1e9,
            "in_job_s": length(in_job) / 1e9, "starved_s": length(starved) / 1e9,
            "in_job_by_worker_span": by_worker, "starved_by_caller_span": by_caller,
            "jobs": len(found), "spans": len(spans)}


def main(argv=None) -> int:
    import argparse
    import json
    import types

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = root
    from benchmark import harness
    from benchmark import run as bench_run  # noqa: F401 -- the caches' paths

    started = harness.process_start()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    kept = []

    class Keeping(harness.Finder):
        """The cell's files, and a first metric reader that keeps the
        run's context for the table."""

        def module(self, kind, name):
            module = super().module(kind, name)
            if kind != "metrics" or kept:
                return module

            def read(ctx):
                kept.append(ctx)
                return module.read(ctx)

            return types.SimpleNamespace(read=read)

    finder = Keeping([os.path.join(root, "benchmark")])
    result = harness.run_cell(bench, finder, args.workload, args.seed, args.seconds, True,
                              "cuda", started, lambda line: print(line, flush=True))
    result.pop("readings", None)
    print(json.dumps(result), flush=True)
    table = end_to_end = None
    if kept:
        table = phase_table(kept[0])
        # The end-to-end metrics of the traced window (tracing's cost).
        end_to_end = {m["name"]: finder.module("metrics", m["name"]).read(kept[0])
                      for m in harness.cell_metrics(bench, args.workload, False)}
    print(json.dumps({"phases": table, "traced_end_to_end": end_to_end}), flush=True)
    out = os.path.join(root, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"spans-{args.workload}-{args.seed}.json"), "w") as f:
        json.dump({"result": result, "phases": table, "traced_end_to_end": end_to_end}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
