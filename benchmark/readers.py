"""What the metric readers in `metrics/` share: each reader is a file
`metrics/<name>.py` with `read(ctx)`, returning the metric's value or
None where the run has nothing to read (the harness then leaves the
metric out). `ctx` is harness.Context."""

from __future__ import annotations

import glob
import importlib.util
import os
import statistics
from typing import Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))


def load_file(path: str, name: str):
    """The module of a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_name(cfg: dict) -> Tuple[str, str]:
    """(kind, name) of the file that a configuration's "reference" key
    names, "reference/<name>.py": the module of its architecture."""
    kind, _, file = cfg["reference"].partition("/")
    if not kind or "/" in file or not file.endswith(".py"):
        raise ValueError(f"reference {cfg['reference']!r} is not <kind>/<name>.py")
    return kind, file[:-3]


def architecture(cfg: dict):
    """The module of the configuration's architecture among the benchmark's
    own files (the harness finds it through its Finder, which searches other
    roots first)."""
    kind, name = reference_name(cfg)
    return load_file(os.path.join(HERE, kind, name + ".py"), f"{kind}_{name}")


def phases(root: str):
    """The work counters of `work/<phase>.py`, by phase."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "work", "*.py"))):
        phase = os.path.basename(path)[:-3]
        out[phase] = load_file(path, "work_" + phase)
    return out


def rows_per_forward(ctx) -> Optional[float]:
    if not ctx.forwards:
        return None
    return statistics.fmean(f.rows for f in ctx.forwards)


def graph_hit_share(ctx) -> Optional[float]:
    counts = ctx.graph_counts
    if counts is None or counts["hits"] + counts["misses"] == 0:
        return None
    return 100.0 * counts["hits"] / (counts["hits"] + counts["misses"])


def idle_share(ctx) -> Optional[float]:
    if ctx.trace is None or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_ns() / 1e9 / ctx.window_s)


def least_time(work: dict, peaks: dict) -> dict:
    """The least time of a phase's work on the chip: its compute at the
    peaks of its precisions, its bytes at the memory's peak, the larger
    of the two, and which one bounds it."""
    compute = work["int8_ops"] / peaks["int8_ops_per_s"] + work["f32_ops"] / peaks["f32_flops_per_s"]
    memory = work["bytes"] / peaks["bytes_per_s"]
    return {"compute_s": compute, "memory_s": memory, "least_s": max(compute, memory),
            "bound": "compute" if compute >= memory else "memory"}


def roofline(ctx, phase: str, graph: bool) -> Optional[float]:
    """Least time of the phase's work over the device time of the
    operations attributed to it: those of graph replays for the decode,
    the others for the encoder (a stopgap until the program names its
    phases in the trace)."""
    if ctx.trace is None or ctx.peaks is None or not ctx.forwards:
        return None
    device_s = ctx.trace.op_ns(graph=graph) / 1e9
    if device_s <= 0:
        return None
    work = ctx.work(phase)
    return 100.0 * least_time(work, ctx.peaks)["least_s"] / device_s
