"""Small cells for the benchmark's CPU tests: a configuration of the
tiny11 kind at test widths, and bergamot-tiny11 itself, each under a bulk
mix at test sizes, written as files into a directory the harness searches
before its own."""

from __future__ import annotations

import json
import os

from benchmark import harness

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

TINY = {
    "emb_dim": 32, "ffn_dim": 64, "vocab_size": 600, "encoder_layers": 2,
    "decoder_layers": 2, "num_heads": 4,
    "model_config": {"encoder_layers": 2, "decoder_layers": 2, "num_heads": 4},
}
CELLS = ("tiny-bulk", "tiny11-small")
LIMITS = {"sample_requests": 12,
          "limits": {"requests_failed": 0, "answers_wrong": 0, "max_logit_gap": 0.5}}


def write(directory: str, kind: str, name: str, data: dict) -> None:
    os.makedirs(os.path.join(directory, kind), exist_ok=True)
    with open(os.path.join(directory, kind, name + ".json"), "w") as f:
        json.dump(data, f)


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_cells(directory: str) -> dict:
    """Write two small cells of the bulk lane into `directory`: "tiny-bulk"
    (the tiny configuration with a shortlist) and "tiny11-small" (the
    bergamot-tiny11 configuration at its own widths, full vocabulary, a
    few short calls); return a BENCHMARK object whose metrics list them
    as the real bulk cells."""
    config = dict(load("configs", "bergamot-tiny11"), name="tiny", **TINY)
    write(directory, "configs", "tiny", config)
    bulk = dict(load("traffic", "bulk-docs-lex"), call_lines=24, pool_lines_per_s=40,
                warm={"min_rounds": 1, "max_s": 5}, shortlist={"frequent": 10, "best": 8})
    write(directory, "traffic", "tiny-bulk", bulk)
    small = dict(load("traffic", "bulk-docs"), call_lines=16, pool_lines_per_s=16, clients=1,
                 warm={"min_rounds": 1, "max_s": 5})
    write(directory, "traffic", "small-docs", small)
    write(directory, "cells", "tiny-bulk", LIMITS)
    write(directory, "cells", "tiny11-small", load("cells", "tiny11-bulk"))
    out = bench()
    out["workloads"] = [
        {"name": "tiny-bulk", "config": "tiny", "traffic": "tiny-bulk", "chips": 1, "why": "test"},
        {"name": "tiny11-small", "config": "bergamot-tiny11", "traffic": "small-docs", "chips": 1,
         "why": "test"},
    ]
    for metric in out["end_to_end"] + out["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = list(CELLS)
    return out


def run(directory: str, cell: str, seed: int = 2**31 + 7, seconds: float = 1.0,
        traced: bool = False, control: bool = False, bench_object: dict = None) -> dict:
    """One CPU run of a tiny cell (no card: the harness's look for one is
    run.py's, not run_cell's)."""
    finder = harness.Finder([directory, HERE])
    lines = []
    result = harness.run_cell(bench_object or tiny_cells(directory), finder, cell, seed, seconds,
                              traced, "cpu", harness.process_start(), lines.append,
                              control=control)
    result["log"] = lines
    return result
