"""One run of one cell: set-up, warm-up, the measured window, the metrics
and the comparison that decides `correct`.

Everything the run needs is found by name under the benchmark's roots
(`configs/`, `traffic/`, `lanes/`, `cells/`, `metrics/`, `work/`, and the
architecture file that a configuration's "reference" key names, which
supplies the plain reference, the weights' layout and the work counts), so
a new cell, configuration, architecture, mix, lane or metric is new files
and entries, never an edit here. The program under test is slimt_tpu_torch,
imported only here.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import resource
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark import inputs, readers, trace as tracing, traffic
from benchmark.probe import Forward, ForwardProbe
from benchmark.reference import check
from benchmark.reference import shortlist as shortlist_columns
from benchmark.reference.text import Text

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "slimt_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (slimt_tpu_torch is not slimt_tpu)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Finder:
    """Files by kind and name, from the first of `roots` that has them."""

    def __init__(self, roots: Sequence[str]):
        self.roots = list(roots)

    def path(self, kind: str, name: str, suffix: str) -> str:
        for root in self.roots:
            path = os.path.join(root, kind, name + suffix)
            if os.path.exists(path):
                return path
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under {self.roots}")

    def json(self, kind: str, name: str) -> dict:
        with open(self.path(kind, name, ".json")) as f:
            return json.load(f)

    def module(self, kind: str, name: str):
        return readers.load_file(self.path(kind, name, ".py"), f"{kind}_{name}")

    def architecture(self, cfg: dict):
        """The module of the configuration's architecture: the file that its
        "reference" key names ("reference/<name>.py")."""
        return self.module(*readers.reference_name(cfg))


def cell_metrics(bench: dict, cell: str, per_layer: bool) -> List[dict]:
    """The cell's end-to-end metrics, or its per-layer metrics: those that
    list it, and those without a list whose `moves` metric it reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not per_layer:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    config: dict
    traffic: dict
    window: traffic.Window
    forwards: List[Forward]
    setup_s: float
    window_s: float
    graph_counts: Optional[Dict[str, int]]
    trace: Optional[tracing.DeviceTrace]
    peaks: Optional[dict]
    phases: Dict[str, object]
    shortlist_width: Optional[Callable[[Forward], int]]
    architecture: object

    def work(self, phase: str) -> dict:
        return self.phases[phase].count(self.config, self.forwards, self.shortlist_width,
                                        self.architecture)


def process_start() -> float:
    """When this process started, on the perf_counter clock (from Linux's
    /proc; else now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def graph_counts(model) -> Optional[Dict[str, int]]:
    graphs = getattr(model, "_graphs", None)
    return None if graphs is None else dict(graphs.counts)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


@dataclasses.dataclass
class Inputs:
    """Everything the run makes from its seed; the program and the
    reference both get these."""

    pieces: list
    vocabulary: bytes
    weights: inputs.Weights
    model: bytes
    shortlist: Optional[check.Shortlist]
    shortlist_file: Optional[bytes]
    lexicon: inputs.Lexicon


def make_inputs(cfg: dict, architecture, spec: dict, seed: int, device) -> Inputs:
    vocab = cfg["vocab_size"]
    lexicon = inputs.make_lexicon(seed, vocab - inputs.FIRST_WORD_ID - inputs.CHAR_PIECES,
                                  cfg["zipf_s"])
    pieces = inputs.vocabulary_pieces(lexicon)
    weights = inputs.make_weights(cfg, seed, device, architecture)
    listed = file = None
    if spec.get("shortlist"):
        lex = spec["shortlist"]
        candidates = inputs.make_candidates(lexicon, vocab, lex["best"], seed, device)
        file = inputs.shortlist_bytes(candidates, lex["frequent"], lex["best"])
        listed = check.Shortlist(candidates, lex["frequent"], cfg["shortlist_bucket"])
    return Inputs(pieces, inputs.spm_model_bytes(pieces), weights, inputs.marian_bytes(weights),
                  listed, file, lexicon)


def run_cell(bench: dict, finder: Finder, cell_name: str, seed: int, seconds: float,
             traced: bool, device, started: float, log: Callable[[str], None],
             control: bool = False) -> dict:
    """One run; returns the result line's object (the checks last) and
    `readings`, what the check read. With `control`, the int4 control takes
    the program's place in the comparison (see judge)."""
    from slimt_tpu_torch import Model, ModelConfig, Package
    from slimt_tpu_torch.config import Config
    from slimt_tpu_torch.ops import launches
    from slimt_tpu_torch.runtime import service

    device = torch.device(device)
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cfg = finder.json("configs", cell["config"])
    architecture = finder.architecture(cfg)
    spec = finder.json("traffic", cell["traffic"])
    limits = finder.json("cells", cell_name)
    metrics = cell_metrics(bench, cell_name, traced)

    marks = {"start": time.perf_counter()}
    made = make_inputs(cfg, architecture, spec, seed, device)
    marks["inputs"] = time.perf_counter()
    model = Model(ModelConfig(**cfg["model_config"]),
                  Package(made.model, made.vocabulary, made.shortlist_file),
                  cfg["tgt_length_limit_factor"], device=device)
    probe = ForwardProbe(model)
    marks["model"] = time.perf_counter()
    lane = traffic.make(finder, spec, made.lexicon, seed, seconds)
    lane.open(model, Config, service)
    marks["traffic"] = time.perf_counter()
    warm = lane.warm(model)
    marks["warm"] = time.perf_counter()

    counts_before = graph_counts(model)
    launches_before = launches.snapshot()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    capture = tracing.Capture(device) if traced and device.type == "cuda" else None
    host = HostMeter()
    with host:
        if capture is not None:
            with capture:
                window = lane.run(model, seconds)
        else:
            window = lane.run(model, seconds)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    counts_after = graph_counts(model)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    launched = {k: v - launches_before.get(k, 0) for k, v in launches.snapshot().items()}
    occupancy = lane.service.meters.occupancy.average()
    shortlist_meter = model.shortlist_meter.snapshot()
    lane.close()

    forwards = probe.between(window.start, window.end)
    window_s = window.end - window.start
    setup_s = window.start - started
    device_trace = capture.trace.within(window.start, window.end) if capture else None
    delta = None
    if counts_before is not None:
        delta = {k: counts_after[k] - counts_before[k] for k in counts_before}
    width = None
    if made.shortlist is not None:
        listed = made.shortlist

        def width(forward):
            return shortlist_columns.width(listed.candidates, listed.frequent,
                                           np.concatenate(forward.sources))

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    with open(os.path.join(HERE, "peaks.json")) as f:
        peaks = json.load(f).get(kind)
    ctx = Context(cfg, spec, window, forwards, setup_s, window_s, delta, device_trace, peaks,
                  readers.phases(HERE), width, architecture)
    values = {}
    for metric in metrics:
        value = finder.module("metrics", metric["name"]).read(ctx)
        if value is not None:
            values[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    log(json.dumps({"info": {
        "cell": cell_name, "seed": seed, "card": power_limit() if device.type == "cuda" else "cpu",
        "window_s": window_s, "forwards": len(forwards), "graph_counts": delta,
        "real_tokens": sum(f.real_tokens for f in forwards),
        "padded_tokens": sum(f.padded_tokens for f in forwards),
        "launches": launched, "occupancy": occupancy, "shortlist": shortlist_meter,
        "memory_peak_bytes": memory_peak, "host": host.readings, **warm, **window.info,
        **({"trace": capture.cost_s} if capture else {}),
        "setup_parts_s": {"before_inputs": marks["start"] - started,
                          **{k: marks[k] - marks[p] for p, k in
                             zip(list(marks)[:-1], list(marks)[1:])}}}}))

    result = {"attempted": len(window.texts),
              "failed": sum(a is None for a in window.answers),
              "metrics": values,
              "device": {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                         "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if device_trace is not None:
        result["device"]["busy_s"] = device_trace.busy_ns() / 1e9
        result["device"]["window_s"] = window_s
        result["breakdown"] = tracing.breakdown(device_trace, window.start, window.end,
                                                host_label(forwards))

    # The program's state goes before the reference runs on the card.
    every_forward = probe.forwards
    del model, lane, probe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    judged = time.perf_counter()
    checks, faults, readings = judge(made, cfg, architecture, spec, limits, window, every_forward,
                                     seed, device, control)
    for fault in faults[:20]:
        log("fault: " + fault)
    log(json.dumps({"check_s": time.perf_counter() - judged, **readings}))
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    result["readings"] = readings
    return result


def judge(made: Inputs, cfg: dict, architecture, spec: dict, limits: dict,
          window: traffic.Window, forwards_all, seed: int, device, control: bool = False):
    """(checks, faults, readings): the numbers compared, each with its
    limit, a line for each request judged wrong (see reference/check.py),
    and the counts of tokens compared with the gaps read. The reference
    and its int4 control are the architecture's `Reference`. With `control`
    the int4 control takes the program's place in the comparison of
    logits: `max_logit_gap` is then the widest gap of the token that the
    control puts first at each served position (the control need not
    decode), so `correct` comes out of the same verdict; the program's own
    gap stays among the readings."""
    text = Text(made.pieces, inputs.EOS_ID)
    answered = [a is not None for a in window.answers]
    picked = check.sample_requests(window.texts, answered, limits["sample_requests"],
                                   inputs.rng(seed, "check"))
    faults, segments = check.judge_answers(
        window.texts, window.answers, picked, forwards_all, text,
        spec["service"]["wrap_length"], cfg["tgt_length_limit_factor"], made.shortlist)
    reference = architecture.Reference(made.weights, cfg, device)
    lower = None
    if control:
        lower = architecture.Reference(made.weights, cfg, device, precision="int4")
    gaps = check.logit_gaps(reference, segments, lower)
    readings = {k: gaps[k] for k in ("tokens_compared", "tokens_outside_columns",
                                      "tokens_in_bucket_padding")}
    readings["program_max_logit_gap"] = gaps["max_logit_gap"]
    if control:
        readings["control_max_logit_gap"] = gaps["control_max_logit_gap"]
    limit = limits["limits"]
    out = {
        "requests_failed": {"value": sum(not a for a in answered), "limit": limit["requests_failed"]},
        "answers_wrong": {"value": len(faults), "limit": limit["answers_wrong"]},
        "max_logit_gap": {"value": gaps["control_max_logit_gap" if control else "max_logit_gap"],
                          "limit": limit["max_logit_gap"]},
    }
    return out, faults, readings


def host_label(forwards: List[Forward]):
    """What the host was doing at a moment of the window (perf_counter s):
    "forward_open" while a batch it called has not returned its result,
    else "host_batching" (tokenizing, packing, completing)."""
    opens = np.array([f.start for f in forwards])
    closes = np.array([f.done if f.done is not None else np.inf for f in forwards])

    def label(at: float) -> str:
        return "forward_open" if np.any((opens <= at) & (closes >= at)) else "host_batching"

    return label


class HostMeter:
    """What the host did in the window, for the info line: the process's
    CPU seconds, its context switches (involuntary ones: another thread
    or process took the core) and the garbage collector's passes and
    seconds by generation."""

    def __init__(self):
        self.readings: dict = {}
        self._gc = {"collections": [0, 0, 0], "seconds": [0.0, 0.0, 0.0]}
        self._began = 0.0

    def _collecting(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._began = time.perf_counter()
        else:
            self._gc["collections"][info["generation"]] += 1
            self._gc["seconds"][info["generation"]] += time.perf_counter() - self._began

    def __enter__(self):
        self._usage = resource.getrusage(resource.RUSAGE_SELF)
        self._wall = time.perf_counter()
        gc.callbacks.append(self._collecting)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._collecting)
        usage = resource.getrusage(resource.RUSAGE_SELF)
        self.readings = {
            "wall_s": time.perf_counter() - self._wall,
            "cpu_s": usage.ru_utime + usage.ru_stime - self._usage.ru_utime - self._usage.ru_stime,
            "involuntary_switches": usage.ru_nivcsw - self._usage.ru_nivcsw,
            "voluntary_switches": usage.ru_nvcsw - self._usage.ru_nvcsw,
            "gc_collections": self._gc["collections"], "gc_s": self._gc["seconds"]}
        return False
