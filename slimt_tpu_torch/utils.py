"""Utilities the runtime and the model use: timing, running averages,
the shortlist and service meters, the gc threshold, tensor dumps behind
SLIMT_TPU_DEBUG, a profiler scope behind SLIMT_TPU_PROFILE (the JAX
package's variable names), the span recorder (`span`, `spans_between`,
`recording`), and the stubbed device forward of the host-path
measurements (`stub_device_forward`).

Parity with the reference's Utils.hh: `Timer` (Utils.hh:69-99),
`AverageMeter` (Utils.hh:101-112).

The JAX package's `configure_compile_cache` (the persistent XLA compile
cache) has no counterpart: PyTorch runs eagerly, and the port's kernels
are cached by hashed name in slimt_tpu_torch/build/ (ops/_build.py).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch.autograd.profiler as _autograd_profiler


def tune_gc(gen0_threshold: int) -> None:
    """Raise (never lower) Python's gen-0 gc threshold: at CPython's
    default of 700 allocations a host-heavy serving loop runs a gc pass
    hundreds of times per second. Called by the services with
    Config.gc_gen0_threshold."""
    if gen0_threshold <= 0:
        return
    import gc

    current = gc.get_threshold()
    if current[0] < gen0_threshold:
        gc.set_threshold(gen0_threshold, *current[1:])


class Timer:
    def __init__(self):
        self.start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    def reset(self) -> None:
        self.start = time.perf_counter()


class AverageMeter:
    """Running average (reference Utils.hh:101-112). Thread-safe:
    recorded from concurrent Async workers and completion threads."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        with self._lock:
            self.sum += value
            self.count += 1

    def average(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0


def argsort(values: Sequence) -> List[int]:
    return sorted(range(len(values)), key=values.__getitem__)


def debug_enabled() -> bool:
    return os.environ.get("SLIMT_TPU_DEBUG", "") not in ("", "0")


def debug_print(name: str, array) -> None:
    """Tensor dump behind SLIMT_TPU_DEBUG (reference Utils.cc:28-96
    print_ndarray), in the JAX package's stderr format. A torch tensor is
    moved to the host first (bfloat16 as float32: numpy has no bfloat16)."""
    if not debug_enabled():
        return
    import sys

    import numpy as np

    if hasattr(array, "detach"):
        import torch

        array = array.detach().cpu()
        if array.dtype == torch.bfloat16:
            array = array.to(torch.float32)
        array = array.numpy()
    arr = np.asarray(array)
    print(
        f"{name}: shape={arr.shape} dtype={arr.dtype} "
        f"mean={arr.mean():.6g} std={arr.std():.6g}\n{arr}",
        file=sys.stderr,
    )


# -- spans -------------------------------------------------------------

# Finished spans the process keeps; older ones are dropped, and counted.
SPAN_CAPACITY = 1 << 16


class SpanRecord:
    """One finished span: `name`; `start_ns` and `end_ns` on
    time.perf_counter_ns(), the clock a device trace's host timestamps
    are mapped from (epoch ns minus perf_counter ns); `cpu_ns`, the
    thread's CPU time over the span (time.thread_time_ns()); `thread`
    (its name) and `tid` (its native id); `id`; `parent`, the id of the
    span open beneath it on the same thread (None at the bottom);
    `batch`, the forward it belongs to (given, or its parent's; every
    span of one forward shares it, on the caller's, the dispatch
    worker's and the pool's threads); `fields`, numbers by name."""

    __slots__ = ("name", "start_ns", "end_ns", "cpu_ns", "thread", "tid", "id",
                 "parent", "batch", "fields")

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, {(self.end_ns - self.start_ns) / 1e3:.1f} us, "
                f"thread={self.thread!r}, batch={self.batch}, {self.fields})")


class SpanRecorder:
    """Finished spans in a deque bounded by `capacity`; `dropped` counts
    the spans it pushed out."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self._records: "collections.deque[SpanRecord]" = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    def add(self, record: SpanRecord) -> None:
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self.dropped += 1
            self._records.append(record)

    def between(self, t0: float, t1: float) -> List[SpanRecord]:
        """The spans that overlap [t0, t1] (perf_counter seconds), in the
        order they ended."""
        lo, hi = round(t0 * 1e9), round(t1 * 1e9)
        with self._lock:
            return [r for r in self._records if r.end_ns >= lo and r.start_ns <= hi]


RECORDER = SpanRecorder()
_forced = 0  # open recording() scopes
_forced_lock = threading.Lock()
_local = threading.local()
_span_ids = itertools.count(1)
_batch_ids = itertools.count(1)


def recording_on() -> bool:
    """Spans record while a torch profiler runs in the process (every
    torch.profiler scope sets `_is_profiler_enabled`, whatever its
    activities) or inside `recording()`."""
    return _forced > 0 or _autograd_profiler._is_profiler_enabled


@contextlib.contextmanager
def recording():
    """Record spans inside the block, profiler or not (tests, operator
    scripts); yields the recorder."""
    global _forced
    with _forced_lock:
        _forced += 1
    try:
        yield RECORDER
    finally:
        with _forced_lock:
            _forced -= 1


def new_batch() -> int:
    """A fresh forward id for `span(..., batch=)`."""
    return next(_batch_ids)


def spans_between(t0: float, t1: float) -> List[SpanRecord]:
    """The recorded spans that overlap [t0, t1] (perf_counter seconds)."""
    return RECORDER.between(t0, t1)


class _NoSpan:
    """What `span` returns while nothing records: one shared object."""

    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **fields) -> None:
        pass


class _Span:
    on = True

    __slots__ = ("record", "_cpu")

    def __init__(self, name: str, batch: Optional[int], fields: Dict[str, float]):
        record = self.record = SpanRecord()
        record.name, record.batch, record.fields = name, batch, fields
        record.id = next(_span_ids)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        record = self.record
        parent = stack[-1] if stack else None
        record.parent = None if parent is None else parent.id
        if record.batch is None and parent is not None:
            record.batch = parent.batch
        thread = threading.current_thread()
        record.thread, record.tid = thread.name, thread.native_id
        stack.append(record)
        self._cpu = time.thread_time_ns()
        record.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        record = self.record
        record.end_ns = time.perf_counter_ns()
        record.cpu_ns = time.thread_time_ns() - self._cpu
        _local.stack.pop()
        RECORDER.add(record)
        return False

    def set(self, **fields) -> None:
        """Add fields known only inside the span."""
        self.record.fields.update(fields)


_NO_SPAN = _NoSpan()


def span(name: str, batch: Optional[int] = None, **fields):
    """`with span("model.job", batch=b, rows=n) as s:` records the block
    as a SpanRecord while recording is on (`recording_on`); `s.set(...)`
    adds fields, `s.on` says whether it records. Off, it costs one flag
    check and returns a shared no-op."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return _NO_SPAN
    return _Span(name, batch, fields)


def _write_spans(path: str, records: List[SpanRecord]) -> None:
    """Append `records` to the Chrome trace at `path` as complete events
    on that trace's clock (epoch microseconds after its
    baseTimeNanoseconds), on their threads' rows."""
    with open(path) as f:
        data = json.load(f)
    offset = time.time_ns() - time.perf_counter_ns()
    base = data.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    data.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "slimt_span", "name": r.name, "pid": pid, "tid": r.tid,
         "ts": (r.start_ns + offset - base) / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
         "args": {"batch": r.batch, "thread": r.thread, "cpu_us": r.cpu_ns / 1e3,
                  **r.fields}}
        for r in records)
    with open(path, "w") as f:
        json.dump(data, f)


# Seconds of idle card at each end of a traced scope (see `trace`).
TRACE_PAD_S = 0.1


@contextlib.contextmanager
def trace(name: str = "slimt_tpu_torch", directory: Optional[str] = None):
    """torch.profiler scope (CPU, and CUDA where there is a card) with a
    record_function(name) inside, written as a Chrome trace
    `<name>.<pid>.<ns>.pt.trace.json` into `directory` or
    SLIMT_TPU_PROFILE, with the spans recorded in the scope (`span`) as
    complete events beside the kernels; a no-op without either.

    With the card traced, the scope's work starts TRACE_PAD_S after the
    capture window opens, and the window closes TRACE_PAD_S after the
    card is idle: the profiler maps the card's timestamps onto the host's
    clock, drops every kernel mapped outside the window, and on an H100
    host that mapping was milliseconds early in 2 of 30 traced forwards
    without the padding (`chip_smoke.py --trace-sessions`), which dropped
    the scope's first kernels."""
    directory = directory or os.environ.get("SLIMT_TPU_PROFILE")
    if not directory:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    card = torch.cuda.is_available()
    if card:
        activities.append(ProfilerActivity.CUDA)

    def pad():
        if card:
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)

    os.makedirs(directory, exist_ok=True)
    start = time.perf_counter()
    with profile(activities=activities) as prof:
        pad()
        with record_function(name):
            yield
        pad()
    path = os.path.join(directory, f"{name}.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    _write_spans(path, spans_between(start, time.perf_counter()))


class ShortlistMeter:
    """Generated vs bucket-padded shortlist width statistics
    (observability for the static-shape padding tax)."""

    def __init__(self):
        self.generated = AverageMeter()
        self.padded = AverageMeter()

    def record_widths(self, generated: int, padded: int) -> None:
        self.generated.record(generated)
        self.padded.record(padded)

    def snapshot(self) -> dict:
        return {
            "batches": self.generated.count,
            "avg_generated_width": round(self.generated.average(), 1),
            "avg_padded_width": round(self.padded.average(), 1),
        }


class ServiceMeters:
    """Words-per-second + batch occupancy meters, the reference's
    exhaust-loop instrumentation (slimt/Frontend.cc:44-59). `wps()` is
    the words of every batch over their summed elapsed seconds (a ratio
    of sums: a mean of per-batch rates weighs a short batch as much as a
    long one)."""

    def __init__(self):
        self.batches = 0
        self.words = 0
        self.seconds = 0.0
        self.occupancy = AverageMeter()
        self._lock = threading.Lock()

    def record_batch(
        self, words: int, elapsed: float, used: int, capacity: int
    ) -> None:
        with self._lock:
            self.batches += 1
            self.words += words
            self.seconds += max(elapsed, 0.0)
        if capacity > 0:
            self.occupancy.record(used / capacity)

    def wps(self) -> float:
        with self._lock:
            return self.words / self.seconds if self.seconds > 0 else 0.0


def stub_device_forward(model) -> None:
    """Replace a Model's device forward with an instant echo (hypothesis
    tokens = source tokens), keeping every host stage real (ingest,
    packing, completion, detokenize, response assembly).

    A measurement tool, never a serving mode: it takes the device out of
    the service path so that what is left is the host's cost
    (`python -m slimt_tpu_torch.host_path`), and, through
    SLIMT_TPU_TORCH_STUB_DEVICE=1 in `slimt_tpu_torch.server`, bounds a
    fleet of N servers sharing one card by host cores and transport alone
    (`python -m slimt_tpu_torch.fleet budget`).

    The echo runs on the caller's thread in numpy: a stubbed Model
    launches no kernel, makes no allocation on its device and never
    queues a batch on its dispatch worker (any path that would raises).
    A ContinuousEngine built from the Model's params decodes as before."""
    import numpy as np

    from slimt_tpu_torch.runtime.request import Hypothesis

    def forward_async(segments, need_alignment=True, raw=False):
        if raw:
            # The columnar completion contract (Batch.complete_raw): the
            # padded token matrix and each row's step count.
            steps = np.asarray([len(s) for s in segments], np.int32)
            t = max(1, int(steps.max()))
            toks = np.zeros((len(segments), t), np.int32)
            for i, s in enumerate(segments):
                toks[i, : len(s)] = s
            return lambda: (toks, steps, None)
        hyps = [Hypothesis(target=list(s), alignment=[]) for s in segments]
        return lambda: hyps

    def forward_async_arrays(
        indices, mask, lengths, batch, need_alignment=False,
        shortlist_words=None, raw=False,
    ):
        steps = np.asarray(lengths, np.int32)
        if raw:
            return lambda: (indices, steps, None)
        return lambda: [
            Hypothesis(target=indices[i, : steps[i]].tolist(), alignment=[])
            for i in range(batch)
        ]

    def refuse():
        raise RuntimeError("this Model's device forward is stubbed "
                           "(utils.stub_device_forward): it queues no batch")

    model.forward_async = forward_async
    model.forward_async_arrays = forward_async_arrays
    model.forward = lambda segments, need_alignment=True: forward_async(
        segments, need_alignment
    )()
    model._dispatch_worker = refuse

