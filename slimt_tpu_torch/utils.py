"""Utilities the runtime and the model use: timing, running averages,
the shortlist and service meters, the gc threshold, tensor dumps behind
SLIMT_TPU_DEBUG and a profiler scope behind SLIMT_TPU_PROFILE (the JAX
package's variable names).

Parity with the reference's Utils.hh: `Timer` (Utils.hh:69-99),
`AverageMeter` (Utils.hh:101-112).

The JAX package's `configure_compile_cache` (the persistent XLA compile
cache) has no counterpart: PyTorch runs eagerly, and the port's kernels
are cached by hashed name in slimt_tpu_torch/build/ (ops/_build.py).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import List, Optional, Sequence


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


# Seconds of idle card at each end of a traced scope (see `trace`).
TRACE_PAD_S = 0.1


@contextlib.contextmanager
def trace(name: str = "slimt_tpu_torch", directory: Optional[str] = None):
    """torch.profiler scope (CPU, and CUDA where there is a card) with a
    record_function(name) inside, written as a Chrome trace
    `<name>.<pid>.<ns>.pt.trace.json` into `directory` or
    SLIMT_TPU_PROFILE; a no-op without either.

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
    with profile(activities=activities) as prof:
        pad()
        with record_function(name):
            yield
        pad()
    prof.export_chrome_trace(
        os.path.join(directory, f"{name}.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


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
    exhaust-loop instrumentation (slimt/Frontend.cc:44-59)."""

    def __init__(self):
        self.wps = AverageMeter()
        self.occupancy = AverageMeter()

    def record_batch(
        self, words: int, elapsed: float, used: int, capacity: int
    ) -> None:
        if elapsed > 0:
            self.wps.record(words / elapsed)
        if capacity > 0:
            self.occupancy.record(used / capacity)

