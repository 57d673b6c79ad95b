"""Utilities the runtime and the model use: timing, running averages,
the shortlist and service meters, and the gc threshold.

Parity with the reference's Utils.hh: `Timer` (Utils.hh:69-99),
`AverageMeter` (Utils.hh:101-112).
"""

from __future__ import annotations

import threading
import time


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

