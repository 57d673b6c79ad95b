"""Failure detection and fail-fast semantics.

The reference's failure story is abort-on-error in one process
(SURVEY §5: SLIMT_ABORT, format/checksum validation). A serving
process adds a sharper requirement: a lost device must fail the process
fast rather than stall it. Utilities:

  - probe_devices(): cheap device liveness check (runs a trivial
    product on each card with a deadline);
  - Watchdog: wraps model.forward-style callables, marking the model
    unhealthy after consecutive device failures so the serving layer
    can drain and exit rather than hang.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence


def probe_devices(timeout: float = 30.0, kinds: Sequence[str] = ("cuda",)) -> dict:
    """Liveness probe: run and fetch a trivial product (an 8x8 matmul of
    ones) on every device of `kinds` within `timeout` seconds. "cuda"
    probes each of the torch.cuda.device_count() cards; the CPU is probed
    only when "cpu" is named. With no card, a "cuda" probe reports ok:
    False with the reason; it never answers for the CPU in the card's
    place."""
    import torch

    def run():
        devices = []
        for kind in kinds:
            if kind == "cpu":
                devices.append(torch.device("cpu"))
            elif kind == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "no CUDA device: torch.cuda.is_available() is False"
                    )
                devices += [torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())]
            else:
                raise ValueError(f"unknown device kind {kind!r}")
        results = {}
        for device in devices:
            x = torch.ones((8, 8), dtype=torch.float32, device=device)
            results[str(device)] = float((x @ x)[0, 0].item()) == 8.0
        return results

    # A daemon thread, NOT a ThreadPoolExecutor: the pool's __exit__ /
    # atexit hook joins worker threads, and on a wedged device the
    # probe thread never returns — the probe (and interpreter exit)
    # would hang in exactly the failure mode this exists to detect.
    box = {}

    def target():
        try:
            box["results"] = run()
        except Exception as e:  # noqa: BLE001
            box["error"] = f"{type(e).__name__}: {e}"

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    thread.join(timeout)
    if thread.is_alive():
        return {"ok": False, "error": f"device probe timed out ({timeout}s)"}
    if "error" in box:
        return {"ok": False, "error": box["error"]}
    results = box["results"]
    return {"ok": all(results.values()), "devices": results}


class Watchdog:
    """Fail-fast wrapper: after `max_failures` consecutive errors the
    wrapped callable refuses further work (raising RuntimeError) so
    callers drain instead of queueing against a dead device."""

    def __init__(self, fn: Callable, max_failures: int = 3):
        self._fn = fn
        self._max = max_failures
        self._failures = 0
        self._lock = threading.Lock()
        self.last_error: Optional[BaseException] = None

    @property
    def healthy(self) -> bool:
        return self._failures < self._max

    def __call__(self, *args, **kwargs):
        if not self.healthy:
            raise RuntimeError(
                f"unhealthy after {self._failures} consecutive failures: "
                f"{self.last_error!r}"
            )
        try:
            result = self._fn(*args, **kwargs)
        except Exception as e:
            with self._lock:
                self._failures += 1
                self.last_error = e
            raise
        with self._lock:
            self._failures = 0
        return result
