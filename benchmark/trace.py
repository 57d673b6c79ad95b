"""The device trace of a run's window, and its reduction.

torch.profiler with the CUDA activity alone records, through CUPTI, every
kernel, copy and memset on the card and the runtime calls that launched
them, on the host's clock in nanoseconds since the epoch. A kernel whose
launch correlates with a `cudaGraphLaunch` ran inside a CUDA-graph
replay. The window is padded by `PAD_S` of idle card at each end, so
that no kernel of the window falls outside the capture.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

PAD_S = 0.1


@dataclasses.dataclass
class DeviceTrace:
    names: List[str]
    start: np.ndarray  # ns, host clock since the epoch
    end: np.ndarray
    graph: np.ndarray  # launched by a CUDA-graph replay
    offset_ns: int  # epoch ns minus perf_counter ns

    def to_ns(self, perf_s: float) -> int:
        return round(perf_s * 1e9) + self.offset_ns

    def within(self, t0: float, t1: float) -> "DeviceTrace":
        """The operations that overlap [t0, t1] (perf_counter seconds),
        clipped to it."""
        lo, hi = self.to_ns(t0), self.to_ns(t1)
        keep = (self.end > lo) & (self.start < hi)
        return DeviceTrace([n for n, k in zip(self.names, keep) if k],
                           np.clip(self.start[keep], lo, hi), np.clip(self.end[keep], lo, hi),
                           self.graph[keep], self.offset_ns)

    def busy_ns(self) -> int:
        """The length of the union of the operations' intervals."""
        return int(sum(b - a for a, b in _union(self.start, self.end)))

    def gaps(self, t0: float, t1: float) -> List[Tuple[int, int]]:
        """The idle intervals of [t0, t1], in ns."""
        out, at = [], self.to_ns(t0)
        for a, b in _union(self.start, self.end):
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.to_ns(t1) > at:
            out.append((at, self.to_ns(t1)))
        return out

    def op_ns(self, graph: Optional[bool] = None) -> int:
        """Summed durations of the operations (those of graph replays, or
        the others, where `graph` is given)."""
        pick = np.ones(len(self.names), bool) if graph is None else self.graph == graph
        return int((self.end[pick] - self.start[pick]).sum())

    def by_name(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for name, a, b in zip(self.names, self.start.tolist(), self.end.tolist()):
            out[name] = out.get(name, 0) + (b - a)
        return out


def _union(start: np.ndarray, end: np.ndarray):
    order = np.argsort(start, kind="stable")
    lo = hi = None
    for a, b in zip(start[order].tolist(), end[order].tolist()):
        if hi is None or a > hi:
            if hi is not None:
                yield lo, hi
            lo, hi = a, b
        else:
            hi = max(hi, b)
    if hi is not None:
        yield lo, hi


class Capture:
    """`with Capture(device) as c:` traces the block; `c.trace` after it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.trace: Optional[DeviceTrace] = None
        self.cost_s: Dict[str, float] = {}  # what reading the trace took

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._profile = profile(activities=[ProfilerActivity.CUDA])
        self._profile.__enter__()
        torch.cuda.synchronize(self.device)
        time.sleep(PAD_S)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        time.sleep(PAD_S)
        offset = time.time_ns() - time.perf_counter_ns()
        stop = time.perf_counter()
        self._profile.__exit__(*exc)
        reduce = time.perf_counter()
        if exc[0] is None:
            self.trace = reduce_events(self._profile.profiler.kineto_results.events(), offset)
        self.cost_s = {"profiler_stop_s": reduce - stop, "reduce_s": time.perf_counter() - reduce,
                       "events": len(self.trace.names) if self.trace else 0}
        return False


def reduce_events(events, offset_ns: int) -> DeviceTrace:
    cuda = torch.autograd.DeviceType.CUDA
    graph_launches = set()
    names, start, end, corr = [], [], [], []
    for event in events:
        if event.device_type() == cuda:
            names.append(event.name())
            start.append(event.start_ns())
            end.append(event.end_ns())
            corr.append(event.correlation_id())
        elif event.name() == "cudaGraphLaunch":
            graph_launches.add(event.correlation_id())
    graph = np.array([c in graph_launches for c in corr], bool)
    return DeviceTrace(names, np.array(start, np.int64), np.array(end, np.int64), graph, offset_ns)


def breakdown(trace: DeviceTrace, t0: float, t1: float,
              label: Callable[[float], str]) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps, each named by what the host was doing at its middle."""
    ops = sorted(trace.by_name().items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.gaps(t0, t1), key=lambda g: g[0] - g[1])[:10]
    return {
        "device_ops": [[name[:96], ns / 1e9] for name, ns in ops],
        "idle_gaps": [[label(((a + b) / 2 - trace.offset_ns) / 1e9), (b - a) / 1e9]
                      for a, b in gaps],
    }
