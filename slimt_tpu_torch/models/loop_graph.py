"""CUDA graphs for the decode loops (models/decode.py, models/continuous.py).

A loop's chunk of k decode steps reads and writes fixed buffers only, so
on CUDA it is captured once as one `torch.cuda.CUDAGraph` and replayed:
the host then issues one replay every k steps in place of every op of
every step. Nothing falls back to the host loop: a capture or a replay
that fails raises.

`ChunkGraph.run` runs the chunk eagerly the first time, on the graph's
own stream (the real first chunk of its batch: it also builds the
kernels, fills the layout caches and sets the kernels' launch
attributes, none of which may happen during a capture), then captures it
with capture_error_mode "thread_local", so that another thread may use
the card while this one captures. The capture's launches go to the
capturing thread's tally (ops/launches.py), not to the kernels'
counters, and each replay adds that tally: the counters count the
kernels a replay runs, as they count an eager launch, whatever other
threads launch meanwhile.

`GraphCache` keeps the graphs of one owner (a Model, an engine) in an
LRU with a bound, keyed by what the capture fixed: the provider, the
cache type, the shapes, the options and the weights; `counts` holds its
hits, misses (each a capture) and evictions. `DeviceGraphs` holds one
GraphCache for each device a multi-device decode runs on (a meshed or
multi-process Model, a mesh leg): each keeps its own bound. `HostCopy` is a
non-blocking copy into pinned host memory behind an event: the loops
read their all-complete flag and the continuous engine its chunk buffer
through it, one chunk behind, so no replay waits on the host.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable, Dict, Optional

import torch

from slimt_tpu_torch.ops import launches
from slimt_tpu_torch.utils import span

# Graphs a cache keeps before it drops the least recently used: the bound
# of one device's cache (a meshed Model keeps one cache per device,
# DeviceGraphs, so its shards do not evict each other's buckets). A key is
# B x T bucket x shortlist width x alignment x options, so traffic may
# hold more; chip_smoke.py prints each Model's hits, captures and
# evictions. There, one Model's whole life (its served traffic, three k,
# the latency and forward lines) held 14 keys; a miss costs a capture
# (tens of ms on the declared path, a few under fused_step), and a pass
# through a one-graph cache still beat the eager loop.
GRAPH_CACHE_SIZE = 16

_replays_lock = threading.Lock()


class ChunkGraph:
    """`body` (no arguments, fixed buffers in and out) as one CUDA graph on
    `device`. `replays` counts the replays of every ChunkGraph."""

    replays = 0

    def __init__(self, body: Callable[[], None], device: torch.device):
        self.body = body
        self.device = device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[object, int] = {}
        self.capture_ms: Optional[float] = None
        self.pool_bytes: Optional[int] = None

    def run(self) -> None:
        """The chunk: a replay, or on the first run the eager chunk and
        the capture."""
        if self.graph is None:
            with span("decode.capture"):
                self._first_run()
            return
        self.graph.replay()
        launches.add(self.launches)
        with _replays_lock:
            ChunkGraph.replays += 1

    def _first_run(self) -> None:
        current = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.body()
            reserved = torch.cuda.memory_reserved(self.device)
            start = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            # Capturing launches nothing: the wrappers count into this
            # thread's tally, which each replay adds.
            with launches.tallied() as tally:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.body()
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
            self.capture_ms = (time.perf_counter() - start) * 1e3
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        current.wait_stream(stream)
        self.launches = tally
        self.graph = graph


class Bucket:
    """One cache entry: a loop's fixed buffers (`state`, an object whose
    `run_chunk` advances them) and the graph of its chunk. `use()` holds
    it for one batch: other threads wait, and the caller's stream waits
    for the last batch's work on the buffers."""

    def __init__(self, state, device: torch.device):
        self.state = state
        self.device = device
        self.graph = ChunkGraph(state.run_chunk, device)
        self._lock = threading.Lock()
        self._released: Optional[torch.cuda.Event] = None

    @contextlib.contextmanager
    def use(self):
        with self._lock:
            stream = torch.cuda.current_stream(self.device)
            if self._released is not None:
                stream.wait_event(self._released)
            try:
                yield self.state
            finally:
                self._released = torch.cuda.Event()
                self._released.record(stream)

    def stats(self) -> Dict[str, float]:
        """The graph's capture time (ms) and the memory its capture
        reserved (MB), beside its fixed buffers' (MB)."""
        return {"capture_ms": self.graph.capture_ms,
                "pool_mb": None if self.graph.pool_bytes is None
                else self.graph.pool_bytes / 2**20,
                "buffers_mb": self.state.buffer_bytes() / 2**20}


class GraphCache:
    """Buckets by key, the least recently used dropped past `capacity`.
    `counts`: the lookups that found their bucket (hits), those that made
    one (misses: each captures at its first run) and the buckets dropped
    (evictions); `capture_s` the seconds its captures took."""

    def __init__(self, capacity: int = GRAPH_CACHE_SIZE):
        self.capacity = capacity
        self._buckets: "collections.OrderedDict[tuple, Bucket]" = collections.OrderedDict()
        self._lock = threading.Lock()
        self.counts = {"hits": 0, "misses": 0, "evictions": 0}
        self._evicted_capture_ms = 0.0

    def bucket(self, key: tuple, make_state: Callable[[], object],
               device: torch.device) -> Bucket:
        """The bucket of `key`, made from `make_state()` on a miss."""
        with self._lock:
            bucket = self._buckets.pop(key, None)
            if bucket is None:
                bucket = Bucket(make_state(), device)
                self.counts["misses"] += 1
            else:
                self.counts["hits"] += 1
            self._buckets[key] = bucket
            while len(self._buckets) > self.capacity:
                _, evicted = self._buckets.popitem(last=False)
                self._evicted_capture_ms += evicted.graph.capture_ms or 0.0
                self.counts["evictions"] += 1
            return bucket

    @property
    def capture_s(self) -> float:
        """The seconds every capture of this cache took, evicted ones too."""
        with self._lock:
            kept = sum(b.graph.capture_ms or 0.0 for b in self._buckets.values())
            return (self._evicted_capture_ms + kept) / 1e3

    def items(self):
        with self._lock:
            return list(self._buckets.items())

    def __len__(self) -> int:
        return len(self._buckets)


class DeviceGraphs:
    """The graph caches of a multi-device owner: one GraphCache, bounded
    by `capacity`, for each device a decode loop runs on, made at its
    first lookup, and the stream that device's loops run on. A device is
    a rank of the mesh (`on(rank, device)`): on a virtual mesh several
    ranks share one card, and each still keeps its own cache and stream.
    The streams last as long as the owner, so the allocator's blocks of
    each stream serve its next batches. `counts` holds each cache's hits,
    misses and evictions, by device."""

    def __init__(self, capacity: int = GRAPH_CACHE_SIZE):
        self.capacity = capacity
        self._caches: Dict[int, GraphCache] = {}
        self._names: Dict[int, str] = {}
        self._streams: Dict[int, "torch.cuda.Stream"] = {}
        self._lock = threading.Lock()

    def stream(self, rank: int, device: torch.device) -> "torch.cuda.Stream":
        """The stream of mesh rank `rank`'s loops, on `device`."""
        with self._lock:
            stream = self._streams.get(rank)
            if stream is None:
                stream = self._streams[rank] = torch.cuda.Stream(device)
            return stream

    def on(self, rank: int, device: torch.device) -> GraphCache:
        """The cache of mesh rank `rank`, on `device`."""
        with self._lock:
            cache = self._caches.get(rank)
            if cache is None:
                cache = self._caches[rank] = GraphCache(self.capacity)
                self._names[rank] = f"rank {rank} ({device})"
            return cache

    @property
    def counts(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {self._names[rank]: dict(self._caches[rank].counts)
                    for rank in sorted(self._caches)}

    @property
    def capture_s(self) -> float:
        """The seconds every cache's captures took."""
        with self._lock:
            return sum(cache.capture_s for cache in self._caches.values())


class HostCopy:
    """A copy of `tensor` on the host. From a CUDA tensor: a non-blocking
    copy into pinned memory, recorded behind an event on the current
    stream; `numpy()` waits for that event only. From a CPU tensor: a
    copy at once."""

    def __init__(self, tensor: torch.Tensor):
        self.event = None
        if tensor.is_cuda:
            self.host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            self.host.copy_(tensor, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(tensor.device))
        else:
            self.host = tensor.clone()

    def numpy(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class FlagReader:
    """Reads of a device flag (a [1] bool tensor): with `lag` 0 each read
    returns the flag at once (a CPU tensor, or the eager loop on the card,
    which waits for it); with `lag` 1 a read issues a HostCopy and returns
    the previous read's value (False at the first), so that the device
    runs the next chunk while the host waits for the last one's flag."""

    def __init__(self, flag: torch.Tensor, lag: int):
        self.flag = flag
        self.lag = lag
        self._pending: "collections.deque[HostCopy]" = collections.deque()

    def read(self) -> bool:
        """Each read that waits for the device is a decode.flag_wait span."""
        if not self.lag:
            with span("decode.flag_wait"):
                return bool(self.flag.item())
        self._pending.append(HostCopy(self.flag))
        if len(self._pending) <= self.lag:
            return False
        with span("decode.flag_wait"):
            return bool(self._pending.popleft().numpy()[0])
