"""The harness's spans around the entry layer: a wrapper, set from outside
on one Model instance, around `forward_async` (the Async lane) and
`forward_async_arrays` (the bulk lane). For every batch it keeps the
call's start and the moment its result came back, the rows, the T
bucket, and the source ids and served tokens, which the correctness
check reads after the window. It changes nothing the Model does."""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Forward:
    start: float  # perf_counter seconds
    done: Optional[float]
    rows: int
    t_bucket: int
    lengths: np.ndarray
    raw_sources: object  # list of id lists, or the padded [B, T] array
    raw_result: object = None
    columns: Optional[np.ndarray] = None  # the reference's, filled by the check
    generated: Optional[np.ndarray] = None

    @property
    def real_tokens(self) -> int:
        return int(self.lengths.sum())

    @property
    def padded_tokens(self) -> int:
        b_pad = 1 << max(0, (self.rows - 1).bit_length())
        return b_pad * self.t_bucket

    @property
    def sources(self) -> List[np.ndarray]:
        if isinstance(self.raw_sources, np.ndarray):
            return [self.raw_sources[i, :n] for i, n in enumerate(self.lengths.tolist())]
        return [np.asarray(s) for s in self.raw_sources]

    @property
    def served(self) -> List[np.ndarray]:
        """The tokens served per row (EOS included where it came)."""
        result = self.raw_result
        if isinstance(result, tuple):  # raw: (tokens [B, S], steps [B], alignment)
            tokens, steps = result[0], result[1]
            return [np.asarray(tokens[i, :n]) for i, n in enumerate(np.asarray(steps).tolist())]
        return [np.asarray(h.target, dtype=np.int64) for h in result]

    @property
    def steps(self) -> np.ndarray:
        return np.array([len(s) for s in self.served], np.int64)


def _bucket(t: int) -> int:
    return max(16, -(-t // 16) * 16)


class ForwardProbe:
    def __init__(self, model):
        self.forwards: List[Forward] = []
        self._lock = threading.Lock()
        forward_async = model.forward_async
        forward_async_arrays = model.forward_async_arrays

        def wrap(record: Forward, finish):
            def finished():
                result = finish()
                record.raw_result = result
                record.done = time.perf_counter()
                return result
            return finished

        def on_segments(segments, need_alignment=True, raw=False):
            start = time.perf_counter()
            finish = forward_async(segments, need_alignment, raw)
            lengths = np.array([len(s) for s in segments], np.int64)
            record = Forward(start, None, len(segments),
                             _bucket(int(lengths.max())), lengths, segments)
            with self._lock:
                self.forwards.append(record)
            return wrap(record, finish)

        def on_arrays(indices, mask, lengths, batch, need_alignment=False,
                      shortlist_words=None, raw=False):
            start = time.perf_counter()
            finish = forward_async_arrays(indices, mask, lengths, batch, need_alignment,
                                          shortlist_words, raw)
            record = Forward(start, None, int(batch), indices.shape[1],
                             np.asarray(lengths, np.int64)[:batch], indices)
            with self._lock:
                self.forwards.append(record)
            return wrap(record, finish)

        model.forward_async = on_segments
        model.forward_async_arrays = on_arrays

    def between(self, start: float, end: float) -> List[Forward]:
        """The forwards called in [start, end]."""
        with self._lock:
            return [f for f in self.forwards if start <= f.start <= end]
