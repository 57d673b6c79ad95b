"""The bulk lane: offline documents. `clients` threads each send calls of
`call_lines` lines to one `Blocking.translate_bulk` service, closed loop,
for the window. Line lengths are lognormal by `line_words`; a share
`repeat_share` (default 0) of the lines repeats an earlier line of the
same run, drawn uniformly, and no other line repeats.

Its mix's parameters, besides those every mix has (traffic.py):
"call_lines", "clients", "line_words", "pool_lines_per_s" (the lines made
before the window, a rate times the window; past them calls are made on
demand, in order, from the same stream), "repeat_share" and "warm"
({"min_rounds", "max_s"}).
"""

from __future__ import annotations

import math
import threading
import time
from typing import List

import numpy as np

from benchmark import inputs, traffic


class Lane:
    def __init__(self, spec: dict, lexicon, seed: int, seconds: float):
        self.spec = spec
        self.lexicon = lexicon
        self._seen: set = set()
        self._made: List[str] = []
        self._lock = threading.Lock()
        self._generator = inputs.rng(seed, "traffic")
        self._warm_generator = inputs.rng(seed, "warm")
        self.calls: List[List[str]] = []
        pool = math.ceil(spec["pool_lines_per_s"] * seconds / spec["call_lines"]) + spec["clients"]
        for _ in range(pool):
            self.calls.append(self._new_call(self._generator))
        self.generated_in_window = 0

    def _new_call(self, generator, repeats: bool = True) -> List[str]:
        lengths = inputs.lognormal_lengths(generator, self.spec["call_lines"],
                                           self.spec["line_words"])
        lines = inputs.make_lines(generator, self.lexicon, lengths, unique=True, seen=self._seen)
        share = self.spec.get("repeat_share", 0.0) if repeats else 0.0
        if share > 0:
            for i in np.flatnonzero(generator.random(len(lines)) < share).tolist():
                earlier = len(self._made) + i
                if earlier:
                    at = int(generator.integers(earlier))
                    lines[i] = self._made[at] if at < len(self._made) else \
                        lines[at - len(self._made)]
            self._made.extend(lines)
        return lines

    def _call(self, index: int) -> List[str]:
        with self._lock:
            while index >= len(self.calls):  # past the pool: made on demand, in order
                self.calls.append(self._new_call(self._generator))
                self.generated_in_window += 1
            return self.calls[index]

    def open(self, model, config_type, services):
        self.service = services.Blocking(config_type(**self.spec["service"]))

    def _round(self, model, calls: List[List[str]]) -> None:
        """The calls sent by the clients at once, each client one at a time."""
        counter = iter(range(len(calls)))
        lock = threading.Lock()

        def client():
            while True:
                with lock:
                    i = next(counter, None)
                if i is None:
                    return
                self.service.translate_bulk(model, calls[i])

        traffic.run_threads(client, self.spec["clients"])

    def warm(self, model) -> dict:
        warm = self.spec["warm"]
        # One line first: a checkout's first run builds the kernels here,
        # outside the warm-up's time bound.
        self.service.translate_bulk(model, self._new_call(self._warm_generator, False)[:1])
        start, rounds = time.perf_counter(), 0
        while True:
            before = traffic.graph_misses(model)
            calls = [self._new_call(self._warm_generator, False)
                     for _ in range(self.spec["clients"])]
            self._round(model, calls)
            rounds += 1
            settled = traffic.graph_misses(model) == before and rounds >= warm["min_rounds"]
            if settled or time.perf_counter() - start > warm["max_s"]:
                return {"warm_rounds": rounds, "warm_settled": settled}

    def run(self, model, seconds: float) -> traffic.Window:
        results = {}
        lock = threading.Lock()
        next_call = iter(range(1 << 30))
        t0 = time.perf_counter()
        deadline = t0 + seconds

        def client():
            while True:
                with lock:
                    i = next(next_call)
                lines = self._call(i)
                start = time.perf_counter()
                if start >= deadline:
                    return
                responses = self.service.translate_bulk(model, lines)
                with lock:
                    results[i] = (start, time.perf_counter(), lines, responses)

        traffic.run_threads(client, self.spec["clients"])
        calls = [results[i] for i in sorted(results)]
        texts = [line for call in calls for line in call[2]]
        answers = [r.target.text for call in calls for r in call[3]]
        return traffic.Window(min(c[0] for c in calls), max(c[1] for c in calls), texts, answers,
                              info={"calls": len(calls),
                                    "calls_made_in_window": self.generated_in_window})

    def close(self):
        self.service.close()
