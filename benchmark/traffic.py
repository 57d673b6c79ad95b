"""The one general traffic generator: a traffic mix is a data file,
`traffic/<name>.json`, of parameters, and its "lane" names the lane that
drives it, a file `lanes/<lane>.py` found by name (so a new lane is a new
file): its `Lane(spec, lexicon, seed, seconds)` makes every request of
the window from the seed, and has `open(model, config_type, services)`,
`warm(model)`, `run(model, seconds)` returning a Window, and `close()`.

Every mix has "lane", "service" (fields of the port's service Config),
"shortlist" (null, or {"frequent", "best"} for a lex shortlist) and
"warm" (how the set-up warms the graph cache: traffic of the same mix
from another seed, until a round adds no graph capture or the time
bound is reached). Lengths are {"median", "sigma", "min", "max"} of a
rounded, clipped lognormal. Words are drawn by the lexicon's Zipf law.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Callable, List, Optional


def load(root: str, name: str) -> dict:
    with open(os.path.join(root, "traffic", name + ".json")) as f:
        return json.load(f)


@dataclasses.dataclass
class Window:
    """What one lane measured: the window [start, end] (perf_counter),
    the requests due in it with their answers (None: failed or never
    answered), and the lane's own readings (printed on the info line). A
    lane that measures more returns a subclass with fields of its own,
    which its metrics' readers read."""

    start: float
    end: float
    texts: List[str]
    answers: List[Optional[str]]
    info: dict = dataclasses.field(default_factory=dict)


def graph_misses(model) -> int:
    graphs = getattr(model, "_graphs", None)
    return -1 if graphs is None else graphs.counts["misses"]


def make(finder, spec: dict, lexicon, seed: int, seconds: float):
    """The mix's lane, found by name under the finder's roots."""
    return finder.module("lanes", spec["lane"]).Lane(spec, lexicon, seed, seconds)


def run_threads(target: Callable[[], None], n: int) -> None:
    errors = []

    def guarded():
        try:
            target()
        except BaseException as exc:  # noqa: BLE001 -- raised again below
            errors.append(exc)

    threads = [threading.Thread(target=guarded, name=f"bench-client-{k}") for k in range(n)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise errors[0]
