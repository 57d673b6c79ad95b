"""The columns a shortlisted batch may choose from, worked out from the
shortlist's candidates and the batch's source ids.

marian's lexical shortlist (slimt Shortlist.cc): the first `frequent`
target ids, and every candidate of each source id in the batch, the set
filled up to a multiple of 8 with the next ids from `frequent` on. The
program then pads the set to a whole number of `bucket` columns with the
smallest ids outside it (a few stable shapes); the greedy choice ranges
over all of them, so the reference does the same.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

ALIGNMENT = 8


def columns(candidates: np.ndarray, frequent: int, source_ids: Iterable[int],
            bucket: int) -> np.ndarray:
    """Sorted column ids for a batch whose rows hold `source_ids`;
    candidates [vocab, best]."""
    vocab = candidates.shape[0]
    chosen = np.zeros(vocab, bool)
    chosen[:min(frequent, vocab)] = True
    words = np.unique(np.fromiter(source_ids, dtype=np.int64))
    chosen[candidates[words].reshape(-1)] = True
    missing = (-int(chosen.sum())) % ALIGNMENT
    if missing:
        free = np.flatnonzero(~chosen[frequent:])[:missing] + frequent
        chosen[free] = True
    want = min(vocab, -(-int(chosen.sum()) // bucket) * bucket)
    extra = want - int(chosen.sum())
    if extra > 0:
        chosen[np.flatnonzero(~chosen)[:extra]] = True
    return np.flatnonzero(chosen)


def width(candidates: np.ndarray, frequent: int, source_ids: Iterable[int]) -> int:
    """The shortlist's width before the program pads it to its bucket."""
    vocab = candidates.shape[0]
    chosen = np.zeros(vocab, bool)
    chosen[:min(frequent, vocab)] = True
    words = np.unique(np.fromiter(source_ids, dtype=np.int64))
    chosen[candidates[words].reshape(-1)] = True
    n = int(chosen.sum())
    return min(vocab, n + (-n) % ALIGNMENT)
