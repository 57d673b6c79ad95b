"""Response, pivot alignment remapping, and the progress Handle.

Mirrors slimt/Response.{hh,cc}. The pivot `combine` marginalizes the
intermediate language out of P(s|q)·P(q|t): the two models tokenize the
pivot text differently, so P(q'|t) is first redistributed over bytes
and re-collected at the first model's target token ranges with a
two-pointer sweep (slimt/Response.cc:22-127), then the matrices are
multiplied (slimt/Response.cc:129-175).
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

from slimt_tpu_torch.text.annotation import AnnotatedText, Encoding, Range

Alignment = List[List[float]]  # P[t][s] = p(source token s | target token t)


@dataclasses.dataclass
class Options:
    """Per-call options (slimt/Response.hh:45-48)."""

    alignment: bool = False
    html: bool = False


class Response:
    def __init__(self):
        self.source = AnnotatedText()
        self.target = AnnotatedText()
        self.alignments: List[Alignment] = []

    @classmethod
    def _blank(cls) -> "Response":
        """Uninitialized instance for assembly paths that set source/
        target/alignments themselves (skips three default-object
        allocations per line in the columnar bulk lane). Any field
        added to __init__ must be handled here or by those callers."""
        return cls.__new__(cls)

    def size(self) -> int:
        return self.source.sentence_count()

    def to(self, encoding: Encoding) -> None:
        self.source.to(encoding)
        self.target.to(encoding)

    def __repr__(self):
        return f"Response(source={self.source.text!r}, target={self.target.text!r})"


def transfer_through_characters(
    source_side_pivots: List[Range],
    target_side_pivots: List[Range],
    pivot_given_targets: Alignment,
) -> Alignment:
    """Rewrite P(q'|t) over the second model's pivot tokenization into
    P(q|t) over the first model's, spreading probability over bytes
    (slimt/Response.cc:22-127)."""
    n_t = len(pivot_given_targets)
    remapped = [[0.0] * len(source_side_pivots) for _ in range(n_t)]

    sq, qt = 0, 0
    while sq < len(source_side_pivots) and qt < len(target_side_pivots):
        sp = source_side_pivots[sq]
        tp = target_side_pivots[qt]
        if sp.begin == tp.begin and sp.end == tp.end:
            for t in range(n_t):
                remapped[t][sq] += pivot_given_targets[t][qt]
            sq += 1
            qt += 1
        else:
            left = max(tp.begin, sp.begin)
            right = min(tp.end, sp.end)
            if left >= right:
                # Zero-width token (e.g. a control piece with empty
                # surface): no byte overlap to spread over. Give a
                # zero-width target token's mass to the current source
                # token to conserve probability, then advance whichever
                # side ends first. (The reference asserts here,
                # slimt/Response.cc:49.)
                if tp.end - tp.begin == 0:
                    for t in range(n_t):
                        remapped[t][sq] += pivot_given_targets[t][qt]
                    qt += 1
                else:
                    sq += 1
                continue
            character_count = right - left
            spread = tp.end - tp.begin
            for t in range(n_t):
                remapped[t][sq] += (
                    character_count * pivot_given_targets[t][qt] / float(spread)
                )
            if sp.end == tp.end:
                sq += 1
                qt += 1
            elif sp.end > tp.end:
                qt += 1
            else:
                sq += 1

    # Unmatched trailing pivot tokens (e.g. an unpredicted EOS): gift
    # their mass uniformly (slimt/Response.cc:78-96). A first-leg
    # sentence that decoded to ZERO tokens has nowhere to gift to —
    # drop the mass instead of dividing by zero.
    n_s = len(source_side_pivots)
    while qt < len(target_side_pivots) and n_s > 0:
        for t in range(n_t):
            gift = pivot_given_targets[t][qt] / n_s
            for s in range(n_s):
                remapped[t][s] += gift
        qt += 1

    return remapped


def remap_alignments(first: Response, second: Response) -> List[Alignment]:
    """P(s|t) = Σ_q P(s|q)·P(q|t) per sentence
    (slimt/Response.cc:129-175)."""
    alignments = []
    for sid in range(first.source.sentence_count()):
        source_given_pivots = first.alignments[sid]
        pivot_given_targets = second.alignments[sid]

        source_side_pivots = [
            first.target.word_as_range(sid, i)
            for i in range(first.target.word_count(sid))
        ]
        target_side_pivots = [
            second.source.word_as_range(sid, i)
            for i in range(second.source.word_count(sid))
        ]

        remapped = transfer_through_characters(
            source_side_pivots, target_side_pivots, pivot_given_targets
        )

        n_source = first.source.word_count(sid)
        n_target = second.target.word_count(sid)
        output = [[0.0] * n_source for _ in range(n_target)]
        for idt in range(min(n_target, len(remapped))):
            for idq in range(len(source_side_pivots)):
                if idq >= len(source_given_pivots):
                    continue
                row = source_given_pivots[idq]
                weight = remapped[idt][idq]
                if weight == 0.0:
                    continue
                for ids in range(min(n_source, len(row))):
                    output[idt][ids] += row[ids] * weight
        alignments.append(output)
    return alignments


def combine(first: Response, second: Response) -> Response:
    """Merge the two pivot legs (slimt/Response.cc:177-190)."""
    combined = Response()
    # Alignment-free pivots carry [[], [], ...] per sentence — skip
    # the remap (it would only build all-zero matrices).
    if first.alignments and any(len(a) for a in first.alignments):
        combined.alignments = remap_alignments(first, second)
    combined.source = first.source
    combined.target = second.target
    return combined


@dataclasses.dataclass
class Fraction:
    p: int
    q: int

    def percent(self) -> float:
        return 100.0 * self.p / self.q if self.q else 100.0


class Handle:
    """Future + live progress for an async request
    (slimt/Response.hh:66-91)."""

    def __init__(self, request, parts: int, future: Future):
        self._request = request
        self._parts = parts
        self._part = 0
        self.future = future
        self._start = time.perf_counter()

    @dataclasses.dataclass
    class Info:
        wps: float
        parts: Fraction
        words: Fraction
        segments: Fraction

    def info(self) -> "Handle.Info":
        (wp, wq), (sp, sq) = self._request.progress()
        elapsed = max(time.perf_counter() - self._start, 1e-9)
        summary = Handle.Info(
            wps=wp / elapsed,
            parts=Fraction(self._part + 1, self._parts),
            words=Fraction(wp, wq),
            segments=Fraction(sp, sq),
        )
        # Snapshot before testing: concurrent info() calls (e.g. HTTP
        # pollers) must never observe a half-advanced handle or step
        # _request onto None.
        nxt = self._request.next
        if nxt is not None:
            self._request = nxt
            self._part += 1
        return summary

    def result(self, timeout: Optional[float] = None) -> Response:
        return self.future.result(timeout)
