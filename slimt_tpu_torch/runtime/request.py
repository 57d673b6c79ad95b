"""Request: the unit of work after text processing.

Mirrors slimt/Request.{hh,cc}: a request owns the source AnnotatedText
and its token segments; workers complete segments concurrently
(`process`), an atomic countdown fires the continuation with the
assembled Response when the last segment lands. The translation cache
is probed at construction and updated per fresh translation
(slimt/Request.cc:29-85,114-134).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional, Sequence

from slimt_tpu_torch.runtime.cache import AtomicCache
from slimt_tpu_torch.runtime.response import Response
from slimt_tpu_torch.text.annotation import AnnotatedText

Alignment = List[List[float]]  # [target_token][source_token]


@dataclasses.dataclass
class Hypothesis:
    """The decode result for one segment (reference Types.hh:44-52).

    `decoded` optionally carries the detokenization — (utf8 bytes,
    per-token end offsets) — precomputed in one batched native call by
    Batch.complete; Request._complete then skips per-sentence decode."""

    target: List[int]
    alignment: List[List[float]]  # per-step distribution over source
    decoded: Optional[tuple] = None


History = Hypothesis  # reference: History = Ptr<Hypothesis>


def cache_usable(history, needs_alignment: bool) -> bool:
    """Whether a cached hypothesis can serve a request: one translated
    without alignments cannot serve an alignment-needing request
    (shared by Request construction and the bulk path)."""
    return not (
        needs_alignment and history.target and not history.alignment
    )


def cache_key(model_id: int, words: Sequence[int]) -> int:
    """Cache key over (model id, segment words). The reference folds
    hash_combine per word (slimt/Request.cc:20-26); the key never
    leaves the in-process cache, so the C-speed built-in tuple hash
    replaces the per-word Python fold."""
    return hash((model_id, *words))


class Request:
    Continuation = Callable[[Response], Optional["Request"]]

    def __init__(
        self,
        id_: int,
        model_id: int,
        source: AnnotatedText,
        segments: List[List[int]],
        vocabulary,
        cache: Optional[AtomicCache],
        continuation: "Request.Continuation",
        needs_alignment: bool = True,
    ):
        self.id = id_
        self.model_id = model_id
        self.source = source
        self.segments = segments
        self.vocabulary = vocabulary
        self.cache = cache
        self.continuation = continuation
        self.needs_alignment = needs_alignment
        self.next: Optional["Request"] = None
        self.failed: Optional[BaseException] = None
        self.on_error: Optional[Callable[[BaseException], None]] = None

        self._lock = threading.Lock()
        self.histories: List[Optional[History]] = [None] * len(segments)
        self._counter = len(segments)
        self.words_total = sum(len(s) for s in segments)
        self._words_complete = 0

        if not segments:
            self._complete()
            return

        if cache is not None:
            # Keys are needed again at store time (process); hash each
            # segment once.
            self._keys = [cache_key(model_id, s) for s in segments]
            prefilled = 0
            for idx, segment in enumerate(segments):
                found, history = cache.find(self._keys[idx])
                if found and not cache_usable(history, needs_alignment):
                    found = False
                if found:
                    self.histories[idx] = history
                    prefilled += 1
                    self._words_complete += len(segment)
            self._counter -= prefilled
            if self._counter == 0:
                self._complete()

    # -- batching interface -------------------------------------------

    def size(self) -> int:
        return len(self.segments)

    def cached(self, index: int) -> bool:
        return self.histories[index] is not None

    def word_count(self, index: int) -> int:
        return len(self.segments[index])

    def segment(self, index: int) -> List[int]:
        return self.segments[index]

    def progress(self):
        """((words done, words total), (segments done, segments total))."""
        with self._lock:
            words = (self._words_complete, self.words_total)
            segments = (len(self.segments) - self._counter, len(self.segments))
        return words, segments

    # -- completion ----------------------------------------------------

    def process(self, index: int, history: History) -> None:
        """Record one finished segment; may fire completion
        (slimt/Request.cc:114-134). A request that already failed
        (another batch errored) never completes: its future holds the
        exception, and firing the continuation would set_result on a
        resolved future and poison the whole completing batch."""
        finished = False
        with self._lock:
            if self.failed is not None:
                return
            self.histories[index] = history
            self._words_complete += len(self.segments[index])
            self._counter -= 1
            finished = self._counter == 0
        if self.cache is not None:
            self.cache.store(self._keys[index], history)
        if finished:
            self._complete()

    def fail(self, exc: BaseException) -> None:
        """Propagate a worker-side failure to the requester (no
        reference equivalent — the reference aborts the process)."""
        with self._lock:
            if self.failed is not None:
                return
            self.failed = exc
        if self.on_error is not None:
            try:
                self.on_error(exc)
            except Exception:  # e.g. future already resolved
                pass

    def _complete(self) -> None:
        """Assemble the Response: decode every history, rebuild the
        target AnnotatedText preserving inter-sentence gaps
        (slimt/Request.cc:136-170)."""
        assert self.source.sentence_count() == len(self.histories)
        response = Response()
        response.source = self.source
        target = response.target

        for sentence_id, history in enumerate(self.histories):
            if history.decoded is not None:
                # Batched-decode fast path (Batch.complete): bytes +
                # end offsets go straight into the annotation, no
                # per-token string objects or str round-trips.
                data, ends = history.decoded
                target.append_sentence_raw(
                    self.source.gap_data(sentence_id), data, ends
                )
            else:
                words = history.target
                decoded, views = self.vocabulary.decode(
                    words, ignore_eos=False
                )
                data = decoded.encode("utf-8")
                if len(data) == len(decoded):  # ASCII: bytes == chars
                    tokens = [decoded[b:e] for b, e in views]
                else:
                    tokens = [
                        data[b:e].decode("utf-8", errors="replace")
                        for b, e in views
                    ]
                target.append_sentence(
                    self.source.gap_text(sentence_id), tokens
                )
            if sentence_id + 1 == len(self.histories):
                target.append_ending_whitespace_data(
                    self.source.gap_data(sentence_id + 1)
                )
            response.alignments.append(history.alignment)

        self.next = self.continuation(response)
