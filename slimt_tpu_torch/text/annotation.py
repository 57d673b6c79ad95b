"""Byte-range token/sentence annotation over a flat string.

Reimplements the reference's Annotation/AnnotatedText
(slimt/Annotation.hh:40-261, slimt/Annotation.cc) semantics:

  - text is a sequence:  gap sentence gap sentence ... gap
    (always one more gap than sentences; gaps may be empty)
  - `token_begin[i]` is the byte offset where token i begins; the list
    has one trailing entry so [token_begin[i], token_begin[i+1]) is
    always valid
  - `gap[s]` indexes the token that is the whitespace gap before
    sentence s

Offsets are byte offsets into the UTF-8 encoding of the text
(Encoding.BYTE) and can be converted to codepoint offsets
(Encoding.UTF8) like the reference's `to(Encoding)`
(slimt/Annotation.cc:83-164).
"""

from __future__ import annotations

import enum
from typing import Iterable, List, NamedTuple, Sequence, Tuple


class Encoding(enum.Enum):
    BYTE = "byte"
    UTF8 = "utf8"


class Range(NamedTuple):
    begin: int
    end: int

    @property
    def size(self) -> int:
        return self.end - self.begin


class AnnotatedText:
    """Owns the text (as UTF-8 bytes) plus its annotation."""

    def __init__(self, text: str = ""):
        self._data = bytearray(text.encode("utf-8"))
        # Empty text = a single (possibly whole-text) gap
        # (slimt/Annotation.hh:43-47, Annotation.cc:15-18).
        self.token_begin: List[int] = [0, len(self._data)]
        self.gap: List[int] = [0]
        self.encoding = Encoding.BYTE

    @classmethod
    def from_arrays(cls, data, token_begin, gap) -> "AnnotatedText":
        """Columnar fast path: adopt pre-built annotation arrays (the
        native ingest/assemble emit token_begin/gap in exactly the
        record_contiguous_sentence / append_sentence_raw layout).
        `data` may be a bytes-like view and `token_begin`/`gap` numpy
        views — all three are adopted LAZILY and only materialized on
        first access (__getattr__ below), so a Response whose
        text/annotations are never inspected pays nothing."""
        out = cls.__new__(cls)
        out.encoding = Encoding.BYTE
        out._lazy = (data, token_begin, gap)
        return out

    def __getattr__(self, name):
        # Only consulted when normal lookup fails — i.e. exactly for
        # _data/token_begin/gap on a from_arrays instance before use.
        if name not in ("_data", "token_begin", "gap"):
            raise AttributeError(name)
        lazy = self.__dict__.get("_lazy")
        if lazy is None:
            # Another thread finished materializing between our failed
            # lookup and here — the attribute exists now.
            try:
                return self.__dict__[name]
            except KeyError:
                raise AttributeError(name) from None
        # Materialize idempotently (read, assign all three, THEN drop
        # _lazy) so a concurrent first access from another thread can
        # never observe a popped _lazy with the attributes unset.
        data, token_begin, gap = lazy
        self._data = data if isinstance(data, bytearray) else bytearray(data)
        self.token_begin = (
            token_begin
            if isinstance(token_begin, list)
            else token_begin.tolist()
        )
        self.gap = gap if isinstance(gap, list) else gap.tolist()
        self.__dict__.pop("_lazy", None)
        return getattr(self, name)

    # -- content access ------------------------------------------------

    @property
    def text(self) -> str:
        return self._data.decode("utf-8", errors="replace")

    @property
    def data(self) -> bytes:
        return bytes(self._data)

    def sentence_count(self) -> int:
        return len(self.gap) - 1

    def word_count(self, sentence_id: int) -> int:
        return self.gap[sentence_id + 1] - self.gap[sentence_id] - 1

    def word_as_range(self, sentence_id: int, word_id: int) -> Range:
        token_idx = self.gap[sentence_id] + 1 + word_id
        return Range(self.token_begin[token_idx], self.token_begin[token_idx + 1])

    def sentence_as_range(self, sentence_id: int) -> Range:
        return Range(
            self.token_begin[self.gap[sentence_id] + 1],
            self.token_begin[self.gap[sentence_id + 1]],
        )

    def gap_as_range(self, gap_idx: int) -> Range:
        token_idx = self.gap[gap_idx]
        return Range(self.token_begin[token_idx], self.token_begin[token_idx + 1])

    def _view(self, range_: Range) -> str:
        if self.encoding == Encoding.BYTE:
            return self._data[range_.begin : range_.end].decode(
                "utf-8", errors="replace"
            )
        chars = self._data.decode("utf-8")
        return chars[range_.begin : range_.end]

    def word(self, sentence_id: int, word_id: int) -> str:
        return self._view(self.word_as_range(sentence_id, word_id))

    def sentence(self, sentence_id: int) -> str:
        return self._view(self.sentence_as_range(sentence_id))

    def gap_text(self, gap_idx: int) -> str:
        return self._view(self.gap_as_range(gap_idx))

    def gap_data(self, gap_idx: int) -> bytes:
        """Raw bytes of a gap (no str decode) — completion fast path;
        only valid while encoding is BYTE."""
        assert self.encoding == Encoding.BYTE
        token_idx = self.gap[gap_idx]
        return bytes(
            self._data[self.token_begin[token_idx] : self.token_begin[token_idx + 1]]
        )

    def words(self, sentence_id: int) -> List[str]:
        return [
            self.word(sentence_id, w) for w in range(self.word_count(sentence_id))
        ]

    # -- construction --------------------------------------------------

    def append_sentence(self, prefix: str, tokens: Sequence[str]) -> None:
        """Append gap text then a sentence of contiguous tokens
        (slimt/Annotation.cc:20-43)."""
        assert self.token_begin[-1] == len(self._data)
        self.append_ending_whitespace(prefix)

        offset = len(self._data)
        encoded = [t.encode("utf-8") for t in tokens]
        self._data += b"".join(encoded)
        begins = self.token_begin
        for chunk in encoded:
            offset += len(chunk)
            begins.append(offset)
        self.gap.append(len(begins) - 1)
        begins.append(offset)

    def append_sentence_raw(
        self, prefix: bytes, data: bytes, ends: Sequence[int]
    ) -> None:
        """append_sentence for an already-decoded sentence: `prefix`
        (gap) and `data` are UTF-8 bytes, `ends[i]` the end offset of
        token i within `data` (tokens contiguous from 0 — the
        Vocabulary.decode_batch contract). Skips building per-token
        string objects and str round-trips."""
        assert self.token_begin[-1] == len(self._data)
        self.append_ending_whitespace_data(prefix)

        offset = len(self._data)
        self._data += data
        begins = self.token_begin
        begins.extend(offset + e for e in ends)
        self.gap.append(len(begins) - 1)
        begins.append(offset + (ends[-1] if len(ends) else 0))

    def append_ending_whitespace(self, whitespace: str) -> None:
        self._data += whitespace.encode("utf-8")
        self.token_begin[-1] = len(self._data)

    def append_ending_whitespace_data(self, whitespace: bytes) -> None:
        if whitespace:
            self._data += whitespace
            self.token_begin[-1] = len(self._data)

    def record_contiguous_sentence(
        self, begins: Sequence[int], end: int
    ) -> None:
        """record_existing_sentence for tokens already verified to tile
        contiguously (the Vocabulary.encode_batch_begins contract):
        `begins[i]` is the byte offset of token i, `end` the end of the
        last token; a zero-width EOS pseudo-token is appended at `end`.
        Equivalent to record_existing_sentence(ranges + [(end, end)], …)
        without building per-token range tuples. `begins` must be
        non-empty."""
        assert begins, "record_contiguous_sentence requires tokens"
        assert self.token_begin[-1] == len(self._data)
        tb = self.token_begin
        tb[-1:] = begins
        tb.append(end)  # zero-width EOS begin
        self.gap.append(len(tb))
        tb.append(end)
        tb.append(len(self._data))

    def record_existing_sentence(
        self, token_ranges: Sequence[Tuple[int, int]], sentence_begin: int
    ) -> None:
        """Record a sentence whose tokens are already in the text, as
        contiguous byte ranges (slimt/Annotation.cc:53-81)."""
        assert self.token_begin[-1] == len(self._data)
        if token_ranges:
            size = len(self._data)
            prev_end = token_ranges[0][0]
            for begin, end in token_ranges:
                assert 0 <= begin <= end <= size
                assert begin == prev_end, "tokens must be contiguous"
                prev_end = end
        self.token_begin[-1:] = (b for b, _ in token_ranges)
        self.gap.append(len(self.token_begin))
        if token_ranges:
            self.token_begin.append(token_ranges[-1][1])
        else:
            self.token_begin.append(sentence_begin)
        self.token_begin.append(len(self._data))

    # -- encoding conversion ------------------------------------------

    def to(self, encoding: Encoding) -> None:
        """Re-encode offsets between byte and codepoint indices
        (slimt/Annotation.cc:83-164)."""
        if encoding == self.encoding:
            return
        # Build byte-offset → codepoint-offset maps over UTF-8 starts.
        starts = [
            i
            for i, b in enumerate(self._data)
            if (b & 0xC0) != 0x80  # not a continuation byte
        ]
        starts.append(len(self._data))
        if self.encoding == Encoding.BYTE:
            byte_to_cp = {b: cp for cp, b in enumerate(starts)}
            self.token_begin = [byte_to_cp[b] for b in self.token_begin]
            self.encoding = Encoding.UTF8
        else:
            self.token_begin = [starts[cp] for cp in self.token_begin]
            self.encoding = Encoding.BYTE

    # -- transformation ------------------------------------------------

    def apply(self, fun) -> "AnnotatedText":
        """Token-rewriter used by HTML restore
        (slimt/Annotation.hh:218-254): fun(range, text, is_last) → new
        token text; returns a rebuilt AnnotatedText."""
        out = AnnotatedText()
        for s in range(self.sentence_count()):
            prefix = fun(self.gap_as_range(s), self.gap_text(s), False)
            tokens = [
                fun(self.word_as_range(s, w), self.word(s, w), False)
                for w in range(self.word_count(s))
            ]
            out.append_sentence(prefix, tokens)
        out.append_ending_whitespace(
            fun(
                self.gap_as_range(self.sentence_count()),
                self.gap_text(self.sentence_count()),
                True,
            )
        )
        return out

    def __repr__(self) -> str:
        return (
            f"AnnotatedText({self.text!r}, sentences={self.sentence_count()})"
        )
