"""Moses-compatible sentence splitter.

Port of the reference's PCRE2-based splitter semantics
(slimt/Splitter.cc:139-240) to the Python `regex` engine (which
supports \\p{} classes and possessive quantifiers like PCRE2):

  - a chunker regex finds candidate end-of-sentence punctuation
    (including CJK/Armenian full stops);
  - heuristics on the following text decide break vs no-break:
    lowercase continuation → no break; uppercase after a nonbreaking
    prefix or single-letter abbreviation → no break; digit after a
    NUMERIC_ONLY prefix → no break; in-text "[...]" ellipsis → no
    break;
  - nonbreaking-prefix lists ("etc." class 1, "No." # NUMERIC_ONLY #
    class 2) loaded from Moses prefix files
    (slimt/Splitter.cc:31-53).

SentenceStream reproduces the three iteration modes
{OneSentencePerLine, OneParagraphPerLine, WrappedText}
(slimt/Splitter.cc:307-373).
"""

from __future__ import annotations

import enum
from typing import Iterator, List, Optional, Tuple

import regex

# \R equivalent: any Unicode newline sequence.
_NEWLINE = r"(?:\r\n|[\n\v\f\r\x85  ])"

_CHUNKER = regex.compile(
    r"\s*"  # whitespace
    r"[^.?!։。？！]*?"  # non-EOS stuff (lazy)
    r"([\p{L}\p{Lo}\p{N}]*)"  # 1: alphanumeric prefix of potential EOS
    r"([.?!։。？！]++)"  # 2: the potential EOS marker
    r"("  # 3: trailing matter
    r"['\")\]’”\p{Pf}]*"
    r"(?:\[[\p{Nd}]+[\p{Nd},\s]*[\p{Nd}]\])?"  # footnote?
    r"['\")\]’”\p{Pf}]*"
    r")"
    r"(\s*)"  # 4: whitespace after
    r"(?="  # look-ahead
    r"([^\s\p{L}\p{Lo}\p{N}\p{M}\p{S}]*)"  # 5: sentence-initial punct
    r"\s*"
    r"([\p{L}\p{Lo}\p{M}\p{N}]*)"  # 6: leading letters/digits
    r")",
    regex.DOTALL,
)

_LOWERCASE = regex.compile(r"\p{M}*\p{Ll}")
_UPPERCASE = regex.compile(r"\p{M}*[\p{Lu}\p{Lt}]")
_DIGIT = regex.compile(r"[\p{Nd}\p{Nl}]")
_LETTER_OTHER = regex.compile(r"\p{M}*\p{Lo}")

_PREFIX_LINE = regex.compile(r"([^#\s]*)\s*(?:(#\s*NUMERIC_ONLY\s*#))?")
_LAST_TOKEN = regex.compile(r".*\s([^\s]*)", regex.DOTALL)

# no ^ anchor: used with .match(span, pos), which anchors at pos
_SINGLE_LINE = regex.compile(r"\s*(.*)" + _NEWLINE + r"+\s*")

_CJK_EOS = ("。", "！", "？")


def single_line(span: str) -> str:
    """Collapse line breaks to single spaces
    (slimt/Splitter.cc:85-105)."""
    out = []
    pos = 0
    while True:
        m = _SINGLE_LINE.match(span, pos)
        if not m:
            break
        out.append(m.group(1))
        out.append(" ")
        pos = m.end()
    out.append(span[pos:])
    return "".join(out)


class Splitter:
    """Sentence splitter with nonbreaking-prefix heuristics."""

    def __init__(self, prefixes: Optional[str] = None):
        # prefix → class: 1 = always nonbreaking, 2 = NUMERIC_ONLY
        self.prefix_type = {}
        if prefixes:
            self.load_from_serialized(prefixes)

    def load_from_serialized(self, data: str) -> None:
        for line in data.splitlines():
            self.declare_prefix(line)

    def load(self, path: str) -> None:
        with open(path, encoding="utf-8") as f:
            self.load_from_serialized(f.read())

    def declare_prefix(self, line: str) -> None:
        m = _PREFIX_LINE.match(line)
        if m and m.group(1):
            self.prefix_type[m.group(1)] = 2 if m.group(2) else 1

    def get_prefix_class(self, piece: str) -> int:
        m = _LAST_TOKEN.fullmatch(piece)
        if m:
            piece = m.group(1)
        return self.prefix_type.get(piece, 0)

    def next_sentence(self, text: str, pos: int, end: int) -> Tuple[str, int]:
        """Extract the next sentence from text[pos:end].

        Returns (sentence, new_pos); new_pos == end signals exhaustion.
        Mirrors Splitter::operator() (slimt/Splitter.cc:125-240)."""
        # consume leading whitespace
        while pos < end and text[pos].isspace():
            pos += 1
        snt_start = pos
        snt_end = end
        cursor = pos
        matched = False
        while True:
            m = _CHUNKER.match(text, cursor, end)
            if not m:
                break
            cursor = m.end()
            prefix = m.group(1)
            punct = m.group(2)
            tail = m.group(3)
            ws_after = m.group(4)
            following = m.group(6)

            # whitespace required after the marker except ideographic
            # full-width stops
            if not ws_after and punct not in _CJK_EOS:
                continue
            if _LETTER_OTHER.match(following):
                pass  # letter-other does not suppress the break
            elif _LOWERCASE.match(following):
                continue  # followed by lowercase → no break
            elif _UPPERCASE.match(following):
                if punct == "." and self.get_prefix_class(prefix) != 0:
                    continue  # nonbreaking prefix
                if len(punct) == 1 and snt_end < len(text) and text[snt_end] == ".":
                    continue  # abbreviation a.b.c (as-written reference check)
            elif _DIGIT.match(following):
                if punct == "." and self.get_prefix_class(prefix) == 2:
                    continue  # NUMERIC_ONLY prefix before a number
            else:
                # in-text ellipsis "[...]"
                punct_start = m.start(2)
                if (
                    punct == "..."
                    and punct_start - m.start() > 1
                    and tail == "]"
                    and text[punct_start - 1] == "["
                ):
                    continue
            snt_end = m.start(4)  # sentence ends before the whitespace
            matched = True
            break

        if not matched:
            # last sentence: right-trim and exhaust
            sentence = text[snt_start:end].rstrip()
            return sentence, end
        return text[snt_start:snt_end], cursor

    def split(self, text: str) -> List[str]:
        """All sentences of a paragraph."""
        out = []
        pos, end = 0, len(text)
        while pos < end:
            sentence, pos = self.next_sentence(text, pos, end)
            if sentence:
                out.append(sentence)
        return out


class SplitMode(enum.Enum):
    ONE_SENTENCE_PER_LINE = "sentence"
    ONE_PARAGRAPH_PER_LINE = "paragraph"
    WRAPPED_TEXT = "wrapped_text"


def _read_line(text: str, pos: int) -> Tuple[Optional[str], int]:
    """(line without EOL/CR, new_pos); None at end
    (slimt/Splitter.cc:258-271)."""
    if pos >= len(text):
        return None, pos
    nl = text.find("\n", pos)
    if nl == -1:
        line_end, new_pos = len(text), len(text)
    else:
        line_end, new_pos = nl, nl + 1
    while line_end > pos and text[line_end - 1] == "\r":
        line_end -= 1
    return text[pos:line_end], new_pos


def _read_paragraph(text: str, pos: int) -> Tuple[Optional[str], int]:
    """Paragraph = text up to a blank line (slimt/Splitter.cc:277-299)."""
    if pos >= len(text):
        return None, pos
    c = pos
    n = len(text)
    while True:
        nl = text.find("\n", c)
        if nl == -1:
            c = n
            d = n
            break
        d = nl + 1
        while d < n and text[d] in "\n\r":
            d += 1
        if d > nl + 1 or d >= n:
            c = nl
            break
        c = nl + 1
    end = c
    while end > pos and text[end - 1] == "\r":
        end -= 1
    return text[pos:end], (d if d < n else n)


class SentenceStream:
    """Iterates sentences in one of three modes; in paragraph modes an
    empty yield marks a paragraph boundary (slimt/Splitter.cc:340-366).
    Yields (sentence_text, begin, end) spans into the original text.

    Note: sentences are NOT newline-collapsed — the reference's
    TextProcessor consumes the string_view extraction path, which
    skips single_line (slimt/TextProcessor.cc:104 uses
    `operator>>(string_view&)`; only the std::string overload
    collapses, Splitter.cc:368-372). `single_line` is provided for
    callers that want the collapsed form."""

    def __init__(self, text: str, splitter: Splitter, mode: SplitMode):
        self.text = text
        self.splitter = splitter
        self.mode = mode

    def __iter__(self) -> Iterator[Tuple[str, int, int]]:
        text = self.text
        if self.mode == SplitMode.ONE_SENTENCE_PER_LINE:
            pos = 0
            while True:
                start = pos
                line, pos = _read_line(text, pos)
                if line is None:
                    return
                yield line, start, start + len(line)
        else:
            reader = (
                _read_line
                if self.mode == SplitMode.ONE_PARAGRAPH_PER_LINE
                else _read_paragraph
            )
            pos = 0
            while True:
                start = pos
                para, pos = reader(text, pos)
                if para is None:
                    return
                ppos, pend = 0, len(para)
                while ppos < pend:
                    before = ppos
                    sentence, ppos = self.splitter.next_sentence(
                        para, ppos, pend
                    )
                    if sentence:
                        begin = para.find(sentence, before)
                        yield sentence, start + begin, start + begin + len(
                            sentence
                        )
                # paragraph boundary marker
                yield "", pos, pos
