"""Lightweight HTML/XML tokenizer.

Python equivalent of the reference's zero-copy XHScanner
(slimt/XHScanner.{hh,cc}) with the same token semantics:

  ("text", value)            — body text, entities resolved
  ("tag_start", name, attrs) — attrs preformatted as ' k="v"' pairs
  ("tag_end", name)
  ("comment", data)
  ("pi", data)               — <?...?> processing instruction
  ("doctype", data)          — <!...> declaration
  ("data", raw)              — raw content of special elements

Special elements (script/style/textarea/iframe/noembed/noscript/
noframes — XHScanner.cc:123-135) have their attributes parsed but
their content emitted raw as a single "data" token followed by the
closing "tag_end".

Entity resolution matches the reference's minimal set
(XHScanner.cc:303-345): lt gt amp quot apos nbsp (+ numeric
references).
"""

from __future__ import annotations

import re
from typing import Iterator, List, Tuple

SPECIAL_TAGS = frozenset(
    ("script", "style", "textarea", "iframe", "noembed", "noscript", "noframes")
)

_ENTITIES = {
    "&lt;": "<",
    "&gt;": ">",
    "&amp;": "&",
    "&quot;": '"',
    "&apos;": "'",
    "&nbsp;": " ",
}

_ENTITY_RE = re.compile(r"&(?:#[0-9]+|#x[0-9a-fA-F]+|[a-zA-Z]+);")
_TAG_NAME_RE = re.compile(r"[a-zA-Z][a-zA-Z0-9:_-]*")
_ATTR_RE = re.compile(
    r"\s*([^\s=/>]+)(?:\s*=\s*(\"[^\"]*\"|'[^']*'|[^\s>]*))?"
)


def _resolve_entity(match: re.Match) -> str:
    entity = match.group(0)
    if entity in _ENTITIES:
        return _ENTITIES[entity]
    if entity.startswith("&#"):
        try:
            code = (
                int(entity[3:-1], 16)
                if entity[2] in "xX"
                else int(entity[2:-1])
            )
            if 0xD800 <= code <= 0xDFFF or code > 0x10FFFF:
                return entity  # lone surrogate: not encodable utf-8
            return chr(code)
        except (ValueError, OverflowError):
            return entity
    return entity  # unknown named entity: keep as-is (XHScanner.cc:298-300)


def decode_entities(text: str) -> str:
    return _ENTITY_RE.sub(_resolve_entity, text)


class BadHTML(ValueError):
    """Malformed-markup error for the whole HTML pipeline (scanner and
    extractor), the analog of the reference's BadHTML exception."""


class ScanError(BadHTML):
    pass


def _fold(markup: str) -> str:
    """Length-preserving lowercase for case-insensitive tag searches:
    str.lower() can CHANGE LENGTH (e.g. 'İ' → 'i̇'), which would
    desynchronize indices between the folded and original strings."""
    lower = markup.lower()
    if len(lower) == len(markup):
        return lower
    return "".join(
        c.lower() if len(c.lower()) == 1 else c for c in markup
    )


def _find_matching_close(lower: str, pos: int, name: str) -> int:
    """Find the start of the close tag for `name` from `pos` in the
    length-preserving folded markup, counting nested same-name
    elements (reference consume_ignored_tag, slimt/HTML.cc:279-356).
    Returns -1 if not found."""
    name = name.lower()
    depth = 1
    cursor = pos
    open_re = re.compile(r"<" + re.escape(name) + r"[\s>/]")
    close = f"</{name}>"
    while depth:
        nxt_close = lower.find(close, cursor)
        if nxt_close == -1:
            return -1
        m = open_re.search(lower, cursor, nxt_close)
        if m:
            depth += 1
            cursor = m.end()
        else:
            depth -= 1
            cursor = nxt_close + len(close)
            if depth == 0:
                return nxt_close
    return -1


def scan(markup: str, raw_nested: frozenset = frozenset()) -> Iterator[Tuple]:
    """Tokenize; elements named in `raw_nested` have their content
    (nesting-aware) emitted as a raw "data" token."""
    pos = 0
    n = len(markup)
    lower = None  # folded copy, built lazily on first special element
    while pos < n:
        lt = markup.find("<", pos)
        if lt == -1:
            yield ("text", decode_entities(markup[pos:]))
            return
        if lt > pos:
            yield ("text", decode_entities(markup[pos:lt]))
        pos = lt
        if markup.startswith("<!--", pos):
            end = markup.find("-->", pos + 4)
            if end == -1:
                raise ScanError("unterminated comment")
            yield ("comment", markup[pos + 4 : end])
            pos = end + 3
        elif markup.startswith("<?", pos):
            end = markup.find("?>", pos + 2)
            if end == -1:
                raise ScanError("unterminated processing instruction")
            yield ("pi", markup[pos + 2 : end])
            pos = end + 2
        elif markup.startswith("<!", pos):
            # <!DOCTYPE ...> and friends: re-emitted as <!...>
            end = markup.find(">", pos + 2)
            if end == -1:
                raise ScanError("unterminated <! declaration")
            yield ("doctype", markup[pos + 2 : end])
            pos = end + 1
        elif markup.startswith("</", pos):
            m = _TAG_NAME_RE.match(markup, pos + 2)
            if not m:
                raise ScanError(f"bad closing tag at {pos}")
            end = markup.find(">", m.end())
            if end == -1:
                raise ScanError("unterminated closing tag")
            yield ("tag_end", m.group(0))
            pos = end + 1
        else:
            m = _TAG_NAME_RE.match(markup, pos + 1)
            if not m:
                # stray '<' — treat as text like forgiving parsers do
                yield ("text", "<")
                pos += 1
                continue
            name = m.group(0)
            cursor = m.end()
            attrs_parts: List[str] = []
            self_closing = False
            while cursor < n:
                if markup[cursor] == ">":
                    cursor += 1
                    break
                if markup.startswith("/>", cursor):
                    self_closing = True
                    cursor += 2
                    break
                am = _ATTR_RE.match(markup, cursor)
                if not am or am.end() == cursor:
                    raise ScanError(f"bad attribute at {cursor}")
                attr = am.group(1)
                raw = am.group(2)
                if raw is None:
                    value = ""
                elif raw[:1] in "\"'":
                    value = raw[1:-1]
                else:
                    value = raw
                # Keep the attribute text RAW (entities included) so
                # re-emitting the tag reproduces well-formed markup —
                # decoding here without re-escaping would let a
                # decoded quote terminate the attribute early
                # (reference XHScanner keeps attribute bytes raw).
                attrs_parts.append(f' {attr}="{value}"')
                cursor = am.end()
            else:
                raise ScanError("unterminated open tag")
            yield ("tag_start", name, "".join(attrs_parts))
            pos = cursor
            if self_closing:
                yield ("tag_end", name)
            elif name.lower() in SPECIAL_TAGS:
                if lower is None:
                    lower = _fold(markup)
                close = f"</{name.lower()}>"
                idx = lower.find(close, pos)
                if idx == -1:
                    raise ScanError(f"did not find closing tag {close}")
                yield ("data", markup[pos:idx])
                yield ("tag_end", name)
                pos = idx + len(close)
            elif name.lower() in raw_nested:
                if lower is None:
                    lower = _fold(markup)
                idx = _find_matching_close(lower, pos, name)
                if idx == -1:
                    raise ScanError(f"did not find closing tag </{name}>")
                yield ("data", markup[pos:idx])
                yield ("tag_end", name)
                end = markup.find(">", idx)
                if end == -1:
                    raise ScanError(f"unterminated closing tag </{name}>")
                pos = end + 1
