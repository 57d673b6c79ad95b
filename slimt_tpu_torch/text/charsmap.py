"""Precompiled charsmap (sentencepiece NormalizerSpec) reader.

The blob is a darts-clone double-array trie mapping byte sequences to
replacement strings in a NUL-separated pool:

    u32 trie_size_bytes | trie units (u32 each) | replacement pool

Normalization follows sentencepiece's Normalizer::NormalizePrefix
(slimt's vocabulary dependency, slimt/Vocabulary.cc:24-27): at each
position apply the LONGEST trie match, else copy one UTF-8 character
unchanged. (HF tokenizers' Precompiled normalizes grapheme-by-grapheme
instead — a documented quirk of its reimplementation; the two agree on
single-grapheme rules, which is what real charsmaps like nmt_nfkc
contain.) The native C++ backend implements the same traversal
(native/slimt_host.cpp Charsmap); this module is the pure-Python
fallback, parity-tested against it.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple


class Charsmap:
    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("charsmap blob too short")
        (trie_bytes,) = struct.unpack_from("<I", blob, 0)
        if 4 + trie_bytes > len(blob) or trie_bytes % 4:
            raise ValueError("malformed charsmap blob")
        self.units = memoryview(blob)[4 : 4 + trie_bytes].cast("I")
        self.pool = bytes(memoryview(blob)[4 + trie_bytes :])

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & 0x200) >> 6)

    def longest(self, data: bytes, pos: int) -> Tuple[int, Optional[bytes]]:
        """Longest match at data[pos:]; (byte length, replacement
        bytes) or (0, None)."""
        units = self.units
        n = len(units)
        node = self._offset(units[0])
        best_len = 0
        best_val = -1
        for i in range(pos, len(data)):
            nxt = node ^ data[i]
            if nxt >= n:
                break
            unit = units[nxt]
            if (unit & 0x800000FF) != data[i]:
                break
            node = nxt ^ self._offset(unit)
            if (unit & 0x100) and node < n:
                best_len = i - pos + 1
                best_val = units[node] & 0x7FFFFFFF
        if best_len == 0:
            return 0, None
        end = self.pool.find(b"\0", best_val)
        if end < 0:
            end = len(self.pool)
        return best_len, self.pool[best_val:end]

    def apply(self, data: bytes) -> Tuple[bytes, List[int]]:
        """Normalize `data`; returns (output bytes, per-output-byte
        offset of the consumed chunk's start in `data`) — the
        sentencepiece streaming algorithm."""
        out = bytearray()
        align: List[int] = []
        i = 0
        n = len(data)
        while i < n:
            length, rep = self.longest(data, i)
            if length:
                out += rep
                align.extend([i] * len(rep))
                i += length
            else:
                b = data[i]
                if b < 0x80:
                    step = 1
                elif b & 0xE0 == 0xC0:
                    step = 2
                elif b & 0xF0 == 0xE0:
                    step = 3
                elif b & 0xF8 == 0xF0:
                    step = 4
                else:
                    step = 1
                if i + step > n:
                    step = 1
                out += data[i : i + step]
                align.extend([i] * step)
                i += step
        return bytes(out), align
