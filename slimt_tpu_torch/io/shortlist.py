"""Marian binary lexical shortlist: reader, writer, and generator.

File layout (slimt/Shortlist.hh:41-89, slimt/Shortlist.cc:41-113):

    u64 magic      (0xF11A48D5013417F5)
    u64 checksum   (hash over every u64 word from `frequent` to EOF)
    u64 frequent   (top-N frequent target words always included)
    u64 best       (per-source-word translation candidates)
    u64 word_to_offset_size
    u64 shortlist_size
    u64 word_to_offset[word_to_offset_size]   (skiplist into shortlist)
    u32 shortlist[shortlist_size]             (target word ids)

The checksum is the reference's hash_bytes/hash_combine fold
(slimt/Utils.hh:47-67) — boost-style combine with std::hash (identity
for integers on libstdc++), folded over 64-bit words.

`generate(words)` reproduces ShortlistGenerator::generate
(slimt/Shortlist.cc:115-175): union of top-`frequent` target words and
per-source-word candidates, padded to a multiple of 8 by turning on
additional target words, emitted sorted ascending.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

MAGIC = 0xF11A48D5013417F5
_MASK = (1 << 64) - 1
ALIGNMENT = 8  # kVExtAlignment: pad selected vocab to multiple of 8


def hash_combine(seed: int, value: int) -> int:
    """boost::hash_combine with identity hash (slimt/Utils.hh:47-57)."""
    return (
        seed
        ^ (value + 0x9E3779B9 + ((seed << 6) & _MASK) + (seed >> 2))
    ) & _MASK


def hash_words(words: Sequence[int]) -> int:
    seed = 0
    for word in words:
        seed = hash_combine(seed, int(word))
    return seed


class ShortlistGenerator:
    def __init__(
        self,
        blob: bytes,
        vocab_size: int,
        shared: bool = False,
        check: bool = True,
    ):
        header = struct.unpack_from("<6Q", blob, 0)
        magic, checksum, frequent, best, w2o_size, sl_size = header
        if magic != MAGIC:
            raise ValueError("incorrect magic in binary shortlist")
        expected = 48 + w2o_size * 8 + sl_size * 4
        if expected != len(blob):
            raise ValueError(
                f"shortlist header claims {expected} bytes, file is {len(blob)}"
            )
        if check:
            n_words = (len(blob) - 16) // 8
            words = np.frombuffer(blob, dtype="<u8", count=n_words, offset=16)
            if hash_words(words) != checksum:
                raise ValueError("shortlist checksum failed: corrupted file")

        self.frequent = frequent
        self.best = best
        self.word_to_offset = np.frombuffer(
            blob, dtype="<u8", count=w2o_size, offset=48
        )
        self.shortlist = np.frombuffer(
            blob, dtype="<u4", count=sl_size, offset=48 + w2o_size * 8
        )
        self.vocab_size = vocab_size

        if check:
            if (self.word_to_offset[:-1] >= sl_size).any() and sl_size > 0:
                raise ValueError("offset table not within shortlist size")
            if w2o_size and self.word_to_offset[-1] != sl_size:
                raise ValueError("word_to_offset[-1] != shortlist_size")
            if sl_size and (self.shortlist >= vocab_size).any():
                raise ValueError("shortlist indices out of bounds")

        self.shared = shared

    def generate(self, words: Sequence[int]) -> np.ndarray:
        """Sorted candidate target ids for a batch's source words."""
        target = np.zeros(self.vocab_size, dtype=bool)
        target[: min(self.frequent, self.vocab_size)] = True
        seen = set()
        for word in words:
            word = int(word)
            if self.shared:
                target[word] = True
            if word in seen or word + 1 >= len(self.word_to_offset):
                continue
            seen.add(word)
            begin = int(self.word_to_offset[word])
            end = int(self.word_to_offset[word + 1])
            target[self.shortlist[begin:end]] = True

        # pad to a multiple of 8 by enabling further target words
        # (slimt/Shortlist.cc:147-164)
        ones = int(target.sum())
        i = self.frequent
        while i < self.vocab_size and ones % ALIGNMENT != 0:
            if not target[i]:
                target[i] = True
                ones += 1
            i += 1
        return np.flatnonzero(target).astype(np.uint32)

    def generate_padded(
        self, words: Sequence[int], bucket: int
    ) -> np.ndarray:
        """Like generate() but padded up to a multiple of `bucket` with
        additional (unused) target ids — a few stable shapes."""
        return self.pad(self.generate(words), bucket)

    def pad(self, indices: np.ndarray, bucket: int) -> np.ndarray:
        """generate()'s `indices` padded as generate_padded pads them (a
        caller that needs both widths generates once)."""
        want = -(-len(indices) // bucket) * bucket
        want = min(want, self.vocab_size)
        if want > len(indices):
            mask = np.ones(self.vocab_size, dtype=bool)
            mask[indices] = False
            extra = np.flatnonzero(mask)[: want - len(indices)]
            indices = np.sort(
                np.concatenate([indices, extra.astype(np.uint32)])
            )
        return indices


def write_shortlist(
    word_to_offset: Sequence[int],
    shortlist: Sequence[int],
    frequent: int = 100,
    best: int = 100,
) -> bytes:
    """Serialize in the marian binary layout (valid checksum)."""
    body = struct.pack("<4Q", frequent, best, len(word_to_offset), len(shortlist))
    body += np.asarray(word_to_offset, dtype="<u8").tobytes()
    body += np.asarray(shortlist, dtype="<u4").tobytes()
    n_words = len(body) // 8
    words = np.frombuffer(body, dtype="<u8", count=n_words)
    checksum = hash_words(words)
    return struct.pack("<2Q", MAGIC, checksum) + body


def build_synthetic_shortlist(
    vocab_size: int, best: int = 4, frequent: int = 16, seed: int = 0
) -> bytes:
    """Random but valid shortlist for tests/benchmarks."""
    rng = np.random.default_rng(seed)
    offsets = [0]
    entries: List[int] = []
    for _ in range(vocab_size):
        cands = rng.integers(0, vocab_size, best)
        entries.extend(int(c) for c in cands)
        offsets.append(len(entries))
    return write_shortlist(offsets, entries, frequent=frequent, best=best)
