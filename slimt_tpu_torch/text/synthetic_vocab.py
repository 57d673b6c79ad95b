"""Build small sentencepiece-compatible vocabularies for tests/benchmarks.

Real Bergamot models ship trained .spm vocabularies; this builds a
deterministic unigram model over a word list (word pieces + character
fallback) serialized as a ModelProto, so the full pipeline — proto
parse, Viterbi/HF segmentation, annotation ranges — runs identically
to production.

Id layout follows marian vocab convention: </s> = 0 (eos), <unk> = 1.
"""

from __future__ import annotations

import math
from typing import Iterable, List

from slimt_tpu_torch.text import spm_proto
from slimt_tpu_torch.text.spm_proto import (
    PIECE_CONTROL,
    PIECE_NORMAL,
    PIECE_UNKNOWN,
    Piece,
    SpmModel,
)
from slimt_tpu_torch.text.vocabulary import SPACE, Vocabulary


def build_spm_model(
    words: Iterable[str], target_size: int = 0
) -> SpmModel:
    pieces: List[Piece] = [
        Piece("</s>", 0.0, PIECE_CONTROL),
        Piece("<unk>", 0.0, PIECE_UNKNOWN),
    ]
    seen = {p.piece for p in pieces}
    word_list = [w for w in words if w]

    # Word-level pieces (with the ▁ word-start marker), scored by rank.
    for rank, word in enumerate(dict.fromkeys(word_list)):
        piece = SPACE + word
        if piece not in seen:
            seen.add(piece)
            pieces.append(Piece(piece, -math.log(2.0 + rank), PIECE_NORMAL))

    # Character fallback so any text segments: all chars of the words,
    # plus basic ASCII, with low scores.
    chars = set("".join(word_list))
    chars |= set(
        "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
        "0123456789.,!?;:'\"()-"
    )
    chars.add(SPACE)
    for ch in sorted(chars):
        if ch not in seen:
            seen.add(ch)
            pieces.append(Piece(ch, -12.0, PIECE_NORMAL))
        marked = SPACE + ch
        if marked not in seen:
            seen.add(marked)
            pieces.append(Piece(marked, -11.5, PIECE_NORMAL))

    # Pad with unused filler to reach a requested vocab size.
    filler = 0
    while target_size and len(pieces) < target_size:
        name = f"<fill_{filler}>"
        pieces.append(Piece(name, -100.0, PIECE_NORMAL))
        filler += 1

    return SpmModel(pieces=pieces, unk_id=1, bos_id=-1, eos_id=0, pad_id=-1)


def build_vocabulary(
    words: Iterable[str], target_size: int = 0, backend: str = "auto"
) -> Vocabulary:
    blob = spm_proto.serialize_model(build_spm_model(words, target_size))
    return Vocabulary(blob, backend=backend)


DEFAULT_WORDS = (
    "hello world goodbye this is a test of the translation engine "
    "quick brown fox jumps over lazy dog sentence splitting works "
    "numbers like 123 and punctuation are handled".split()
)
