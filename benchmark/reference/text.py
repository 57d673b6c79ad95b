"""Plain text handling of the benchmark's vocabulary: every word of the
generated text is one whole-word piece, so a line tokenizes word by word,
is wrapped into segments of `wrap_length - 1` pieces and an EOS, and
ids detokenize by sentencepiece's rule (control pieces are empty, the
unknown piece is its unk_surface " ⁇ ", the word-start marker is a space,
the first piece's leading space dropped)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

SPACE = "▁"
UNKNOWN, CONTROL = 2, 3
UNK_SURFACE = " \u2047 "  # sentencepiece's default unk_surface


class Text:
    def __init__(self, pieces: Sequence[Tuple[str, float, int]], eos_id: int):
        self.pieces = [(piece, kind) for piece, _, kind in pieces]
        self.ids: Dict[str, int] = {piece: i for i, (piece, _) in enumerate(self.pieces)}
        self.eos_id = eos_id

    def encode(self, line: str) -> List[int]:
        """The line's word ids (KeyError for a word outside the lexicon)."""
        return [self.ids[SPACE + word] for word in line.split()]

    def segments(self, line: str, wrap_length: int) -> List[List[int]]:
        ids = self.encode(line)
        step = wrap_length - 1
        return [ids[at:at + step] + [self.eos_id] for at in range(0, max(len(ids), 1), step)]

    def decode(self, ids: Sequence[int]) -> str:
        out = []
        for i in ids:
            piece, kind = self.pieces[i]
            if kind == UNKNOWN:
                out.append(UNK_SURFACE)
            elif kind != CONTROL:
                out.append(piece.replace(SPACE, " "))
        text = "".join(out)
        return text[1:] if text.startswith(" ") else text
