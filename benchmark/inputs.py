"""The inputs of a run, all made from its seed: the lexicon, the
SentencePiece vocabulary, the weights as a marian .bin, the lexical
shortlist in marian's binary layout, and the text.

The writers here are the benchmark's own copies of the formats the port
reads (marian v1 .bin, sentencepiece ModelProto, marian's binary
shortlist), so that the port loads the inputs through its normal loaders
and the plain reference reads the same arrays without the port.
"""

from __future__ import annotations

import dataclasses
import math
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark import readers

SPACE = "▁"  # sentencepiece's word-start marker
LETTERS = "abcdefghijklmnopqrstuvwxyz"
EOS_ID, UNK_ID = 0, 1  # marian's vocabulary convention
FIRST_WORD_ID = 2
CHAR_PIECES = 2 * len(LETTERS)  # "a" and "▁a" for every letter


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed, so that the inputs of
    one kind do not depend on how much another kind drew."""
    sequence = np.random.SeedSequence(int(seed), spawn_key=(zlib.crc32(tag.encode()),))
    return int(sequence.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))


def torch_generator(seed: int, tag: str, device) -> torch.Generator:
    generator = torch.Generator(device=device)
    generator.manual_seed(sub_seed(seed, tag))
    return generator


# -- lexicon and vocabulary ------------------------------------------------


@dataclasses.dataclass
class Lexicon:
    """`words[r]` is the word of rank r + 1, whose piece id is
    FIRST_WORD_ID + r; `cdf` is the Zipf law over the ranks."""

    words: List[str]
    cdf: np.ndarray

    def sample(self, generator: np.random.Generator, n: int) -> np.ndarray:
        """n word ranks (0-based) drawn by the Zipf law."""
        draws = np.searchsorted(self.cdf, generator.random(n), side="right")
        return np.minimum(draws, len(self.words) - 1)


def make_lexicon(seed: int, n_words: int, zipf_s: float) -> Lexicon:
    """n_words distinct lowercase words of 2-10 letters, in a random
    order that is their frequency rank."""
    generator = rng(seed, "lexicon")
    words: Dict[str, None] = {}
    while len(words) < n_words:
        n = 2 * (n_words - len(words)) + 64
        lengths = generator.integers(2, 11, n)
        letters = generator.integers(0, len(LETTERS), (n, 10))
        table = np.array(list(LETTERS))[letters]
        for row, length in zip(table, lengths):
            words.setdefault("".join(row[:length]), None)
            if len(words) == n_words:
                break
    weights = np.arange(1, n_words + 1, dtype=np.float64) ** -zipf_s
    cdf = np.cumsum(weights)
    return Lexicon(list(words), cdf / cdf[-1])


def vocabulary_pieces(lexicon: Lexicon) -> List[Tuple[str, float, int]]:
    """(piece, score, type) in id order: </s>, <unk>, a word piece for
    every word scored by its rank, and a letter fallback."""
    pieces = [("</s>", 0.0, 3), ("<unk>", 0.0, 2)]
    pieces += [(SPACE + word, -math.log(2.0 + rank), 1)
               for rank, word in enumerate(lexicon.words)]
    for letter in LETTERS:
        pieces += [(letter, -12.0, 1), (SPACE + letter, -11.5, 1)]
    return pieces


def _varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64
    out = bytearray()
    while True:
        low = value & 0x7F
        value >>= 7
        if value:
            out.append(low | 0x80)
        else:
            out.append(low)
            return bytes(out)


def _field(number: int, wire: int, payload: bytes) -> bytes:
    return _varint(number << 3 | wire) + payload


def _message(number: int, payload: bytes) -> bytes:
    return _field(number, 2, _varint(len(payload)) + payload)


def spm_model_bytes(pieces: Sequence[Tuple[str, float, int]]) -> bytes:
    """A sentencepiece ModelProto: the pieces (field 1), the trainer's
    special ids (field 2: unk 1, bos none, eos 0, pad none) and the
    identity normalizer with a dummy prefix (field 3)."""
    out = bytearray()
    for piece, score, kind in pieces:
        body = _message(1, piece.encode("utf-8"))
        body += _field(2, 5, struct.pack("<f", score)) + _field(3, 0, _varint(kind))
        out += _message(1, body)
    trainer = (_field(40, 0, _varint(UNK_ID)) + _field(41, 0, _varint(-1))
               + _field(42, 0, _varint(EOS_ID)) + _field(43, 0, _varint(-1)))
    out += _message(2, trainer)
    normalizer = _message(1, b"identity")
    for number in (3, 4, 5):  # dummy prefix, strip extra spaces, escape spaces
        normalizer += _field(number, 0, _varint(1))
    out += _message(3, normalizer)
    return bytes(out)


# -- weights ----------------------------------------------------------------


@dataclasses.dataclass
class Weights:
    """The model's arrays under marian's names: int8 matrices with their
    multipliers (f32 = q / mult) in `int8`, f32 arrays in `f32`, and the
    name of the embedding matrix, [vocabulary, emb]."""

    int8: Dict[str, Tuple[np.ndarray, float]]
    f32: Dict[str, np.ndarray]
    embedding: Optional[str] = None


# Weights are N(0, 1/rows) (the embedding N(0, 1/E)), quantized per
# matrix at 4 standard deviations, so an int8 step is 4 sigma / 127.
CLIP_SIGMAS = 4.0


def make_weights(cfg: dict, seed: int, device, architecture=None) -> Weights:
    """The arrays of the configuration's architecture (its `layout`, with
    the settings it `planted`; found by readers.architecture where not
    given): every matrix from one normal draw on `device`, rounded to int8
    there; every vector from a second draw. The weight multipliers follow
    from the widths; the activation multipliers are the configuration's."""
    architecture = architecture or readers.architecture(cfg)
    matrices, vectors = architecture.layout(cfg)
    embedding = architecture.EMBEDDING
    generator = torch_generator(seed, "weights", device)
    total = sum(rows * cols for _, rows, cols in matrices)
    draw = torch.randn(total, generator=generator, device=device)
    q = torch.clamp(torch.round(draw * (127.0 / CLIP_SIGMAS)), -127, 127).to(torch.int8)
    del draw
    q = q.cpu().numpy()
    small = torch.randn(sum(n for _, n, _ in vectors), generator=generator,
                        device=device).cpu().numpy()
    int8, f32, at = {}, {}, 0
    for name, rows, cols in matrices:
        sigma = architecture.planted(name, cfg["init"])[0] / math.sqrt(
            cfg["emb_dim"] if name == embedding else rows)
        int8[name] = (q[at:at + rows * cols].reshape(rows, cols), 127.0 / (CLIP_SIGMAS * sigma))
        at += rows * cols
    spread = cfg["init"]
    at = 0
    for name, n, kind in vectors:
        part = small[at:at + n] * np.float32(spread[kind + "_std"])
        if kind == "scale":
            part = part + np.float32(1.0)
        part = part + np.float32(architecture.planted(name, spread)[1])
        f32[name] = part.astype(np.float32).reshape(1, n)
        at += n
    activation = np.array([[cfg["activation_multiplier"]]], np.float32)
    for name, _, _ in matrices:
        f32[architecture.activation_name(name)] = activation
    return Weights(int8, f32, embedding)


TYPE_FLOAT32 = 0x0404
TYPE_INTGEMM8 = 0x4101


def marian_bytes(weights: Weights) -> bytes:
    """The weights as a marian v1 .bin: headers, names, shapes, a pad to
    256 bytes and the payloads. intgemm8 payloads are the int8 matrix
    stored transposed (all but the embedding, as marian exports them)
    followed by the f32 multiplier."""
    items = []
    for name, (q, mult) in weights.int8.items():
        stored = q if name == weights.embedding else q.T
        items.append((name, TYPE_INTGEMM8, q.shape,
                      np.ascontiguousarray(stored).tobytes() + struct.pack("<f", mult)))
    for name, array in weights.f32.items():
        items.append((name, TYPE_FLOAT32, array.shape, array.astype("<f4").tobytes()))
    out = bytearray(struct.pack("<QQ", 1, len(items)))
    for name, kind, shape, payload in items:
        out += struct.pack("<QQQQ", len(name) + 1, kind, len(shape), len(payload))
    for name, *_ in items:
        out += name.encode() + b"\0"
    for _, _, shape, _ in items:
        out += struct.pack(f"<{len(shape)}i", *shape)
    pad = (-(len(out) + 8)) % 256
    out += struct.pack("<Q", pad) + b"\0" * pad
    for *_, payload in items:
        out += payload
    return bytes(out)


# -- shortlist --------------------------------------------------------------


SHORTLIST_MAGIC = 0xF11A48D5013417F5
_MASK64 = (1 << 64) - 1


def _fold(words: np.ndarray) -> int:
    """boost::hash_combine over 64-bit words with the identity hash: the
    checksum of marian's binary shortlist."""
    seed = 0
    for word in words.tolist():
        seed = (seed ^ (word + 0x9E3779B9 + ((seed << 6) & _MASK64) + (seed >> 2))) & _MASK64
    return seed


def make_candidates(lexicon: Lexicon, vocab_size: int, best: int, seed: int,
                    device) -> np.ndarray:
    """[vocab_size, best] distinct target word ids for every source id,
    drawn without replacement by the lexicon's Zipf law (Gumbel top-k on
    `device`, a block of source ids at a time)."""
    n_words = len(lexicon.words)
    weights = np.diff(np.concatenate([[0.0], lexicon.cdf]))
    log_p = torch.from_numpy(np.log(weights).astype(np.float32)).to(device)
    generator = torch_generator(seed, "shortlist", device)
    out = torch.empty((vocab_size, best), dtype=torch.int32, device=device)
    block = max(1, (1 << 26) // n_words)
    for lo in range(0, vocab_size, block):
        hi = min(vocab_size, lo + block)
        uniform = torch.rand((hi - lo, n_words), generator=generator, device=device)
        gumbel = -torch.log(-torch.log(uniform.clamp_min(1e-20)))
        out[lo:hi] = torch.topk(log_p + gumbel, best, dim=1).indices.to(torch.int32)
    return out.cpu().numpy() + FIRST_WORD_ID


def shortlist_bytes(candidates: np.ndarray, frequent: int, best: int) -> bytes:
    """marian's binary shortlist: magic, checksum, frequent, best, the
    offset table over source ids and the candidate ids."""
    vocab_size = candidates.shape[0]
    offsets = np.arange(vocab_size + 1, dtype="<u8") * np.uint64(candidates.shape[1])
    body = struct.pack("<4Q", frequent, best, len(offsets), candidates.size)
    body += offsets.tobytes() + candidates.astype("<u4").tobytes()
    checksum = _fold(np.frombuffer(body, dtype="<u8"))
    return struct.pack("<2Q", SHORTLIST_MAGIC, checksum) + body


# -- text -------------------------------------------------------------------


def lognormal_lengths(generator: np.random.Generator, n: int, spec: dict) -> np.ndarray:
    """n lengths lognormal about spec["median"] with spec["sigma"], rounded
    and clipped to [spec["min"], spec["max"]]."""
    draws = spec["median"] * np.exp(spec["sigma"] * generator.standard_normal(n))
    return np.clip(np.rint(draws), spec["min"], spec["max"]).astype(np.int64)


def make_lines(generator: np.random.Generator, lexicon: Lexicon, lengths: np.ndarray,
               unique: bool = True, seen=None) -> List[str]:
    """One line of Zipf words for each length; with `unique`, a line that
    repeats one before it (here or in `seen`) is drawn again at its length."""
    words = np.array(lexicon.words, dtype=object)
    ranks = lexicon.sample(generator, int(lengths.sum()))
    ends = np.cumsum(lengths)
    lines = [" ".join(chunk) for chunk in np.split(words[ranks], ends[:-1])]
    if unique:
        seen = set() if seen is None else seen
        for i, line in enumerate(lines):
            while line in seen:
                line = " ".join(words[lexicon.sample(generator, int(lengths[i]))])
            seen.add(line)
            lines[i] = line
    return lines
