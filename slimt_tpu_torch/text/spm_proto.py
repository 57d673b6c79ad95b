"""Minimal protobuf wire-format codec for sentencepiece ModelProto.

The reference links the sentencepiece C++ library
(slimt/Vocabulary.cc:3,24-27 loads a serialized ModelProto). This
module reads/writes the same serialized format with a hand-rolled
wire-format codec (no protobuf dependency), extracting only the fields
inference needs:

  ModelProto:
    1: repeated SentencePiece pieces
         { 1: piece (string), 2: score (float),
           3: type (enum: 1 NORMAL, 2 UNKNOWN, 3 CONTROL,
                    4 USER_DEFINED, 5 UNUSED, 6 BYTE) }
    2: TrainerSpec   { 40: unk_id, 41: bos_id, 42: eos_id, 43: pad_id }
    3: NormalizerSpec { 1: name, 2: precompiled_charsmap (bytes),
                        3: add_dummy_prefix, 4: remove_extra_whitespaces,
                        5: escape_whitespaces }
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

PIECE_NORMAL = 1
PIECE_UNKNOWN = 2
PIECE_CONTROL = 3
PIECE_USER_DEFINED = 4
PIECE_UNUSED = 5
PIECE_BYTE = 6


@dataclasses.dataclass
class Piece:
    piece: str
    score: float = 0.0
    type: int = PIECE_NORMAL


@dataclasses.dataclass
class NormalizerSpec:
    name: str = "identity"
    precompiled_charsmap: bytes = b""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True


@dataclasses.dataclass
class SpmModel:
    pieces: List[Piece]
    unk_id: int = 0
    bos_id: int = -1
    eos_id: int = 0
    pad_id: int = -1
    normalizer: NormalizerSpec = dataclasses.field(default_factory=NormalizerSpec)


# --- wire format primitives ------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # two's-complement encoding for negative ints
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _scan(buf: bytes) -> List[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) triples."""
    fields = []
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            value = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.append((field, wire, value))
    return fields


def _signed(value: int) -> int:
    """Interpret a 64-bit varint as a signed int32/int64."""
    if value >= 1 << 63:
        value -= 1 << 64
    return value


# --- ModelProto ------------------------------------------------------


def parse_model(buf: bytes) -> SpmModel:
    pieces: List[Piece] = []
    model = SpmModel(pieces=pieces)
    for field, wire, value in _scan(buf):
        if field == 1 and wire == 2:  # SentencePiece
            piece = Piece(piece="")
            for f2, w2, v2 in _scan(value):
                if f2 == 1 and w2 == 2:
                    piece.piece = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    (piece.score,) = struct.unpack("<f", v2)
                elif f2 == 3 and w2 == 0:
                    piece.type = v2
            pieces.append(piece)
        elif field == 2 and wire == 2:  # TrainerSpec
            for f2, w2, v2 in _scan(value):
                if w2 != 0:
                    continue
                if f2 == 40:
                    model.unk_id = _signed(v2)
                elif f2 == 41:
                    model.bos_id = _signed(v2)
                elif f2 == 42:
                    model.eos_id = _signed(v2)
                elif f2 == 43:
                    model.pad_id = _signed(v2)
        elif field == 3 and wire == 2:  # NormalizerSpec
            ns = model.normalizer
            for f2, w2, v2 in _scan(value):
                if f2 == 1 and w2 == 2:
                    ns.name = v2.decode("utf-8")
                elif f2 == 2 and w2 == 2:
                    ns.precompiled_charsmap = v2
                elif f2 == 3 and w2 == 0:
                    ns.add_dummy_prefix = bool(v2)
                elif f2 == 4 and w2 == 0:
                    ns.remove_extra_whitespaces = bool(v2)
                elif f2 == 5 and w2 == 0:
                    ns.escape_whitespaces = bool(v2)
    return model


def _field(field: int, wire: int, payload: bytes) -> bytes:
    return _write_varint(field << 3 | wire) + payload


def _len_field(field: int, payload: bytes) -> bytes:
    return _field(field, 2, _write_varint(len(payload)) + payload)


def serialize_model(model: SpmModel) -> bytes:
    out = bytearray()
    for piece in model.pieces:
        body = _len_field(1, piece.piece.encode("utf-8"))
        body += _field(2, 5, struct.pack("<f", piece.score))
        body += _field(3, 0, _write_varint(piece.type))
        out += _len_field(1, body)
    trainer = (
        _field(40, 0, _write_varint(model.unk_id))
        + _field(41, 0, _write_varint(model.bos_id))
        + _field(42, 0, _write_varint(model.eos_id))
        + _field(43, 0, _write_varint(model.pad_id))
    )
    out += _len_field(2, trainer)
    ns = model.normalizer
    norm = _len_field(1, ns.name.encode("utf-8"))
    if ns.precompiled_charsmap:
        norm += _len_field(2, ns.precompiled_charsmap)
    norm += _field(3, 0, _write_varint(int(ns.add_dummy_prefix)))
    norm += _field(4, 0, _write_varint(int(ns.remove_extra_whitespaces)))
    norm += _field(5, 0, _write_varint(int(ns.escape_whitespaces)))
    out += _len_field(3, norm)
    return bytes(out)
