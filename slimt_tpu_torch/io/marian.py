"""Marian v1 binary model-file (.bin) reader and writer.

This is the checkpoint format real Bergamot student models ship in; the
layout is documented against the reference parser (slimt/Io.cc:114-273,
slimt/Io.hh:19-44):

    u64  version                  (== 1)
    u64  num_headers
    Header[num_headers]           { u64 name_length (incl. NUL),
                                    u64 type (marian type code),
                                    u64 shape_length,
                                    u64 data_length }
    names                         (name_length bytes each, NUL-terminated)
    shapes                        (i32 * shape_length per item)
    u64  pad                      (bytes to skip so data is 256B-aligned)
    <pad bytes>
    data blobs                    (data_length bytes each, back to back)

Marian type codes (slimt/Io.cc:37-102): a size in the low byte plus class
bits — signed 0x0100, unsigned 0x0200, float 0x0400, intgemm 0x4000.
`intgemm8` (0x4101) matrices carry a trailing float32 quantization
multiplier *inside* the data payload after rows*cols int8 elements
(slimt/Io.cc:236-239, slimt/Modules.cc:18-22).

The reader is mmap-backed (numpy.memmap) and zero-copy for tensor
payloads, like the reference's MmapFile path (slimt/Io.cc:292-345).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

BINARY_FILE_VERSION = 1
DATA_ALIGNMENT = 256

# Marian type codes we understand (reference slimt/Io.cc:37-102).
TYPE_INT8 = 0x0100 + 1
TYPE_INT16 = 0x0100 + 2
TYPE_INT32 = 0x0100 + 4
TYPE_UINT8 = 0x0200 + 1
TYPE_UINT32 = 0x0200 + 4
TYPE_FLOAT16 = 0x0400 + 2
TYPE_FLOAT32 = 0x0400 + 4
TYPE_INTGEMM8 = 0x0100 + 1 + 0x4000

TYPE_NAMES = {
    TYPE_INT8: "int8",
    TYPE_INT16: "int16",
    TYPE_INT32: "int32",
    TYPE_UINT8: "uint8",
    TYPE_UINT32: "uint32",
    TYPE_FLOAT16: "float16",
    TYPE_FLOAT32: "float32",
    TYPE_INTGEMM8: "intgemm8",
}

_NP_DTYPE = {
    TYPE_INT8: np.int8,
    TYPE_INT16: np.int16,
    TYPE_INT32: np.int32,
    TYPE_UINT8: np.uint8,
    TYPE_UINT32: np.uint32,
    TYPE_FLOAT16: np.float16,
    TYPE_FLOAT32: np.float32,
    TYPE_INTGEMM8: np.int8,  # payload is int8 + trailing f32 multiplier
}

_TYPE_OF_NP = {
    np.dtype(np.int8): TYPE_INT8,
    np.dtype(np.int16): TYPE_INT16,
    np.dtype(np.int32): TYPE_INT32,
    np.dtype(np.uint8): TYPE_UINT8,
    np.dtype(np.uint32): TYPE_UINT32,
    np.dtype(np.float16): TYPE_FLOAT16,
    np.dtype(np.float32): TYPE_FLOAT32,
}


def _stored_transposed(name: str, type_code: int, shape: tuple) -> bool:
    """Whether an intgemm8 payload is stored TRANSPOSED on disk.

    Marian exports intgemm8 weight matrices through
    PrepareB(Quantized)Transposed: the payload is the TRANSPOSE of the
    declared [rows, cols] header shape, laid out row-major [cols,
    rows].  The reference consumes it that way — its ruy provider
    memcpy's the payload and indexes column j at data[j*rows + k]
    (qmm/Ruy.inl.cc:86-89,158-162), and gemmology/intgemm call
    PrepareBQuantizedTransposed on it (qmm/Gemmology.inl.cc:275-281).
    The only exceptions, special-cased by NAME exactly like
    slimt/Io.cc:166-224: "Wemb" (natural [V, E] — it is dequantized
    for the input embedding and re-prepared at load) and
    "Wemb_QuantMultA" (a junk ig8 blob).  Items here always carry the
    LOGICAL orientation; the disk layout is this module's concern.

    (Caught by the crosscheck differential harness: round 1 stored
    these payloads natural, self-consistently — wrong for real files.)
    """
    return (
        type_code == TYPE_INTGEMM8
        and len(shape) == 2
        and name not in ("Wemb", "Wemb_QuantMultA")
    )


@dataclasses.dataclass
class Item:
    """One named tensor from a marian .bin file.

    For `intgemm8` items, `array` is the int8 matrix and `scale` the
    trailing per-tensor quantization *multiplier* (quantized = f32 *
    scale; dequantized = int8 / scale — see slimt/Io.cc:279-281).
    """

    name: str
    type_code: int
    shape: tuple
    array: np.ndarray
    scale: Optional[float] = None

    @property
    def is_quantized(self) -> bool:
        return self.type_code == TYPE_INTGEMM8


def _parse(buf: Union[bytes, np.memmap, memoryview]) -> List[Item]:
    mv = memoryview(buf)
    pos = 0

    def read_u64() -> int:
        nonlocal pos
        (value,) = struct.unpack_from("<Q", mv, pos)
        pos += 8
        return value

    version = read_u64()
    if version != BINARY_FILE_VERSION:
        raise ValueError(
            f"binary file version mismatch: {version} (file) != "
            f"{BINARY_FILE_VERSION} (expected)"
        )

    num_headers = read_u64()
    headers = []
    for _ in range(num_headers):
        name_length, type_code, shape_length, data_length = struct.unpack_from(
            "<QQQQ", mv, pos
        )
        pos += 32
        headers.append((name_length, type_code, shape_length, data_length))

    names = []
    for name_length, _, _, _ in headers:
        raw = bytes(mv[pos : pos + name_length])
        pos += name_length
        # name_length includes the trailing NUL (slimt/Io.cc:135-137).
        names.append(raw[: name_length - 1].decode("utf-8"))

    shapes = []
    for _, _, shape_length, _ in headers:
        shape = struct.unpack_from(f"<{shape_length}i", mv, pos)
        pos += 4 * shape_length
        shapes.append(tuple(shape))

    pad = read_u64()
    pos += pad

    items: List[Item] = []
    for (name, shape, (_, type_code, _, data_length)) in zip(
        names, shapes, headers
    ):
        blob = mv[pos : pos + data_length]
        pos += data_length
        if type_code not in _NP_DTYPE:
            raise ValueError(f"unsupported marian type code {type_code:#x} for {name}")
        dtype = _NP_DTYPE[type_code]
        scale = None
        if type_code == TYPE_INTGEMM8:
            n = int(np.prod(shape)) if shape else 0
            flat = np.frombuffer(blob, dtype=np.int8, count=n)
            if _stored_transposed(name, type_code, shape):
                # Disk layout is [cols, rows] row-major (the prepared
                # transpose); expose the logical [rows, cols] matrix.
                array = flat.reshape(shape[::-1]).T
            else:
                array = flat.reshape(shape)
            # Trailing f32 multiplier after the int8 payload.
            (scale,) = struct.unpack_from("<f", blob, n)
        else:
            n = data_length // np.dtype(dtype).itemsize
            array = np.frombuffer(blob, dtype=dtype, count=n)
            if shape and int(np.prod(shape)) == n:
                array = array.reshape(shape)
        items.append(Item(name, type_code, shape, array, scale))
    return items


def load_items(path_or_bytes: Union[str, bytes]) -> List[Item]:
    """Parse a marian .bin file (path → mmap; bytes → in-memory)."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        return _parse(path_or_bytes)
    data = np.memmap(path_or_bytes, dtype=np.uint8, mode="r")
    return _parse(data)


def save_items(items: Sequence[Item]) -> bytes:
    """Serialize items into marian v1 binary format.

    Used to synthesize test models and to re-serialize checkpoints; the
    output round-trips through `load_items` and through the reference
    parser's layout expectations.
    """
    names = []
    shapes = []
    blobs = []
    headers = []
    for item in items:
        name_bytes = item.name.encode("utf-8") + b"\0"
        if item.type_code == TYPE_INTGEMM8:
            if item.scale is None:
                raise ValueError(f"intgemm8 item {item.name} requires a scale")
            array = np.asarray(item.array, dtype=np.int8)
            if _stored_transposed(item.name, item.type_code, item.shape):
                array = array.T  # disk layout is the prepared transpose
            payload = (
                np.ascontiguousarray(array).tobytes()
                + struct.pack("<f", item.scale)
            )
        else:
            payload = np.ascontiguousarray(
                item.array, dtype=_NP_DTYPE[item.type_code]
            ).tobytes()
        names.append(name_bytes)
        shapes.append(item.shape)
        blobs.append(payload)
        headers.append(
            (len(name_bytes), item.type_code, len(item.shape), len(payload))
        )

    out = bytearray()
    out += struct.pack("<Q", BINARY_FILE_VERSION)
    out += struct.pack("<Q", len(items))
    for header in headers:
        out += struct.pack("<QQQQ", *header)
    for name_bytes in names:
        out += name_bytes
    for shape in shapes:
        out += struct.pack(f"<{len(shape)}i", *shape)
    # Align the data section to 256 bytes, counting the u64 pad field
    # itself (the reference reads pad then skips; slimt/Io.cc:150-153).
    pos = len(out) + 8
    pad = (-pos) % DATA_ALIGNMENT
    out += struct.pack("<Q", pad)
    out += b"\0" * pad
    for payload in blobs:
        out += payload
    return bytes(out)


def item_from_array(name: str, array: np.ndarray) -> Item:
    """Wrap a float/int numpy array as a non-quantized Item."""
    array = np.asarray(array)
    code = _TYPE_OF_NP[array.dtype]
    return Item(name, code, tuple(array.shape), array)


def quantize_item(name: str, weights: np.ndarray) -> Item:
    """Symmetric per-tensor int8 quantization of a float matrix.

    Produces an `intgemm8` Item with multiplier 127/absmax, matching
    marian's export convention consumed by slimt/Io.cc:225-262.
    """
    weights = np.asarray(weights, dtype=np.float32)
    absmax = float(np.max(np.abs(weights))) or 1.0
    scale = 127.0 / absmax
    q = np.clip(np.rint(weights * scale), -127, 127).astype(np.int8)
    return Item(name, TYPE_INTGEMM8, tuple(weights.shape), q, scale)
