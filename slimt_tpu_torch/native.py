"""ctypes loader for the port's native host library
(slimt_tpu_torch/native/slimt_host.cpp).

Built on first use by one g++ call into slimt_tpu_torch/build/
(`ops/_native_build.host_library_path`); nothing under the JAX package's
top-level native/ is read, built or written. On a machine without g++
every caller falls back to the pure-Python implementations; with g++, a
failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_lib = None
_lock = threading.Lock()
_no_toolchain = False


def library_path():
    """The built library's path (slimt_tpu_torch/build/...), built on
    first use; None where there is no g++."""
    if shutil.which("g++") is None:
        return None
    from slimt_tpu_torch.ops._native_build import host_library_path

    return host_library_path()


def _load():
    global _lib, _no_toolchain
    with _lock:
        if _lib is not None or _no_toolchain:
            return _lib
        path = library_path()
        if path is None:
            _no_toolchain = True
            return None
        lib = ctypes.CDLL(str(path))

        lib.slimt_vocab_create.restype = ctypes.c_void_p
        lib.slimt_vocab_create.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint32,
            ctypes.c_uint32,
        ]
        lib.slimt_vocab_destroy.argtypes = [ctypes.c_void_p]
        lib.slimt_vocab_set_charsmap.restype = ctypes.c_int
        lib.slimt_vocab_set_charsmap.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64
        ]
        lib.slimt_vocab_cap_multiplier.restype = ctypes.c_int
        lib.slimt_vocab_cap_multiplier.argtypes = [ctypes.c_void_p]
        lib.slimt_vocab_encode.restype = ctypes.c_int
        lib.slimt_vocab_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int,
        ]
        # Pointer args typed c_void_p so callers can pass the raw
        # ndarray.ctypes.data integer (no per-call data_as cast).
        lib.slimt_vocab_decode.restype = ctypes.c_int
        lib.slimt_vocab_decode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.slimt_vocab_encode_batch.restype = ctypes.c_int64
        lib.slimt_vocab_encode_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.slimt_ingest_lines.restype = ctypes.c_int64
        lib.slimt_ingest_lines.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_uint32,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.slimt_vocab_decode_padded.restype = ctypes.c_int64
        lib.slimt_vocab_decode_padded.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.slimt_assemble_lines.restype = ctypes.c_int64
        lib.slimt_assemble_lines.argtypes = [
            ctypes.c_int,
            ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.slimt_vocab_decode_batch.restype = ctypes.c_int
        lib.slimt_vocab_decode_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.slimt_hash_words.restype = ctypes.c_uint64
        lib.slimt_hash_words.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def hash_words(seed: int, words: Sequence[int]) -> Optional[int]:
    lib = _load()
    if lib is None:
        return None
    arr = np.asarray(list(words), dtype=np.uint32)
    return int(
        lib.slimt_hash_words(
            ctypes.c_uint64(seed),
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len(arr),
        )
    )


class NativeVocab:
    """Native unigram segmenter over a piece table (plus, when the
    model ships one, the precompiled charsmap normalization — a
    darts-trie longest-match pass applied before the whitespace
    handling, sentencepiece Normalizer semantics)."""

    def __init__(self, pieces, unk_id: int, normalizer):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        blob = b"".join(p.piece.encode("utf-8") for p in pieces)
        # Worst-case per-token surface bytes for decode buffers: the
        # longest piece, or " ⁇ " (5 bytes) for unknowns.
        self._max_surface = max(
            [5] + [len(p.piece.encode("utf-8")) for p in pieces]
        )
        offsets = np.zeros(len(pieces) + 1, np.uint32)
        np.cumsum(
            [len(p.piece.encode("utf-8")) for p in pieces], out=offsets[1:]
        )
        scores = np.asarray([p.score for p in pieces], np.float32)
        types = np.asarray([p.type for p in pieces], np.uint8)
        self._handle = ctypes.c_void_p(
            lib.slimt_vocab_create(
                blob,
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                types.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                len(pieces),
                unk_id,
            )
        )
        self._norm = normalizer
        self._cap_mult = 1
        charsmap = getattr(normalizer, "precompiled_charsmap", b"")
        if charsmap:
            ok = lib.slimt_vocab_set_charsmap(
                self._handle, bytes(charsmap), len(charsmap)
            )
            if not ok:
                raise RuntimeError("malformed precompiled charsmap")
            self._cap_mult = int(
                lib.slimt_vocab_cap_multiplier(self._handle)
            )

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.slimt_vocab_destroy(handle)

    def encode(self, line: str) -> Tuple[List[int], List[Tuple[int, int]]]:
        data = line.encode("utf-8")
        cap = max(2, self._cap_mult) * len(data) + 8
        ids = np.empty(cap, np.uint32)
        begin = np.empty(cap, np.uint32)
        end = np.empty(cap, np.uint32)
        count = self._lib.slimt_vocab_encode(
            self._handle, data, len(data),
            int(self._norm.add_dummy_prefix),
            int(self._norm.escape_whitespaces),
            int(self._norm.remove_extra_whitespaces),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            begin.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            end.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            cap,
        )
        if count < 0:
            raise RuntimeError("encode capacity exceeded")
        return (
            ids[:count].tolist(),
            list(zip(begin[:count].tolist(), end[:count].tolist())),
        )

    def encode_batch_begins(
        self, lines: Sequence[str], n_threads: int = 0
    ) -> List[Tuple[List[int], List[int], int]]:
        """Segment many lines in ONE multithreaded library call,
        returning (ids, tiled token begins, final end) per line — the
        Vocabulary.encode_batch_begins contract. The C++ side spreads
        sentences across threads (the ctypes call releases the GIL) and
        writes flat arrays; the only per-line Python work is slicing
        two pre-converted lists."""
        n = len(lines)
        if n == 0:
            return []
        if n_threads <= 0:
            n_threads = min(4, os.cpu_count() or 1)
        datas = [line.encode("utf-8") for line in lines]
        blob = b"".join(datas)
        offsets = np.zeros(n + 1, np.uint64)
        np.cumsum([len(d) for d in datas], out=offsets[1:])
        cap = self._cap_mult * len(blob) + n
        ids = np.empty(max(cap, 1), np.uint32)
        begins = np.empty(max(cap, 1), np.uint32)
        counts = np.empty(n, np.uint32)
        ends = np.empty(n, np.uint32)
        norm = self._norm
        total = self._lib.slimt_vocab_encode_batch(
            self._handle,
            blob,
            offsets.ctypes.data,
            n,
            int(norm.add_dummy_prefix),
            int(norm.escape_whitespaces),
            int(norm.remove_extra_whitespaces),
            n_threads,
            ids.ctypes.data,
            begins.ctypes.data,
            counts.ctypes.data,
            ends.ctypes.data,
        )
        if total < 0:
            raise RuntimeError("encode capacity exceeded")
        ids_list = ids[:total].tolist()
        begins_list = begins[:total].tolist()
        counts_list = counts.tolist()
        ends_list = ends.tolist()
        out = []
        pos = 0
        for count, end in zip(counts_list, ends_list):
            hi = pos + count
            out.append((ids_list[pos:hi], begins_list[pos:hi], end))
            pos = hi
        return out

    # Scratch buffers for ingest_lines, reused across calls so repeat
    # ingests don't re-pay page-fault costs on fresh allocations.
    # Thread-local: the bulk path's lookahead tokenizes the next chunk
    # on a pool thread while the main thread ingests the current one.
    _scratch_tls = threading.local()

    @classmethod
    def _scratch(cls, key: str, size: int, dtype):
        bufs = getattr(cls._scratch_tls, "bufs", None)
        if bufs is None:
            bufs = cls._scratch_tls.bufs = {}
        arr = bufs.get(key)
        if arr is None or arr.size < size or arr.dtype != dtype:
            arr = np.empty(int(size * 5 // 4) + 64, dtype)
            bufs[key] = arr
        return arr

    def ingest_lines(
        self,
        line_datas: Sequence[bytes],
        sent_begin: Sequence[int],
        sent_end: Sequence[int],
        sent_counts: Sequence[int],
        wrap_length: int,
        eos_id: int,
        n_threads: int = 0,
        raw: bool = False,
    ):
        """Tokenize + hard-wrap + annotate a batch of lines in ONE
        multithreaded library call (the TextProcessor.process_batch
        hot loop). Sentences are given as byte [begin,end) spans within
        each line (flat arrays + per-line counts, from the Python
        splitter).

        Default form returns per line (segments, token_begin, gap) —
        segments as lists of ids with EOS appended, token_begin/gap
        being the AnnotatedText annotation contents that repeated
        record_contiguous_sentence calls would produce. With raw=True
        returns the columnar form instead — COPIES of the flat arrays
        (the scratch is reused by the next call):
        (seg_ids u32, seg_bounds u64 [S+1], seg_line i32 [S],
        tb u32 flat, tb_counts i32, gap u32 flat, gap_counts i32)."""
        n = len(line_datas)
        if n == 0:
            return []
        if n_threads <= 0:
            n_threads = min(4, os.cpu_count() or 1)
        blob = b"".join(line_datas)
        line_off = self._scratch("line_off", n + 1, np.uint64)
        line_off[0] = 0
        np.cumsum([len(d) for d in line_datas], out=line_off[1 : n + 1])
        sb = np.ascontiguousarray(sent_begin, np.uint32)
        se = np.ascontiguousarray(sent_end, np.uint32)
        sc = np.ascontiguousarray(sent_counts, np.int32)
        ss = np.zeros(n, np.int64)
        np.cumsum(sc[:-1], out=ss[1:])  # sentence start index per line

        # Per-line output bounds: tokens per sentence <= bytes + 1
        # (dummy prefix), so T = sentence bytes + sentence count bounds
        # the line's token total; segments per sentence <=
        # 1 + bytes // step, and the annotation structure gives the
        # slot sizes below.
        nsent = len(sb)
        step = max(1, wrap_length - 1)
        cs = np.zeros(nsent + 1, np.int64)
        np.cumsum((se.astype(np.int64) - sb), out=cs[1:])
        sent_bytes = (cs[ss + sc] - cs[ss]) * self._cap_mult
        t_line = sent_bytes + sc  # max tokens per line
        s_line = sc + sent_bytes // step  # max segments per line
        id_slot = self._scratch("id_slot", n + 1, np.int64)
        id_slot[0] = 0
        np.cumsum(t_line + s_line, out=id_slot[1 : n + 1])
        tb_slot = self._scratch("tb_slot", n + 1, np.int64)
        tb_slot[0] = 0
        np.cumsum(t_line + 2 * s_line + 2, out=tb_slot[1 : n + 1])
        gap_slot = self._scratch("gap_slot", n + 1, np.int64)
        gap_slot[0] = 0
        np.cumsum(s_line + 1, out=gap_slot[1 : n + 1])

        seg_ids = self._scratch("seg_ids", int(id_slot[n]), np.uint32)
        seg_sizes = self._scratch("seg_sizes", int(gap_slot[n]), np.uint32)
        tb = self._scratch("tb", int(tb_slot[n]), np.uint32)
        gap = self._scratch("gap", int(gap_slot[n]), np.uint32)
        tb_counts = self._scratch("tb_counts", n, np.int32)
        gap_counts = self._scratch("gap_counts", n, np.int32)
        seg_counts = self._scratch("seg_counts", n, np.int32)
        max_segs = int(gap_slot[n])  # segments + 1 per line, summed
        seg_bounds = self._scratch("seg_bounds", max_segs + 1, np.uint64)
        seg_line = self._scratch("seg_line", max_segs, np.int32)

        norm = self._norm
        total_segs = self._lib.slimt_ingest_lines(
            self._handle,
            blob,
            line_off.ctypes.data,
            n,
            sb.ctypes.data,
            se.ctypes.data,
            sc.ctypes.data,
            ss.ctypes.data,
            wrap_length,
            eos_id,
            int(norm.add_dummy_prefix),
            int(norm.escape_whitespaces),
            int(norm.remove_extra_whitespaces),
            n_threads,
            id_slot.ctypes.data,
            tb_slot.ctypes.data,
            gap_slot.ctypes.data,
            seg_ids.ctypes.data,
            seg_sizes.ctypes.data,
            tb.ctypes.data,
            tb_counts.ctypes.data,
            gap.ctypes.data,
            gap_counts.ctypes.data,
            seg_counts.ctypes.data,
            seg_bounds.ctypes.data,
            seg_line.ctypes.data,
        )
        if total_segs < 0:
            raise RuntimeError("ingest capacity exceeded")

        tb_counts_l = tb_counts[:n].tolist()
        gap_counts_l = gap_counts[:n].tolist()
        if raw:
            total_ids = int(seg_bounds[total_segs]) if total_segs else 0
            return (
                seg_ids[:total_ids].copy(),
                seg_bounds[: total_segs + 1].astype(np.int64),
                seg_line[:total_segs].copy(),
                tb[: sum(tb_counts_l)].copy(),
                tb_counts_l,
                gap[: sum(gap_counts_l)].copy(),
                gap_counts_l,
            )

        bounds = seg_bounds[: total_segs + 1].tolist()
        total_ids = bounds[-1] if total_segs else 0
        ids_list = seg_ids[:total_ids].tolist()
        seg_counts_l = seg_counts[:n].tolist()
        tb_list = tb[: sum(tb_counts_l)].tolist()
        gap_list = gap[: sum(gap_counts_l)].tolist()

        out = []
        tb_pos = 0
        gap_pos = 0
        seg_pos = 0
        for l in range(n):
            segments = [
                ids_list[bounds[s] : bounds[s + 1]]
                for s in range(seg_pos, seg_pos + seg_counts_l[l])
            ]
            seg_pos += seg_counts_l[l]
            tb_hi = tb_pos + tb_counts_l[l]
            gap_hi = gap_pos + gap_counts_l[l]
            out.append(
                (segments, tb_list[tb_pos:tb_hi], gap_list[gap_pos:gap_hi])
            )
            tb_pos = tb_hi
            gap_pos = gap_hi
        return out

    def decode_padded(self, tokens: np.ndarray, steps: np.ndarray):
        """Decode rows of the padded device-result token matrix in ONE
        call — no per-row Python slicing. Returns
        (text uint8 array, text_off uint64 [n+1], ends uint32 flat,
        ends_off uint64 [n+1]); buffers are freshly allocated (they
        outlive the call: the assemble step reads them per chunk)."""
        n = tokens.shape[0]
        tokens = np.ascontiguousarray(tokens, np.int32)
        steps = np.ascontiguousarray(steps, np.int32)
        total_steps = int(steps.sum())
        cap = self._max_surface * total_steps + 1024
        text = np.empty(cap, np.uint8)
        ends = np.empty(max(total_steps, 1), np.uint32)
        ends_off = np.empty(n + 1, np.uint64)
        text_off = np.empty(n + 1, np.uint64)
        wrote = self._lib.slimt_vocab_decode_padded(
            self._handle,
            tokens.ctypes.data,
            tokens.shape[1] if tokens.ndim == 2 else 0,
            steps.ctypes.data,
            n,
            text.ctypes.data,
            cap,
            ends.ctypes.data,
            ends_off.ctypes.data,
            text_off.ctypes.data,
        )
        if wrote < 0:
            raise RuntimeError("decode capacity exceeded")
        return text, text_off, ends, ends_off

    def decode(
        self, words: Sequence[int]
    ) -> Tuple[str, List[Tuple[int, int]]]:
        n = len(words)
        # ascontiguousarray: the raw base pointer goes to C++, so a
        # strided ndarray view must be compacted first.
        ids = np.ascontiguousarray(words, np.uint32)
        cap = self._max_surface * n + 1024
        text = ctypes.create_string_buffer(cap)
        begin = np.empty(max(n, 1), np.uint32)
        end = np.empty(max(n, 1), np.uint32)
        length = self._lib.slimt_vocab_decode(
            self._handle,
            ids.ctypes.data,
            n,
            text,
            cap,
            begin.ctypes.data,
            end.ctypes.data,
        )
        if length < 0:
            raise RuntimeError("decode capacity exceeded")
        return (
            text.raw[:length].decode("utf-8", errors="replace"),
            list(zip(begin[:n].tolist(), end[:n].tolist())),
        )

    def decode_batch(
        self, segments: Sequence[Sequence[int]]
    ) -> List[Tuple[bytes, List[int]]]:
        """Decode many id sequences in ONE library call (one per
        device batch instead of one per sentence). Returns per
        sequence its UTF-8 text bytes plus per-token end offsets into
        them (token i spans [end[i-1], end[i]), tokens contiguous from
        0 — the decode_one contract in slimt_tpu_torch/native/slimt_host.cpp)."""
        import itertools

        n_seqs = len(segments)
        if n_seqs == 0:
            return []
        lengths = [len(s) for s in segments]
        seq_offsets = np.zeros(n_seqs + 1, np.uint32)
        np.cumsum(lengths, out=seq_offsets[1:])
        total = int(seq_offsets[-1])
        ids = np.fromiter(
            itertools.chain.from_iterable(segments), np.uint32, total
        )
        cap = self._max_surface * total + 1024
        text = ctypes.create_string_buffer(cap)
        ends = np.empty(max(total, 1), np.uint32)
        text_offsets = np.empty(n_seqs + 1, np.uint32)
        length = self._lib.slimt_vocab_decode_batch(
            self._handle,
            ids.ctypes.data,
            seq_offsets.ctypes.data,
            n_seqs,
            text,
            cap,
            ends.ctypes.data,
            text_offsets.ctypes.data,
        )
        if length < 0:
            raise RuntimeError("decode capacity exceeded")
        raw = text.raw
        to = text_offsets.tolist()
        so = seq_offsets.tolist()
        ends_list = ends.tolist()
        return [
            (raw[to[i] : to[i + 1]], ends_list[so[i] : so[i + 1]])
            for i in range(n_seqs)
        ]


def assemble_lines(
    src_blob: bytes,
    src_line_off: np.ndarray,
    src_tb: np.ndarray,
    src_tb_off: np.ndarray,
    src_gap: np.ndarray,
    src_gap_off: np.ndarray,
    seg_counts: np.ndarray,
    seg_starts: np.ndarray,
    seg_batch: np.ndarray,
    seg_row: np.ndarray,
    batches,
    seg_text_len: np.ndarray,
    seg_steps: np.ndarray,
):
    """Assemble per-line target text + annotation arrays from
    per-batch decode_padded outputs in ONE library call (the
    append_sentence_raw loop for a whole chunk). `batches` is a list
    of (text, text_off, ends, ends_off) arrays; (seg_batch, seg_row)
    locate each line-major segment in them; seg_text_len/seg_steps are
    the per-segment decoded byte/token counts (for exact output
    sizing). Lines with seg_counts < 0 are skipped (the caller
    assembles them — cache-hit content lives outside batch buffers).

    Returns (text uint8, text_off int64 [n+1], tb uint32 flat,
    tb_counts, gap uint32 flat, gap_counts) — freshly allocated; the
    caller wraps them in lazy AnnotatedText views."""
    lib = _load()
    n = len(seg_counts)
    line_len = np.diff(src_line_off.astype(np.int64))
    # Group boundaries come from seg_starts (the TRUE line-major
    # segment layout) so a skipped line (seg_counts = -1) does not
    # shift later lines' groups; slot sizes are upper bounds, so
    # including skipped lines' segment sizes merely oversizes.
    total_segs = len(seg_text_len)
    bounds_idx = np.empty(n + 1, np.int64)
    bounds_idx[:n] = seg_starts
    bounds_idx[n] = total_segs
    true_counts = np.diff(bounds_idx)
    if total_segs:
        ext = np.concatenate([seg_text_len.astype(np.int64), [0]])
        text_per_line = np.add.reduceat(ext, bounds_idx[:-1])
        ext2 = np.concatenate([seg_steps.astype(np.int64), [0]])
        steps_per_line = np.add.reduceat(ext2, bounds_idx[:-1])
        # np.add.reduceat quirk: a zero-length group at index i
        # returns element[i]; mask those out explicitly.
        empty = true_counts == 0
        text_per_line = np.where(empty, 0, text_per_line)
        steps_per_line = np.where(empty, 0, steps_per_line)
    else:
        text_per_line = np.zeros(n, np.int64)
        steps_per_line = np.zeros(n, np.int64)

    text_slot = np.zeros(n + 1, np.int64)
    np.cumsum(line_len + text_per_line, out=text_slot[1:])
    tb_slot = np.zeros(n + 1, np.int64)
    np.cumsum(steps_per_line + true_counts + 2, out=tb_slot[1:])
    gap_slot = np.zeros(n + 1, np.int64)
    np.cumsum(true_counts + 1, out=gap_slot[1:])

    out_text = np.empty(max(int(text_slot[-1]), 1), np.uint8)
    out_tb = np.empty(max(int(tb_slot[-1]), 1), np.uint32)
    out_gap = np.empty(max(int(gap_slot[-1]), 1), np.uint32)
    out_text_off = np.empty(n + 1, np.int64)
    tb_counts = np.empty(n, np.int32)
    gap_counts = np.empty(n, np.int32)

    n_batches = max(len(batches), 1)
    ptr_text = np.empty(n_batches, np.uint64)
    ptr_text_off = np.empty(n_batches, np.uint64)
    ptr_ends = np.empty(n_batches, np.uint64)
    ptr_ends_off = np.empty(n_batches, np.uint64)
    for i, (text, text_off, ends, ends_off) in enumerate(batches):
        ptr_text[i] = text.ctypes.data
        ptr_text_off[i] = text_off.ctypes.data
        ptr_ends[i] = ends.ctypes.data
        ptr_ends_off[i] = ends_off.ctypes.data

    sc = np.ascontiguousarray(seg_counts, np.int32)
    ss = np.ascontiguousarray(seg_starts, np.int64)
    sb = np.ascontiguousarray(seg_batch, np.int32)
    sr = np.ascontiguousarray(seg_row, np.int32)
    total = lib.slimt_assemble_lines(
        n,
        src_blob,
        src_line_off.ctypes.data,
        src_tb.ctypes.data,
        src_tb_off.ctypes.data,
        src_gap.ctypes.data,
        src_gap_off.ctypes.data,
        sc.ctypes.data,
        ss.ctypes.data,
        sb.ctypes.data,
        sr.ctypes.data,
        ptr_text.ctypes.data,
        ptr_text_off.ctypes.data,
        ptr_ends.ctypes.data,
        ptr_ends_off.ctypes.data,
        text_slot.ctypes.data,
        tb_slot.ctypes.data,
        gap_slot.ctypes.data,
        out_text.ctypes.data,
        out_tb.ctypes.data,
        out_gap.ctypes.data,
        out_text_off.ctypes.data,
        tb_counts.ctypes.data,
        gap_counts.ctypes.data,
    )
    if total < 0:
        raise RuntimeError("assemble capacity exceeded")
    return out_text, out_text_off, out_tb, tb_counts, out_gap, gap_counts
