"""Configuration structs for models and the translation service.

Mirrors the reference's plain-struct config surface:
- service `Config` (reference slimt/Frontend.hh:21-39)
- `Model::Config` (reference slimt/Model.hh:33-51)
- presets tiny/base/nano (reference slimt/Model.cc:206-245)
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ModelConfig:
    """Architecture hyperparameters of a Bergamot student model.

    Defaults are the `tiny` preset (6 encoder layers, 2 SSRU decoder
    layers, 8 heads; reference slimt/Model.cc:206-218).
    """

    encoder_layers: int = 6
    decoder_layers: int = 2
    feed_forward_depth: int = 2
    num_heads: int = 8
    split_mode: str = "sentence"

    # Execution knobs (no reference equivalent); the same fields and
    # defaults as the JAX package's ModelConfig, so one config object
    # drives either package.
    # Quantized-matmul provider: "xla_int8" and "pallas" (the int8
    # affine), "fused" (SSRU and FFN block kernels in the decoder),
    # "f32" (the weights dequantized once, every product in f32: the
    # reference-numerics debug path, no int8 kernel), or
    # "fused_step" (the whole decode step — all layers, the
    # shortlisted logits and the argmax — as one call; the small-batch
    # latency path). Mirrors the reference's compile-time QMM provider
    # switch (QMM.cc:3-34).
    qmm_provider: str = "xla_int8"
    # The reference decoder adds the position-0 sinusoid at *every* decode
    # step (Transformer.cc:160 calls transform_embedding with start=0).
    # Keep True for output parity with the reference; False restores
    # marian's per-position signal.
    decoder_position_zero: bool = True
    # Cross-attention K/V cache dtype for the decode loop; the cache is
    # re-read every step. The default "int16" keeps per-row (b, t)
    # scales at 2 bytes an element in the joined [B, T, E] layout, with
    # a uniform absolute error of rowmax / 65534, and converts to f32
    # inside the attention. "float32" restores exact reference
    # numerics; the other dtypes are explicit opt-ins.
    kv_cache_dtype: str = "int16"
    # Greedy-sampling argmax. "packed_int" (default): one int32 max over
    # integer keys in the accumulator domain — the projection's scale
    # is a positive scalar, so the bias folds to accumulator units once
    # and the float epilogue collapses to an integer add and shift
    # (ops/logits_argmax.packed_int_argmax; first index on ties). The
    # compared-value truncation and half-unit bias rounding are its
    # only numeric deltas. "packed_fp16"/"packed_bf16": 16-bit-float
    # packed keys; "exact": the f32 first-max argmax (reference
    # numerics).
    argmax_method: str = "packed_int"
    # Blockwise encoder self-attention: O(T * block) memory, lifts the
    # reference's hard 128-token wrap for long inputs. "auto" (default)
    # picks per T bucket against models/model.FLASH_AUTO_CROSSOVER_T:
    # the plain SDPA up to the crossover, blockwise beyond. True/False
    # force one path regardless of T.
    flash_attention: "str | bool" = "auto"
    # Fused encoder SDPA for the wrap-length regime (T <= 256): one
    # kernel computes all heads' attention on joined [B, T, E]
    # operands, and the scores never reach device memory. Numerics:
    # the plain SDPA's math, differing only in summation order. "off"
    # = plain SDPA; "on" = force; "auto" = on for the accelerator at
    # supported shapes.
    encoder_sdpa: str = "off"
    # Whole-encoder-layer kernel: QKVO int8 affines, multi-head SDPA,
    # residual/post-LN and the FFN pair of one layer. Supersedes
    # encoder_sdpa when active. Numerics: int8 affines are bit-exact
    # (int32 accumulation is associative); LN and softmax use the split
    # layer's f32 formulas, differing only in summation order. "auto"
    # (default): on for the accelerator at wrap-regime shapes, exact-f32
    # encoder, int8 providers | "on" (force) | "off" (split encoder).
    encoder_layer_kernel: str = "auto"
    # Decode-attention kernel for the int16 joined KV cache: keeps all
    # but the K/V streams on chip. "off" (default) | "on" | "auto" (on
    # for the accelerator; alignment-free int16 requests only).
    attn_kernel: str = "off"
    # Lossless result-transport compaction: the decode returns tokens as
    # 16-bit values and the valid mask bit-packed in one buffer
    # (models/decode.compact_result / unpack_compact). A transport
    # encoding, not a numerics knob; off when vocab_size > 65535
    # (marian tiny/base vocabs are 32k).
    compact_transfer: bool = True
    # Reduced-precision encoder activations ("float16"/"bfloat16"): the
    # residual stream and SDPA operands between encoder blocks ride this
    # dtype. Any reduced dtype upstream of an int8 activation quantize
    # flips rint() by one step on a few entries, and six layers amplify
    # it, so agreement drops to the int8 class. The whole-layer kernel
    # takes exact f32 activations only, so the split layer runs. None =
    # exact f32 encoder.
    encoder_dtype: "str | None" = None


@dataclasses.dataclass
class Config:
    """Service configuration (reference slimt/Frontend.hh:21-39)."""

    max_words: int = 1024  # max padded tokens per device batch
    cache_size: int = 1024  # translation cache entries; 0 disables
    workers: int = 1  # async worker threads
    tgt_length_limit_factor: float = 1.5  # max target len / source len
    wrap_length: int = 128  # hard wrap for long sentences (tokens)
    html: bool = False
    # Async batching window (seconds): how long a worker waits for
    # more segments once work exists. 0 = reference behavior (pack
    # immediately); a few ms raises device batch occupancy under
    # streaming request loads.
    batch_latency: float = 0.0
    # Blocking-service completion pool: host-side response assembly
    # (detokenize + annotations) runs on this many executor threads,
    # overlapped with the device waits for later batches. 0 = strict
    # reference behavior (complete serially on the caller thread).
    completion_threads: int = 4
    # Bulk path (Blocking.translate_bulk) ingest chunk size in lines:
    # each chunk's device batches dispatch before the next chunk
    # tokenizes, hiding device compute behind host ingest. 0 = one
    # chunk (ingest everything first).
    bulk_chunk_lines: int = 2048
    # Bulk-path ingest worker processes: chunks tokenize in this many
    # spawned processes (each with its own TextProcessor), lifting the
    # GIL's one-core cap on host ingest. 0 = in-process ingest (the
    # right choice on few-core hosts, where main-thread unpickling can
    # cost more than the overlapped tokenization it replaces; worth
    # enabling on many-core serving hosts). The pool starts lazily on
    # the first multi-chunk translate_bulk call and lives for the
    # service's lifetime.
    ingest_processes: int = 0
    # Blocking.translate routes through the bulk lane by default: for
    # a known list of lines it produces byte-identical Responses to
    # the per-request path (differential-tested: annotations,
    # alignments, cache interplay, HTML) at a higher host throughput.
    # False pins the reference-style Request/Batcher exhaust loop
    # (slimt/Frontend.cc:91-145) for every call.
    prefer_bulk: bool = True
    # Raise Python's gen-0 garbage-collection threshold to this many
    # allocations while a service exists (0 = leave gc untouched).
    # At the default gen-0 threshold (700 allocations) a host-heavy
    # serving loop runs a gc pass hundreds of times per second. Only
    # ever raises the threshold, never lowers it.
    gc_gen0_threshold: int = 50_000


class preset:
    """Model presets (reference slimt/Model.cc:206-245)."""

    @staticmethod
    def tiny() -> ModelConfig:
        return ModelConfig(encoder_layers=6, decoder_layers=2)

    @staticmethod
    def base() -> ModelConfig:
        return ModelConfig(encoder_layers=6, decoder_layers=2)

    @staticmethod
    def nano() -> ModelConfig:
        return ModelConfig(encoder_layers=4, decoder_layers=2)
