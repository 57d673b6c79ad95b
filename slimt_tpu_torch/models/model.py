"""Model on torch: the counterpart of slimt_tpu/models/model.py.

Built from the same Package of artifacts, it owns the weights on one
device and turns batches of token segments into Hypotheses with the
same bucketing, shortlist padding, step limits and compact transport
as the JAX Model, so the runtime (`runtime/service.py`,
`runtime/bulk.py`) drives it unchanged through `forward_async` and
`forward_async_arrays`. Those return once the batch is queued on the
Model's dispatch worker (one thread, and on CUDA one side stream), which
runs the batches in submission order, as the JAX device queue does. On
CUDA the worker runs the decode loop as CUDA graphs, one per bucket,
kept in the Model's own LRU (models/loop_graph.py); a meshed Model keeps
one such LRU for each device it decodes on (loop_graph.DeviceGraphs).

The port implements the declared serving config, the `fused` provider
(SSRU and FFN block kernels per decoder layer), the decode-attention
kernel (`attn_kernel`), the argmax methods exact/packed_fp16/packed_bf16,
the `fused_step` latency provider (whole-step kernel per decode step),
every `kv_cache_dtype` (float32: the exact split cache; bfloat16,
float16, int8, k8v16, k16v8 and int16 joined caches; under fused_step
bfloat16 and int16 run as they are and the others as int16, as in the
JAX Model), and the encoder's three gates: the whole-layer kernel
(`encoder_layer_kernel`), the fused SDPA (`encoder_sdpa`) and blockwise
attention (`flash_attention`), so inputs of any length are served,
and the two numerics knobs: `qmm_provider="f32"` (every product in f32
against weights dequantized once at load, the argmax over f32 logits)
and `encoder_dtype` "float16"/"bfloat16" (the split encoder in that
dtype). It loads marian .bin models and the JAX package's native .npz
checkpoints (io/checkpoint.py). A config value that is none of these
raises ValueError; nothing is substituted silently.

The decoder is the Bergamot student's SSRU or marian's transformer
decoder of causal self-attention (transformer-big), as the checkpoint's
names say (`decoder_kind`, transformer.decoder_kind): the latter runs
under the declared providers and "f32", on one device, with the int16
or the float32 caches; the fused providers and a mesh raise ValueError.

With a `mesh` (parallel.sharding.Mesh) the Model is multi-device, as the
JAX Model is with a jax.sharding.Mesh: its weights tensor-parallel over
"model" (or replicated, sharding="replicate"), each batch data-parallel
over "data" and, with shard_sequence, its tokens over "seq"
(models/decode.translate_mesh). On the card its decode replays CUDA
graphs, each data shard's loop on a stream of its own and every shard at
once: each one-device loop (replicated or gathered weights), and the
ranks' lockstep loop (tensor parallelism, int8 caches over data shards)
where every rank is on one card. A lockstep loop whose ranks span cards
runs the same chunks eagerly: one CUDA graph is captured on one card.
The embedding, encoder and caches run eagerly, as on one card.
Where the mesh spans processes (parallel.multihost.global_mesh), each
process feeds its own block of the batch's rows, decodes it through the
graphs of its local card, and the compact results are all-gathered after
its loop, so every process returns the whole batch. On the card a
meshed Model runs a kernel wherever a shard is a whole problem for it:
the JAX Model's gates that turn its Pallas kernels off on a mesh are TPU
lowering limits and are not copied.
"""

from __future__ import annotations

import dataclasses
import io
import itertools
import queue
import threading
import time
import weakref
from concurrent.futures import Future
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from slimt_tpu_torch.config import ModelConfig
from slimt_tpu_torch.device import resolve_device
from slimt_tpu_torch.io import checkpoint, load_items
from slimt_tpu_torch.io.loader import load_weights, model_dims, unstack_layers
from slimt_tpu_torch.io.shortlist import ShortlistGenerator
from slimt_tpu_torch.io.params import params_from_numpy
from slimt_tpu_torch.models.decode import (
    JobTally,
    check_decoder,
    compact_result,
    on_stream,
    translate_batch,
    unpack_compact,
)
from slimt_tpu_torch.models.loop_graph import DeviceGraphs, GraphCache
from slimt_tpu_torch.models.transformer import ACT_DTYPES, KV_DTYPES, SELF_ATTENTION, decoder_kind
from slimt_tpu_torch.ops.encoder_layer import MAX_T
from slimt_tpu_torch.runtime.request import Hypothesis
from slimt_tpu_torch.text.vocabulary import Vocabulary
from slimt_tpu_torch.utils import ShortlistMeter, new_batch, span

# The bucket helpers and their constants are those of the JAX package's
# models/model.py (the bulk lane imports them from here). Keep them
# identical.
SHORTLIST_BUCKET = 1024
SEQ_BUCKET = 16

# flash_attention="auto" runs the blockwise kernel past this T bucket and
# the plain SDPA up to it. A copy of the JAX package's value, not yet
# measured on the card: tokens do not depend on it, since both sides are
# exact-class.
FLASH_AUTO_CROSSOVER_T = 768


def resolve_flash(flash, t_pad: int) -> bool:
    """ModelConfig.flash_attention ("auto"/True/False) for a T bucket:
    "auto" = blockwise only past the crossover."""
    if flash == "auto":
        return t_pad > FLASH_AUTO_CROSSOVER_T
    return bool(flash)

_model_ids = itertools.count()


def _bucket_seq(t: int) -> int:
    return max(SEQ_BUCKET, -(-t // SEQ_BUCKET) * SEQ_BUCKET)


def _bucket_batch(b: int) -> int:
    out = 1
    while out < b:
        out *= 2
    return out


@dataclasses.dataclass
class Package:
    """Artifact bundle: each field is a filesystem path or raw bytes."""

    model: Union[str, bytes]
    vocabulary: Union[str, bytes]
    shortlist: Union[str, bytes, None] = None
    ssplit: Union[str, bytes, None] = None

    @staticmethod
    def _bytes(source: Union[str, bytes, None]) -> Optional[bytes]:
        if source is None:
            return None
        if isinstance(source, (bytes, bytearray)):
            return bytes(source)
        with open(source, "rb") as f:
            return f.read()


# Model.counters()' own keys (the graph cache's are added to them).
COUNTERS = ("forwards", "rows", "rows_padded", "source_tokens", "source_slots",
            "row_steps", "target_tokens")

ARGMAX_METHODS = ("packed_int", "exact", "packed_fp16", "packed_bf16")
KV_CACHE_DTYPES = tuple(d for d in KV_DTYPES if d is not None)
QMM_PROVIDERS = ("xla_int8", "pallas", "fused", "fused_step", "f32")


def _check_config(config: ModelConfig) -> None:
    """Raise ValueError on every config value that is not one of the
    JAX package's."""
    unsupported = []
    if config.kv_cache_dtype not in KV_CACHE_DTYPES:
        unsupported.append(f"kv_cache_dtype={config.kv_cache_dtype!r} (not a cache dtype)")
    # Under fused_step the kernel's argmax is exact, and argmax_method is
    # ignored, as in the JAX package.
    if config.argmax_method not in ARGMAX_METHODS:
        unsupported.append(f"argmax_method={config.argmax_method!r} (not a method)")
    if config.qmm_provider not in QMM_PROVIDERS:
        unsupported.append(f"qmm_provider={config.qmm_provider!r} (not a provider)")
    if config.encoder_dtype is not None and config.encoder_dtype not in ACT_DTYPES:
        unsupported.append(f"encoder_dtype={config.encoder_dtype!r} (not a dtype)")
    for name, modes in (("encoder_layer_kernel", ("on", "auto", "off")),
                        ("encoder_sdpa", ("on", "auto", "off")),
                        ("flash_attention", (True, False, "auto"))):
        value = getattr(config, name)
        if value not in modes:
            unsupported.append(f"{name}={value!r} (not a mode)")
    if unsupported:
        raise ValueError("unsupported config: " + "; ".join(unsupported))


def _run_job(stream, fn, ready, future: Future) -> None:
    """Run one queued batch under inference mode (thread-local) and, on
    CUDA, on `stream` after the caller's `ready` event; its result or
    error goes to `future`."""
    try:
        if stream is not None:
            stream.wait_event(ready)
        with torch.inference_mode(), on_stream(stream):
            result = fn()
    except BaseException as exc:  # noqa: BLE001 -- surfaces from finish()
        future.set_exception(exc)
    else:
        future.set_result(result)


def _serve(jobs: queue.SimpleQueue, stream) -> None:
    """The dispatch worker's loop: jobs in order until None. It keeps no
    reference to a finished job, so the Model can be collected."""
    while True:
        job = jobs.get()
        if job is None:
            return
        _run_job(stream, *job)
        del job


class _DispatchWorker:
    """One daemon thread (and on CUDA one side stream) that runs a Model's
    batches in the order they were submitted, as the JAX device queue
    does; it ends when its Model is collected."""

    def __init__(self, owner, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._jobs = queue.SimpleQueue()
        threading.Thread(
            target=_serve, args=(self._jobs, self.stream),
            name=f"slimt-dispatch-{owner.id}", daemon=True,
        ).start()
        weakref.finalize(owner, self._jobs.put, None)

    def submit(self, fn) -> Future:
        """Queue `fn`; on CUDA it runs after the work the caller's stream
        holds now (the inputs' copies included)."""
        ready = None
        if self.stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        future = Future()
        self._jobs.put((fn, ready, future))
        return future


class Model:
    def __init__(
        self,
        config: ModelConfig,
        package: Package,
        tgt_length_limit_factor: float = 1.5,
        *,
        device="cuda",
        mesh=None,
        sharding: str = "tp",
        shard_sequence: bool = False,
    ):
        """Load `package` onto `device` (keyword-only): the card unless the
        caller asks for "cpu" ("cuda" without a card raises). The first
        three parameters mean what they mean in the JAX Model. On CUDA
        every int8 product and encoder layer runs the hand-written kernels
        of ops/; on the CPU their plain versions.

        `mesh` (a parallel.sharding.Mesh; `device` is then its first
        rank's) makes the Model multi-device: weights split over "model"
        (sharding="tp") or replicated ("replicate"), batches over "data",
        and with shard_sequence=True (and a "seq" axis > 1) the tokens of
        every batch over "seq", which must divide the T bucket (16)."""
        if isinstance(tgt_length_limit_factor, (str, torch.device)):
            raise TypeError(
                "Model's third parameter is tgt_length_limit_factor, as in "
                f"the JAX Model; pass device={tgt_length_limit_factor!r} by keyword"
            )
        _check_config(config)
        if sharding not in ("tp", "replicate"):
            raise ValueError(f"sharding={sharding!r} not in ('tp', 'replicate')")
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device(0)
        self.device = resolve_device(device)
        self.id = next(_model_ids)
        self.config = config
        self.limit_factor = tgt_length_limit_factor

        model_bytes = Package._bytes(package.model)
        if checkpoint.is_native(model_bytes):
            # The JAX package's .npz: stacked layers and the dims in meta.
            stacked, meta = checkpoint.load_native(io.BytesIO(model_bytes))
            host_params = unstack_layers(stacked)
            self.vocab_size = meta["vocab_size"]
            self.emb_dim = meta["emb_dim"]
            self.ffn_dim = meta["ffn_dim"]
        else:
            host_params = load_weights(load_items(model_bytes), config)
            self.vocab_size, self.emb_dim, self.ffn_dim = model_dims(host_params)
        # "ssru" or "self-attention", from the checkpoint's own layers.
        self.decoder_kind = decoder_kind(host_params)
        check_decoder(self.decoder_kind, config.qmm_provider, config.kv_cache_dtype,
                      "loop" if mesh is None else "mesh")
        # Under "f32" the weights are dequantized here, once.
        dequantize = config.qmm_provider == "f32"
        self._data_size, self._shard_seq, self._collectives = 1, False, None
        if mesh is None:
            self.params = params_from_numpy(host_params, self.device, dequantize=dequantize)
        else:
            from slimt_tpu_torch.parallel import sharding as shd

            seq_axis = mesh.shape["seq"]
            self._shard_seq = shard_sequence and seq_axis > 1
            if self._shard_seq and SEQ_BUCKET % seq_axis:
                # T buckets are multiples of 16; the seq axis must divide them.
                raise ValueError(f"seq axis {seq_axis} must divide the T bucket (16)")
            split = shd.replicate_params if sharding == "replicate" else shd.shard_params
            self.params = params_from_numpy(split(host_params, mesh), dequantize=dequantize)
            self._data_size = mesh.shape["data"]
            if mesh.process_count > 1:
                from slimt_tpu_torch.parallel.collectives import Process

                self._collectives = Process()

        self.vocabulary = Vocabulary(Package._bytes(package.vocabulary))
        self._ssplit = Package._bytes(package.ssplit)
        self._processor = None

        self.shortlist_generator: Optional[ShortlistGenerator] = None
        shortlist_bytes = Package._bytes(package.shortlist)
        if shortlist_bytes:
            self.shortlist_generator = ShortlistGenerator(
                shortlist_bytes, vocab_size=self.vocab_size
            )
        self.shortlist_meter = ShortlistMeter()
        # The decode loop's graphs (CUDA; on a mesh one cache for each
        # device); private: the steps a chunk (None: the default) and the
        # eager loop on the card, for the checks that compare them.
        self._graphs = None
        if self.device.type == "cuda":
            self._graphs = GraphCache() if mesh is None else DeviceGraphs()
        self._loop_unroll = None
        self._eager_loop = False
        self._worker: Optional[_DispatchWorker] = None
        self._worker_lock = threading.Lock()
        # Added to by the dispatch worker alone, once a batch (counters()).
        self._counts = dict.fromkeys(COUNTERS, 0)
        if self.decoder_kind == SELF_ATTENTION:
            self._counts["self_positions"] = 0

    def counters(self) -> dict:
        """What this Model's forwards did, since it was made: `forwards`;
        `rows` and `rows_padded` (the B bucket); `source_tokens` and
        `source_slots` (B bucket x T bucket); `row_steps` (B bucket x the
        decode steps its loop ran, chunks x k) and `target_tokens` (served,
        EOS included); and its graph cache's `hits`, `misses`,
        `evictions` and `capture_s` (0 without one: on the CPU). A
        self-attention decoder adds `self_positions` (the cache positions
        its self-attention read: B bucket x the sum of step + 1 over the
        steps run) and `self_cache_bytes` (the self-attention caches the
        graph cache holds now)."""
        out = dict(self._counts)
        if self.decoder_kind == SELF_ATTENTION:
            held = [] if self._graphs is None else self._graphs.items()
            out["self_cache_bytes"] = sum(bucket.state.self_cache_bytes() for _, bucket in held)
        graphs = self._graphs
        counts = {} if graphs is None else graphs.counts
        if isinstance(graphs, DeviceGraphs):  # one cache a device: summed
            counts = {k: sum(c[k] for c in counts.values())
                      for k in ("hits", "misses", "evictions")}
        for key in ("hits", "misses", "evictions"):
            out[key] = counts.get(key, 0)
        out["capture_s"] = 0.0 if graphs is None else graphs.capture_s
        return out

    def _dispatch_worker(self) -> _DispatchWorker:
        with self._worker_lock:
            if self._worker is None:
                self._worker = _DispatchWorker(self, self.device)
            return self._worker

    @property
    def processor(self):
        """The TextProcessor, built on first access: it imports the
        sentence splitter and with it `regex`."""
        if self._processor is None:
            from slimt_tpu_torch.text.processor import TextProcessor

            self._processor = TextProcessor(
                self.config.split_mode,
                self.vocabulary,
                self._ssplit.decode("utf-8") if self._ssplit else None,
            )
        return self._processor

    # -- device forward ------------------------------------------------

    def forward(
        self, segments: Sequence[Sequence[int]], need_alignment: bool = True
    ) -> List[Hypothesis]:
        """Translate a batch of token segments (each ending in EOS)."""
        return self.forward_async(segments, need_alignment)()

    def forward_async(
        self,
        segments: Sequence[Sequence[int]],
        need_alignment: bool = True,
        raw: bool = False,
    ):
        """Queue the batch on this Model's dispatch worker and return a
        zero-arg callable producing the Hypotheses (or, with raw=True, the
        columnar arrays: tokens [B, steps], per-row step counts, alignment
        or None). It returns once the batch is queued, so callers can
        launch several batches back-to-back and fetch results later; the
        batches run in submission order, and an error in one surfaces from
        its callable."""
        batch = len(segments)
        lengths = [len(s) for s in segments]
        # power-of-two bucket, rounded to a multiple of the data axis
        b_pad = -(-_bucket_batch(batch) // self._data_size) * self._data_size
        t_pad = _bucket_seq(max(lengths))
        indices = np.full((b_pad, t_pad), self.vocabulary.pad_id, np.int32)
        mask = np.zeros((b_pad, t_pad), np.float32)
        for i, segment in enumerate(segments):
            indices[i, : len(segment)] = segment
            mask[i, : len(segment)] = 1.0
        words = None
        if self.shortlist_generator is not None:
            words = [w for s in segments for w in s]
        return self._dispatch(
            indices, mask, lengths, batch, need_alignment, words, raw=raw
        )

    def forward_async_arrays(
        self,
        indices: np.ndarray,
        mask: np.ndarray,
        lengths,
        batch: int,
        need_alignment: bool = False,
        shortlist_words=None,
        raw: bool = False,
    ):
        """Columnar forward on padded [B, T] arrays packed by the
        caller (the bulk lane); queued as forward_async is."""
        return self._dispatch(
            indices, mask, lengths, batch, need_alignment,
            shortlist_words, raw=raw,
        )

    def _dispatch(
        self, indices, mask, lengths, batch, need_alignment,
        shortlist_words, raw: bool = False,
    ):
        """Prepare the batch on the caller's thread (padding, shortlist
        ids, the shortlist meter: errors raise here), then queue the
        decode, the compaction and the device-to-host copy on the
        dispatch worker. finish() waits for them and builds the result.

        Spans (utils.span, while recording), all of one `batch` id:
        model.prepare (child model.shortlist) on the caller's thread;
        model.job on the worker, with its children model.h2d, the decode's
        (decode.translate_batch) and model.d2h; model.finish where
        finish() runs."""
        batch_id = new_batch()
        with span("model.prepare", batch=batch_id):
            # Copies: the caller may reuse its buffers once this returns.
            indices = np.array(indices, np.int32)
            mask = np.array(mask, np.float32)
            b_pad, t_pad = indices.shape
            shortlist_ids = None
            if self.shortlist_generator is not None:
                words = shortlist_words
                if words is None:
                    words = []
                elif isinstance(words, np.ndarray):
                    words = words.tolist()
                with span("model.shortlist"):
                    generated = self.shortlist_generator.generate(words)
                    shortlist_ids = self.shortlist_generator.pad(
                        generated, SHORTLIST_BUCKET
                    ).astype(np.int32)
                self.shortlist_meter.record_widths(len(generated), len(shortlist_ids))

            # Static bound (sizes the outputs, from the bucketed T) vs the
            # reference's limit_factor x the batch's actual longest source.
            max_steps = max(1, int(self.limit_factor * t_pad))
            actual_max = max((int(n) for n in lengths), default=t_pad)
            steps_cap = max(1, int(self.limit_factor * actual_max))
            source_tokens = int(np.sum(lengths))
            compact = self.config.compact_transfer and self.vocab_size <= 65535
            self_attention = self.decoder_kind == SELF_ATTENTION
            device = self.device
            # A mesh takes the host arrays and places each shard itself; across
            # processes each process feeds its own block of the rows.
            feed = device if self.mesh is None else torch.device("cpu")
            rows = slice(None)
            if self._collectives is not None:
                block = indices.shape[0] // self.mesh.process_count
                rows = slice(self.mesh.process_index * block,
                             (self.mesh.process_index + 1) * block)

        def run():
            with span("model.job", batch=batch_id, submitted_ns=submitted,
                      rows=batch, rows_padded=b_pad, t_pad=t_pad) as job:
                # CUDA events at the job's start, the loop's start and after
                # the loop, only while the spans record.
                tally = JobTally(timed=job.on and device.type == "cuda")
                tally.mark()
                with span("model.h2d"):
                    shortlist = None
                    if shortlist_ids is not None:
                        shortlist = torch.from_numpy(shortlist_ids).to(feed)
                    ids = torch.from_numpy(indices[rows]).to(feed)
                    masks = torch.from_numpy(mask[rows]).to(feed)
                result = translate_batch(
                    self.params,
                    ids,
                    masks,
                    eos_id=self.vocabulary.eos_id,
                    max_steps=max_steps,
                    num_heads=self.config.num_heads,
                    shortlist=shortlist,
                    decoder_position_zero=self.config.decoder_position_zero,
                    steps_cap=steps_cap,
                    with_alignment=bool(need_alignment),
                    provider=self.config.qmm_provider,
                    # "float32" is the exact split cache, as in the JAX Model
                    # (under fused_step the loop then takes int16).
                    kv_dtype=(None if self.config.kv_cache_dtype == "float32"
                              else self.config.kv_cache_dtype),
                    argmax_method=self.config.argmax_method,
                    attn_kernel=self._attn_kernel(),
                    flash_attention=resolve_flash(self.config.flash_attention, t_pad),
                    fused_sdpa=self._on_card(self.config.encoder_sdpa, t_pad),
                    fused_layer=self._on_card(self.config.encoder_layer_kernel, t_pad),
                    loop_unroll=self._loop_unroll,
                    graphs=self._graphs,
                    _eager=self._eager_loop,
                    encoder_dtype=self.config.encoder_dtype,
                    shard_sequence=self._shard_seq,
                    tally=tally,
                )
                with span("model.d2h"):
                    gather = (self._collectives.all_gather if self._collectives is not None
                              else (lambda t: t))
                    align = gather(result.alignment).cpu().numpy() if need_alignment else None
                    if compact:
                        packed = gather(compact_result(result).packed)
                        tokens, valid = unpack_compact(packed, max_steps)
                    else:
                        tokens = gather(result.tokens).cpu().numpy()
                        valid = gather(result.valid).cpu().numpy()
                target_tokens = int(valid[:batch].sum())
                counts = self._counts
                counts["forwards"] += 1
                counts["rows"] += batch
                counts["rows_padded"] += b_pad
                counts["source_tokens"] += source_tokens
                counts["source_slots"] += b_pad * t_pad
                counts["row_steps"] += b_pad * tally.steps
                counts["target_tokens"] += target_tokens
                extra = {}
                if self_attention:
                    # Step s reads positions 0..s of its self-cache.
                    extra["self_positions"] = b_pad * tally.steps * (tally.steps + 1) // 2
                    counts["self_positions"] += extra["self_positions"]
                if job.on:
                    job.set(steps=tally.steps, target_tokens=target_tokens,
                            **tally.device_ns(), **extra)
            return (tokens, valid), align

        submitted = time.perf_counter_ns()
        future = self._dispatch_worker().submit(run)

        def finish():
            with span("model.finish", batch=batch_id):
                (tokens, valid), align = future.result()
                if raw:
                    steps = valid[:batch].sum(axis=1).astype(np.int32)
                    return tokens, steps, align
                histories = []
                for i in range(batch):
                    steps = int(valid[i].sum())
                    target = tokens[i, :steps].tolist()
                    alignment = (
                        [align[i, t, : lengths[i]].tolist() for t in range(steps)]
                        if align is not None
                        else []
                    )
                    histories.append(Hypothesis(target=target, alignment=alignment))
                return histories

        return finish

    def _on_card(self, mode: str, t_pad: int) -> bool:
        """encoder_sdpa and encoder_layer_kernel: "on", or "auto" on the
        port's accelerator (CUDA) in the wrap regime (T bucket <= 256), as
        the JAX package turns them on for its accelerator backend."""
        return mode == "on" or (
            mode == "auto" and self.device.type == "cuda" and t_pad <= MAX_T
        )

    def _attn_kernel(self) -> bool:
        """attn_kernel "on", or "auto" on the port's accelerator (CUDA),
        as the JAX package turns it on for its accelerator backend; the
        decode loop then gates it to alignment-free int16 requests."""
        mode = self.config.attn_kernel
        return mode == "on" or (mode == "auto" and self.device.type == "cuda")

    def warmup(
        self,
        batch_buckets: Sequence[int] = (1, 8, 64),
        seq_buckets: Sequence[int] = (16, 32, 64, 128),
        alignment: bool = False,
    ) -> int:
        """Run each (B, T) bucket once: builds the kernels, fills the
        allocator's cache and, on CUDA, captures each bucket's decode
        graph. Returns the number of runs."""
        runs = 0
        for b in batch_buckets:
            for t in seq_buckets:
                segment = [1] * (t - 1) + [self.vocabulary.eos_id]
                self.forward([segment] * b, need_alignment=False)
                runs += 1
                if alignment:
                    self.forward([segment] * b, need_alignment=True)
                    runs += 1
        return runs

    def __repr__(self):
        where = f"mesh={self.mesh.shape}" if self.mesh is not None else f"device={self.device}"
        return (
            f"Model(id={self.id}, {where}, vocab={self.vocab_size}, "
            f"emb={self.emb_dim}, ffn={self.ffn_dim})"
        )
