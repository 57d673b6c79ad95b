"""Step-level continuous batching on torch: the counterpart of
slimt_tpu/models/continuous.py.

The decode loop runs in chunks of k steps over a pool of slots. Between
chunks, finished rows free their slots and queued segments are admitted
into them (their encoder pass and cross-KV rows are written in while the
other rows keep decoding in the next chunks).

The pool (`SlotPool`) holds the device state in fixed tensors, updated
in place:
  - per decoder layer, the joined KV cache [B, T, E] and its per-row
    scales (int16 and int8; float16 and bfloat16 carry scalar scales);
  - the additive source mask [B, 1, 1, T];
  - the SSRU cell states, one [L, B, 1, E] block seen per layer;
  - the previous word, per-row step counts and caps, the complete flags.

Three steps, as in the JAX module:
  - `encode_segments`: indices/mask [A, T] → joined KV rows, mask rows and
    caps (the encoder and precompute_cross_kv, eager, on the admission
    batch only);
  - `admit`: an index_copy_ of A new rows into the pool at given slot ids
    (an id >= slots is padding and is dropped);
  - `chunk_decode`: `chunk` decode steps from the carried state, and ONE
    uint16 buffer [B, chunk tokens + bit-packed valid + complete flag].
    On CUDA the chunk is one CUDA graph per pool (models/loop_graph.py):
    the pool's tensors are its fixed buffers by construction.

Numerics are those of greedy_decode (the same decoder_step, argmax and
per-row EOS and cap bookkeeping), so a segment's tokens are those of the
batch-at-a-time path. Alignment-free and full-vocabulary only, as in the
JAX module.

`ContinuousEngine.translate` schedules on the host: shortest-first or
FIFO admission, admissions padded to a fixed bucket, and the fetch of
chunk i (a non-blocking copy into pinned memory behind an event)
harvested after chunk i+1 is dispatched.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from slimt_tpu_torch.models import loop_graph
from slimt_tpu_torch.models import transformer as tfm
from slimt_tpu_torch.models.decode import (
    BIT_WEIGHTS,
    PROVIDERS,
    StepContext,
    as_uint16,
    check_decoder,
    pack_bits16,
    unpack_bits16,
)
from slimt_tpu_torch.ops.encoder_layer import MAX_T
from slimt_tpu_torch.ops.qmm import _f32

# The pool's cache types: the joined caches of precompute_cross_kv.
POOL_CACHES = {"int16": torch.int16, "int8": torch.int8,
               "float16": torch.float16, "bfloat16": torch.bfloat16}
# The whole-step kernel reads these of them (ops/decoder_step.JOINED_KINDS).
FUSED_STEP_POOL_CACHES = ("int16", "float16", "bfloat16")


class SlotPool(NamedTuple):
    """Device-resident decode state for B slots."""

    kv: Tuple  # per decoder layer: dict(k, v, kqi, vqi), rows = slots
    mask_add: torch.Tensor  # [B, 1, 1, T] f32
    states: Tuple  # per decoder layer: [B, 1, E] f32 SSRU cells (one block)
    prev: torch.Tensor  # [B] int32 previous word (0 = start)
    steps_done: torch.Tensor  # [B] int32
    cap: torch.Tensor  # [B] int32 per-row step cap (1.5 x src len)
    complete: torch.Tensor  # [B] bool


@torch.inference_mode()
def encode_segments(
    params,
    indices: torch.Tensor,  # [A, T] int32
    mask: torch.Tensor,  # [A, T] f32
    *,
    num_heads: int,
    provider: Optional[str] = None,
    kv_dtype: Optional[str] = "int16",
    encoder_dtype: Optional[str] = None,
    fused_layer: bool = False,
    fused_sdpa: bool = False,
):
    """Encoder and cross-KV projection of an admission batch: the
    translate_batch prefix (models/decode.py) on A rows, with its encoder
    gates (`fused_layer`, `fused_sdpa`) and `encoder_dtype`. Returns (kv
    rows, mask_add [A, 1, 1, T], cap [A] int32 = max(1, floor(1.5 *
    length)))."""
    act = tfm.act_dtype(encoder_dtype)
    base = None if provider == "fused_step" else provider
    x = tfm.transform_embedding(tfm.embed(params, indices, act))
    mask_add = tfm.make_additive_mask(mask)
    encoder_out = tfm.encoder_forward(
        params, x, mask_add, num_heads, base,
        fused_sdpa=fused_sdpa, fused_layer=fused_layer, act_dtype=act,
    )
    kv = tfm.precompute_cross_kv(params, encoder_out, num_heads, kv_dtype, base)
    lengths = mask.to(torch.float32).sum(-1)
    # floor() matches the batch path's int(limit_factor * len): per ROW
    # here, since a row in a pool has no batch whose longest row caps it.
    cap = torch.clamp(torch.floor(_f32(1.5) * lengths), min=1.0).to(torch.int32)
    return kv, mask_add, cap


def _host_ids(rows) -> np.ndarray:
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    return np.asarray(rows, np.int64)


@torch.inference_mode()
def admit(pool: SlotPool, rows, kv_new, mask_new, cap_new) -> SlotPool:
    """Write A admissions into the pool at `rows` ([A] ids, host or
    device; an id >= B is padding and is dropped), in place. Fresh rows
    start as greedy_decode's do: zero states, prev 0, steps 0,
    incomplete. Returns the pool."""
    ids = _host_ids(rows)
    keep = np.nonzero(ids < pool.prev.shape[0])[0]
    if not len(keep):
        return pool
    device = pool.prev.device
    slots = torch.from_numpy(ids[keep]).to(device)
    picked = torch.from_numpy(keep).to(device)

    def put(dst, src):
        dst.index_copy_(0, slots, src.index_select(0, picked))

    for layer, new in zip(pool.kv, kv_new):
        for name, buffer in layer.items():
            if buffer.dim():  # the float caches' scales are scalars
                put(buffer, new[name])
    put(pool.mask_add, mask_new)
    put(pool.cap, cap_new.to(torch.int32))
    for state in pool.states:
        state.index_fill_(0, slots, 0.0)
    pool.prev.index_fill_(0, slots, 0)
    pool.steps_done.index_fill_(0, slots, 0)
    pool.complete.index_fill_(0, slots, False)
    return pool


def make_pool(params, slots: int, t_slot: int, *, kv_dtype: Optional[str] = "int16",
              device=None) -> SlotPool:
    """An all-complete (empty) pool on the params' device (or `device`);
    rows are populated by `admit`. The pool, and so continuous batching,
    holds the SSRU decoder's cells: a self-attention decoder raises
    (check_decoder)."""
    check_decoder(tfm.decoder_kind(params), path="continuous")
    if kv_dtype not in POOL_CACHES:
        raise ValueError(
            f"continuous decode supports joined KV dtypes only, not {kv_dtype!r}")
    layers = params["decoder"]
    emb_dim = params["emb"]["q"].shape[1]
    if device is None:
        device = params["emb"]["q"].device
    dtype = POOL_CACHES[kv_dtype]
    scaled = not dtype.is_floating_point

    def scale():
        return torch.ones((slots, t_slot), device=device) if scaled else _f32(1.0)

    kv = tuple(
        {"k": torch.zeros((slots, t_slot, emb_dim), dtype=dtype, device=device),
         "v": torch.zeros((slots, t_slot, emb_dim), dtype=dtype, device=device),
         "kqi": scale(), "vqi": scale()}
        for _ in layers
    )
    states = torch.zeros((len(layers), slots, 1, emb_dim), device=device)
    return SlotPool(
        kv=kv,
        mask_add=torch.full((slots, 1, 1, t_slot), -1e8, device=device),
        states=tuple(states.unbind(0)),
        prev=torch.zeros((slots,), dtype=torch.int32, device=device),
        steps_done=torch.zeros((slots,), dtype=torch.int32, device=device),
        cap=torch.zeros((slots,), dtype=torch.int32, device=device),
        complete=torch.ones((slots,), dtype=torch.bool, device=device),
    )


class ChunkDecoder(StepContext):
    """`chunk` decode steps over a pool, in place: the pool's tensors and
    the transport buffer `packed` are its fixed buffers, so on CUDA
    `run_chunk` is what loop_graph captures."""

    def __init__(self, params, pool: SlotPool, *, chunk: int, eos_id: int,
                 num_heads: int, provider: Optional[str] = None,
                 argmax_method: str = "packed_int"):
        super().__init__(params, pool.kv, pool.mask_add,
                         tfm.prepare_output_projection(params, None, provider),
                         num_heads=num_heads, provider=provider,
                         argmax_method=argmax_method)
        self.pool, self.chunk, self.eos_id = pool, chunk, eos_id
        slots = pool.prev.shape[0]
        device = pool.prev.device
        self.weights = torch.tensor(BIT_WEIGHTS, dtype=torch.int32, device=device)
        self.packed = torch.zeros((slots, chunk + -(-chunk // 16) + 1), dtype=torch.int16,
                                  device=device)

    def run_chunk(self) -> None:
        """Up to `chunk` greedy steps, as greedy_decode's: zero embedding
        before a row's first word, the position-0 sinusoid, EOS recorded
        then the row complete, per-row step caps. Steps after every row is
        complete change nothing the pool shows (the JAX loop skips them)."""
        pool = self.pool
        prev, steps, complete, states = pool.prev, pool.steps_done, pool.complete, pool.states
        tokens, valid = [], []
        for _ in range(self.chunk):
            # steps == 0 rows feed the zero embedding: rows have private ages.
            choice, states, _ = self.step(prev, states, steps == 0)
            word = choice.to(torch.int32)
            active = ~complete & (steps < pool.cap)
            tokens.append(torch.where(active, word, 0))
            valid.append(active)
            steps = steps + active.to(torch.int32)
            complete = complete | (active & (word == self.eos_id)) | (steps >= pool.cap)
            prev = torch.where(active, word, prev)
        pool.prev.copy_(prev)
        pool.steps_done.copy_(steps)
        pool.complete.copy_(complete)
        for dst, src in zip(pool.states, states):
            dst.copy_(src)
        packed = torch.cat([
            torch.stack(tokens, 1),
            pack_bits16(torch.stack(valid, 1), self.weights),
            pack_bits16(complete[:, None], self.weights),
        ], dim=1)
        self.packed.copy_(as_uint16(packed))

    def buffer_bytes(self) -> int:
        pool = self.pool
        tensors = [pool.mask_add, *pool.states, pool.prev, pool.steps_done, pool.cap,
                   pool.complete, self.packed]
        tensors += [t for layer in pool.kv for t in layer.values() if t.dim()]
        return sum(t.numel() * t.element_size() for t in tensors)


@torch.inference_mode()
def chunk_decode(
    params,
    pool: SlotPool,
    *,
    chunk: int,
    eos_id: int,
    num_heads: int,
    provider: Optional[str] = None,
    argmax_method: str = "packed_int",
    graphs: Optional[loop_graph.GraphCache] = None,
    _eager: bool = False,
) -> Tuple[SlotPool, torch.Tensor]:
    """Up to `chunk` greedy decode steps from the pool's carried state, in
    place. On CUDA the chunk is a CUDA graph of `graphs` (the caller's
    GraphCache; the engine passes its own), captured at the pool's first
    chunk; `_eager` runs it eagerly. Returns (the pool, packed int16 [B, chunk + W + 1] carrying
    uint16: chunk token columns, W = ceil(chunk / 16) words of valid bits,
    one word of the complete flag), a copy of the chunk's buffer."""
    options = dict(chunk=chunk, eos_id=int(eos_id), num_heads=num_heads,
                   provider=provider, argmax_method=argmax_method)
    device = pool.prev.device
    if device.type != "cuda" or _eager:
        decoder = ChunkDecoder(params, pool, **options)
        decoder.run_chunk()
        return pool, decoder.packed
    if graphs is None:
        raise ValueError("chunk_decode on CUDA replays its chunk from `graphs`, "
                         "a loop_graph.GraphCache: pass one")
    key = ("chunk", id(params), id(pool.prev), pool.prev.data_ptr(),
           tuple(sorted(options.items())))
    bucket = graphs.bucket(key, lambda: ChunkDecoder(params, pool, **options), device)
    with bucket.use() as decoder:
        bucket.graph.run()
        return pool, decoder.packed.clone()


def unpack_chunk(packed, chunk: int):
    """Host inverse of chunk_decode's transport buffer: returns (tokens
    [B, chunk] int32, valid [B, chunk] bool, complete [B] bool)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed).view(np.uint16)
    tokens = packed[:, :chunk].astype(np.int32)
    wvalid = -(-chunk // 16)
    valid = unpack_bits16(packed[:, chunk:chunk + wvalid], chunk)
    complete = unpack_bits16(packed[:, chunk + wvalid:], 1)[:, 0]
    return tokens, valid, complete


class ContinuousEngine:
    """Host scheduler: shortest-first (or FIFO) admission, chunked decode,
    fetch-behind-dispatch.

    `translate(segments)` returns per-segment token lists, those of the
    batch-at-a-time decode of the same segments. The params' device runs
    it: on CUDA each chunk is a replay of the pool's graph (`_eager`: the
    eager chunk, for the checks that compare the two) and the encoder
    takes the whole-layer kernel and the fused SDPA where T <= 256, as a
    Model's "auto" gates do."""

    def __init__(
        self,
        params,
        *,
        eos_id: int,
        num_heads: int,
        slots: int = 256,
        chunk: int = 16,
        t_slot: int = 64,
        admit_bucket: Optional[int] = None,
        kv_dtype: str = "int16",
        provider: Optional[str] = None,
        argmax_method: str = "packed_int",
        encoder_dtype: Optional[str] = None,
        admit_order: str = "shortest",  # "shortest" | "fifo" (online)
        _eager: bool = False,
    ):
        tfm.act_dtype(encoder_dtype)  # raises on a value that is not a dtype
        if provider not in PROVIDERS:
            raise ValueError(f"provider={provider!r} not in {PROVIDERS}")
        if provider == "fused_step" and kv_dtype not in FUSED_STEP_POOL_CACHES:
            raise ValueError(f"fused_step reads the {FUSED_STEP_POOL_CACHES} caches, "
                             f"not {kv_dtype!r}")
        if admit_order not in ("shortest", "fifo"):
            raise ValueError(f"admit_order={admit_order!r}: 'shortest' or 'fifo'")
        self.params = params
        self.eos_id = eos_id
        self.num_heads = num_heads
        self.slots = slots
        self.chunk = chunk
        self.t_slot = t_slot
        self.admit_bucket = admit_bucket or max(8, slots // 4)
        self.kv_dtype = kv_dtype
        self.provider = provider
        self.argmax_method = argmax_method
        self.encoder_dtype = encoder_dtype
        self.admit_order = admit_order
        # The chunk transport packs tokens as uint16 (like the compact
        # transport): marian vocabs are 32k; larger vocabs need a wider
        # token column.
        vocab = params["emb"]["q"].shape[0]
        if vocab > 65535:
            raise ValueError(
                f"continuous decode's uint16 chunk transport supports "
                f"vocab <= 65535, model has {vocab}"
            )
        self.device = params["emb"]["q"].device
        self._eager = _eager
        self._graphs = loop_graph.GraphCache() if self.device.type == "cuda" else None
        self._fused_encoder = self.device.type == "cuda" and t_slot <= MAX_T
        self.pool = make_pool(params, slots, t_slot, kv_dtype=kv_dtype)
        # Host mirror of slot occupancy: segment id per slot (-1 free).
        self.slot_seg = np.full(slots, -1, np.int64)
        self.stats: Dict[str, float] = {
            "chunks": 0, "occupied_rows": 0, "row_slots": 0,
            "admitted": 0, "encode_calls": 0,
        }

    def _encode_admissions(self, seg_tokens: List[List[int]]):
        a = self.admit_bucket
        indices = np.zeros((a, self.t_slot), np.int32)
        mask = np.zeros((a, self.t_slot), np.float32)
        for i, toks in enumerate(seg_tokens):
            if len(toks) > self.t_slot:
                # Never truncate silently: the caller owns wrapping.
                raise ValueError(
                    f"segment of {len(toks)} tokens exceeds the pool's "
                    f"t_slot={self.t_slot}; wrap it first"
                )
            indices[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1.0
        out = encode_segments(
            self.params,
            torch.from_numpy(indices).to(self.device),
            torch.from_numpy(mask).to(self.device),
            num_heads=self.num_heads,
            provider=self.provider,
            kv_dtype=self.kv_dtype,
            encoder_dtype=self.encoder_dtype,
            fused_layer=self._fused_encoder,
            fused_sdpa=self._fused_encoder,
        )
        self.stats["encode_calls"] += 1
        return out

    def _chunk(self) -> torch.Tensor:
        _, packed = chunk_decode(
            self.params, self.pool, chunk=self.chunk, eos_id=self.eos_id,
            num_heads=self.num_heads, provider=self.provider,
            argmax_method=self.argmax_method, graphs=self._graphs, _eager=self._eager)
        return packed

    def translate(self, segments: List[List[int]]) -> List[List[int]]:
        """Decode every segment (the same input contract as
        translate_batch's rows). Admission order: "shortest" mirrors the
        reference Batcher's shortest-first packing; "fifo" admits in
        arrival order (the online regime, where no global sort exists)."""
        if self.admit_order == "shortest":
            order = sorted(range(len(segments)), key=lambda i: len(segments[i]))
        else:
            order = list(range(len(segments)))
        pending = list(reversed(order))  # pop() = admission order
        results: List[Optional[List[int]]] = [None] * len(segments)
        grown: Dict[int, List[int]] = {}
        inflight = None  # (HostCopy of the chunk's buffer, slot_seg snapshot)

        def harvest(fetched, snapshot):
            tokens, valid, complete = unpack_chunk(fetched.numpy(), self.chunk)
            freed = []
            for b in range(self.slots):
                seg = snapshot[b]
                # A snapshot can name a segment that already completed in
                # an earlier chunk (its slot was freed after this chunk was
                # dispatched): that row produced nothing; skip it.
                if seg < 0 or results[seg] is not None:
                    continue
                row = grown.setdefault(seg, [])
                row.extend(tokens[b][valid[b]].tolist())
                self.stats["occupied_rows"] += 1
                if complete[b]:
                    results[seg] = grown.pop(seg)
                    freed.append(b)
            self.stats["row_slots"] += self.slots
            return freed

        def release(freed):
            free.extend(freed)
            for b in freed:
                # A freed slot stays idle for the chunk already dispatched;
                # cleared here so the next admission round can take it.
                self.slot_seg[b] = -1

        # Occupancy loop: admit → dispatch chunk → (lagged) harvest.
        free = list(range(self.slots))[::-1]
        while pending or (self.slot_seg >= 0).any() or inflight:
            while pending and free:
                batch: List[List[int]] = []
                rows: List[int] = []
                while pending and free and len(batch) < self.admit_bucket:
                    seg = pending.pop()
                    b = free.pop()
                    self.slot_seg[b] = seg
                    batch.append(segments[seg])
                    rows.append(b)
                kv, mask_add, cap = self._encode_admissions(batch)
                row_ids = np.full(self.admit_bucket, self.slots, np.int64)
                row_ids[:len(rows)] = rows
                admit(self.pool, row_ids, kv, mask_add, cap)
                self.stats["admitted"] += len(rows)
            if not (self.slot_seg >= 0).any():
                if inflight:
                    release(harvest(*inflight))
                    inflight = None
                    continue
                break
            snapshot = self.slot_seg.copy()
            fetched = loop_graph.HostCopy(self._chunk())
            self.stats["chunks"] += 1
            # Harvest the previous chunk while this one runs on the device.
            if inflight:
                release(harvest(*inflight))
            inflight = (fetched, snapshot)
        return [r if r is not None else [] for r in results]

    def occupancy(self) -> float:
        return self.stats["occupied_rows"] / max(1, self.stats["row_slots"])

