"""Greedy decode on torch: the counterpart of slimt_tpu/models/decode.py.

The JAX package runs the loop as one `lax.while_loop` on the device,
`loop_unroll` steps an iteration. Here `DecodeLoop` holds a batch's
decode state in fixed buffers and advances it k = `loop_unroll` steps a
chunk (`run_chunk`, the JAX `one_step` k times): the step index is a
device int32 tensor, so no step depends on the host. On CUDA the chunk
is captured once per bucket as a CUDA graph (models/loop_graph.py) and
replayed, and the host reads the all-complete flag one replay behind;
on the CPU, and on the card behind the private `_eager`, the chunk runs
eagerly and the flag is read at once. The semantics are the
reference's, as in the JAX package:
  - step 0 feeds a zero embedding (no previous word);
  - the decoder's positional signal is position 0 at every step
    (`decoder_position_zero`), else the step's own position;
  - the EOS token is recorded, then the row is complete;
  - padding rows (fully masked) start complete;
  - the trip count is min(max_steps, steps_cap); the steps of a chunk
    past it are masked (`step < limit`), and the buffers are padded to
    a whole number of chunks and sliced, as in the JAX package;
  - with alignment, each step records head 0 of the last decoder
    layer's cross-attention.

`kv_dtype` picks the cross-attention cache (transformer.
precompute_cross_kv), with the JAX package's coercions (cache_dtype):
"float32" is the exact split cache, except under "fused_step", whose
kernel reads the int16, bfloat16 and float32 joined caches and takes
int16 for any other. Under provider "fused" each decoder layer runs the
SSRU-block and FFN-block kernels; `attn_kernel` runs the
decode-attention kernel on alignment-free int16 requests (never under
"fused_step", as in the JAX package); `argmax_method` picks the greedy
argmax (transformer.output_argmax). Under provider "fused_step" each
step is one call of the whole-step kernel (ops/decoder_step), whose
argument block is built once per bucket over the loop's buffers; the
argmax is then the exact first maximum. Under provider "f32" every
product is an f32 product against the dequantized weights, which the
params must carry (io/params.params_from_numpy(..., dequantize=True),
as a Model loads them) and the argmax runs over f32 logits; `encoder_dtype` runs the
encoder in float16 or bfloat16 (transformer.act_dtype).

The host reads the flag once every `check_every` steps, rounded up to
whole chunks. Rows that are complete, and steps past the limit, are
masked out of tokens, valid and the alignment, so the result depends
on neither k nor `check_every`.

On a mesh (translate_mesh) the same holds for every data shard: each
runs its own DecodeLoop on a stream of its own, and `run_loops` advances
them in turn, a chunk of each a round, as the JAX package's one SPMD
while_loop runs every shard at once; where the ranks must step together
(tensor parallelism, an int8 cache over data shards) one MeshLoop holds
them all in fixed buffers, captured as one graph where every rank is on
one card.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from slimt_tpu_torch.models import loop_graph
from slimt_tpu_torch.models import transformer as tfm
from slimt_tpu_torch.ops import decode_attn
from slimt_tpu_torch.ops import decoder_step as dstep
from slimt_tpu_torch.ops.qmm import _f32
from slimt_tpu_torch.utils import span

CHECK_EVERY = 8

# Decode steps a chunk (a graph replay) runs where the caller passes no
# `loop_unroll`; SLIMT_TPU_DECODE_UNROLL overrides it. Read once at
# import, as in the JAX package: set it before the process imports
# slimt_tpu_torch, or pass `loop_unroll`.
DEFAULT_UNROLL = 8
_ENV_DECODE_UNROLL = int(os.environ.get("SLIMT_TPU_DECODE_UNROLL", DEFAULT_UNROLL))


# Providers of the declared path; "fused" runs the block kernels,
# "fused_step" is the latency path and "f32" the reference-numerics path.
DECLARED_PROVIDERS = (None, "xla_int8", "pallas")
PROVIDERS = DECLARED_PROVIDERS + ("fused", "fused_step", "f32")
# The joined caches the whole-step kernel reads; under fused_step every
# other kv_dtype becomes int16 (slimt_tpu/models/decode.py:98-106).
FUSED_STEP_CACHES = ("bfloat16", "float32", "int16")


def check_options(provider: Optional[str], kv_dtype: Optional[str]) -> None:
    """Raise ValueError on a provider that is not one (PROVIDERS) and on
    a kv_dtype that is not a cache dtype (transformer.KV_DTYPES)."""
    if provider not in PROVIDERS:
        raise ValueError(f"provider={provider!r} not in {PROVIDERS}")
    if kv_dtype not in tfm.KV_DTYPES:
        raise ValueError(f"kv_dtype={kv_dtype!r} not in {tfm.KV_DTYPES}")


def check_decoder(kind: str, provider: Optional[str] = None,
                  kv_dtype: Optional[str] = "int16", path: str = "loop") -> None:
    """The one guard of what the self-attention decoder (kind, from
    transformer.decoder_kind) cannot run: raise ValueError on `path`
    "mesh" (its self-caches live in the one-device loop only) and
    "continuous" (the slot pool holds SSRU cells), and on the one-device
    loop under the SSRU's block and whole-step providers or with a
    cross-attention cache other than int16 (the declared one) or the
    exact float32 split cache (None)."""
    if kind != tfm.SELF_ATTENTION:
        return
    if path == "mesh":
        raise ValueError("the self-attention decoder is not served on a mesh: its "
                         "self-attention caches live in the one-device loop only")
    if path == "continuous":
        raise ValueError("continuous batching serves the SSRU decoder only: the "
                         "self-attention decoder's caches are not in the slot pool")
    if provider in ("fused", "fused_step"):
        raise ValueError(f"provider={provider!r} runs SSRU kernels; the self-attention "
                         f"decoder runs under {DECLARED_PROVIDERS + ('f32',)}")
    if kv_dtype not in ("int16", None, "float32"):
        raise ValueError(f"kv_dtype={kv_dtype!r}: the self-attention decoder's caches "
                         "are int16 or float32")


def cache_dtype(provider: Optional[str], kv_dtype: Optional[str]) -> Optional[str]:
    """The cache the loop builds for `kv_dtype`, with the JAX package's
    coercions: under fused_step any cache but bfloat16, float32 and int16
    becomes int16; elsewhere "float32" means the exact split f32 cache
    (None)."""
    if provider == "fused_step":
        return kv_dtype if kv_dtype in FUSED_STEP_CACHES else "int16"
    return None if kv_dtype == "float32" else kv_dtype


def resolve_unroll(loop_unroll: Optional[int]) -> int:
    """Steps a chunk: `loop_unroll`, or SLIMT_TPU_DECODE_UNROLL's value
    (DEFAULT_UNROLL where it is unset); at least 1."""
    return max(1, int(_ENV_DECODE_UNROLL if loop_unroll is None else loop_unroll))


class GreedyResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_steps] int32
    valid: torch.Tensor  # [B, max_steps] bool — recorded positions
    alignment: torch.Tensor  # [B, max_steps, T_src or 0] f32


def _load(dst, src) -> None:
    """Copy `src` into the buffers `dst` (tensors, or tuples and dicts of
    them); a tensor that already is the buffer (the full-vocabulary
    projection, a view of the weights), and a CPU scalar, stay."""
    if isinstance(dst, dict):
        for key in dst:
            _load(dst[key], src[key])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _load(d, s)
    elif isinstance(dst, torch.Tensor) and dst.dim() and not (
            dst.data_ptr() == src.data_ptr() and dst.stride() == src.stride()):
        dst.copy_(src)


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dim():
        return tree.numel() * tree.element_size()
    return 0


class StepContext:
    """What each decode step of a loop reads besides its carried state,
    built once over the loop's fixed buffers: the cross-KV caches, the
    mask and the projection, the packed-int bias, the whole step's
    argument block (fused_step on CUDA), the embedding scale and the
    position-0 signal, and the decoder's kind (transformer.decoder_kind),
    read once here. `step` is one decoder step over them; DecodeLoop
    and continuous.ChunkDecoder both run it."""

    def __init__(self, params, kv_caches, mask_add, projection, *, num_heads, provider,
                 argmax_method, attn_kernel=False):
        self.params = params
        self.kv, self.mask_add, self.projection = kv_caches, mask_add, projection
        self.num_heads = num_heads
        self.provider, self.argmax_method, self.attn_kernel = provider, argmax_method, attn_kernel
        emb_dim = params["emb"]["q"].shape[1]
        device = mask_add.device
        self.packed_bias = None
        if tfm.uses_packed_int(provider, argmax_method):
            self.packed_bias = tfm.packed_int_bias(params, projection[1])
        self.plan = None
        if provider == "fused_step" and device.type == "cuda":
            self.plan = dstep.StepPlan(
                params["decoder"], kv_caches, mask_add, num_heads, projection,
                params["out"]["aq"], tfm.output_inv(params),
            )
        self.sqrt_e = _f32(math.sqrt(emb_dim))
        self.signal0 = tfm.sinusoidal_signal(0, 1, emb_dim, device=device)
        self.kind = tfm.decoder_kind(params)

    def step(self, prev, states, fresh, position=None, at=None):
        """One decoder step after the words `prev` [B]: the zero embedding
        where `fresh` ([B] bool, or [1] for every row) is set, and the
        sinusoid at `position` (a [1] device step; None: position 0).
        `at`, the device step, is where the self-attention decoder writes
        its caches (decoder_step, which dispatches on the kind). Returns
        decoder_step's (choice, new states, attention)."""
        embedded = tfm.embed(self.params, prev[:, None])
        prev_embed = torch.where(fresh[:, None, None], 0.0, embedded)
        if position is None:
            signal = self.signal0
        else:
            signal = tfm.sinusoidal_signal(
                0, 1, embedded.shape[-1], positions=position.to(torch.float32))
        x = prev_embed * self.sqrt_e + signal
        return tfm.decoder_step(
            self.params, states, x, self.mask_add, self.kv, self.num_heads,
            projection=self.projection, provider=self.provider, plan=self.plan,
            argmax_method=self.argmax_method, attn_kernel=self.attn_kernel,
            packed_bias=self.packed_bias, kind=self.kind, at=at,
        )


class _Outputs:
    """What a greedy loop writes at its device step `step`: tokens, valid
    and the head-0 alignment, [B, steps padded to whole chunks(, T_src)],
    behind its step limit. Rows that are complete, and steps past the
    limit, are masked out of all three."""

    def _make_outputs(self, batch: int, steps_padded: int, t_src: int,
                      with_alignment: bool, device) -> None:
        self.with_alignment = with_alignment
        self.limit = torch.zeros(1, dtype=torch.int32, device=device)
        self.tokens = torch.zeros((batch, steps_padded), dtype=torch.int32, device=device)
        self.valid = torch.zeros((batch, steps_padded), dtype=torch.bool, device=device)
        self.align = torch.zeros((batch, steps_padded, t_src if with_alignment else 0),
                                 dtype=torch.float32, device=device)

    def _record(self, step, word, attn, complete, eos_id: int):
        """Write the words `word` [B] int32 chosen at `step` (and head 0 of
        the cross-attention `attn`); returns the rows complete after it."""
        # `step < limit` masks the steps of a chunk past the cap.
        in_limit = step < self.limit
        active = ~complete & in_limit
        at = step.to(torch.long)
        self.tokens.index_copy_(1, at, torch.where(active, word, 0)[:, None])
        self.valid.index_copy_(1, at, active[:, None])
        if self.with_alignment:
            head0 = torch.where(active[:, None], attn[:, 0, 0, :], 0.0)
            self.align.index_copy_(1, at, head0[:, None, :])
        return complete | ((word == eos_id) & in_limit)


class DecodeLoop(StepContext, _Outputs):
    """A batch's greedy decode in fixed buffers: the inputs it adopts (the
    cross-KV caches, the mask, the projection and the shortlist; a later
    batch of the bucket copies its own into them, `load`), the carried
    state (step, limit, prev, states, complete) and the outputs (tokens,
    valid, alignment, padded to whole chunks). `run_chunk` advances them
    `unroll` steps in place; on CUDA it is what loop_graph captures.

    `states` is the SSRU decoder's [L, B, 1, E] block of cells, or the
    self-attention decoder's per-layer caches (transformer.
    make_self_caches, one position a step padded to whole chunks: int16
    beside the int16 cross-attention cache, float32 beside the exact
    split one), which each step writes at the
    device step and which a new batch does not zero: no step reads a
    position its batch has not written. The kind is read once, here."""

    def __init__(self, params, kv_caches, mask_add, projection, shortlist, *,
                 eos_id, num_heads, max_steps, unroll, provider, argmax_method,
                 attn_kernel, with_alignment, decoder_position_zero):
        super().__init__(params, kv_caches, mask_add, projection, num_heads=num_heads,
                         provider=provider, argmax_method=argmax_method,
                         attn_kernel=attn_kernel)
        self.shortlist = shortlist
        self.eos_id = eos_id
        self.max_steps, self.unroll = max_steps, unroll
        self.position_zero = decoder_position_zero
        batch, t_src = mask_add.shape[0], mask_add.shape[-1]
        layers = len(params["decoder"])
        emb_dim = params["emb"]["q"].shape[1]
        device = mask_add.device
        steps_padded = -(-max_steps // unroll) * unroll
        self._make_outputs(batch, steps_padded, t_src, with_alignment, device)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.step_at = zeros(1)
        self.prev = zeros(batch)
        self.complete = zeros(batch, dtype=torch.bool)
        self.done = zeros(1, dtype=torch.bool)
        if self.kind == tfm.SELF_ATTENTION:
            self_dtype = "int16" if isinstance(kv_caches[0], dict) else "float32"
            self.states = tfm.make_self_caches(params, batch, steps_padded, self_dtype, device)
            self._zeroed = ()
            self._carried = lambda: self.states
            self._store = lambda states: None
            return
        # One [L, B, 1, E] block: the whole-step kernel reads it in place.
        self.states = zeros(layers, batch, 1, emb_dim, dtype=torch.float32)
        self._zeroed = (self.states,)
        self._carried = lambda: tuple(self.states.unbind(0))
        self._store = lambda states: torch.stack(states, out=self.states)

    def load(self, kv_caches, mask_add, projection, shortlist) -> None:
        """Copy a batch of this bucket's shapes into the input buffers."""
        _load((self.kv, self.mask_add, self.projection, self.shortlist),
              (kv_caches, mask_add, projection, shortlist))
        if self.packed_bias is not None and projection[1] is not self.projection[1]:
            self.packed_bias.copy_(tfm.packed_int_bias(self.params, projection[1]))

    def reset(self, limit: int) -> None:
        """The carried state and outputs of a new batch; padding rows
        (fully masked) start complete."""
        for buffer in (self.step_at, self.prev, *self._zeroed, self.done, self.tokens,
                       self.valid, self.align):
            buffer.zero_()
        self.limit.fill_(limit)
        self.complete.copy_(~(self.mask_add[:, 0, 0, :] == 0.0).any(-1))

    def _one_step(self, step, prev, states, complete):
        choice, new_states, attn = self.step(
            prev, states, step == 0, None if self.position_zero else step, step)
        if self.shortlist is not None:
            choice = self.shortlist[choice.to(torch.long)]
        word = choice.to(torch.int32)
        complete = self._record(step, word, attn, complete, self.eos_id)
        return step + 1, word, new_states, complete

    def run_chunk(self) -> None:
        """`unroll` steps from the carried state, written back in place,
        and the all-complete flag `done`."""
        step, prev, complete = self.step_at, self.prev, self.complete
        states = self._carried()
        for _ in range(self.unroll):
            step, prev, states, complete = self._one_step(step, prev, states, complete)
        self.step_at.copy_(step)
        self.prev.copy_(prev)
        self.complete.copy_(complete)
        self._store(states)
        self.done.copy_(complete.all().reshape(1))

    def result(self) -> GreedyResult:
        n = self.max_steps
        return GreedyResult(self.tokens[:, :n], self.valid[:, :n], self.align[:, :n])

    def buffer_bytes(self) -> int:
        return _nbytes((self.kv, self.mask_add, self.projection, self.shortlist,
                        self.states, self.tokens, self.valid, self.align))

    def self_cache_bytes(self) -> int:
        """The bytes of the self-attention decoder's caches (0 for SSRU)."""
        return _nbytes(self.states) if self.kind == tfm.SELF_ATTENTION else 0


class JobTally:
    """What a decode tells its caller (translate_batch's `tally`): `steps`,
    the decode steps its loop ran (chunks x k; on a mesh the longest
    loop's), and with `timed` (on CUDA) three timing events on the
    current stream: `mark()` at the job's start (the caller's), at the
    loop's start (after the cross-K/V) and after the loop."""

    def __init__(self, timed: bool = False):
        self.steps = 0
        self.events = [] if timed else None

    def mark(self) -> None:
        if self.events is not None:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.events.append(event)

    def device_ns(self) -> dict:
        """`device_encode_ns` (job start to loop start: the inputs' copies,
        embedding, encoder and cross-K/V) and `device_decode_ns` (the loop,
        its binding included) on the device's clock, once the events have
        completed; {} without the three."""
        if self.events is None or len(self.events) != 3:
            return {}
        start, loop, end = self.events
        return {"device_encode_ns": round(start.elapsed_time(loop) * 1e6),
                "device_decode_ns": round(loop.elapsed_time(end) * 1e6)}


class LoopRun(NamedTuple):
    """A loop run_loops advances: its state (`unroll`, the flag `done`),
    `chunk`, which runs one chunk (a graph's `run`, or the state's
    `run_chunk` run eagerly), the stream its chunks go to (None: the
    current one), the lag of its flag reads (loop_graph.FlagReader) and
    whether its buffers are a kept bucket's (loop_graph.GraphCache)."""

    loop: object
    chunk: Callable[[], None]
    stream: Optional["torch.cuda.Stream"] = None
    lag: int = 0
    kept: bool = False


def on_stream(stream):
    """The context that makes `stream` current (None: the current one)."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def run_loops(runs, limit: int, check_every: int) -> list:
    """Advance several loops (LoopRun) in turn, one chunk of each a round,
    each on its own stream, until each one's step reaches `limit` or a
    read of its all-complete flag says every row is done; each flag is
    read once every `check_every` steps, rounded up to whole chunks. A
    loop that is done is advanced no further; the call returns when the
    last one is. With lag 1 a read waits for the loop's last read chunk
    only, while the chunks queued since run on. Returns the chunks each
    loop ran (`run_loop.chunks` counts them all, over every thread)."""
    readers = [loop_graph.FlagReader(run.loop.done, run.lag) for run in runs]
    steps, chunks = [0] * len(runs), [0] * len(runs)
    active = list(range(len(runs)))
    while active:
        still = []
        for i in active:
            run = runs[i]
            every = -(-max(1, int(check_every)) // run.loop.unroll)
            with on_stream(run.stream):
                run.chunk()
                chunks[i] += 1
                steps[i] += run.loop.unroll
                if steps[i] >= limit or (chunks[i] % every == 0 and readers[i].read()):
                    continue
            still.append(i)
        active = still
    with _chunks_lock:
        run_loop.chunks += sum(chunks)
    return chunks


def run_loop(loop: DecodeLoop, limit: int, check_every: int, chunk=None) -> int:
    """run_loops of one loop on the current stream. `chunk` runs one chunk
    (a graph's `run`, whose flag is read one replay behind); None runs
    `loop.run_chunk` eagerly and reads the flag at once. Returns the
    chunks run."""
    if chunk is None:
        return run_loops([LoopRun(loop, loop.run_chunk)], limit, check_every)[0]
    return run_loops([LoopRun(loop, chunk, lag=1)], limit, check_every)[0]


run_loop.chunks = 0
_chunks_lock = threading.Lock()


def loop_key(params, loop_args: dict, kv_caches, mask_add, projection, shortlist) -> tuple:
    """What a capture fixes: the weights (and so their device and layer
    count), the options (k and the steps among them), the cache type and
    the shapes (B, T, the projection width)."""
    first = kv_caches[0]
    cache = (first["k"].dtype, first["v"].dtype) if isinstance(first, dict) else "split"
    return ("greedy", id(params), tuple(mask_add.shape), cache,
            tuple(projection[0].shape), shortlist is not None,
            tuple(sorted(loop_args.items())))


@torch.inference_mode()
def greedy_decode(
    params: dict,
    encoder_out: torch.Tensor,
    mask_add: torch.Tensor,
    eos_id: int,
    max_steps: int,
    num_heads: int,
    shortlist: Optional[torch.Tensor] = None,
    decoder_position_zero: bool = True,
    steps_cap: Optional[int] = None,
    with_alignment: bool = True,
    check_every: int = CHECK_EVERY,
    provider: Optional[str] = None,
    kv_dtype: Optional[str] = "int16",
    argmax_method: str = "packed_int",
    attn_kernel: bool = False,
    loop_unroll: Optional[int] = None,
    graphs: Optional[loop_graph.GraphCache] = None,
    _eager: bool = False,
    tally: Optional[JobTally] = None,
) -> GreedyResult:
    """Greedy decode of `encoder_out` [B, T, E], `loop_unroll` steps a
    chunk (None: resolve_unroll's default). On CUDA the chunk runs as a
    CUDA graph of `graphs` (None: the process's cache), captured at the
    bucket's first batch; `_eager` runs it eagerly instead, for the
    checks that compare the two. On the CPU it runs eagerly. `tally`
    (a JobTally) gets the steps run and its loop marks. Spans:
    decode.cross_kv, decode.bind, decode.loop."""
    check_options(provider, kv_dtype)
    check_decoder(tfm.decoder_kind(params), provider, kv_dtype)
    attn_kernel = gate_attn_kernel(attn_kernel, with_alignment, kv_dtype, provider)
    with span("decode.cross_kv"):
        kv_caches = tfm.precompute_cross_kv(
            params, encoder_out, num_heads, cache_dtype(provider, kv_dtype),
            None if provider == "fused_step" else provider)
    limit = step_limit(max_steps, steps_cap)
    loop_args = greedy_args(eos_id, num_heads, max_steps, loop_unroll, provider,
                            argmax_method, attn_kernel, with_alignment, decoder_position_zero)
    if tally is not None:
        tally.mark()
    with contextlib.ExitStack() as stack:
        with span("decode.bind"):
            run = start_loop(stack, params, kv_caches, mask_add, shortlist, limit, loop_args,
                             graphs, _eager)
        with span("decode.loop"):
            chunks = run_loops([run], limit, check_every)[0]
        if tally is not None:
            tally.mark()
            tally.steps = chunks * run.loop.unroll
        return finish_loop(run)


def gate_attn_kernel(attn_kernel: bool, with_alignment: bool, kv_dtype: Optional[str],
                     provider: Optional[str]) -> bool:
    """The decode-attention kernel serves the alignment-free int16 path
    only (it returns no attention weights), as in the JAX package."""
    return bool(attn_kernel) and not with_alignment and (
        kv_dtype == "int16") and provider != "fused_step"


def step_limit(max_steps: int, steps_cap: Optional[int]) -> int:
    """The trip count: min(max_steps, steps_cap)."""
    return max_steps if steps_cap is None else min(max_steps, int(steps_cap))


def start_loop(
    stack: contextlib.ExitStack, params: dict, kv_caches, mask_add: torch.Tensor,
    shortlist: Optional[torch.Tensor], limit: int, loop_args: dict,
    graphs: Optional[loop_graph.GraphCache], eager: bool, stream=None,
) -> LoopRun:
    """Bind a batch to its loop and load it, on `stream` (None: the
    current one): on the CPU, or with `eager`, a new DecodeLoop over the
    batch's tensors, run eagerly with its flag read at once; on CUDA the
    bucket of `graphs` for the batch's key, held in `stack` (Bucket.use)
    until the batch is done, its buffers loaded, replayed with its flag
    read one replay behind. Returns the LoopRun, reset to `limit`."""
    with on_stream(stream):
        projection = tfm.prepare_output_projection(params, shortlist, loop_args["provider"])

        def make_loop():
            return DecodeLoop(params, kv_caches, mask_add, projection, shortlist, **loop_args)

        if not mask_add.is_cuda or eager:
            loop = make_loop()
            loop.reset(limit)
            return LoopRun(loop, loop.run_chunk, stream)
        if graphs is None:
            raise ValueError("greedy_decode on CUDA replays its chunks from `graphs`, "
                             "a loop_graph.GraphCache: pass one")
        key = loop_key(params, loop_args, kv_caches, mask_add, projection, shortlist)
        bucket = graphs.bucket(key, make_loop, mask_add.device)
        loop = stack.enter_context(bucket.use())
        loop.load(kv_caches, mask_add, projection, shortlist)
        loop.reset(limit)
        return LoopRun(loop, bucket.graph.run, stream, lag=1, kept=True)


def finish_loop(run: LoopRun):
    """The result of a run's loop (a GreedyResult, or MeshLoop's list of
    them): a bucket's buffers serve the bucket's next batch, so a kept
    loop hands out copies, made on its stream."""
    result = run.loop.result()
    if not run.kept:
        return result
    with on_stream(run.stream):
        if isinstance(result, GreedyResult):
            return GreedyResult(*(t.clone() for t in result))
        return [GreedyResult(*(t.clone() for t in r)) for r in result]


def greedy_args(eos_id, num_heads, max_steps, loop_unroll, provider, argmax_method,
                attn_kernel, with_alignment, decoder_position_zero) -> dict:
    """A DecodeLoop's options (and a part of its bucket's key)."""
    return dict(
        eos_id=int(eos_id), num_heads=num_heads, max_steps=max_steps,
        unroll=resolve_unroll(loop_unroll), provider=provider,
        argmax_method=argmax_method, attn_kernel=attn_kernel,
        with_alignment=bool(with_alignment),
        decoder_position_zero=bool(decoder_position_zero),
    )


def translate_batch(
    params: dict,
    indices: torch.Tensor,
    mask: torch.Tensor,
    eos_id: int,
    max_steps: int,
    num_heads: int,
    shortlist: Optional[torch.Tensor] = None,
    decoder_position_zero: bool = True,
    steps_cap: Optional[int] = None,
    with_alignment: bool = True,
    check_every: int = CHECK_EVERY,
    provider: Optional[str] = None,
    kv_dtype: Optional[str] = "int16",
    argmax_method: str = "packed_int",
    attn_kernel: bool = False,
    flash_attention: bool = False,
    fused_sdpa: bool = False,
    fused_layer: bool = False,
    loop_unroll: Optional[int] = None,
    graphs: Optional[loop_graph.GraphCache] = None,
    _eager: bool = False,
    encoder_dtype: Optional[str] = None,
    shard_sequence: bool = False,
    tally: Optional[JobTally] = None,
) -> GreedyResult:
    """embed → encoder → greedy decode for a padded [B, T] batch.
    `provider` "fused" runs the decoder's SSRU and FFN block kernels (and
    the split encoder's FFN), "fused_step" each decode step as one
    whole-step call. The encoder takes `flash_attention`, `fused_sdpa`
    and `fused_layer` (transformer.encoder_layer_forward) and the
    provider, which under "fused_step" is None, as in the JAX package;
    `encoder_dtype` ("float16"/"bfloat16") runs the embedding and the
    encoder in that dtype. `loop_unroll`, `graphs`, `_eager` and `tally`
    go to greedy_decode. Spans: decode.encoder (embedding and encoder),
    then greedy_decode's.

    On a mesh (`params` a parallel.sharding.ShardedParams) the batch is
    split over its data ranks, and with `shard_sequence` its tokens over
    its seq ranks; translate_mesh runs it, with `loop_unroll`, `_eager`
    and `graphs` (on CUDA a loop_graph.DeviceGraphs: one cache for each
    device) as here, and concatenates the data shards' results in rank
    order."""
    from slimt_tpu_torch.parallel.sharding import ShardedParams

    if isinstance(params, ShardedParams):
        return translate_mesh(
            params, indices, mask, eos_id, max_steps, num_heads, shortlist,
            decoder_position_zero, steps_cap, with_alignment, check_every, provider,
            kv_dtype, argmax_method, attn_kernel, flash_attention, fused_sdpa,
            fused_layer, encoder_dtype, shard_sequence, loop_unroll, graphs, _eager,
            tally)
    with span("decode.encoder"):
        act = tfm.act_dtype(encoder_dtype)
        word_embedding = tfm.transform_embedding(tfm.embed(params, indices, act))
        mask_add = tfm.make_additive_mask(mask)
        encoder_out = tfm.encoder_forward(
            params, word_embedding, mask_add, num_heads,
            None if provider == "fused_step" else provider,
            flash=flash_attention, fused_sdpa=fused_sdpa, fused_layer=fused_layer,
            act_dtype=act,
        )
    return greedy_decode(
        params, encoder_out, mask_add, eos_id, max_steps, num_heads,
        shortlist, decoder_position_zero, steps_cap, with_alignment,
        check_every, provider, kv_dtype, argmax_method, attn_kernel,
        loop_unroll, graphs, _eager, tally,
    )


# -- a mesh (parallel/) ----------------------------------------------------

# The providers whose decoder takes whole rows (the fused blocks, the whole
# step, f32 products): under tensor parallelism they decode on the
# gathered params, once per data shard.
WHOLE_ROW_PROVIDERS = ("fused", "fused_step", "f32")
# The caches whose decode attention quantizes q per tensor over the whole
# batch (int8 K): their data shards step in lockstep.
BATCH_SCALED_CACHES = ("int8", "k8v16")


def lockstep(steps, reduce):
    """Run generators (tfm.tp_decoder_step, one per data shard) together:
    each time they yield, their yields (lists over their ranks) go to
    `reduce` at once, and each gets back its part of the answer. Returns
    their return values."""
    results = [None] * len(steps)
    sends = [None] * len(steps)
    active = list(range(len(steps)))
    while active:
        asked = {}
        for i in active:
            try:
                asked[i] = steps[i].send(sends[i])
            except StopIteration as stop:
                results[i] = stop.value
        active = list(asked)
        if active:
            answers = reduce([asked[i] for i in active])
            for i, answer in zip(active, answers):
                sends[i] = answer
    return results


def _max_over(parts):
    """The max of every rank's value (lists over ranks), handed back on
    each rank's device in the same shape."""
    from slimt_tpu_torch.parallel.collectives import Local

    flat = [t for part in parts for t in part]
    best = Local.all_reduce_max(flat)
    out, at = [], 0
    for part in parts:
        out.append(best[at:at + len(part)])
        at += len(part)
    return out


class MeshShard(NamedTuple):
    """The inputs of one data shard of a lockstep decode (MeshLoop): its
    model ranks (tfm.ModelRanks), each rank's cross-KV caches
    (tfm.tp_cross_kv) and additive mask, the shortlist on each rank's
    device (None: the full vocabulary) and whether each rank's joined
    caches are padded to the whole row."""

    ranks: object
    caches: list
    masks: list
    shortlists: Optional[list]
    padded: list


class _LockstepShard(_Outputs):
    """A MeshLoop's state of one data shard: its inputs (adopted; `load`
    copies a later batch's into them) and projection shares, prev and the
    stacked cell states [L, B, 1, E / M] on each rank, and on rank 0 the
    complete rows, the step limit and the outputs."""

    def __init__(self, inputs: MeshShard, provider, argmax_method, steps_padded: int,
                 with_alignment: bool):
        self.ranks, self.caches, self.masks, self.shortlists, self.padded = inputs
        self.provider, self.argmax_method = provider, argmax_method
        self.shortlist = self.shortlists[0] if self.shortlists is not None else None
        self.projections, self.width, self.packed_biases = self._projections()
        mask0 = self.masks[0]
        batch, t_src = mask0.shape[0], mask0.shape[-1]
        self.device = mask0.device
        layers = len(self.ranks.ps[0]["decoder"])
        emb_dim = self.ranks.ps[0]["emb"]["q"].shape[1]
        self.sqrt_e = _f32(math.sqrt(emb_dim))
        self.signal0 = [tfm.sinusoidal_signal(0, 1, emb_dim, device=m.device)
                        for m in self.masks]
        self.prev = [torch.zeros(batch, dtype=torch.int32, device=m.device) for m in self.masks]
        self.states = [torch.zeros((layers, batch, 1, p["decoder"][0]["rnn"]["w"]["q"].shape[1]),
                                   device=m.device) for p, m in zip(self.ranks.ps, self.masks)]
        self.complete = torch.zeros(batch, dtype=torch.bool, device=self.device)
        self._make_outputs(batch, steps_padded, t_src, with_alignment, self.device)

    def _projections(self):
        """Each rank's share of the projection (of the shortlist's rows),
        the whole width, and the packed-int biases where they serve."""
        if self.ranks.size == 1:
            w, b = tfm.prepare_output_projection(self.ranks.ps[0], self.shortlist,
                                                 self.provider)
            projections, width = [(w, b, 0)], w.shape[1]
        else:
            projections, width = tfm.tp_projections(self.ranks, self.shortlists)
        biases = None
        if tfm.uses_packed_int(self.provider, self.argmax_method):
            biases = [tfm.packed_int_bias(p, b)
                      for p, (_, b, _) in zip(self.ranks.ps, projections)]
        return projections, width, biases

    def load(self, inputs: MeshShard) -> None:
        _load((self.caches, self.masks, self.shortlists),
              (inputs.caches, inputs.masks, inputs.shortlists))
        if self.shortlists is not None:
            projections, _, biases = self._projections()
            _load((self.projections, self.packed_biases), (projections, biases))

    def reset(self, limit: int) -> None:
        for buffer in (*self.prev, *self.states, self.tokens, self.valid, self.align):
            buffer.zero_()
        self.limit.fill_(limit)
        self.complete.copy_(~(self.masks[0][:, 0, 0, :] == 0.0).any(-1))

    def inputs(self, steps: dict, prev: list, position_zero: bool) -> list:
        """Each rank's [B, 1, E] step input after the words `prev`: the zero
        embedding at step 0, and the sinusoid at the device step (or at
        position 0)."""
        xs = []
        for m, x in enumerate(tfm.tp_embed(self.ranks, [p[:, None] for p in prev])):
            step = steps[x.device]
            prev_embed = torch.where((step == 0)[:, None, None], 0.0, x)
            if position_zero:
                signal = self.signal0[m]
            else:
                signal = tfm.sinusoidal_signal(0, 1, x.shape[-1],
                                               positions=step.to(torch.float32))
            xs.append(prev_embed * self.sqrt_e + signal)
        return xs

    def result(self, max_steps: int) -> GreedyResult:
        return GreedyResult(self.tokens[:, :max_steps], self.valid[:, :max_steps],
                            self.align[:, :max_steps])


class MeshLoop:
    """The lockstep decode of a mesh's data shards in fixed buffers, on the
    pattern of DecodeLoop: each shard's model ranks step together
    (tfm.tp_decoder_step), and every shard meets the others at each yield
    of the int8 caches' query absmax (lockstep, max-reduced over every
    shard and rank). The step is a device tensor on each device, the state
    (_LockstepShard) is written in place, `run_chunk` advances every shard
    `unroll` steps and sets `done` where every row of every shard is
    complete. A chunk holds no host value, so where every rank is on one
    card loop_graph captures it as one graph, the collectives between the
    ranks included."""

    def __init__(self, shards, *, eos_id, num_heads, max_steps, unroll, provider,
                 argmax_method, attn_kernel, with_alignment, decoder_position_zero):
        steps_padded = -(-max_steps // unroll) * unroll
        self.shards = [_LockstepShard(s, provider, argmax_method, steps_padded, with_alignment)
                       for s in shards]
        self.eos_id, self.num_heads = eos_id, num_heads
        self.max_steps, self.unroll = max_steps, unroll
        self.provider, self.argmax_method, self.attn_kernel = provider, argmax_method, attn_kernel
        self.position_zero = decoder_position_zero
        devices = dict.fromkeys(m.device for s in self.shards for m in s.masks)
        self.step_at = {d: torch.zeros(1, dtype=torch.int32, device=d) for d in devices}
        self.done = torch.zeros(1, dtype=torch.bool, device=self.shards[0].device)

    def load(self, shards) -> None:
        """Copy a batch of this bucket's shapes into the input buffers."""
        for state, inputs in zip(self.shards, shards):
            state.load(inputs)

    def reset(self, limit: int) -> None:
        for buffer in (*self.step_at.values(), self.done):
            buffer.zero_()
        for shard in self.shards:
            shard.reset(limit)

    def _steps(self, steps, prevs, states):
        """One decoder step generator per shard."""
        return [tfm.tp_decoder_step(
            s.ranks, states[i], s.inputs(steps, prevs[i], self.position_zero), s.masks,
            s.caches, self.num_heads, projections=s.projections, width=s.width,
            provider=self.provider, argmax_method=self.argmax_method,
            attn_kernel=self.attn_kernel, packed_biases=s.packed_biases, padded=s.padded)
            for i, s in enumerate(self.shards)]

    def run_chunk(self) -> None:
        steps = dict(self.step_at)
        prevs = [list(s.prev) for s in self.shards]
        states = [[list(st.unbind(0)) for st in s.states] for s in self.shards]
        completes = [s.complete for s in self.shards]
        for _ in range(self.unroll):
            results = lockstep(self._steps(steps, prevs, states), _max_over)
            for i, (shard, (choices, new_states, attn)) in enumerate(zip(self.shards, results)):
                choice = choices[0]
                if shard.shortlist is not None:
                    choice = shard.shortlist[choice.to(torch.long)]
                word = choice.to(torch.int32)
                completes[i] = shard._record(steps[shard.device], word, attn, completes[i],
                                             self.eos_id)
                prevs[i] = [word.to(p.device) for p in shard.prev]
                states[i] = new_states
            steps = {d: step + 1 for d, step in steps.items()}
        for device, step in steps.items():
            self.step_at[device].copy_(step)
        for shard, prev, state, complete in zip(self.shards, prevs, states, completes):
            for buffer, value in zip(shard.prev, prev):
                buffer.copy_(value)
            for buffer, layers in zip(shard.states, state):
                torch.stack(layers, out=buffer)
            shard.complete.copy_(complete)
        first = self.done.device
        done = torch.stack([c.all().to(first) for c in completes]).all()
        self.done.copy_(done.reshape(1))

    def result(self) -> list:
        return [shard.result(self.max_steps) for shard in self.shards]

    def buffer_bytes(self) -> int:
        return sum(_nbytes((s.caches, s.masks, s.shortlists, s.projections, s.states,
                            s.tokens, s.valid, s.align)) for s in self.shards)


def mesh_lockstep(sharded, provider: Optional[str], kv_dtype: Optional[str]) -> bool:
    """Whether translate_mesh steps its ranks together (MeshLoop): under
    tensor parallelism on the ranks' shards, or where the cache scales the
    decode's query over the whole batch (int8 K) and this process holds
    several data shards; else each data shard runs the one-device loop."""
    local = sharded.mesh.local_shape
    split = sharded.tensor_parallel and provider not in WHOLE_ROW_PROVIDERS
    return split or (cache_dtype(provider, kv_dtype) in BATCH_SCALED_CACHES
                     and local["data"] > 1)


def mesh_loop_key(shards, loop_args: dict) -> tuple:
    """What a lockstep capture fixes: every rank's weights, the options,
    the cache types, the shapes and the padded heads."""
    first = shards[0].caches[0][0]
    cache = (first["k"].dtype, first["v"].dtype) if isinstance(first, dict) else "split"
    return ("lockstep", tuple(id(p) for s in shards for p in s.ranks.ps),
            tuple(tuple(m.shape) for s in shards for m in s.masks), cache,
            tuple(s.shortlists[0].shape[0] if s.shortlists else 0 for s in shards),
            tuple(tuple(s.padded) for s in shards), tuple(sorted(loop_args.items())))


def _record_stream(tree, stream) -> None:
    """Mark the CUDA tensors of `tree` as used on `stream` (their memory
    is not reused before its work so far is done)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for item in tree:
            _record_stream(item, stream)
    elif isinstance(tree, torch.Tensor) and tree.is_cuda:
        tree.record_stream(stream)


def _loop_stream(graphs, rank: int, device, inputs):
    """The stream of the loops of mesh rank `rank` (graphs.stream; None on
    the CPU or without `graphs`: the current one), after the work queued
    so far on the device's current stream; `inputs`, made on that
    stream, are marked as used on it."""
    if device.type != "cuda" or graphs is None:
        return None
    stream = graphs.stream(rank, device)
    stream.wait_stream(torch.cuda.current_stream(device))
    _record_stream(inputs, stream)
    return stream


def _start_lockstep(stack, mesh, shards, limit: int, loop_args: dict, graphs,
                    eager: bool) -> LoopRun:
    """The lockstep run of `shards` (MeshShard): where every rank is on one
    card, the bucket of rank 0's cache in `graphs`, replayed on rank 0's
    stream (with `eager`, a new MeshLoop run eagerly there); on the CPU,
    or where the ranks span cards (a CUDA graph is captured on one card's
    stream), a new MeshLoop run eagerly on the devices' current streams,
    its flag read one chunk behind on the card (at once on the CPU and
    with `eager`)."""
    device = shards[0].masks[0].device
    one_card = len({m.device for s in shards for m in s.masks}) == 1
    stream = None
    if one_card:
        stream = _loop_stream(graphs, mesh.rank(0), device,
                              [(s.caches, s.masks, s.shortlists) for s in shards])

    def make_loop():
        return MeshLoop(shards, **loop_args)

    if device.type != "cuda" or eager or not one_card:
        with on_stream(stream):
            loop = make_loop()
            loop.reset(limit)
        return LoopRun(loop, loop.run_chunk, stream,
                       lag=int(device.type == "cuda" and not eager))
    with on_stream(stream):
        bucket = graphs.on(mesh.rank(0), device).bucket(
            mesh_loop_key(shards, loop_args), make_loop, device)
        loop = stack.enter_context(bucket.use())
        loop.load(shards)
        loop.reset(limit)
    return LoopRun(loop, bucket.graph.run, stream, lag=1, kept=True)


def _join(results, runs, first: torch.device) -> GreedyResult:
    """The shards' results concatenated in rank order on `first`, after
    every loop's stream: each device's current stream waits for the loops'
    streams there by an event, and each result is marked as used on it."""
    for run in runs:
        if run.stream is not None:
            torch.cuda.current_stream(run.stream.device).wait_stream(run.stream)
    for result in results:
        for t in result:
            if t.is_cuda:
                t.record_stream(torch.cuda.current_stream(t.device))
    return GreedyResult(*(torch.cat([getattr(r, f).to(first) for r in results])
                          for f in GreedyResult._fields))


def _check_tensor_parallel(sharded, num_heads: int) -> None:
    """Raise where a TP mesh's shards cannot serve: the heads, E and F must
    split over the model axis (the vocabulary may be replicated)."""
    model = sharded.mesh.local_shape["model"]
    if num_heads % model:
        raise ValueError(f"tensor parallelism over {model} model ranks needs the "
                         f"heads ({num_heads}) to divide; use sharding='replicate'")
    replicated = []

    def walk(spec, path):
        if isinstance(spec, dict):
            for key, value in spec.items():
                walk(value, path + (key,))
        elif isinstance(spec, list):
            for i, value in enumerate(spec):
                walk(value, path + (i,))
        elif path[-1] == "q" and path[0] in ("encoder", "decoder") and "model" not in spec:
            replicated.append("/".join(map(str, path)))

    walk(sharded.specs, ())
    if replicated:
        raise ValueError("tensor parallelism needs every matrix split over the model "
                         f"axis; these do not divide: {replicated[:4]}; use "
                         "sharding='replicate'")


@torch.inference_mode()
def translate_mesh(
    sharded, indices: torch.Tensor, mask: torch.Tensor, eos_id: int, max_steps: int,
    num_heads: int, shortlist: Optional[torch.Tensor] = None,
    decoder_position_zero: bool = True, steps_cap: Optional[int] = None,
    with_alignment: bool = True, check_every: int = CHECK_EVERY,
    provider: Optional[str] = None, kv_dtype: Optional[str] = "int16",
    argmax_method: str = "packed_int", attn_kernel: bool = False,
    flash_attention: bool = False, fused_sdpa: bool = False, fused_layer: bool = False,
    encoder_dtype: Optional[str] = None, shard_sequence: bool = False,
    loop_unroll: Optional[int] = None, graphs: Optional[loop_graph.DeviceGraphs] = None,
    _eager: bool = False, tally: Optional[JobTally] = None,
) -> GreedyResult:
    """translate_batch on a mesh (`sharded`, parallel.sharding.
    ShardedParams): the [B, T] batch of this process split over its data
    ranks (B a multiple of their count) and, with `shard_sequence`, T over
    the seq ranks. Per data shard:
      - the encoder: on the model ranks' column shards and the seq ranks'
        rows (tfm.tp_encoder); or, where a whole-row piece runs (the whole
        layer #2, provider "fused" or "f32", an `encoder_dtype`), on the
        data shard's whole params (gathered under TP) and whole rows;
      - the cross-KV caches on each rank's rows and columns, gathered along
        T onto the seq rank 0 (tfm.tp_cross_kv);
      - the decode: with one rank of whole params and no batch-scaled cache
        (mesh_lockstep), the one-device loop, k = `loop_unroll` steps a
        chunk; else the ranks step together (MeshLoop), every data shard in
        lockstep.
    Every shard's embedding, encoder and caches are queued first, on the
    devices' current streams; then the loops run at once (run_loops), each
    data shard's on a stream of its own (`graphs`' stream of its first
    rank), even where shards share a card. On CUDA each loop replays CUDA
    graphs from `graphs` (a loop_graph.DeviceGraphs: the cache of the
    loop's first rank): every one-device loop, and the lockstep loop where
    every rank is on one card. A lockstep loop whose ranks span cards runs
    its chunks eagerly on the same fixed buffers (a CUDA graph is captured
    on one card's stream); `_eager` runs every loop eagerly, for the
    checks that compare the two (on `graphs`' streams where given, else
    on the current ones). Returns the shards' results concatenated in rank
    order on the first rank's device, after every loop's stream. `tally`
    gets the steps of the longest loop (no marks: a mesh's phases are
    not timed)."""
    from slimt_tpu_torch.parallel.collectives import Local
    from slimt_tpu_torch.parallel.sharding import batch_blocks

    check_options(provider, kv_dtype)
    mesh = sharded.mesh
    if mesh.device(0).type == "cuda" and not _eager and not isinstance(
            graphs, loop_graph.DeviceGraphs):
        raise ValueError("a mesh decode on CUDA replays its chunks from `graphs`, a "
                         "loop_graph.DeviceGraphs (one cache for each device): pass one")
    check_decoder(tfm.decoder_kind(sharded.at(0)), path="mesh")
    local = mesh.local_shape
    data, seqs = local["data"], local["seq"] if shard_sequence else 1
    tp = sharded.tensor_parallel
    model = local["model"] if tp else 1
    gathered_decode = tp and provider in WHOLE_ROW_PROVIDERS
    dec_model = 1 if gathered_decode else model
    if tp and not gathered_decode:
        _check_tensor_parallel(sharded, num_heads)
    batch, t = indices.shape
    blocks = batch_blocks(mesh, batch, t, shard_sequence)
    act = tfm.act_dtype(encoder_dtype)
    enc_provider = None if provider == "fused_step" else provider
    vocab = sharded.vocab_size
    emb_dim = sharded.at(0)["emb"]["q"].shape[1]
    whole_encoder = ((model == 1 and seqs == 1)
                     or tfm.layer_kernel_runs(fused_layer, flash_attention, act,
                                              enc_provider, t, emb_dim, num_heads)
                     or enc_provider in ("fused", "f32") or act is not None)
    dtype = cache_dtype(provider, kv_dtype)
    if dtype in BATCH_SCALED_CACHES and mesh.process_count > 1:
        raise ValueError(f"kv_dtype={kv_dtype!r} scales the decode's query over the whole "
                         "batch, which spans processes here: not served across processes")
    # The decode-attention kernel the whole batch would take, forced on
    # every shard (tfm._decode_attention_joined reads it from attn_kernel).
    attn_kernel = gate_attn_kernel(attn_kernel, with_alignment, kv_dtype, provider) and (
        decode_attn.kernel_for(batch * mesh.process_count, num_heads, t))
    limit = step_limit(max_steps, steps_cap)
    loop_args = greedy_args(eos_id, num_heads, max_steps, loop_unroll, provider,
                            argmax_method, attn_kernel, with_alignment, decoder_position_zero)
    shards = []
    for d in range(data):
        rows = blocks[d, 0][0]
        dev = [[mesh.device(d, m, s) for s in range(seqs)] for m in range(model)]
        full_mask = Local.all_gather(
            [mask[rows, blocks[d, s][1]].to(dev[0][s]) for s in range(seqs)], 1)
        if whole_encoder:
            params = sharded.gathered(d)
            ids = indices[rows].to(mesh.device(d))
            mask_add = tfm.make_additive_mask(full_mask[0].to(mesh.device(d)))
            x = tfm.transform_embedding(tfm.embed(params, ids, act))
            out = tfm.encoder_forward(params, x, mask_add, num_heads, enc_provider,
                                      flash=flash_attention, fused_sdpa=fused_sdpa,
                                      fused_layer=fused_layer, act_dtype=act)
            kv_seqs, encoded = 1, [[out] for _ in range(model)]
        else:
            grid = [[sharded.at(d, m, s) for s in range(seqs)] for m in range(model)]
            by_seq = [tfm.ModelRanks([grid[m][s] for m in range(model)], Local, vocab)
                      for s in range(seqs)]
            xs = [[None] * seqs for _ in range(model)]
            masks = [[None] * seqs for _ in range(model)]
            for s in range(seqs):
                cols = blocks[d, s][1]
                embedded = tfm.tp_embed(by_seq[s], [indices[rows, cols].to(dev[m][s])
                                                     for m in range(model)])
                for m in range(model):
                    # The whole sequence's signal on the rank's device (as
                    # transform_embedding computes it), then its rows.
                    signal = tfm.sinusoidal_signal(0, t, emb_dim, device=dev[m][s])[cols]
                    xs[m][s] = embedded[m] * _f32(math.sqrt(emb_dim)) + signal
                    masks[m][s] = tfm.make_additive_mask(full_mask[s].to(dev[m][s]))
            encoded = tfm.tp_encoder(grid, by_seq, xs, masks, num_heads, Local,
                                     provider=enc_provider, fused_sdpa=fused_sdpa,
                                     flash=flash_attention)
            kv_seqs = seqs
        # The decode ranks: (d, m, 0) with their shards, or the gathered params.
        if gathered_decode:
            dec_ps = [sharded.gathered(d)]
            kv_grid = [[dec_ps[0]]]
            kv_in = [[Local.all_gather([encoded[0][s] for s in range(kv_seqs)], 1)[0]
                      .to(mesh.device(d))]]
        else:
            dec_ps = [sharded.at(d, m) for m in range(dec_model)]
            kv_grid = [[sharded.at(d, m, s) for s in range(kv_seqs)] for m in range(dec_model)]
            kv_in = [[encoded[m][s].to(kv_grid[m][s]["emb"]["q"].device)
                      for s in range(kv_seqs)] for m in range(dec_model)]
        # Joined caches are padded to the whole row, except where #3 runs on a
        # rank's own heads: an int16 cache on the card at a width it takes.
        own_heads = (attn_kernel and dtype == "int16" and mesh.device(d).type == "cuda"
                     and (emb_dim // dec_model) % 128 == 0)
        pad = [dec_model > 1 and dtype is not None and not own_heads] * dec_model
        caches = tfm.tp_cross_kv(kv_grid, kv_in, num_heads, dtype, Local, pad,
                                 provider=enc_provider)
        dec_masks = [tfm.make_additive_mask(full_mask[0].to(p["emb"]["q"].device))
                     for p in dec_ps]
        shortlists = None if shortlist is None else [
            shortlist.to(p["emb"]["q"].device) for p in dec_ps]
        shards.append(MeshShard(tfm.ModelRanks(dec_ps, Local, vocab), caches, dec_masks,
                                shortlists, pad))
    with contextlib.ExitStack() as stack:
        if mesh_lockstep(sharded, provider, kv_dtype):
            runs = [_start_lockstep(stack, mesh, shards, limit, loop_args, graphs, _eager)]
        else:
            runs = []
            for d, shard in enumerate(shards):
                device, rank = shard.masks[0].device, mesh.rank(d)
                stream = _loop_stream(graphs, rank, device,
                                      (shard.caches, shard.masks, shard.shortlists))
                runs.append(start_loop(
                    stack, shard.ranks.ps[0], shard.caches[0], shard.masks[0],
                    shard.shortlists[0] if shard.shortlists else None, limit, loop_args,
                    graphs.on(rank, device) if graphs is not None else None, _eager,
                    stream))
        chunks = run_loops(runs, limit, check_every)
        if tally is not None:
            tally.steps = max(c * run.loop.unroll for c, run in zip(chunks, runs))
        results = []
        for run in runs:
            result = finish_loop(run)
            results.extend([result] if isinstance(result, GreedyResult) else result)
    return _join(results, runs, mesh.device(0))


class CompactResult(NamedTuple):
    """One uint16 buffer per batch, carried as int16 (torch's uint16
    support varies by version): tokens in [:, :S], then the valid mask
    bit-packed (numpy packbits order) into little-endian byte pairs."""

    packed: torch.Tensor  # [B, S + ceil(ceil(S/8)/2)] int16
    alignment: torch.Tensor


# numpy packbits' bit order within a byte.
BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_bits16(bits: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bits [B, n] bool as uint16 words in int32 [B, ceil(ceil(n/8)/2)]:
    numpy packbits order, the bytes paired little-endian. `weights` is
    BIT_WEIGHTS as an int32 tensor on the bits' device (made here if
    None; a captured caller passes its own)."""
    batch, n = bits.shape
    nbytes = -(-n // 8)
    nbytes += nbytes % 2
    padded = torch.zeros((batch, nbytes * 8), dtype=torch.int32, device=bits.device)
    padded[:, :n] = bits.to(torch.int32)
    if weights is None:
        weights = torch.tensor(BIT_WEIGHTS, dtype=torch.int32, device=bits.device)
    byte = (padded.reshape(batch, nbytes, 8) * weights).sum(-1, dtype=torch.int32)
    return byte[:, 0::2] | (byte[:, 1::2] << 8)


def as_uint16(values: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 65535] as int16 with the same 16 bits."""
    return torch.where(values > 32767, values - 65536, values).to(torch.int16)


def unpack_bits16(words: np.ndarray, n: int) -> np.ndarray:
    """Host inverse of pack_bits16 on uint16 words: bool [B, n]."""
    byte_pairs = np.empty((words.shape[0], 2 * words.shape[1]), np.uint8)
    byte_pairs[:, 0::2] = words & 0xFF
    byte_pairs[:, 1::2] = words >> 8
    return np.unpackbits(byte_pairs[:, :(n + 7) // 8], axis=1, count=n).astype(bool)


def compact_result(result: GreedyResult) -> CompactResult:
    """Lossless device-side compaction; inverse: `unpack_compact`."""
    words = pack_bits16(result.valid)
    packed = torch.cat([result.tokens.to(torch.int32), words], dim=1)
    return CompactResult(as_uint16(packed), result.alignment)


def unpack_compact(packed, max_steps: int):
    """Host-side inverse of `compact_result` on the fetched array:
    (tokens int32 [B, max_steps], valid bool [B, max_steps])."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed).view(np.uint16)
    tokens = packed[:, :max_steps].astype(np.int32)
    return tokens, unpack_bits16(packed[:, max_steps:], max_steps)
