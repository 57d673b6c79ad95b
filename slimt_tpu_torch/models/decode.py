"""Greedy decode on torch: the counterpart of slimt_tpu/models/decode.py.

The JAX package runs the loop as one `lax.while_loop` on the device;
here the loop runs on the host and launches each step's kernels. The
semantics are the reference's, as in the JAX package:
  - step 0 feeds a zero embedding (no previous word);
  - the decoder's positional signal is position 0 at every step
    (`decoder_position_zero`);
  - the EOS token is recorded, then the row is complete;
  - padding rows (fully masked) start complete;
  - the trip count is min(max_steps, steps_cap);
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
argument block is built once per batch; the argmax is then the exact
first maximum.

The loop asks the device whether every row is complete once every
`check_every` steps (one `.item()`, which waits for the device). Rows
that are already complete are masked out of tokens, valid and the
alignment, so the result does not depend on `check_every`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from slimt_tpu_torch.models import transformer as tfm
from slimt_tpu_torch.ops import decoder_step as dstep
from slimt_tpu_torch.ops.qmm import _f32

CHECK_EVERY = 8


# Providers of the declared path; "fused" runs the block kernels and
# "fused_step" is the latency path.
DECLARED_PROVIDERS = (None, "xla_int8", "pallas")
PROVIDERS = DECLARED_PROVIDERS + ("fused", "fused_step")
# The joined caches the whole-step kernel reads; under fused_step every
# other kv_dtype becomes int16 (slimt_tpu/models/decode.py:98-106).
FUSED_STEP_CACHES = ("bfloat16", "float32", "int16")


def check_options(provider: Optional[str], kv_dtype: Optional[str]) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, on a provider
    the port does not implement, and ValueError on a kv_dtype that is not
    a cache dtype (transformer.KV_DTYPES)."""
    if provider not in PROVIDERS:
        raise NotImplementedError(
            f"provider={provider!r} (ROADMAP Queue 1, item 12)"
        )
    if kv_dtype not in tfm.KV_DTYPES:
        raise ValueError(f"kv_dtype={kv_dtype!r} not in {tfm.KV_DTYPES}")


def cache_dtype(provider: Optional[str], kv_dtype: Optional[str]) -> Optional[str]:
    """The cache the loop builds for `kv_dtype`, with the JAX package's
    coercions: under fused_step any cache but bfloat16, float32 and int16
    becomes int16; elsewhere "float32" means the exact split f32 cache
    (None)."""
    if provider == "fused_step":
        return kv_dtype if kv_dtype in FUSED_STEP_CACHES else "int16"
    return None if kv_dtype == "float32" else kv_dtype


class GreedyResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_steps] int32
    valid: torch.Tensor  # [B, max_steps] bool — recorded positions
    alignment: torch.Tensor  # [B, max_steps, T_src or 0] f32


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
) -> GreedyResult:
    check_options(provider, kv_dtype)
    # The decode-attention kernel serves the alignment-free int16 path
    # only (it returns no attention weights), as in the JAX package.
    attn_kernel = bool(attn_kernel) and not with_alignment and (
        kv_dtype == "int16") and provider != "fused_step"
    batch, t_src, emb_dim = encoder_out.shape
    device = encoder_out.device
    kv_caches = tfm.precompute_cross_kv(
        params, encoder_out, num_heads, cache_dtype(provider, kv_dtype))
    projection = tfm.prepare_output_projection(params, shortlist)
    plan = None
    if provider == "fused_step" and device.type == "cuda":
        plan = dstep.StepPlan(
            params["decoder"], kv_caches, mask_add, num_heads, projection,
            params["out"]["aq"], tfm.output_inv(params),
        )
    # One [L, B, 1, E] block: the whole-step kernel reads it in place.
    states = tuple(
        torch.zeros(
            (len(params["decoder"]), batch, 1, emb_dim),
            dtype=torch.float32, device=device,
        ).unbind(0)
    )
    tokens = torch.zeros((batch, max_steps), dtype=torch.int32, device=device)
    valid = torch.zeros((batch, max_steps), dtype=torch.bool, device=device)
    align = torch.zeros(
        (batch, max_steps, t_src if with_alignment else 0),
        dtype=torch.float32, device=device,
    )
    complete = ~(mask_add[:, 0, 0, :] == 0.0).any(-1)
    prev = torch.zeros((batch,), dtype=torch.int32, device=device)
    limit = max_steps if steps_cap is None else min(max_steps, int(steps_cap))
    sqrt_e = _f32(math.sqrt(emb_dim))
    signal0 = tfm.sinusoidal_signal(0, 1, emb_dim, device=device)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    every = max(1, int(check_every))

    for step in range(limit):
        if step % every == 0 and bool(complete.all()):
            break
        if step == 0:
            prev_embed = torch.zeros(
                (batch, 1, emb_dim), dtype=torch.float32, device=device
            )
        else:
            prev_embed = tfm.embed(params, prev[:, None])
        if decoder_position_zero:
            signal = signal0
        else:
            signal = tfm.sinusoidal_signal(
                0, 1, emb_dim,
                positions=torch.tensor([step], dtype=torch.float32, device=device),
            )
        x = prev_embed * sqrt_e + signal
        choice, states, attn = tfm.decoder_step(
            params, states, x, mask_add, kv_caches, num_heads,
            projection=projection, provider=provider, plan=plan,
            argmax_method=argmax_method, attn_kernel=attn_kernel,
        )
        word = shortlist[choice.to(torch.long)] if shortlist is not None else choice
        word = word.to(torch.int32)
        active = ~complete
        tokens[:, step] = torch.where(active, word, zero)
        valid[:, step] = active
        if with_alignment:
            align[:, step] = torch.where(active[:, None], attn[:, 0, 0, :], 0.0)
        complete = complete | (word == eos_id)
        prev = word
    return GreedyResult(tokens, valid, align)


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
) -> GreedyResult:
    """embed → encoder → greedy decode for a padded [B, T] batch.
    `provider` "fused" runs the decoder's SSRU and FFN block kernels (and
    the split encoder's FFN), "fused_step" each decode step as one
    whole-step call. The encoder takes `flash_attention`, `fused_sdpa`
    and `fused_layer` (transformer.encoder_layer_forward) and the
    provider, which under "fused_step" is None, as in the JAX package."""
    word_embedding = tfm.transform_embedding(tfm.embed(params, indices))
    mask_add = tfm.make_additive_mask(mask)
    encoder_out = tfm.encoder_forward(
        params, word_embedding, mask_add, num_heads,
        None if provider == "fused_step" else provider,
        flash=flash_attention, fused_sdpa=fused_sdpa, fused_layer=fused_layer,
    )
    return greedy_decode(
        params, encoder_out, mask_add, eos_id, max_steps, num_heads,
        shortlist, decoder_position_zero, steps_cap, with_alignment,
        check_every, provider, kv_dtype, argmax_method, attn_kernel,
    )


class CompactResult(NamedTuple):
    """One uint16 buffer per batch, carried as int16 (torch's uint16
    support varies by version): tokens in [:, :S], then the valid mask
    bit-packed (numpy packbits order) into little-endian byte pairs."""

    packed: torch.Tensor  # [B, S + ceil(ceil(S/8)/2)] int16
    alignment: torch.Tensor


def compact_result(result: GreedyResult) -> CompactResult:
    """Lossless device-side compaction; inverse: `unpack_compact`."""
    tokens, valid = result.tokens, result.valid
    batch, steps = valid.shape
    nbytes = -(-steps // 8)
    nbytes += nbytes % 2
    bits = torch.zeros((batch, nbytes * 8), dtype=torch.int32, device=valid.device)
    bits[:, :steps] = valid.to(torch.int32)
    weights = torch.tensor(
        [128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=valid.device
    )
    byte = (bits.reshape(batch, nbytes, 8) * weights).sum(-1, dtype=torch.int32)
    words = byte[:, 0::2] | (byte[:, 1::2] << 8)
    packed = torch.cat([tokens.to(torch.int32), words], dim=1)
    packed = torch.where(packed > 32767, packed - 65536, packed)
    return CompactResult(packed.to(torch.int16), result.alignment)


def unpack_compact(packed, max_steps: int):
    """Host-side inverse of `compact_result` on the fetched array:
    (tokens int32 [B, max_steps], valid bool [B, max_steps])."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed).view(np.uint16)
    tokens = packed[:, :max_steps].astype(np.int32)
    words = packed[:, max_steps:]
    byte_pairs = np.empty((words.shape[0], 2 * words.shape[1]), np.uint8)
    byte_pairs[:, 0::2] = words & 0xFF
    byte_pairs[:, 1::2] = words >> 8
    nbytes = (max_steps + 7) // 8
    valid = np.unpackbits(
        byte_pairs[:, :nbytes], axis=1, count=max_steps
    ).astype(bool)
    return tokens, valid
