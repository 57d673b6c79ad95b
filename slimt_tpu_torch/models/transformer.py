"""Bergamot student transformer on torch: the serving paths of
slimt_tpu/models/transformer.py.

Plain functions over the params dict from io/params.py (loader layout,
per-layer lists). What the ported configs reach is here: the exact-f32
encoder, through the whole-layer kernel (ops/encoder_layer) or the split
layer (int8 affines, self-attention by the plain SDPA, the fused SDPA
kernel or the blockwise kernel of ops/attention, then the FFN), every
cross-attention cache of the JAX package (the exact split f32 pair; the
int8, int16, k8v16 and k16v8 per-row caches; the float32, bfloat16 and
float16 joined caches) with each branch of its decode attention, the
SSRU decoder and the greedy argmax over the (optionally shortlisted)
tied projection (`packed_int`, or the argmax kernel's
exact/packed_fp16/packed_bf16, ops/logits_argmax). Under the `f32`
provider every int8 product is an f32 product against the dequantized
weights that io/params.params_from_numpy(..., dequantize=True) loads,
and the argmax runs over the f32
logits (qmm.affine_f32; no int8 kernel). `act_dtype` (ModelConfig.
encoder_dtype) runs the split encoder's residual stream and SDPA
operands in float16 or bfloat16, with the JAX package's rounding
points. Under the `fused`
provider each decoder layer runs the SSRU-block and FFN-block kernels
(ops/fused_blocks); `attn_kernel` routes the int16 cache through the
decode-attention kernel (ops/decode_attn); the `fused_step` latency
provider makes the decode step one call of ops/decoder_step (exact
first-max argmax) over the int16 or a float joined cache. Every other
int8 product goes through ops/qmm. Masks are additive: 0 for real
tokens, -99999999 for padding.

Scalars that enter float32 arithmetic are float32 0-dim tensors
(`_f32`): `python_float / tensor` in torch multiplies by a reciprocal,
and that rounds differently from the JAX package's division.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from slimt_tpu_torch.io.loader import SELF_ATTENTION, SSRU  # the decoder kinds
from slimt_tpu_torch.ops import attention, decode_attn, fused_blocks, logits_argmax, qmm
from slimt_tpu_torch.ops import encoder_layer as enc
from slimt_tpu_torch.ops.logits_argmax import first_max, packed_argmax_16  # noqa: F401
from slimt_tpu_torch.ops.qmm import _f32

MASK_MIN = -99999999.0
INT16_MAX = 32767.0


# ModelConfig.encoder_dtype → the encoder's activation dtype.
ACT_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16}


def act_dtype(encoder_dtype: Optional[str]) -> Optional[torch.dtype]:
    """The encoder's activation dtype for ModelConfig.encoder_dtype (None:
    the exact f32 encoder)."""
    if encoder_dtype is None:
        return None
    if encoder_dtype not in ACT_DTYPES:
        raise ValueError(f"encoder_dtype={encoder_dtype!r} not in {tuple(ACT_DTYPES)}")
    return ACT_DTYPES[encoder_dtype]


def _constant(value: float, dtype: torch.dtype) -> torch.Tensor:
    """A Python float as a 0-dim CPU tensor of `dtype`, rounded once from
    the double (numpy's conversion, as JAX's weak-typed constants; for
    bfloat16 through float32, as ml_dtypes converts)."""
    if dtype == torch.float16:
        return torch.from_numpy(np.array(value, dtype=np.float16))
    return _f32(value).to(dtype)


def layer_norm(x: torch.Tensor, ln: dict) -> torch.Tensor:
    """Statistics in f32; the output carries x's dtype."""
    return enc.layer_norm(x.float(), ln["scale"], ln["bias"]).to(x.dtype)


def embed(params: dict, indices: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Token ids → embeddings [.., E] from the int8 table: f32, or the
    rows cast to `dtype` times 1/scale cast to it."""
    emb_q = params["emb"]["q"]
    rows = emb_q.index_select(0, indices.reshape(-1).to(torch.long))
    rows = rows.reshape(*indices.shape, emb_q.shape[1])
    if dtype is None or dtype == torch.float32:
        return rows.to(torch.float32) * _f32(params["emb"]["inv"])
    return rows.to(dtype) * _f32(params["emb"]["inv"]).to(dtype)


def sinusoidal_signal(
    start: int,
    length: int,
    emb_dim: int,
    positions: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """Marian's sin/cos signal: first half sin, second half cos."""
    half = emb_dim // 2
    if positions is None:
        positions = start + torch.arange(length, dtype=torch.float32, device=device)
    positions = positions.to(torch.float32)
    increment = _f32(-math.log(10000.0) / (half - 1.0))
    inv_timescales = torch.exp(
        torch.arange(half, dtype=torch.float32, device=positions.device)
        * increment
    )
    angles = positions[:, None] * inv_timescales[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def transform_embedding(x: torch.Tensor, start: int = 0) -> torch.Tensor:
    """x * sqrt(E) + positional signal, in x's dtype: sqrt(E) and the
    signal are rounded to it (a no-op for f32)."""
    emb_dim = x.shape[-1]
    signal = sinusoidal_signal(start, x.shape[-2], emb_dim, device=x.device)
    if x.dtype == torch.float32:
        return x * _f32(math.sqrt(emb_dim)) + signal
    return x * _constant(math.sqrt(emb_dim), x.dtype) + signal.to(x.dtype)


def make_additive_mask(mask: torch.Tensor) -> torch.Tensor:
    """0/1 mask [B, T] → additive [B, 1, 1, T]."""
    return ((1.0 - mask) * _f32(MASK_MIN))[:, None, None, :]


def _affine(p: dict, x: torch.Tensor, relu: bool = False, provider: Optional[str] = None,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The affine of matrix dict `p` (its bias where it has one) on x
    upcast to f32: the int8 product (qmm.affine), or under "f32" the
    product against the dequantized weight `w` (qmm.affine_f32); the
    output rounded to `out_dtype` where one is given. The relu runs
    before that rounding, which it commutes with (rounding keeps the
    sign; at most a zero's sign differs, which the next product's
    quantization or sum erases)."""
    x = x.to(torch.float32)
    if provider == "f32":
        if "w" not in p:
            raise ValueError("provider 'f32' needs the dequantized weights: load the "
                             "params with io.params.params_from_numpy(..., dequantize=True)")
        y = qmm.affine_f32(x, p["w"], p.get("b"), relu=relu)
    else:
        y = qmm.affine(x, p["q"], p.get("b"), p["aq"], p["inv"], relu=relu)
    return y if out_dtype is None else y.to(out_dtype)


def ssru_forward(
    rnn: dict, state: torch.Tensor, x: torch.Tensor,
    provider: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SSRU step; state is c(t-1) [B, 1, E]. Returns (h, c(t)).
    Provider "fused" runs the whole cell as the SSRU-block kernel."""
    if provider == "fused":
        return fused_blocks.ssru_block(x, state, rnn)
    f = torch.sigmoid(_affine(rnn["wf"], x, provider=provider))
    wx = _affine(rnn["w"], x, provider=provider)  # bias-free
    c_t = f * state + (1.0 - f) * wx
    h = layer_norm(x + torch.relu(c_t), rnn["ln"])
    return h, c_t


# Cache dtypes of precompute_cross_kv: None is the exact split f32 cache,
# the rest joined [B, T, E] caches.
FLOAT_CACHES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}
KV_DTYPES = (None, "int8", "k8v16", "k16v8", "int16", *FLOAT_CACHES)


# Per-row caches: whether K, then V, is int16 (else int8).
ROW_CACHES = {"int8": (False, False), "k8v16": (False, True),
              "k16v8": (True, False), "int16": (True, True)}


def _per_row(a: torch.Tensor, wide: bool, absmax: Optional[torch.Tensor] = None):
    """a [B, T, E] quantized per row (b, t) against its absmax, half to
    even, to int16 (wide) or int8; and the inverse scales [B, T]. Under
    tensor parallelism `absmax` [B, T] is the whole row's, max-reduced over
    the model ranks' column shards (a.abs().amax(-1) where None)."""
    top, dtype = (INT16_MAX, torch.int16) if wide else (127.0, torch.int8)
    if absmax is None:
        absmax = a.abs().amax(-1)
    s = _f32(top) / torch.maximum(absmax, _f32(1e-6))
    return torch.clamp(torch.round(a * s[..., None]), -top, top).to(dtype), _f32(1.0) / s


def precompute_cross_kv(
    params: dict, encoder_out: torch.Tensor, num_heads: int,
    dtype: Optional[str] = "int16", provider: Optional[str] = None,
) -> Tuple:
    """Per decoder layer, the cross-attention cache of encoder_out (of any
    float dtype; the K/V affines take it upcast and give f32, by
    `provider`), as the JAX function builds it for `dtype`:
      None: the exact (K, V) pair of split [B, H, T, D] f32 tensors;
      "int8", "int16": the joined [B, T, E] cache quantized per row (b, t)
        against its absmax, {"k", "v", "kqi", "vqi"} with the inverse scales
        [B, T];
      "k8v16", "k16v8": int8 K with int16 V, or the reverse, so scaled;
      "float32", "bfloat16", "float16": the joined cache cast to that type,
        with scalar kqi = vqi = 1."""
    if dtype not in KV_DTYPES:
        raise ValueError(f"kv cache dtype {dtype!r} not in {KV_DTYPES}")
    one = _f32(1.0)
    caches = []
    for layer in params["decoder"]:
        att = layer["att"]
        k = _affine(att["k"], encoder_out, provider=provider)  # [B, T, E]
        v = _affine(att["v"], encoder_out, provider=provider)
        if dtype is None:
            caches.append((_split_heads(k, num_heads), _split_heads(v, num_heads)))
        elif dtype in FLOAT_CACHES:
            caches.append({"k": k.to(FLOAT_CACHES[dtype]), "v": v.to(FLOAT_CACHES[dtype]),
                           "kqi": one, "vqi": one})
        else:
            wide_k, wide_v = ROW_CACHES[dtype]
            (kq, kqi), (vq, vqi) = _per_row(k, wide_k), _per_row(v, wide_v)
            caches.append({"k": kq, "v": vq, "kqi": kqi, "vqi": vqi})
    return tuple(caches)


def _head_selector(emb_dim: int, num_heads: int, device) -> torch.Tensor:
    """Block-diagonal [E, H] 0/1 matrix: column h selects head h."""
    eye = torch.eye(num_heads, dtype=torch.float32, device=device)
    return eye.repeat_interleave(emb_dim // num_heads, dim=0)


def _decode_attention_joined(
    yq: torch.Tensor, kv: dict, mask_add: torch.Tensor, num_heads: int,
    attn_kernel=False, q_absmax: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """T_q == 1 cross-attention over a joined [B, T, E] cache, each branch
    of the JAX function. Returns (out [B,1,E], attn [B,H,1,T]).

      k8v16: int8 scores, then f32 p * vqi against the int16 V;
      int8: q quantized per tensor over the whole batch, int8 scores, then
        p * vqi re-quantized per (b, h) against the int8 V;
      int16 (and k16v8, whose int8 V rides this branch): f32 q and p, the
        per-row dequants folded in; `attn_kernel` runs ops/decode_attn
        instead (alignment-free path: the weights come back as zeros);
      float: q and p rounded through the cache's type for bfloat16 only.

    The int8 products are exact, as the TPU's int32 sums: the scores stay
    within E * 127^2 < 2^24, so float32 holds them; the attn . V mix
    reaches 127 * T * 127, past 2^24 at T ~ 1040, so it sums in float64.

    On a mesh, `q_absmax` is the int8 branch's per-tensor absmax of q over
    the whole batch (max-reduced over the data and model ranks), and
    `attn_kernel` may name the decode-attention kernel the whole batch
    would take ("block" or "warp", decode_attn.kernel_for)."""
    q = yq[:, 0, :]
    k, v = kv["k"], kv["v"]
    b, t, e = k.shape
    d = e // num_heads
    scale = _f32(1.0 / math.sqrt(d))
    if k.dtype == torch.int8:
        if q_absmax is None:
            q_absmax = q.abs().amax()
        aq = _f32(127.0) / torch.maximum(q_absmax, _f32(1e-6))
        q_q = torch.clamp(torch.round(q * aq), -127.0, 127.0)
        q2 = q_q[:, :, None] * _head_selector(e, num_heads, q.device)[None]  # [B, E, H]
        scores = torch.bmm(q2.transpose(1, 2), k.to(torch.float32).transpose(1, 2))
        scores = scores * (scale / aq) * kv["kqi"][:, None, :]
        attn = enc.softmax(scores + mask_add[:, :, 0, :])  # [B, H, T]
        attn_v = attn * kv["vqi"][:, None, :]
        vh = v.reshape(b, t, num_heads, d)
        if v.dtype == torch.int16:  # k8v16
            res = torch.einsum("bht,bthd->bhd", attn_v, vh.to(torch.float32))
        else:
            s_a = _f32(127.0) / torch.maximum(attn_v.amax(-1, keepdim=True), _f32(1e-9))
            attn_q = torch.round(attn_v * s_a)  # in [0, 127]
            res = torch.einsum("bht,bthd->bhd", attn_q.to(torch.float64),
                               vh.to(torch.float64)).to(torch.float32) / s_a
        return res.reshape(b, 1, e), attn[:, :, None, :]
    if attn_kernel and k.dtype == torch.int16:
        out = decode_attn.decode_attention_int16(
            q, k, v, kv["kqi"], kv["vqi"], mask_add[:, 0, 0, :], num_heads,
            attn_kernel if isinstance(attn_kernel, str) else None)
        attn = q.new_zeros((q.shape[0], num_heads, 1, t))
        return out[:, None, :], attn
    sel = _head_selector(e, num_heads, q.device)
    if k.dtype == torch.int16:
        q2 = q[:, :, None] * sel[None]  # [B, E, H]
        # einsum("bte,beh->bht") as one batched matmul
        scores = torch.bmm(q2.transpose(1, 2), k.to(torch.float32).transpose(1, 2))
        scores = scores * scale * kv["kqi"][:, None, :]
        attn = enc.softmax(scores + mask_add[:, :, 0, :])  # [B, H, T]
        attn_v = attn * kv["vqi"][:, None, :]
        res = torch.bmm(attn_v, v.to(torch.float32))  # [B, H, E]
    else:
        native = k.dtype == torch.bfloat16

        def op(a):
            return (a.to(k.dtype) if native else a).to(torch.float32)

        q2 = op(q[:, :, None] * sel[None])  # [B, E, H]
        scores = torch.bmm(q2.transpose(1, 2), op(k).transpose(1, 2)) * scale
        attn = enc.softmax(scores + mask_add[:, :, 0, :])  # [B, H, T]
        res = torch.bmm(op(attn), op(v))  # [B, H, E]
    out = (res * sel.T[None]).sum(1)  # diagonal-block extract
    return out[:, None, :], attn[:, :, None, :]


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, E] → [B, H, T, D]."""
    b, t, e = x.shape
    return x.reshape(b, t, num_heads, e // num_heads).transpose(1, 2)


def _join_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, D] → [B, T, E]."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def sdpa_act(q, k, v, mask_add):
    """The plain SDPA on operands of a half dtype, as the JAX einsum
    branch computes it: the products of the upcast operands summed in
    f32, the scale and the mask, an f32 softmax, the probabilities
    rounded to v's dtype, the output rounded to q's. (No half operand
    reaches torch.matmul: cuBLAS may reduce those in half precision.)"""
    scale = _f32(1.0 / math.sqrt(q.shape[-1]))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = enc.softmax(scores + mask_add)
    out = torch.matmul(attn.to(v.dtype).float(), v.float())
    return out.to(q.dtype), attn


def attention_forward(
    att: dict, q_in: torch.Tensor, mask_add: torch.Tensor, num_heads: int,
    kv_cache=None, attn_kernel: bool = False,
    flash: bool = False, fused_sdpa: bool = False,
    provider: Optional[str] = None, act_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention block incl. residual + post-LN. Returns (out,
    attn_weights).

    With `kv_cache` it is the decode step's cross-attention: a joined
    cache dict of precompute_cross_kv goes to _decode_attention_joined
    (`attn_kernel`: the decode-attention kernel on the int16 cache), the
    exact (K, V) pair of split f32 tensors to the plain SDPA. Without, it
    is the encoder's self-attention over q_in, in the JAX package's order
    of precedence: the fused SDPA kernel on joined operands where
    `fused_sdpa` is on at 1 < T <= 256 and E % 128 == 0 (weights not
    returned), else the blockwise kernel where `flash` is on (weights not
    returned), else the plain SDPA (`encoder_layer.sdpa_heads`:
    torch.matmul products, as the JAX einsum branch, the scale on QK^T and
    then the mask). `provider` picks the affines (qmm or, under "f32",
    the dequantized weights). `act_dtype` (the encoder's) rounds q, k, v,
    the joined heads, the O affine and the residual to it (sdpa_act; the
    blockwise kernel takes its operands upcast); it needs a float32 q_in
    for the fused SDPA, as the JAX gate."""
    if isinstance(kv_cache, dict):
        yq = _affine(att["q"], q_in, provider=provider)
        attn_out, attn = _decode_attention_joined(
            yq, kv_cache, mask_add, num_heads, attn_kernel)
        out = _affine(att["o"], attn_out, provider=provider)
        return layer_norm(q_in + out, att["ln"]), attn
    t, e = q_in.shape[-2], q_in.shape[-1]
    if (
        fused_sdpa
        and kv_cache is None
        and 1 < t <= enc.MAX_T
        and q_in.dtype == torch.float32
        and e % 128 == 0
        and e % num_heads == 0
    ):
        yq, yk, yv = (_affine(att[n], q_in, provider=provider) for n in ("q", "k", "v"))
        attn_out = attention.fused_sdpa_joined(yq, yk, yv, mask_add, num_heads)
        out = _affine(att["o"], attn_out, provider=provider)
        return layer_norm(q_in + out, att["ln"]), None
    act = act_dtype or torch.float32

    def project(name):
        return _split_heads(
            _affine(att[name], q_in, provider=provider, out_dtype=act_dtype), num_heads)

    yq = project("q")
    if kv_cache is None:
        yk, yv = project("k"), project("v")
    else:
        yk, yv = kv_cache
    if flash:
        attn_out = attention.blockwise_attention(yq.float(), yk.float(), yv.float(), mask_add)
        attn = None
    elif yq.dtype == torch.float32:
        attn_out, attn = enc.sdpa_heads(yq, yk, yv, mask_add)
    else:
        attn_out, attn = sdpa_act(yq, yk, yv, mask_add)
    out = _affine(att["o"], _join_heads(attn_out).to(act), provider=provider,
                  out_dtype=act_dtype)
    return layer_norm(q_in.to(act) + out, att["ln"]), attn


def _ffn_block(
    layer: dict, x: torch.Tensor, provider: Optional[str] = None,
    act_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """FFN1 → relu → FFN2 → residual → post-LN, the affines' outputs and
    the residual in `act_dtype` where one is given. Provider "fused" runs
    the whole block as the FFN-block kernel, on x upcast (an f32 output,
    as the JAX kernel's)."""
    if provider == "fused":
        return fused_blocks.ffn_block(x.to(torch.float32), layer["ffn"])
    h = _affine(layer["ffn"]["w1"], x, relu=True, provider=provider, out_dtype=act_dtype)
    y = _affine(layer["ffn"]["w2"], h, provider=provider, out_dtype=act_dtype)
    return layer_norm(y + x.to(act_dtype or torch.float32), layer["ffn"]["ln"])


# The int8 providers the whole-layer kernel serves. The port has no
# process-wide default provider: None (the encoder's under fused_step)
# runs as "xla_int8".
LAYER_KERNEL_PROVIDERS = ("xla_int8", "pallas", "fused")


def layer_kernel_runs(fused_layer: bool, flash: bool, act_dtype, provider: Optional[str],
                      t: int, e: int, num_heads: int) -> bool:
    """Whether encoder_layer_forward runs the whole-layer kernel: its gate."""
    resolved = provider if provider is not None else "xla_int8"
    return bool(
        fused_layer
        and not flash
        and act_dtype is None
        and resolved in LAYER_KERNEL_PROVIDERS
        and 1 < t <= enc.MAX_T
        and enc.width_ok(e)
        and e % num_heads == 0
    )


def encoder_layer_forward(
    layer: dict, x: torch.Tensor, mask_add: torch.Tensor, num_heads: int,
    provider: Optional[str] = None, flash: bool = False,
    fused_sdpa: bool = False, fused_layer: bool = False,
    act_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """One post-LN encoder layer. The whole-layer kernel where
    `fused_layer` is on, `flash` off, no `act_dtype`, the provider an int8 one, 1 < T <=
    256, E % 128 == 0 and E % heads == 0 (the JAX gate) and E <= enc.MAX_E
    (enc.width_ok: the widths the kernel's tiles hold); else the split
    layer: self-attention (attention_forward) then the FFN, under
    "fused" the FFN-block kernel at M = B·T."""
    if layer_kernel_runs(fused_layer, flash, act_dtype, provider, x.shape[-2],
                         x.shape[-1], num_heads):
        return enc.encoder_layer_fused(x, layer, mask_add, num_heads)
    out, _ = attention_forward(
        layer["att"], x, mask_add, num_heads, flash=flash, fused_sdpa=fused_sdpa,
        provider=provider, act_dtype=act_dtype)
    return _ffn_block(layer, out, provider, act_dtype)


def encoder_forward(
    params: dict, word_embedding: torch.Tensor, mask_add: torch.Tensor,
    num_heads: int, provider: Optional[str] = None, flash: bool = False,
    fused_sdpa: bool = False, fused_layer: bool = False,
    act_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """[B,T,E] → [B,T,E] through every encoder layer
    (encoder_layer_forward, gates as in the JAX package); with
    `act_dtype` the output stays in it."""
    x = word_embedding
    for layer in params["encoder"]:
        x = encoder_layer_forward(
            layer, x, mask_add, num_heads, provider, flash=flash,
            fused_sdpa=fused_sdpa, fused_layer=fused_layer, act_dtype=act_dtype)
    return x


def decoder_layer_forward(
    layer: dict, state: torch.Tensor, x: torch.Tensor,
    mask_add: torch.Tensor, kv_cache, num_heads: int,
    provider: Optional[str] = None, attn_kernel: bool = False,
):
    """SSRU → cross-attention over any cache of precompute_cross_kv → FFN.
    Returns (out, new_state, attn)."""
    decoder_out, new_state = ssru_forward(layer["rnn"], state, x, provider)
    out, attn = attention_forward(
        layer["att"], decoder_out, mask_add, num_heads, kv_cache, attn_kernel,
        provider=provider,
    )
    return _ffn_block(layer, out, provider), new_state, attn


# The self-attention cache's dtypes: int16 per row (the declared path) and
# float32 (the exact path, beside the exact split cross-attention cache).
SELF_CACHES = ("int16", "float32")


def decoder_kind(params: dict) -> str:
    """"self-attention" where the decoder layers carry a self-attention
    block (marian's transformer decoder), else "ssru"."""
    decoder = params["decoder"]
    first = decoder[0] if isinstance(decoder, (list, tuple)) else decoder
    return SELF_ATTENTION if "self" in first else SSRU


def make_self_caches(params: dict, batch: int, steps: int, dtype: str, device) -> tuple:
    """Per decoder layer, the causal self-attention cache of a decode loop
    of `batch` rows and `steps` positions: {"k", "v"} [B, steps, E] and the
    inverse scales {"kqi", "vqi"} [B, steps] f32, per row (b, t) as the
    cross-attention cache's (_per_row) for "int16"; float32 K and V with
    scalar scales 1 for "float32". Zeros when made and never zeroed after:
    a step writes its own position (write_self_cache) and attends to
    the positions up to it only."""
    if dtype not in SELF_CACHES:
        raise ValueError(f"the self-attention cache takes {SELF_CACHES}, not {dtype!r}")
    emb_dim = params["emb"]["q"].shape[1]
    caches = []
    for _ in params["decoder"]:
        if dtype == "float32":
            one = _f32(1.0)
            caches.append({"k": torch.zeros((batch, steps, emb_dim), device=device),
                           "v": torch.zeros((batch, steps, emb_dim), device=device),
                           "kqi": one, "vqi": one})
            continue
        cache = {name: torch.zeros((batch, steps, emb_dim), dtype=torch.int16, device=device)
                 for name in ("k", "v")}
        cache.update({name: torch.zeros((batch, steps), device=device)
                      for name in ("kqi", "vqi")})
        caches.append(cache)
    return tuple(caches)


def write_self_cache(cache: dict, k: torch.Tensor, v: torch.Tensor, at: torch.Tensor) -> None:
    """Write one step's K and V rows [B, 1, E] at position `at` ([1] long,
    a device step) of the cache, quantized per row where it is int16."""
    if cache["k"].dtype == torch.int16:
        for name, a in (("k", k), ("v", v)):
            q, inv = _per_row(a, True)
            cache[name].index_copy_(1, at, q)
            cache[name + "qi"].index_copy_(1, at, inv)
        return
    cache["k"].index_copy_(1, at, k)
    cache["v"].index_copy_(1, at, v)


def self_attention_read(q: torch.Tensor, cache: dict, valid: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """Decode attention (T_q = 1) of q [B, E] over the first `valid` ([1]
    int32 on the device) positions of a self-attention cache. Returns
    [B, E], before the O projection. The int16 cache goes to the
    valid-length kernel (ops/decode_attn.decode_self_attention_int16; on
    the CPU its plain path); the float32 one reads every position, those
    from `valid` on masked out (they hold zeros or an earlier batch's
    finite values, whose weight is exactly 0)."""
    k = cache["k"]
    if k.dtype == torch.int16:
        return decode_attn.decode_self_attention_int16(
            q, k, cache["v"], cache["kqi"], cache["vqi"], valid, num_heads)
    positions = torch.arange(k.shape[1], device=k.device, dtype=valid.dtype)
    mask = torch.where(positions < valid, _f32(0.0), _f32(MASK_MIN)).expand(k.shape[0], -1)
    return decode_attn.attention_plain(q, k, cache["v"], None, None, mask, num_heads)[0]


def self_attention_forward(att: dict, x: torch.Tensor, cache: dict, at: torch.Tensor,
                           valid: torch.Tensor, num_heads: int,
                           provider: Optional[str] = None) -> torch.Tensor:
    """The decoder's causal self-attention block at one step, with the
    residual and the post-LN: the step's K and V rows of x [B, 1, E] are
    written into `cache` at `at`, then its query attends to the positions
    before `valid` (at + 1)."""
    q = _affine(att["q"], x, provider=provider)
    k = _affine(att["k"], x, provider=provider)
    v = _affine(att["v"], x, provider=provider)
    write_self_cache(cache, k, v, at)
    mixed = self_attention_read(q[:, 0, :], cache, valid, num_heads)
    out = _affine(att["o"], mixed[:, None, :], provider=provider)
    return layer_norm(x + out, att["ln"])


def self_attention_decoder_layer(
    layer: dict, cache: dict, x: torch.Tensor, at: torch.Tensor, valid: torch.Tensor,
    mask_add: torch.Tensor, kv_cache, num_heads: int, provider: Optional[str] = None,
    attn_kernel: bool = False,
):
    """marian's transformer decoder layer at one step: causal
    self-attention over the layer's self-cache, cross-attention over any
    cache of precompute_cross_kv, then the FFN, each followed by the
    residual and a post-LN. Returns (out, attn of the cross-attention)."""
    h = self_attention_forward(layer["self"], x, cache, at, valid, num_heads, provider)
    out, attn = attention_forward(layer["att"], h, mask_add, num_heads, kv_cache, attn_kernel,
                                  provider=provider)
    return _ffn_block(layer, out, provider), attn


def output_inv(params: dict) -> np.float32:
    """The tied projection's epilogue multiplier 1 / (out.aq * emb.scale),
    in float32 as the JAX package computes it."""
    return np.float32(1) / (
        np.float32(params["out"]["aq"]) * np.float32(params["emb"]["scale"])
    )


def decoder_step(
    params: dict,
    states: Sequence[torch.Tensor],
    prev_embed: torch.Tensor,
    mask_add: torch.Tensor,
    kv_caches: Sequence,
    num_heads: int,
    shortlist: Optional[torch.Tensor] = None,
    projection: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    provider: Optional[str] = None,
    plan=None,
    argmax_method: str = "packed_int",
    attn_kernel: bool = False,
    packed_bias: Optional[torch.Tensor] = None,
    kind: str = SSRU,
    at: Optional[torch.Tensor] = None,
):
    """One greedy decode step over all decoder layers. prev_embed is
    the transformed [B, 1, E] input. Returns (choice [B] int32 — a
    column of the projection —, new_states, attn [B,H,1,T] of the last
    layer; under "fused_step" only head 0, [B,1,1,T]; zeros under
    `attn_kernel`).

    `kind` is the decoder's (decoder_kind). For the SSRU decoder `states`
    are its layers' cells [B, 1, E]. For the self-attention decoder they
    are its per-layer self-caches (make_self_caches), written at `at`
    (the device step, [1] int32) and returned, and each layer attends to
    positions 0..at (self_attention_decoder_layer).

    provider "fused" runs each layer's SSRU and FFN as block kernels;
    `argmax_method` picks the greedy argmax (output_argmax). Provider
    "fused_step" runs the whole step as one call of
    ops/decoder_step.whole_decode_step (exact first-max argmax; the
    method and `attn_kernel` do not apply); `plan` is that call's
    loop-invariant argument block (StepPlan), built once per batch on
    CUDA; `packed_bias` the `packed_int` argmax's bias in accumulator
    units (packed_int_bias), built once per batch by the decode loop."""
    if projection is None:
        projection = prepare_output_projection(params, shortlist, provider)
    if provider == "fused_step":
        from slimt_tpu_torch.ops import decoder_step as dstep

        choice, new_states, attn0 = dstep.whole_decode_step(
            params["decoder"], states, prev_embed, mask_add, kv_caches,
            num_heads, projection, params["out"]["aq"], output_inv(params),
            plan=plan,
        )
        return choice, new_states, attn0[:, None, None, :]
    if kind == SELF_ATTENTION:
        return _self_attention_step(params, states, prev_embed, mask_add, kv_caches,
                                    num_heads, projection, provider, argmax_method,
                                    attn_kernel, packed_bias, at)
    x = prev_embed
    new_states = []
    guided = None
    for layer, state, kv in zip(params["decoder"], states, kv_caches):
        x, new_state, guided = decoder_layer_forward(
            layer, state, x, mask_add, kv, num_heads, provider, attn_kernel
        )
        new_states.append(new_state)
    choice = output_argmax(params, x[:, 0, :], provider, projection, argmax_method,
                           packed_bias)
    return choice, tuple(new_states), guided


def _self_attention_step(params, caches, x, mask_add, kv_caches, num_heads, projection,
                         provider, argmax_method, attn_kernel, packed_bias, at):
    """decoder_step of the self-attention decoder: (choice, caches, attn)."""
    position = at.to(torch.long)
    valid = at + 1
    guided = None
    for layer, cache, kv in zip(params["decoder"], caches, kv_caches):
        x, guided = self_attention_decoder_layer(layer, cache, x, position, valid, mask_add, kv,
                                                 num_heads, provider, attn_kernel)
    choice = output_argmax(params, x[:, 0, :], provider, projection, argmax_method,
                           packed_bias)
    return choice, caches, guided


def prepare_output_projection(
    params: dict, shortlist: Optional[torch.Tensor] = None,
    provider: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W [E, V or S], b) of the tied logit projection. W is a
    transposed view of the int8 embedding (under "f32", of its
    dequantized copy `emb.w`), or of its shortlisted rows, gathered once
    per batch; nothing is copied per step."""
    emb_q = params["emb"]["w" if provider == "f32" else "q"]  # [V, E]
    bias = params["out"]["b"]
    if shortlist is not None:
        ids = shortlist.to(torch.long)
        return emb_q.index_select(0, ids).T, bias.index_select(0, ids)
    return emb_q.T, bias


def output_logits(
    params: dict,
    x: torch.Tensor,
    shortlist: Optional[torch.Tensor] = None,
    projection: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    provider: Optional[str] = None,
) -> torch.Tensor:
    """Tied-embedding logits x [B, E] → [B, V or S]: the int8 projection
    acc * (1 / (out.aq * emb.scale)) + b; under "f32" x @ W + b on the
    dequantized projection (prepare_output_projection's)."""
    if projection is None:
        projection = prepare_output_projection(params, shortlist, provider)
    w, b = projection
    if provider == "f32":
        return qmm.affine_f32(x, w, b)
    return qmm.affine(x, w, b, params["out"]["aq"], output_inv(params))


def packed_argmax_bf16(logits: torch.Tensor) -> torch.Tensor:
    """The packed argmax over bfloat16-rounded logits."""
    return packed_argmax_16(logits, torch.bfloat16)


def uses_packed_int(provider: Optional[str], method: str) -> bool:
    """Whether output_argmax takes the `packed_int` keys: under the
    declared providers only (elsewhere "packed_int" is the exact argmax)."""
    return method == "packed_int" and provider in (None, "xla_int8", "pallas")


def packed_int_bias(params: dict, bias: torch.Tensor) -> torch.Tensor:
    """The projection bias [S] in accumulator units, as int32 clamped to
    the accumulator bound: the `b_i32` of packed_int_argmax."""
    e_dim = params["emb"]["q"].shape[1]
    cap = e_dim * 127 * 127
    scale = _f32(params["out"]["aq"] * params["emb"]["scale"])
    return torch.clamp(torch.round(bias * scale), -cap, cap).to(torch.int32)


def output_argmax(
    params: dict,
    x: torch.Tensor,
    provider: Optional[str] = None,
    projection: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    method: str = "packed_int",
    packed_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy choice [B] int32 over the tied projection's columns.

    Under "f32" (the projection prepare_output_projection gives it): the
    f32 logits, then packed_argmax_16 for "packed_fp16"/"packed_bf16" up
    to 65536 columns and the exact first maximum for every other method
    (the JAX function's f32 branch; no int8 kernel).
    "packed_int" under the providers None, "xla_int8" and "pallas": the
    int8 projection's int32 accumulators plus the bias folded into
    accumulator units, compared as packed integer keys, by the argmax
    kernel's packed_int mode (ops/logits_argmax; on the CPU its plain
    chain, int8_matmul then packed_int_argmax). Every other case goes
    to the argmax kernel too, whose index is the JAX package's XLA
    argmax: "packed_fp16"/"packed_bf16" up to 65536 columns, else the
    exact first maximum. So "fused" with "packed_int" takes the exact
    argmax, as in the JAX package (transformer.py:1035, :1051-1057).
    `packed_bias` is packed_int_bias of the projection's bias, where the
    caller has it. On the card every int8 case takes E up to
    logits_argmax.MAX_EMB (2048), the kernel's limit."""
    if projection is None:
        projection = prepare_output_projection(params, provider=provider)
    w, b = projection
    aq = params["out"]["aq"]
    if provider == "f32":
        logits = qmm.affine_f32(x, w, b)
        if method in logits_argmax.PACKED_DTYPES and w.shape[1] <= logits_argmax.MAX_PACKED_WIDTH:
            return packed_argmax_16(logits, logits_argmax.PACKED_DTYPES[method])
        return first_max(logits)
    if uses_packed_int(provider, method):
        if packed_bias is None:
            packed_bias = packed_int_bias(params, b)
        return logits_argmax.argmax_affine(x, w, packed_bias, aq, None, "packed_int")
    if method not in logits_argmax.PACKED_DTYPES or w.shape[1] > logits_argmax.MAX_PACKED_WIDTH:
        method = "exact"
    return logits_argmax.argmax_affine(x, w, b, aq, output_inv(params), method)


# -- Tensor and sequence parallelism -------------------------------------
#
# The pieces a mesh's ranks run (models/decode.translate_batch on a
# parallel.sharding.ShardedParams). GSPMD partitioned the JAX functions
# and inserted the collectives; here the single controller runs each
# piece rank by rank (lists in rank order) and calls the collectives
# (parallel.collectives.Local) between them. Every result equals one
# device's, bit for bit:
#   - column-parallel affines (Q, K, V, W1, the SSRU's W and Wf) are #1 on
#     the rank's columns; a column's int32 sum does not depend on the split;
#   - row-parallel affines (O, W2) run #1 in ACCUMULATOR mode, all-reduce
#     the int32 accumulators, and only then apply #1's epilogue (acc * inv,
#     then + b, rounded apart) and the residual and LN over the whole row;
#   - the per-row cross-KV scales take the max of the ranks' absmax over
#     their columns before they quantize;
#   - the SSRU gathers its cell's column shards before the LN; the cell
#     state stays local;
#   - the vocab-sharded embedding takes each rank's rows (zeros elsewhere)
#     and sums them as integers; a shortlist's rows likewise, and its
#     positions are split over the model ranks;
#   - the greedy choice reduces keys that carry the global column with a
#     max: packed_int's from #1's accumulators, the others from #4's key
#     variant;
#   - the decode attention of a rank's heads runs #3 on them where its
#     width allows, and the plain branches on the heads padded to the whole
#     row with zeros (the full call's shapes, so torch's products sum as
#     one device's do);
#   - under sequence parallelism a rank's query rows attend to K and V
#     gathered along T (#8's or #9's query slice).
# The whole-row kernels (the whole layer #2, the fused blocks #5/#6, the
# whole step #7) and the f32 provider take whole rows: under a TP mesh
# they run on the gathered params (ShardedParams.gathered), once per data
# shard, as GSPMD runs a Pallas call on gathered operands.


class ModelRanks:
    """The model ranks of one data shard: their params in rank order (`ps`,
    each a column/row shard, or one whole params dict), the collectives,
    and the vocabulary split: `vocab_sharded` where emb.q is split over the
    ranks (else every rank holds the whole table)."""

    def __init__(self, ps: Sequence[dict], collectives, vocab_size: int):
        self.ps = list(ps)
        self.coll = collectives
        self.size = len(self.ps)
        self.vocab_size = vocab_size
        rows = self.ps[0]["emb"]["q"].shape[0]
        self.vocab_sharded = self.size > 1 and rows * self.size == vocab_size
        self.vocab_lo = [m * rows if self.vocab_sharded else 0 for m in range(self.size)]

    def split(self, n: int, m: int) -> Tuple[int, int]:
        """Rank m's even share [lo, hi) of n positions."""
        return m * n // self.size, (m + 1) * n // self.size


def _owned_rows(table: torch.Tensor, ids: torch.Tensor, lo: int) -> torch.Tensor:
    """The rows of ids in [lo, lo + len(table)) as int32 (int8 rows; float
    rows as their bits), zeros elsewhere: a rank's share of a row gather
    over a vocab-sharded table, summed over the ranks as integers."""
    n = table.shape[0]
    local = ids.to(torch.long) - lo
    inside = (local >= 0) & (local < n)
    rows = table.index_select(0, local.clamp(0, n - 1).reshape(-1))
    rows = rows.reshape(*ids.shape, *table.shape[1:])
    rows = rows.view(torch.int32) if rows.dtype == torch.float32 else rows.to(torch.int32)
    mask = inside.reshape(*inside.shape, *([1] * (table.dim() - 1)))
    return torch.where(mask, rows, 0)


def tp_embed(ranks: ModelRanks, indices: Sequence[torch.Tensor]) -> list:
    """embed over the model ranks: each rank's ids (one batch, on its
    device) give the f32 embeddings on every rank."""
    if not ranks.vocab_sharded:
        return [embed(p, idx) for p, idx in zip(ranks.ps, indices)]
    parts = [_owned_rows(p["emb"]["q"], idx, lo)
             for p, idx, lo in zip(ranks.ps, indices, ranks.vocab_lo)]
    return [rows.to(torch.float32) * _f32(p["emb"]["inv"])
            for p, rows in zip(ranks.ps, ranks.coll.all_reduce_sum(parts))]


def tp_affine_row(ranks: ModelRanks, mats: Sequence[dict], xs: Sequence[torch.Tensor]) -> list:
    """A row-parallel affine: each rank's int8 product of its input columns
    against its rows of the weight (#1, ACCUMULATOR), the int32
    accumulators summed over the ranks, then #1's epilogue."""
    accs = [qmm.int8_matmul(x, p["q"], p["aq"]) for p, x in zip(mats, xs)]
    return [acc.to(torch.float32) * _f32(p["inv"]) + p["b"]
            for p, acc in zip(mats, ranks.coll.all_reduce_sum(accs))]


def tp_ssru(ranks: ModelRanks, rnns, states, xs) -> Tuple[list, list]:
    """ssru_forward over the ranks' column shards of W and Wf: the cell
    c(t) stays local ([B, 1, E / M]); h = LN(x + relu(c)) takes the cell's
    columns gathered."""
    cells = []
    for rnn, state, x in zip(rnns, states, xs):
        f = torch.sigmoid(_affine(rnn["wf"], x))
        wx = _affine(rnn["w"], x)
        cells.append(f * state + (1.0 - f) * wx)
    whole = ranks.coll.all_gather(cells, dim=-1)
    hs = [layer_norm(x + torch.relu(c), rnn["ln"]) for rnn, x, c in zip(rnns, xs, whole)]
    return hs, cells


def pad_heads(a: torch.Tensor, m: int, size: int) -> torch.Tensor:
    """Rank m's columns [..., E / size] in place in a zero [..., E] tensor."""
    width = a.shape[-1]
    out = a.new_zeros((*a.shape[:-1], width * size))
    out[..., m * width:(m + 1) * width] = a
    return out


def tp_cross_kv(grid: Sequence[Sequence[dict]], encoder_out, num_heads: int,
                dtype: Optional[str], coll, pad: Sequence[bool],
                provider: Optional[str] = None) -> list:
    """precompute_cross_kv over a data shard's (model, seq) ranks: grid[m][s]
    the params and encoder_out[m][s] [B, T / S, E] (replicated over m) of
    rank (m, s). The K/V affines run on each rank's rows and columns; the
    per-row scales take the row's absmax, max-reduced over m; the caches
    are gathered along T over s onto rank (m, 0). Joined caches of the
    ranks with pad[m] are padded to the whole row (pad_heads). Returns
    caches[m] per layer."""
    model, seqs = len(grid), len(grid[0])
    heads = num_heads // model
    caches = [[] for _ in range(model)]
    for li in range(len(grid[0][0]["decoder"])):
        att = [[grid[m][s]["decoder"][li]["att"] for s in range(seqs)] for m in range(model)]
        k = [[_affine(att[m][s]["k"], encoder_out[m][s], provider=provider)
              for s in range(seqs)] for m in range(model)]
        v = [[_affine(att[m][s]["v"], encoder_out[m][s], provider=provider)
              for s in range(seqs)] for m in range(model)]

        def gather(parts, dim):
            return coll.all_gather(parts, dim)[0]

        if dtype is None:
            for m in range(model):
                caches[m].append(tuple(
                    gather([_split_heads(a, heads) for a in kv[m]], 2) for kv in (k, v)))
            continue
        if dtype in FLOAT_CACHES:
            one = _f32(1.0)
            for m in range(model):
                kf, vf = (gather([a.to(FLOAT_CACHES[dtype]) for a in kv[m]], 1)
                          for kv in (k, v))
                if pad[m]:
                    kf, vf = pad_heads(kf, m, model), pad_heads(vf, m, model)
                caches[m].append({"k": kf, "v": vf, "kqi": one, "vqi": one})
            continue
        wide = dict(zip(("k", "v"), ROW_CACHES[dtype]))
        quant = {}
        for name, kv in (("k", k), ("v", v)):
            absmax = [coll.all_reduce_max([kv[m][s].abs().amax(-1) for m in range(model)])
                      for s in range(seqs)]
            quant[name] = [[_per_row(kv[m][s], wide[name], absmax[s][m])
                            for s in range(seqs)] for m in range(model)]
        for m in range(model):
            cache = {}
            for name in ("k", "v"):
                q = gather([quant[name][m][s][0] for s in range(seqs)], 1)
                cache[name] = pad_heads(q, m, model) if pad[m] else q
                cache[name + "qi"] = gather([quant[name][m][s][1] for s in range(seqs)], 1)
            caches[m].append(cache)
    return [tuple(c) for c in caches]


def sp_attention(q, k, v, mask_add, num_heads: int, *, fused_sdpa: bool = False,
                 flash: bool = False) -> torch.Tensor:
    """The encoder self-attention of one rank: its query rows q [B, T_q, E']
    (E' = its heads' columns) against k, v [B, T, E'] gathered along T.
    The precedence of attention_forward: the fused SDPA (#8) where asked at
    1 < T <= 256, else blockwise (#9) where asked; on the card a kernel
    in any case where the head dim is one of its (#8 up to T = 256, else
    #9): the plain SDPA never serves a mesh there. Else the plain SDPA,
    each row equal to the full call's (ops/attention's query slice)."""
    t, e = k.shape[1], q.shape[-1]
    d = e // num_heads
    kernel = d in enc.HEAD_DIMS
    short = 1 < t <= enc.MAX_T
    if kernel and short and (fused_sdpa or (q.is_cuda and not flash)):
        return attention.fused_sdpa_joined(q, k, v, mask_add, num_heads, 0, q.shape[1])
    if kernel and (flash or q.is_cuda):
        out = attention.blockwise_attention(
            _split_heads(q, num_heads), _split_heads(k, num_heads),
            _split_heads(v, num_heads), mask_add, 0, q.shape[1])
        return _join_heads(out)
    if q.is_cuda:
        raise ValueError(f"head dim {d} not in {enc.HEAD_DIMS}: no attention kernel "
                         "serves this mesh's encoder on the card")
    return attention.sdpa_rows_plain(q, k, v, mask_add, num_heads, 0, q.shape[1])


def tp_encoder(grid: Sequence[Sequence[dict]], ranks_by_seq: Sequence[ModelRanks],
               xs, masks, num_heads: int, coll, *, provider: Optional[str] = None,
               fused_sdpa: bool = False, flash: bool = False) -> list:
    """encoder_forward over a data shard's (model, seq) ranks: xs[m][s]
    [B, T / S, E] (replicated over m) and masks[m][s] the whole additive
    mask [B, 1, 1, T]; grid[m][s] the params, ranks_by_seq[s] the model
    ranks of seq position s. Q/K/V and W1 run on each rank's columns, K
    and V are gathered along T over s, each rank's query rows attend
    (sp_attention), O and W2 are row-parallel. Returns xs updated."""
    model, seqs = len(grid), len(grid[0])
    heads = num_heads // model
    xs = [list(row) for row in xs]
    for li in range(len(grid[0][0]["encoder"])):
        layer = [[grid[m][s]["encoder"][li] for s in range(seqs)] for m in range(model)]
        att = [[layer[m][s]["att"] for s in range(seqs)] for m in range(model)]
        proj = {name: [[_affine(att[m][s][name], xs[m][s], provider=provider)
                        for s in range(seqs)] for m in range(model)]
                for name in ("q", "k", "v")}
        heads_out = [[None] * seqs for _ in range(model)]
        for m in range(model):
            keys = coll.all_gather(proj["k"][m], 1)
            values = coll.all_gather(proj["v"][m], 1)
            for s in range(seqs):
                heads_out[m][s] = sp_attention(proj["q"][m][s], keys[s], values[s],
                                               masks[m][s], heads, fused_sdpa=fused_sdpa,
                                               flash=flash)
        for s in range(seqs):
            ranks = ranks_by_seq[s]
            if model == 1:
                ys = [_affine(att[0][s]["o"], heads_out[0][s], provider=provider)]
            else:
                ys = tp_affine_row(ranks, [att[m][s]["o"] for m in range(model)],
                                   [heads_out[m][s] for m in range(model)])
            x1 = [layer_norm(xs[m][s] + ys[m], att[m][s]["ln"]) for m in range(model)]
            ffn = [layer[m][s]["ffn"] for m in range(model)]
            hidden = [_affine(ffn[m]["w1"], x1[m], relu=True, provider=provider)
                      for m in range(model)]
            if model == 1:
                ys = [_affine(ffn[0]["w2"], hidden[0], provider=provider)]
            else:
                ys = tp_affine_row(ranks, [f["w2"] for f in ffn], hidden)
            for m in range(model):
                xs[m][s] = layer_norm(ys[m] + x1[m], ffn[m]["ln"])
    return xs


def tp_projections(ranks: ModelRanks, shortlists: Optional[Sequence[torch.Tensor]] = None):
    """Each rank's share of the tied projection: ([(W [E, S_m], b [S_m],
    col0)], the whole width S). The full vocabulary: a rank's own rows
    (vocab-sharded) or its even share of the whole table; a shortlist:
    its rows gathered (owned rows summed as integers where the table is
    sharded), then split evenly over the ranks by position."""
    out = []
    if shortlists is None:
        width = ranks.vocab_size
        for m, p in enumerate(ranks.ps):
            q, b = p["emb"]["q"], p["out"]["b"]
            if ranks.vocab_sharded:
                out.append((q.T, b, ranks.vocab_lo[m]))
            else:
                lo, hi = ranks.split(width, m)
                out.append((q[lo:hi].T, b[lo:hi], lo))
        return out, width
    width = shortlists[0].shape[0]
    if ranks.vocab_sharded:
        rows = ranks.coll.all_reduce_sum(
            [_owned_rows(p["emb"]["q"], ids, lo)
             for p, ids, lo in zip(ranks.ps, shortlists, ranks.vocab_lo)])
        bias = ranks.coll.all_reduce_sum(
            [_owned_rows(p["out"]["b"], ids, lo)
             for p, ids, lo in zip(ranks.ps, shortlists, ranks.vocab_lo)])
        tables = [(r.to(torch.int8), b.view(torch.float32)) for r, b in zip(rows, bias)]
    else:
        tables = [(p["emb"]["q"].index_select(0, ids.to(torch.long)),
                   p["out"]["b"].index_select(0, ids.to(torch.long)))
                  for p, ids in zip(ranks.ps, shortlists)]
    for m, (rows, bias) in enumerate(tables):
        lo, hi = ranks.split(width, m)
        out.append((rows[lo:hi].T, bias[lo:hi].contiguous(), lo))
    return out, width


def tp_output_argmax(ranks: ModelRanks, xs, projections, width: int,
                     provider: Optional[str], method: str, packed_biases=None) -> list:
    """output_argmax over the ranks' shares of the projection: each rank's
    best key over its columns, keyed by the global column, max-reduced.
    `packed_int` (declared providers) keys #1's accumulators with the
    global width's packing; every other method runs #4's key variant
    (the exact argmax where the method is not packed or the width is past
    65536, as output_argmax)."""
    e_dim = ranks.ps[0]["emb"]["q"].shape[1]
    bests = []
    if uses_packed_int(provider, method):
        width_bits, shift = logits_argmax.packed_int_params(width, e_dim)
        for p, x, (w, b, col0), bias in zip(ranks.ps, xs, projections,
                                            packed_biases or [None] * ranks.size):
            if bias is None:
                bias = packed_int_bias(p, b)
            acc = qmm.int8_matmul(x, w, p["out"]["aq"])
            key = logits_argmax.packed_int_keys(acc, bias, width_bits, shift, col0)[0]
            bests.append(key.amax(-1))
        return [logits_argmax.packed_int_column(best, width_bits)
                for best in ranks.coll.all_reduce_max(bests)]
    if method not in logits_argmax.PACKED_DTYPES or width > logits_argmax.MAX_PACKED_WIDTH:
        method = "exact"
    for p, x, (w, b, col0) in zip(ranks.ps, xs, projections):
        bests.append(logits_argmax.argmax_keys(
            x, w, b, p["out"]["aq"], output_inv(p), method, col0)[1])
    return [logits_argmax.key_column(best, method)
            for best in ranks.coll.all_reduce_max(bests)]


def tp_decoder_step(ranks: ModelRanks, states, xs, masks, caches, num_heads: int, *,
                    projections, width: int, provider: Optional[str] = None,
                    argmax_method: str = "packed_int", attn_kernel=False,
                    packed_biases=None, padded=None):
    """decoder_step over the model ranks of one data shard, as a generator.
    states[m]: rank m's cell states per layer ([B, 1, E / M]); xs[m] the
    step's [B, 1, E] input on its device; caches[m] its cross-KV caches
    (tp_cross_kv), padded[m] whether its joined caches are padded to the
    whole row (else #3 runs on its own heads). Where the caches are int8 or k8v16 the step yields, at each
    layer's cross-attention, the ranks' absmax of q and takes back the
    whole batch's (models/decode.lockstep max-reduces them over every data
    shard); else it yields nothing. Returns (choices per rank, new states
    per rank, rank 0's last cross-attention weights, whose head 0 is the
    model's). With one rank (whole params) every piece is the one-device
    function of the provider."""
    model = ranks.size
    heads = num_heads // model
    padded = padded or [False] * model
    new_states = [[] for _ in range(model)]
    attn0 = None
    for li in range(len(ranks.ps[0]["decoder"])):
        layers = [p["decoder"][li] for p in ranks.ps]
        if model == 1:
            h, c = ssru_forward(layers[0]["rnn"], states[0][li], xs[0], provider)
            hs, cells = [h], [c]
        else:
            hs, cells = tp_ssru(ranks, [l["rnn"] for l in layers],
                                [st[li] for st in states], xs)
        for m in range(model):
            new_states[m].append(cells[m])
        atts = [l["att"] for l in layers]
        yqs = [_affine(att["q"], h, provider=provider) for att, h in zip(atts, hs)]
        first = caches[0][li]
        q_absmax = [None] * model
        if isinstance(first, dict) and first["k"].dtype == torch.int8:
            q_absmax = yield [yq.abs().amax() for yq in yqs]
        outs = []
        for m in range(model):
            kv = caches[m][li]
            if not isinstance(kv, dict):
                attn_out, attn = enc.sdpa_heads(_split_heads(yqs[m], heads), *kv, masks[m])
                outs.append(_join_heads(attn_out))
            elif model == 1 or not padded[m]:
                out, attn = _decode_attention_joined(yqs[m], kv, masks[m], heads, attn_kernel,
                                                     q_absmax[m])
                outs.append(out)
            else:
                out, attn = _decode_attention_joined(
                    pad_heads(yqs[m], m, model), kv, masks[m], num_heads, attn_kernel,
                    q_absmax[m])
                width_m = yqs[m].shape[-1]
                outs.append(out[..., m * width_m:(m + 1) * width_m])
                attn = attn[:, m * heads:(m + 1) * heads]
            if m == 0:
                attn0 = attn
        if model == 1:
            ys = [_affine(atts[0]["o"], outs[0], provider=provider)]
        else:
            ys = tp_affine_row(ranks, [att["o"] for att in atts], outs)
        x1 = [layer_norm(h + y, att["ln"]) for h, y, att in zip(hs, ys, atts)]
        if model == 1:
            xs = [_ffn_block(layers[0], x1[0], provider)]
        else:
            ffn = [l["ffn"] for l in layers]
            hidden = [_affine(f["w1"], x, relu=True) for f, x in zip(ffn, x1)]
            ys = tp_affine_row(ranks, [f["w2"] for f in ffn], hidden)
            xs = [layer_norm(y + x, f["ln"]) for f, y, x in zip(ffn, ys, x1)]
    rows = [x[:, 0, :] for x in xs]
    if model == 1:
        w, b, _ = projections[0]
        choices = [output_argmax(ranks.ps[0], rows[0], provider, (w, b), argmax_method,
                                 packed_biases[0] if packed_biases else None)]
    else:
        choices = tp_output_argmax(ranks, rows, projections, width, provider,
                                   argmax_method, packed_biases)
    return choices, new_states, attn0
