"""Whole decode step and one decoder layer: the counterparts of
slimt_tpu/ops/decoder_step_pallas.py's `whole_decode_step` (bodies
`_whole_kernel` and `_layer_math_bte`), the step of the `fused_step`
latency provider, and of its per-layer kernels `decoder_layer_step_bte`
(joined float cache) and `decoder_layer_step` (split float cache).

The whole step runs every decoder layer (SSRU, cross-attention, FFN), the
tied int8 projection over the full vocabulary or a shortlist, and the
exact first-max argmax:

    f  = sigmoid(q8(x) Wf inv + bf);  c' = f c + (1 - f) q8(x) W inv
    h  = LN(x + relu(c'))
    q  = q8(h) Wq inv + bq
    p  = softmax_T(((K . q)_head / sqrt(D)) * kqi + mask)   per head
    a  = LN(h + q8(sum_T (p * vqi) V) Wo inv + bo)
    y  = LN(a + q8(relu(q8(a) W1 inv + b1)) W2 inv + b2)
    choice = first argmax of q8(y) W_out inv_out + b_out

over the joined [B, T, E] int16 per-row cache, or a joined float32,
bfloat16 or float16 cache, for which q and p are rounded through the
cache's type and kqi = vqi = 1 (the JAX kernel's float branch). The
per-layer steps return one layer's (y, c', attn0): `decoder_layer_step_bte`
with the whole step's numerics over a joined float cache,
`decoder_layer_step` over a split [B, H, T, D] float cache with nothing
rounded and score = (K . q)_head / sqrt(D) + mask. The JAX package
reaches these two from its tests only; the port serves no path through
them either.

On a CUDA tensor each entry launches its kernel (csrc/decoder_step.cu:
`slimt_whole_decode_step`, `slimt_decoder_layer_step`) or raises; on a CPU tensor it runs its plain
version. The plain versions call `qmm.affine_plain` directly, so that on
the card they share no kernel with what they are compared against. The
layers kernel runs a tile of rows on a thread-block cluster of `cs`
blocks (`fused_blocks.cluster_layout`; `step_layout` fits it to the card).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from slimt_tpu_torch.ops import _build, decode_attn, fused_blocks, launches, qmm
from slimt_tpu_torch.ops.encoder_layer import layer_norm, softmax
from slimt_tpu_torch.ops.fused_blocks import (
    EMB_DIMS,
    FFN_DIMS,
    card_query,
    check_cluster,
    cluster_layout,
    fit_cluster,
)
# The projection stage alone: the exact mode of the argmax kernel.
from slimt_tpu_torch.ops.logits_argmax import (  # noqa: F401
    argmax_scratch,
    argmax_affine_kernel,
    argmax_affine_plain,
)

MAX_LAYERS = 8
# Cache kinds of the C entries (csrc/decoder_step.cu: CacheKind).
JOINED_KINDS = {torch.int16: 0, torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
SPLIT_KINDS = {torch.float32: 4, torch.bfloat16: 5, torch.float16: 6}
FLOAT_KINDS = {dtype: JOINED_KINDS[dtype] for dtype in SPLIT_KINDS}


def _affine(p: dict, x: torch.Tensor) -> torch.Tensor:
    return qmm.affine_plain(x, p["q"], p["b"], p["aq"], p["inv"])


def _layer_plain(layer, x, c, attend):
    """One decoder layer on [B, E] rows in `_layer_math_bte`'s order: the
    plain SSRU block, `attend(q) -> (out [B, E], attn0 [B, T])` and the
    FFN block. Returns (y, c', attn0)."""
    h, c_t = fused_blocks.ssru_plain(x, c, layer["rnn"])
    att = layer["att"]
    attn_out, attn0 = attend(_affine(att["q"], h))
    a = layer_norm(h + _affine(att["o"], attn_out), att["ln"]["scale"], att["ln"]["bias"])
    return fused_blocks.ffn_plain(a, layer["ffn"]), c_t, attn0


def _joined(kv, mask, num_heads):
    """The attention of a joined cache: int16 with kqi/vqi, or float."""
    def attend(q):
        out, p = decode_attn.attention_plain(
            q, kv["k"], kv["v"], kv.get("kqi"), kv.get("vqi"), mask, num_heads)
        return out, p[:, :, 0]
    return attend


def split_attention_plain(q, k, v, mask, num_heads):
    """decoder_layer_step's attention (`_kernel`): q [B, E]; k, v [B, H, T,
    D] float of any type; mask [B, T]. Nothing is rounded:
    score = (sum_D K q) / sqrt(D) + mask. Returns (out [B, E], p [B, H, T])."""
    b, h, t, d = k.shape
    scale = qmm._f32(1.0 / np.sqrt(d))
    qh = q.reshape(b, h, 1, d)
    scores = (k.to(torch.float32) * qh).sum(-1) * scale + mask[:, None, :]
    p = softmax(scores)
    out = (v.to(torch.float32) * p[..., None]).sum(2)
    return out.reshape(b, h * d), p


def layers_plain(layers, states, x, mask_add, kv_caches, num_heads):
    """Every decoder layer of the plain step. Returns (y [B, E] — the
    projection's input —, new_states per layer [B, 1, E], attn0)."""
    h = x[:, 0, :].to(torch.float32)
    mask = mask_add[:, 0, 0, :].to(torch.float32)
    new_states = []
    attn0 = None
    for layer, state, kv in zip(layers, states, kv_caches):
        h, c_t, attn0 = _layer_plain(layer, h, state[:, 0, :], _joined(kv, mask, num_heads))
        new_states.append(c_t[:, None, :])
    return h, tuple(new_states), attn0


def whole_step_plain(
    layers, states, x, mask_add, kv_caches, num_heads, projection,
    out_aq, out_inv,
):
    """Plain PyTorch version of the whole step. Returns (choice [B]
    int32, new_states per layer [B, 1, E], attn0 [B, T] of the last
    layer)."""
    y, new_states, attn0 = layers_plain(
        layers, states, x, mask_add, kv_caches, num_heads)
    w, bias = projection
    return argmax_affine_plain(y, w, bias, out_aq, out_inv), new_states, attn0


def decoder_layer_step_bte_plain(layer, state, x, mask_add, kv, num_heads):
    """Plain version of decoder_layer_step_bte: kv = (K, V) joined [B, T, E]
    float. Returns (y [B, 1, E], c' [B, 1, E], attn0 [B, T])."""
    mask = mask_add[:, 0, 0, :].to(torch.float32)
    cache = {"k": kv[0], "v": kv[1]}
    y, c_t, attn0 = _layer_plain(layer, x[:, 0, :].to(torch.float32),
                                 state[:, 0, :].to(torch.float32),
                                 _joined(cache, mask, num_heads))
    return y[:, None, :], c_t[:, None, :], attn0


def decoder_layer_step_plain(layer, state, x, mask_add, kv, num_heads):
    """Plain version of decoder_layer_step: kv = (K, V) split [B, H, T, D]
    float. Returns (y [B, 1, E], c' [B, 1, E], attn0 [B, T])."""
    mask = mask_add[:, 0, 0, :].to(torch.float32)

    def attend(q):
        out, p = split_attention_plain(q, kv[0], kv[1], mask, num_heads)
        return out, p[:, 0]

    y, c_t, attn0 = _layer_plain(layer, x[:, 0, :].to(torch.float32),
                                 state[:, 0, :].to(torch.float32), attend)
    return y[:, None, :], c_t[:, None, :], attn0


def check_shapes(e: int, f: int, t: int, num_heads: int, layers: int) -> None:
    """Raise ValueError on a shape the kernel does not take. T is bounded
    only by the shared memory of one row, which the C entry knows
    (`step_rows`; at tiny widths and cs=1, T <= 7008)."""
    d = e // num_heads if num_heads > 0 else 0
    problems = []
    if e not in EMB_DIMS:
        problems.append(f"E={e} not in {EMB_DIMS}")
    if f not in FFN_DIMS:
        problems.append(f"F={f} not in {FFN_DIMS}")
    if t < 1:
        problems.append(f"T={t} < 1")
    if num_heads <= 0 or e % num_heads or num_heads & (num_heads - 1):
        problems.append(f"heads={num_heads} must be a power of two dividing E")
    elif not 8 <= d <= 256:
        problems.append(f"head dim {d} outside 8..256")
    if not 0 < layers <= MAX_LAYERS:
        problems.append(f"{layers} layers outside 1..{MAX_LAYERS}")
    if problems:
        raise ValueError("whole decode step: " + "; ".join(problems))


def _check_projection(w, b, e: int, device) -> None:
    if w.dtype != torch.int8 or w.dim() != 2 or w.shape[0] != e:
        raise ValueError(f"projection W must be int8 [{e}, S], got {w.dtype} {tuple(w.shape)}")
    if b.dtype != torch.float32 or not b.is_contiguous() or b.shape != (w.shape[1],):
        raise ValueError("projection bias must be a contiguous float32 [S] tensor")
    if w.device != device or b.device != device:
        raise ValueError("projection must be on the step's CUDA device")


def step_rows(b: int, e: int, f: int, heads: int, t: int, cs: int = 1,
              device: Optional[int] = None) -> int:
    """Rows a tile of the layers kernel takes on card `device` (the current
    one by default), on a cluster of cs blocks: those of the blocks
    (fused_blocks.rows_per_block), or 1 where their scores over T do not
    fit in shared memory (at tiny widths and cs=1, 4 rows fit up to
    T=1560). The C entry decides; ValueError where one row does not fit."""
    if device is None:
        device = torch.cuda.current_device()
    rows = card_query(device, "slimt_whole_step_rows", fused_blocks.rows_per_block(b), cs,
                      e, f, heads, t)
    if rows == 0:
        raise ValueError(f"whole decode step: T={t}: the scores of one row do "
                         "not fit in shared memory")
    return rows


def step_layout(b: int, e: int, f: int, heads: int, t: int, kind: int, device: int,
                _cluster: Optional[int] = None) -> tuple:
    """(cs, rows) of the layers kernel over caches of `kind` on card
    `device`: `cluster_layout`'s cluster size (`_cluster` forces one, for
    the card checks that compare them), halved while the card cannot hold
    one cluster a row tile at once (`fit_cluster`; a forced size raises
    where it cannot run at all), and the rows a tile that fit in shared
    memory at that size."""
    cs, rows = cluster_layout(b, e, f)
    if _cluster is not None:
        check_cluster(_cluster, e, f)
        cs = _cluster

    def capacity(size):
        return card_query(device, "slimt_step_clusters",
                          step_rows(b, e, f, heads, t, size, device), size, e, f, heads, t,
                          kind)

    cs = fit_cluster(capacity, cs, -(-b // rows), "whole decode step", _cluster is not None)
    return cs, step_rows(b, e, f, heads, t, cs, device)


def _layer_tensors(layer) -> list:
    """A layer's 17 weight, bias and LN tensors in the kernels' order."""
    rnn, att, ffn = layer["rnn"], layer["att"], layer["ffn"]
    return [
        rnn["wf"]["q"], rnn["wf"]["b"], rnn["w"]["q"],
        rnn["ln"]["scale"], rnn["ln"]["bias"],
        att["q"]["q"], att["q"]["b"], att["o"]["q"], att["o"]["b"],
        att["ln"]["scale"], att["ln"]["bias"],
        ffn["w1"]["q"], ffn["w1"]["b"], ffn["w2"]["q"], ffn["w2"]["b"],
        ffn["ln"]["scale"], ffn["ln"]["bias"],
    ]


def _layer_scales(layer) -> list:
    rnn, att, ffn = layer["rnn"], layer["att"], layer["ffn"]
    scales = []
    for p in (rnn["wf"], rnn["w"], att["q"], att["o"], ffn["w1"], ffn["w2"]):
        scales += [p["aq"], p["inv"]]
    return scales


def _pointers(tensors, dev, strided=None):
    """A ctypes array of the tensors' device pointers (None: null), each
    checked to be on `dev`, 16-byte aligned and contiguous (but `strided`,
    the projection, which the kernel reads through its strides)."""
    for tensor in tensors:
        if tensor is None:
            continue
        if tensor.device != dev or not (tensor.is_contiguous() or tensor is strided):
            raise ValueError("step tensors must be contiguous on one CUDA device")
        if tensor.data_ptr() % 16:
            raise ValueError("step tensors must be 16-byte aligned")
    return (ctypes.c_void_p * len(tensors))(
        *[None if x is None else x.data_ptr() for x in tensors])


def _floats(values):
    return (ctypes.c_float * len(values))(*[float(np.float32(v)) for v in values])


def _cache_kind(k, v, kinds, want) -> int:
    """The C entries' kind of a K/V pair; ValueError on another type or
    shape."""
    if k.dtype not in kinds or v.dtype != k.dtype:
        names = ", ".join(str(d).replace("torch.", "") for d in kinds)
        raise ValueError(f"the kernel reads {names} caches, got K {k.dtype}, V {v.dtype}")
    for name, tensor in (("k", k), ("v", v)):
        if tuple(tensor.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(tensor.shape)}")
    return kinds[k.dtype]


class StepPlan:
    """The kernel's loop-invariant arguments, built once per batch: the
    per-layer weight, LN, K/V and (int16 cache) kqi/vqi pointers, the
    mask and the projection, the 12 * L + 2 scales, the cache kind and the
    scratch. A step then passes only x, the states and its outputs."""

    def __init__(self, layers, kv_caches, mask_add, num_heads, projection,
                 out_aq, out_inv, _cluster: Optional[int] = None):
        k0 = kv_caches[0]["k"]
        b, t, e = k0.shape
        f = layers[0]["ffn"]["w1"]["q"].shape[1]
        check_shapes(e, f, t, num_heads, len(layers))
        if _cluster is not None:
            check_cluster(_cluster, e, f)
        if not k0.is_cuda:
            raise ValueError(f"the kernel takes CUDA tensors, got {k0.device}")
        dev = k0.device
        w, bias = projection
        _check_projection(w, bias, e, dev)
        mask = mask_add.reshape(b, t).to(dev, torch.float32).contiguous()
        tensors, scales = [], []
        kinds = set()
        for layer, kv in zip(layers, kv_caches):
            kinds.add(_cache_kind(kv["k"], kv["v"], JOINED_KINDS, (b, t, e)))
            scaled = kv["k"].dtype == torch.int16
            if scaled:
                for name in ("kqi", "vqi"):
                    if tuple(kv[name].shape) != (b, t) or kv[name].dtype != torch.float32:
                        raise ValueError(f"{name} must be float32 {(b, t)}, got "
                                         f"{kv[name].dtype} {tuple(kv[name].shape)}")
            tensors += _layer_tensors(layer) + [
                kv["k"], kv["v"], kv["kqi"] if scaled else None,
                kv["vqi"] if scaled else None]
            scales += _layer_scales(layer)
        if len(kinds) != 1:
            raise ValueError("every layer's cache must have one type")
        tensors += [w, bias, mask]
        scales += [out_aq, out_inv]
        self._keep = tensors
        self._ptrs = _pointers(tensors, dev, strided=w)
        self._scales = _floats(scales)
        self.device = dev
        self.shape = (len(layers), b, t, e)
        kind = kinds.pop()
        self.cs, self.rows = step_layout(b, e, f, num_heads, t, kind, dev.index, _cluster)
        self.scratch = torch.empty(b * e + argmax_scratch(b, w.shape[1]), dtype=torch.float32,
                                   device=dev)
        self.args = (
            ctypes.addressof(self._ptrs), ctypes.addressof(self._scales),
            len(layers), b, t, e, f, num_heads, w.shape[1],
            w.stride(0), w.stride(1), self.rows, self.cs, kind,
        )


def _stacked(states, shape) -> torch.Tensor:
    """The states as one [L, B, E] block: the kernel's own output is one
    already (views of it), anything else is stacked."""
    n_layers, b, _, e = shape
    step = b * e * 4
    base = states[0].data_ptr()
    if all(
        s.dtype == torch.float32 and s.is_contiguous() and s.numel() == b * e
        and s.data_ptr() == base + i * step
        for i, s in enumerate(states)
    ):
        return states[0]
    return torch.stack([s.reshape(b, e).to(torch.float32) for s in states]).contiguous()


def whole_step_kernel(
    layers, states, x, mask_add, kv_caches, num_heads, projection,
    out_aq, out_inv, plan: Optional[StepPlan] = None, _cluster: Optional[int] = None,
):
    """Launch csrc/decoder_step.cu on CUDA tensors, the layers on clusters
    of `step_layout` blocks (`_cluster`, without a plan, forces a size for
    the card checks that compare them). `launches` counts the whole-step
    launches."""
    if plan is None:
        plan = StepPlan(layers, kv_caches, mask_add, num_heads, projection,
                        out_aq, out_inv, _cluster)
    n_layers, b, t, e = plan.shape
    if not x.is_cuda or x.device != plan.device:
        raise ValueError(f"x must be on {plan.device}, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() != b * e:
        raise ValueError(f"x must be a contiguous float32 [{b}, 1, {e}] tensor")
    if len(states) != n_layers:
        raise ValueError(f"{len(states)} states for {n_layers} layers")
    c_in = _stacked(states, plan.shape)
    c_out = torch.empty((n_layers, b, 1, e), dtype=torch.float32, device=x.device)
    attn0 = torch.empty((b, t), dtype=torch.float32, device=x.device)
    choice = torch.empty((b,), dtype=torch.int32, device=x.device)
    lib = _build.library()
    code = lib.slimt_whole_decode_step(
        *plan.args, x.data_ptr(), c_in.data_ptr(), c_out.data_ptr(),
        attn0.data_ptr(), choice.data_ptr(), plan.scratch.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "slimt_whole_decode_step")
    launches.count(whole_step_kernel)
    return choice, tuple(c_out.unbind(0)), attn0


whole_step_kernel.launches = 0


def whole_decode_step(
    layers: Sequence[dict],
    states: Sequence[torch.Tensor],  # per layer [B, 1, E]
    x: torch.Tensor,  # [B, 1, E] transformed previous embedding
    mask_add: torch.Tensor,  # [B, 1, 1, T]
    kv_caches: Sequence[dict],  # per layer {"k", "v", "kqi", "vqi"}, joined
    num_heads: int,
    projection: Tuple[torch.Tensor, torch.Tensor],  # (W [E, S] int8, b [S])
    out_aq,
    out_inv,
    plan: Optional[StepPlan] = None,
):
    """One decode step over every decoder layer + the (shortlisted)
    projection + the first-max argmax, over the int16 per-row cache or a
    float32, bfloat16 or float16 joined cache (its kqi and vqi unused).
    Returns (choice [B] int32 — a column of the projection —, new_states,
    attn0 [B, T], head 0 of the last layer)."""
    args = (layers, states, x, mask_add, kv_caches, num_heads, projection,
            out_aq, out_inv)
    if x.is_cuda:
        return whole_step_kernel(*args, plan=plan)
    if x.device.type == "cpu":
        return whole_step_plain(*args)
    raise ValueError(f"unsupported device {x.device}")


def _layer_step_kernel(layer, state, x, mask_add, kv, num_heads, split: bool,
                       _cluster: Optional[int]):
    """Launch slimt_decoder_layer_step (csrc/decoder_step.cu): one layer
    over a joined [B, T, E] or split [B, H, T, D] float cache, on clusters
    as the whole step's. Returns (y, c', attn0)."""
    k, v = kv
    b, e = x.shape[0], x.shape[-1]
    t = k.shape[2] if split else k.shape[1]
    f = layer["ffn"]["w1"]["q"].shape[1]
    check_shapes(e, f, t, num_heads, 1)
    if _cluster is not None:
        check_cluster(_cluster, e, f)
    if not x.is_cuda:
        raise ValueError(f"the kernel takes CUDA tensors, got {x.device}")
    want = (b, num_heads, t, e // num_heads) if split else (b, t, e)
    kind = _cache_kind(k, v, SPLIT_KINDS if split else FLOAT_KINDS, want)
    dev = x.device
    x2 = x.reshape(b, e).to(torch.float32).contiguous()
    c_in = state.reshape(b, e).to(torch.float32).contiguous()
    mask = mask_add.reshape(b, t).to(dev, torch.float32).contiguous()
    ptrs = _pointers(_layer_tensors(layer) + [k, v, None, None, mask], dev)
    scales = _floats(_layer_scales(layer))
    y = torch.empty((b, 1, e), dtype=torch.float32, device=dev)
    c_out = torch.empty((b, 1, e), dtype=torch.float32, device=dev)
    attn0 = torch.empty((b, t), dtype=torch.float32, device=dev)
    for tensor in (x2, c_in):
        if tensor.device != dev or tensor.data_ptr() % 16:
            raise ValueError("x and the state must be 16-byte aligned on one device")
    cs, rows = step_layout(b, e, f, num_heads, t, kind, dev.index, _cluster)
    lib = _build.library()
    code = lib.slimt_decoder_layer_step(
        ctypes.addressof(ptrs), ctypes.addressof(scales), b, t, e, f, num_heads,
        rows, cs, kind,
        x2.data_ptr(), c_in.data_ptr(), c_out.data_ptr(), attn0.data_ptr(),
        y.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, code, "slimt_decoder_layer_step")
    return y, c_out, attn0


def decoder_layer_step_bte_kernel(layer, state, x, mask_add, kv, num_heads, _cluster=None):
    """Launch the joined-cache layer step on CUDA tensors. `launches`
    counts its launches."""
    out = _layer_step_kernel(layer, state, x, mask_add, kv, num_heads, False, _cluster)
    launches.count(decoder_layer_step_bte_kernel)
    return out


decoder_layer_step_bte_kernel.launches = 0


def decoder_layer_step_kernel(layer, state, x, mask_add, kv, num_heads, _cluster=None):
    """Launch the split-cache layer step on CUDA tensors. `launches`
    counts its launches."""
    out = _layer_step_kernel(layer, state, x, mask_add, kv, num_heads, True, _cluster)
    launches.count(decoder_layer_step_kernel)
    return out


decoder_layer_step_kernel.launches = 0


def decoder_layer_step_bte(
    layer: dict,
    state: torch.Tensor,  # [B, 1, E]
    x: torch.Tensor,  # [B, 1, E]
    mask_add: torch.Tensor,  # [B, 1, 1, T]
    kv: Tuple[torch.Tensor, torch.Tensor],  # joined [B, T, E], float32/bf16/fp16
    num_heads: int,
):
    """One decoder layer over a joined float cache with the whole step's
    numerics (q and p rounded through the cache's type). Returns (y [B, 1,
    E], c' [B, 1, E], attn0 [B, T])."""
    args = (layer, state, x, mask_add, kv, num_heads)
    if x.is_cuda:
        return decoder_layer_step_bte_kernel(*args)
    if x.device.type == "cpu":
        return decoder_layer_step_bte_plain(*args)
    raise ValueError(f"unsupported device {x.device}")


def decoder_layer_step(
    layer: dict,
    state: torch.Tensor,  # [B, 1, E]
    x: torch.Tensor,  # [B, 1, E]
    mask_add: torch.Tensor,  # [B, 1, 1, T]
    kv: Tuple[torch.Tensor, torch.Tensor],  # split [B, H, T, D], float32/bf16/fp16
    num_heads: int,
):
    """One decoder layer over a split float cache, nothing rounded.
    Returns (y [B, 1, E], c' [B, 1, E], attn0 [B, T])."""
    args = (layer, state, x, mask_add, kv, num_heads)
    if x.is_cuda:
        return decoder_layer_step_kernel(*args)
    if x.device.type == "cpu":
        return decoder_layer_step_plain(*args)
    raise ValueError(f"unsupported device {x.device}")
