"""Whole decode step: the counterpart of
slimt_tpu/ops/decoder_step_pallas.py:whole_decode_step (bodies
`_whole_kernel` and `_layer_math_bte`), the step of the `fused_step`
latency provider.

One call runs every decoder layer (SSRU, cross-attention over the
joined int16 per-row cache, FFN), the tied int8 projection over the
full vocabulary or a shortlist, and the exact first-max argmax:

    f  = sigmoid(q8(x) Wf inv + bf);  c' = f c + (1 - f) q8(x) W inv
    h  = LN(x + relu(c'))
    q  = q8(h) Wq inv + bq
    p  = softmax_T(((K . q)_head / sqrt(D)) * kqi + mask)   per head
    a  = LN(h + q8(sum_T (p * vqi) V) Wo inv + bo)
    y  = LN(a + q8(relu(q8(a) W1 inv + b1)) W2 inv + b2)
    choice = first argmax of q8(y) W_out inv_out + b_out

On a CUDA tensor `whole_decode_step` launches csrc/decoder_step.cu or
raises; on a CPU tensor it runs `whole_step_plain`. The plain version
calls `qmm.affine_plain` directly, so that on the card it shares no
kernel with what it is compared against.

Only the int16 per-row cache is taken; the float joined caches of the
JAX kernel are ROADMAP Queue 1, item 12.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from slimt_tpu_torch.ops import _build, decode_attn, fused_blocks, qmm
from slimt_tpu_torch.ops.encoder_layer import layer_norm
from slimt_tpu_torch.ops.fused_blocks import EMB_DIMS, FFN_DIMS
# The projection stage alone: the exact mode of the argmax kernel.
from slimt_tpu_torch.ops.logits_argmax import (  # noqa: F401
    TILE_S,
    argmax_affine_kernel,
    argmax_affine_plain,
)

MAX_LAYERS = 8


def _affine(p: dict, x: torch.Tensor) -> torch.Tensor:
    return qmm.affine_plain(x, p["q"], p["b"], p["aq"], p["inv"])


def _layer_plain(layer, x, c, kv, mask, num_heads):
    """One decoder layer on [B, E] rows in `_layer_math_bte`'s order:
    the plain SSRU block, decode attention and FFN block. Returns (y,
    c', attn head 0 [B, T])."""
    h, c_t = fused_blocks.ssru_plain(x, c, layer["rnn"])
    att = layer["att"]
    attn_out, p = decode_attn.attention_plain(
        _affine(att["q"], h), kv["k"], kv["v"], kv["kqi"], kv["vqi"], mask,
        num_heads)
    a = layer_norm(h + _affine(att["o"], attn_out), att["ln"]["scale"], att["ln"]["bias"])
    return fused_blocks.ffn_plain(a, layer["ffn"]), c_t, p[:, :, 0]


def layers_plain(layers, states, x, mask_add, kv_caches, num_heads):
    """Every decoder layer of the plain step. Returns (y [B, E] — the
    projection's input —, new_states per layer [B, 1, E], attn0)."""
    h = x[:, 0, :].to(torch.float32)
    mask = mask_add[:, 0, 0, :].to(torch.float32)
    new_states = []
    attn0 = None
    for layer, state, kv in zip(layers, states, kv_caches):
        h, c_t, attn0 = _layer_plain(layer, h, state[:, 0, :], kv, mask, num_heads)
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


def check_shapes(e: int, f: int, t: int, num_heads: int, layers: int) -> None:
    """Raise ValueError on a shape the kernel does not take. T is bounded
    only by the shared memory of one row, which the C entry knows
    (`step_rows`; at tiny widths T <= 6896)."""
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


def step_rows(b: int, e: int, f: int, heads: int, t: int) -> int:
    """Rows a block of the layers kernel takes on the current device:
    those of the blocks (fused_blocks.rows_per_block), or 1 where their
    scores over T do not fit in shared memory (at tiny widths, 4 rows fit
    up to T=1448). The C entry decides; ValueError where one row does not
    fit."""
    rows = _build.library().slimt_whole_step_rows(
        fused_blocks.rows_per_block(b), e, f, heads, t)
    if rows == 0:
        raise ValueError(f"whole decode step: T={t}: the scores of one row do "
                         "not fit in shared memory")
    return rows


class StepPlan:
    """The kernel's loop-invariant arguments, built once per batch: the
    per-layer weight, LN, K/V and kqi/vqi pointers, the mask and the
    projection, the 12 * L + 2 scales, and the scratch. A step then
    passes only x, the states and its outputs."""

    def __init__(self, layers, kv_caches, mask_add, num_heads, projection,
                 out_aq, out_inv):
        k0 = kv_caches[0]["k"]
        b, t, e = k0.shape
        f = layers[0]["ffn"]["w1"]["q"].shape[1]
        check_shapes(e, f, t, num_heads, len(layers))
        if not k0.is_cuda:
            raise ValueError(f"the kernel takes CUDA tensors, got {k0.device}")
        dev = k0.device
        w, bias = projection
        _check_projection(w, bias, e, dev)
        mask = mask_add.reshape(b, t).to(dev, torch.float32).contiguous()
        tensors, scales = [], []
        for layer, kv in zip(layers, kv_caches):
            rnn, att, ffn = layer["rnn"], layer["att"], layer["ffn"]
            tensors += [
                rnn["wf"]["q"], rnn["wf"]["b"], rnn["w"]["q"],
                rnn["ln"]["scale"], rnn["ln"]["bias"],
                att["q"]["q"], att["q"]["b"], att["o"]["q"], att["o"]["b"],
                att["ln"]["scale"], att["ln"]["bias"],
                ffn["w1"]["q"], ffn["w1"]["b"], ffn["w2"]["q"], ffn["w2"]["b"],
                ffn["ln"]["scale"], ffn["ln"]["bias"],
                kv["k"], kv["v"], kv["kqi"], kv["vqi"],
            ]
            for p in (rnn["wf"], rnn["w"], att["q"], att["o"], ffn["w1"], ffn["w2"]):
                scales += [p["aq"], p["inv"]]
            for name, want in (("k", (b, t, e)), ("v", (b, t, e)),
                               ("kqi", (b, t)), ("vqi", (b, t))):
                if tuple(kv[name].shape) != want:
                    raise ValueError(f"{name} must be {want}, got {tuple(kv[name].shape)}")
            if kv["k"].dtype != torch.int16 or kv["v"].dtype != torch.int16:
                raise ValueError(
                    "the kernel reads the int16 per-row cache; float caches "
                    "are ROADMAP Queue 1, item 12"
                )
        for tensor in tensors + [mask]:
            if tensor.device != dev or not tensor.is_contiguous():
                raise ValueError("step tensors must be contiguous on one CUDA device")
            if tensor.data_ptr() % 16:
                raise ValueError("step tensors must be 16-byte aligned")
        tensors += [w, bias, mask]
        scales += [out_aq, out_inv]
        self._keep = tensors
        self._ptrs = (ctypes.c_void_p * len(tensors))(*[x.data_ptr() for x in tensors])
        self._scales = (ctypes.c_float * len(scales))(
            *[float(np.float32(s)) for s in scales]
        )
        self.device = dev
        self.shape = (len(layers), b, t, e)
        self.rows = step_rows(b, e, f, num_heads, t)
        tiles = -(-w.shape[1] // TILE_S)
        self.scratch = torch.empty(b * e + 2 * b * tiles, dtype=torch.float32, device=dev)
        self.args = (
            ctypes.addressof(self._ptrs), ctypes.addressof(self._scales),
            len(layers), b, t, e, f, num_heads, w.shape[1],
            w.stride(0), w.stride(1), self.rows,
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
    out_aq, out_inv, plan: Optional[StepPlan] = None,
):
    """Launch csrc/decoder_step.cu on CUDA tensors. `launches` counts
    the whole-step launches."""
    if plan is None:
        plan = StepPlan(layers, kv_caches, mask_add, num_heads, projection,
                        out_aq, out_inv)
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
    whole_step_kernel.launches += 1
    return choice, tuple(c_out.unbind(0)), attn0


whole_step_kernel.launches = 0


def whole_decode_step(
    layers: Sequence[dict],
    states: Sequence[torch.Tensor],  # per layer [B, 1, E]
    x: torch.Tensor,  # [B, 1, E] transformed previous embedding
    mask_add: torch.Tensor,  # [B, 1, 1, T]
    kv_caches: Sequence[dict],  # per layer {"k", "v", "kqi", "vqi"}, int16
    num_heads: int,
    projection: Tuple[torch.Tensor, torch.Tensor],  # (W [E, S] int8, b [S])
    out_aq,
    out_inv,
    plan: Optional[StepPlan] = None,
):
    """One decode step over every decoder layer + the (shortlisted)
    projection + the first-max argmax. Returns (choice [B] int32 — a
    column of the projection —, new_states, attn0 [B, T], head 0 of the
    last layer)."""
    args = (layers, states, x, mask_add, kv_caches, num_heads, projection,
            out_aq, out_inv)
    if x.is_cuda:
        return whole_step_kernel(*args, plan=plan)
    if x.device.type == "cpu":
        return whole_step_plain(*args)
    raise ValueError(f"unsupported device {x.device}")
