"""Whole encoder layer: the counterpart of
slimt_tpu/ops/encoder_layer_pallas.py (with the fused_blocks helpers
`_quant`, `_int8_mm` and `_layer_norm`).

One post-LN layer: Q/K/V affines, multi-head SDPA, O affine, residual
+ LN, FFN1 + relu, FFN2, residual + LN. On a CUDA tensor
`encoder_layer_fused` launches csrc/encoder_layer.cu (it replaces
encoder_layer_pallas._layer_kernel) or raises; on a CPU tensor it runs
the plain version below, built from the same formulas.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from slimt_tpu_torch.ops import _build, qmm

LN_EPS = 1e-6
MAX_T = 256  # the gate of the TPU kernel (transformer.py:500-509)
# Head dims of the attention kernel (csrc/slimt_device.cuh) that the SDPA
# of the layer kernel and the split encoder's kernels launch.
HEAD_DIMS = (8, 16, 32, 64)


def layer_norm(x, scale, bias) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * scale + bias, biased variance."""
    mean = x.mean(-1, keepdim=True)
    centered = x - mean
    var = (centered * centered).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + qmm._f32(LN_EPS))
    return centered * inv * scale + bias


def softmax(scores) -> torch.Tensor:
    """jax.nn.softmax's formula: exp(x - max) / sum."""
    unnormalized = torch.exp(scores - scores.amax(-1, keepdim=True))
    return unnormalized / unnormalized.sum(-1, keepdim=True)


def sdpa_heads(q, k, v, mask_add):
    """SDPA on split heads: [B,H,Tq,D] x [B,H,Tk,D], additive mask
    [B,1,1,Tk] -> (out [B,H,Tq,D], attn [B,H,Tq,Tk]), with the scale on
    the QK^T product and the mask added after it."""
    scale = qmm._f32(1.0 / math.sqrt(q.shape[-1]))
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    attn = softmax(scores + mask_add)
    return torch.matmul(attn, v), attn


def sdpa_plain(q, k, v, mask_add, num_heads) -> torch.Tensor:
    """Multi-head SDPA on joined [B, T, E] operands; mask [B,1,1,T]."""
    b, t, e = q.shape
    d = e // num_heads

    def split(a):
        return a.reshape(b, t, num_heads, d).transpose(1, 2)

    out = sdpa_heads(split(q), split(k), split(v), mask_add)[0]
    return out.transpose(1, 2).reshape(b, t, e)


def layer_plain(x, layer, mask_add, num_heads) -> torch.Tensor:
    """Plain PyTorch version of the layer kernel."""
    b, t, e = x.shape
    att, ffn = layer["att"], layer["ffn"]

    def affine(p, a, mode=qmm.AFFINE):
        return qmm.affine_plain(a, p["q"], p["b"], p["aq"], p["inv"], mode)

    x2 = x.reshape(b * t, e)
    q, k, v = (affine(att[n], x2).reshape(b, t, e) for n in ("q", "k", "v"))
    heads = sdpa_plain(q, k, v, mask_add, num_heads).reshape(b * t, e)
    x1 = layer_norm(
        x2 + affine(att["o"], heads), att["ln"]["scale"], att["ln"]["bias"]
    )
    h = affine(ffn["w1"], x1, qmm.AFFINE_RELU)
    y = affine(ffn["w2"], h)
    out = layer_norm(y + x1, ffn["ln"]["scale"], ffn["ln"]["bias"])
    return out.reshape(b, t, e)


def layer_kernel(x, layer, mask_add, num_heads) -> torch.Tensor:
    """Launch csrc/encoder_layer.cu on CUDA tensors. `launches` counts
    the layer launches."""
    b, t, e = x.shape
    att, ffn = layer["att"], layer["ffn"]
    f = ffn["w1"]["q"].shape[1]
    d = e // num_heads
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not x.is_cuda:
        raise ValueError(f"the kernel takes CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 tensor")
    mask = mask_add.reshape(b, t).to(x.device, torch.float32).contiguous()
    tensors = [
        att["q"]["q"], att["q"]["b"], att["k"]["q"], att["k"]["b"],
        att["v"]["q"], att["v"]["b"], att["o"]["q"], att["o"]["b"],
        att["ln"]["scale"], att["ln"]["bias"],
        ffn["w1"]["q"], ffn["w1"]["b"], ffn["w2"]["q"], ffn["w2"]["b"],
        ffn["ln"]["scale"], ffn["ln"]["bias"],
    ]
    for tensor in tensors:
        if tensor.device != x.device or not tensor.is_contiguous():
            raise ValueError("layer weights must be contiguous on x's device")
    scales = []
    for p in (att["q"], att["k"], att["v"], att["o"], ffn["w1"], ffn["w2"]):
        scales += [p["aq"], p["inv"]]
    weights = (ctypes.c_void_p * 16)(*[t_.data_ptr() for t_ in tensors])
    scale_arr = (ctypes.c_float * 12)(*[float(np.float32(s)) for s in scales])
    out = torch.empty_like(x)
    scratch = torch.empty(
        b * t * (6 * e + f), dtype=torch.float32, device=x.device
    )
    lib = _build.library()
    code = lib.slimt_encoder_layer(
        x.data_ptr(), mask.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        ctypes.cast(weights, ctypes.c_void_p),
        ctypes.cast(scale_arr, ctypes.c_void_p),
        b, t, e, f, num_heads,
        ctypes.c_float(np.float32(1.0 / math.sqrt(d))),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "slimt_encoder_layer")
    layer_kernel.launches += 1
    return out


layer_kernel.launches = 0


def encoder_layer_fused(x, layer, mask_add, num_heads) -> torch.Tensor:
    """x: [B, T, E] f32; layer: {"att", "ffn"} (loader layout, torch);
    mask_add: [B, 1, 1, T] additive. Returns the layer's output."""
    t, e = x.shape[-2], x.shape[-1]
    if t > MAX_T or e % num_heads:
        raise ValueError(
            f"encoder layer needs T <= {MAX_T} and E % heads == 0, "
            f"got T={t}, E={e}, heads={num_heads}"
        )
    if x.is_cuda:
        return layer_kernel(x.contiguous(), layer, mask_add, num_heads)
    if x.device.type == "cpu":
        return layer_plain(x, layer, mask_add, num_heads)
    raise ValueError(f"unsupported device {x.device}")
