"""The split encoder's attention: the counterpart of
slimt_tpu/ops/attention.py (`fused_sdpa_joined`, `blockwise_attention`).

    fused_sdpa_joined:   q, k, v [B, T, E], per head h of D = E / heads
                         out[:, :, h] = softmax((q_h k_h^T) * scale + mask) v_h
    blockwise_attention: q, k, v [B, H, T, D]
                         out[b, h] = softmax((q k^T) * scale + mask[b]) v

with scale = 1 / sqrt(D) and the additive mask [B, 1, 1, T] of row b
serving all its heads. On a CUDA tensor each launches its kernel in
csrc/attention.cu or raises; on a CPU tensor it runs the plain version:
both are the per-head SDPA of ops/encoder_layer (`sdpa_plain` on joined
operands, `sdpa_heads` on split ones), with `encoder_layer.softmax`.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from slimt_tpu_torch.ops import _build, launches
from slimt_tpu_torch.ops.encoder_layer import (
    HEAD_DIMS,
    MAX_T,
    sdpa_heads,
    sdpa_plain,
)


def blockwise_plain(q, k, v, mask_add) -> torch.Tensor:
    """Plain PyTorch version of the blockwise kernel: the full-softmax
    SDPA on [B, H, T, D], without the weights. That of the fused SDPA is
    `encoder_layer.sdpa_plain`."""
    return sdpa_heads(q, k, v, mask_add)[0]


def _scale(d: int) -> ctypes.c_float:
    return ctypes.c_float(np.float32(1.0 / math.sqrt(d)))


def _check(tensors) -> None:
    first = tensors[0]
    if not first.is_cuda:
        raise ValueError(f"the kernel takes CUDA tensors, got {first.device}")
    for t in tensors:
        if t.device != first.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("operands must be contiguous float32 tensors on one device")
        if t.data_ptr() % 16:
            raise ValueError("operands must be 16-byte aligned")


def fused_sdpa_kernel(q, k, v, mask_add, num_heads) -> torch.Tensor:
    """Launch csrc/attention.cu's fused SDPA on CUDA [B, T, E] operands.
    `launches` counts the launches."""
    b, t, e = q.shape
    if k.shape != q.shape or v.shape != q.shape or e % num_heads:
        raise ValueError(f"q, k, v must be [B, T, E] with E % heads == 0, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    d = e // num_heads
    if t > MAX_T:
        raise ValueError(f"T={t} > {MAX_T}: the fused SDPA serves the wrap regime")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    mask = mask_add.reshape(b, t).to(q.device, torch.float32).contiguous()
    _check((q, k, v))
    out = torch.empty_like(q)
    lib = _build.library()
    code = lib.slimt_fused_sdpa(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, t, e, num_heads, _scale(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, code, "slimt_fused_sdpa")
    launches.count(fused_sdpa_kernel)
    return out


fused_sdpa_kernel.launches = 0


def blockwise_kernel(q, k, v, mask_add) -> torch.Tensor:
    """Launch csrc/attention.cu's blockwise attention on CUDA [B, H, T, D]
    operands. `launches` counts the launches."""
    b, h, t, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one [B, H, T, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    mask = mask_add.reshape(b, t).to(q.device, torch.float32).contiguous()
    _check((q, k, v))
    out = torch.empty_like(q)
    lib = _build.library()
    code = lib.slimt_blockwise_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b * h, h, t, d, _scale(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, code, "slimt_blockwise_attention")
    launches.count(blockwise_kernel)
    return out


blockwise_kernel.launches = 0


def fused_sdpa_joined(q, k, v, mask_add, num_heads) -> torch.Tensor:
    """Multi-head SDPA on joined [B, T, E] operands (no split into heads);
    mask_add [B, 1, 1, T]. Returns [B, T, E] f32."""
    if q.is_cuda:
        return fused_sdpa_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                                 mask_add, num_heads)
    if q.device.type == "cpu":
        return sdpa_plain(q, k, v, mask_add, num_heads)
    raise ValueError(f"unsupported device {q.device}")


def blockwise_attention(q, k, v, mask_add) -> torch.Tensor:
    """SDPA on [B, H, T, D] with the full softmax over T, at any T;
    mask_add [B, 1, 1, T]. Returns [B, H, T, D] f32."""
    if q.is_cuda:
        return blockwise_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                                mask_add)
    if q.device.type == "cpu":
        return blockwise_plain(q, k, v, mask_add)
    raise ValueError(f"unsupported device {q.device}")
