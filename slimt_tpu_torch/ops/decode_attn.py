"""Decode-step cross-attention over the joined int16 cache: the
counterpart of slimt_tpu/ops/decode_attn_pallas.py
(`decode_attention_int16`).

    s   = ((K . q)_head * (1 / sqrt(D))) * kqi + mask       per head
    p   = softmax_T(s)
    out = sum_T (p * vqi) V                                  -> [B, E]

On a CUDA tensor `decode_attention_int16` launches csrc/decode_attn.cu
or raises; on a CPU tensor it runs `attention_plain`, the elementwise
formulation (the TPU kernel's kq = K * q, reduced per head), which also
serves the whole decode step's plain version over the int16 and the
float joined caches. Attention weights are not
returned: the kernel serves the alignment-free path only.

`decode_self_attention_int16` is the same attention over the first
`valid` positions of a self-attention decoder's int16 cache [B, C, E]
(C the decode loop's step capacity), with no mask: `valid` is a device
int32 that the CUDA kernel reads at each launch, so a captured graph
replays it at every step; on the CPU, `self_attention_plain`.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from slimt_tpu_torch.ops import _build, launches, qmm
from slimt_tpu_torch.ops.encoder_layer import softmax


def attention_plain(q, k, v, kqi, vqi, mask, num_heads):
    """q [B, E]; k, v [B, T, E]: the int16 cache with its per-row scales
    kqi, vqi [B, T], or a float32, bfloat16 or float16 cache (kqi, vqi
    unused), through whose type q and p are rounded first, as in the TPU
    whole step's float branch; mask [B, T]. Returns (out [B, E], p [B, T,
    H])."""
    b, e = q.shape
    t = k.shape[1]
    d = e // num_heads
    scaled = not k.dtype.is_floating_point
    if not scaled:
        q = q.to(k.dtype).to(torch.float32)
    prod = k.to(torch.float32) * q[:, None, :]  # [B, T, E]
    scores = prod.reshape(b, t, num_heads, d).sum(-1) * qmm._f32(1.0 / math.sqrt(d))
    if scaled:
        scores = scores * kqi[:, :, None]
    scores = scores + mask[:, :, None]
    p = softmax(scores.transpose(1, 2)).transpose(1, 2)  # over T
    weight = p * vqi[:, :, None] if scaled else p.to(k.dtype).to(torch.float32)
    return (v.to(torch.float32) * weight.repeat_interleave(d, dim=2)).sum(1), p


def check_shapes(b: int, t: int, e: int, num_heads: int) -> None:
    """Raise ValueError on a shape the kernel does not take."""
    d = e // num_heads if num_heads > 0 else 0
    lanes = d // 8
    if b < 1 or t < 1:
        raise ValueError(f"decode attention: empty batch B={b}, T={t}")
    if e < 128 or e % 128:
        raise ValueError(f"decode attention: E={e} must be a multiple of 128")
    if num_heads < 1 or e % num_heads or d % 8 or lanes > 32 or lanes & (lanes - 1):
        raise ValueError(
            f"decode attention: head dim {d} must be 8 * 2^i, at most 256")


# The kernels of csrc/decode_attn.cu a caller may force (`_kernel`): the
# C entry's codes; None lets the entry choose.
KERNELS = {None: 0, "block": 1, "warp": 2}


def decode_attention_kernel(q, k, v, kqi, vqi, mask, num_heads, _kernel=None) -> torch.Tensor:
    """Launch csrc/decode_attn.cu on CUDA tensors. `launches` counts the
    launches; `_kernel` ("block" or "warp") forces one of its two kernels
    (the card's timings compare them)."""
    b, t, e = k.shape
    check_shapes(b, t, e, num_heads)
    if _kernel not in KERNELS:
        raise ValueError(f"decode attention: no kernel {_kernel!r}; "
                         f"choose from {sorted(k_ for k_ in KERNELS if k_)}")
    if not q.is_cuda:
        raise ValueError(f"the kernel takes CUDA tensors, got {q.device}")
    for name, tensor, shape, dtype in (
        ("q", q, (b, e), torch.float32), ("k", k, (b, t, e), torch.int16),
        ("v", v, (b, t, e), torch.int16), ("kqi", kqi, (b, t), torch.float32),
        ("vqi", vqi, (b, t), torch.float32), ("mask", mask, (b, t), torch.float32),
    ):
        if tuple(tensor.shape) != shape or tensor.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{tensor.dtype} {tuple(tensor.shape)}")
        if tensor.device != q.device or not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
        if tensor.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((b, e), dtype=torch.float32, device=q.device)
    lib = _build.library()
    code = lib.slimt_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kqi.data_ptr(), vqi.data_ptr(),
        mask.data_ptr(), out.data_ptr(), b, t, e, num_heads,
        ctypes.c_float(np.float32(1.0 / math.sqrt(e // num_heads))), KERNELS[_kernel],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, code, "slimt_decode_attention")
    launches.count(decode_attention_kernel)
    return out


decode_attention_kernel.launches = 0


# The C entry's choice (csrc/decode_attn.cu): the warp kernel from
# WARP_KERNEL_ITEMS (row, head) items at T <= WARP_KERNEL_T, else the block
# kernel. The two sum in different orders.
WARP_KERNEL_ITEMS = 1600
WARP_KERNEL_T = 128


def kernel_for(b: int, num_heads: int, t: int) -> str:
    """The kernel the C entry picks for B rows of `num_heads` heads over T
    positions. A mesh's shard forces the whole batch's choice, so that its
    rows sum as they would on one device."""
    return "warp" if b * num_heads >= WARP_KERNEL_ITEMS and t <= WARP_KERNEL_T else "block"


def decode_attention_int16(q, k, v, kqi, vqi, mask, num_heads, _kernel=None) -> torch.Tensor:
    """q [B, E] f32 (the Q projection of this step); k, v [B, T, E]
    int16 joined cache; kqi, vqi [B, T] per-row dequant scales; mask
    [B, T] additive. Returns out [B, E], before the O projection.
    `_kernel` forces the kernel on CUDA (a mesh's shards)."""
    if q.is_cuda:
        return decode_attention_kernel(
            q.contiguous(), k, v, kqi, vqi, mask.contiguous(), num_heads, _kernel)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kqi, vqi, mask, num_heads)[0]
    raise ValueError(f"unsupported device {q.device}")


def self_attention_plain(q, k, v, kqi, vqi, valid, num_heads) -> torch.Tensor:
    """decode_self_attention_int16 on the CPU: attention_plain over the
    first `valid` positions of the cache, unmasked."""
    n = int(valid.reshape(-1)[0])
    mask = torch.zeros((k.shape[0], n), dtype=torch.float32, device=q.device)
    return attention_plain(q, k[:, :n], v[:, :n], kqi[:, :n], vqi[:, :n], mask, num_heads)[0]


def decode_self_attention_kernel(q, k, v, kqi, vqi, valid, num_heads) -> torch.Tensor:
    """Launch csrc/decode_attn.cu's valid-length kernels on CUDA tensors;
    `launches` counts the launches."""
    b, cap, e = k.shape
    check_shapes(b, cap, e, num_heads)
    if not q.is_cuda:
        raise ValueError(f"the kernel takes CUDA tensors, got {q.device}")
    for name, tensor, shape, dtype in (
        ("q", q, (b, e), torch.float32), ("k", k, (b, cap, e), torch.int16),
        ("v", v, (b, cap, e), torch.int16), ("kqi", kqi, (b, cap), torch.float32),
        ("vqi", vqi, (b, cap), torch.float32), ("valid", valid, (1,), torch.int32),
    ):
        if tuple(tensor.shape) != shape or tensor.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{tensor.dtype} {tuple(tensor.shape)}")
        if tensor.device != q.device or not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
        if tensor.data_ptr() % (4 if name == "valid" else 16):
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((b, e), dtype=torch.float32, device=q.device)
    lib = _build.library()
    code = lib.slimt_decode_self_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kqi.data_ptr(), vqi.data_ptr(),
        valid.data_ptr(), out.data_ptr(), b, cap, e, num_heads,
        ctypes.c_float(np.float32(1.0 / math.sqrt(e // num_heads))),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, code, "slimt_decode_self_attention")
    launches.count(decode_self_attention_kernel)
    return out


decode_self_attention_kernel.launches = 0


def decode_self_attention_int16(q, k, v, kqi, vqi, valid, num_heads) -> torch.Tensor:
    """q [B, E] f32 (the step's self-attention query); k, v [B, C, E]
    int16 self-attention cache with kqi, vqi [B, C] per-row dequant
    scales; valid [1] int32, the positions 0..valid-1 to attend to (the
    step + 1). Returns out [B, E], before the O projection."""
    if q.is_cuda:
        return decode_self_attention_kernel(q.contiguous(), k, v, kqi, vqi, valid, num_heads)
    if q.device.type == "cpu":
        return self_attention_plain(q, k, v, kqi, vqi, valid, num_heads)
    raise ValueError(f"unsupported device {q.device}")
