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

Both take a query slice (`q_offset`, `q_count`): rows q_offset ..
q_offset + q_count - 1 of q against all T_k keys of k and v, the form
sequence parallelism gives a rank (T / seq query rows, the keys gathered
along T). Each row is the row the full call gives, bit for bit: the
kernel walks every row's key tiles in one order (its `_rows` entries), and
the plain version pads the query rows to T_k before its products, so that
torch.matmul takes the full call's path.
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


def _query_rows(q, dim: int, q_offset: int, q_count) -> tuple:
    """(offset, count) of a query slice along `dim` of q, checked."""
    rows = q.shape[dim]
    count = rows - q_offset if q_count is None else int(q_count)
    if q_offset < 0 or count < 1 or q_offset + count > rows:
        raise ValueError(f"query slice [{q_offset}, {q_offset} + {count}) outside "
                         f"the {rows} rows of q")
    return int(q_offset), count


def _pad_rows(q, dim: int, q_offset: int, count: int, keys: int):
    """q's rows q_offset .. q_offset + count - 1 along `dim`, followed by
    zero rows up to `keys` rows where they are fewer: the plain version's
    products then take the full call's shapes."""
    rows = q.narrow(dim, q_offset, count)
    if count >= keys:
        return rows
    shape = list(q.shape)
    shape[dim] = keys - count
    return torch.cat([rows, q.new_zeros(shape)], dim=dim)


def sdpa_rows_plain(q, k, v, mask_add, num_heads, q_offset=0, q_count=None):
    """Plain version of the fused SDPA's query slice: q [B, T_q, E], k, v
    [B, T_k, E]; returns [B, q_count, E], each row equal to that row of
    `encoder_layer.sdpa_plain` over the full query rows."""
    q_offset, count = _query_rows(q, 1, q_offset, q_count)
    b, _, e = q.shape
    t_k = k.shape[1]
    d = e // num_heads
    padded = _pad_rows(q, 1, q_offset, count, t_k)

    def split(a):
        return a.reshape(b, a.shape[1], num_heads, d).transpose(1, 2)

    out = sdpa_heads(split(padded), split(k), split(v), mask_add)[0]
    return out.transpose(1, 2).reshape(b, padded.shape[1], e)[:, :count]


def blockwise_rows_plain(q, k, v, mask_add, q_offset=0, q_count=None):
    """Plain version of the blockwise kernel's query slice: q [B, H, T_q,
    D], k, v [B, H, T_k, D]; returns [B, H, q_count, D]."""
    q_offset, count = _query_rows(q, 2, q_offset, q_count)
    padded = _pad_rows(q, 2, q_offset, count, k.shape[2])
    return sdpa_heads(padded, k, v, mask_add)[0][:, :, :count]


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


def fused_sdpa_rows_kernel(q, k, v, mask_add, num_heads, q_offset=0, q_count=None):
    """Launch csrc/attention.cu's fused SDPA on a query slice of CUDA
    operands (q [B, T_q, E], k, v [B, T_k, E]); returns [B, q_count, E].
    `launches` counts the launches."""
    q_offset, count = _query_rows(q, 1, q_offset, q_count)
    b, q_rows, e = q.shape
    t = k.shape[1]
    if k.shape != (b, t, e) or v.shape != k.shape or e % num_heads:
        raise ValueError(f"q [B, T_q, E], k and v [B, T_k, E] with E % heads == 0, got "
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
    code = lib.slimt_fused_sdpa_rows(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, q_rows, q_offset, count, t, e, num_heads, _scale(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, code, "slimt_fused_sdpa_rows")
    launches.count(fused_sdpa_rows_kernel)
    return out[:, q_offset:q_offset + count]


fused_sdpa_rows_kernel.launches = 0


def blockwise_rows_kernel(q, k, v, mask_add, q_offset=0, q_count=None):
    """Launch csrc/attention.cu's blockwise attention on a query slice of
    CUDA operands (q [B, H, T_q, D], k, v [B, H, T_k, D]); returns [B, H,
    q_count, D]. `launches` counts the launches."""
    q_offset, count = _query_rows(q, 2, q_offset, q_count)
    b, h, q_rows, d = q.shape
    t = k.shape[2]
    if k.shape != (b, h, t, d) or v.shape != k.shape:
        raise ValueError(f"q [B, H, T_q, D], k and v [B, H, T_k, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    mask = mask_add.reshape(b, t).to(q.device, torch.float32).contiguous()
    _check((q, k, v))
    out = torch.empty_like(q)
    lib = _build.library()
    code = lib.slimt_blockwise_attention_rows(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b * h, h, q_rows, q_offset, count, t, d, _scale(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, code, "slimt_blockwise_attention_rows")
    launches.count(blockwise_rows_kernel)
    return out[:, :, q_offset:q_offset + count]


blockwise_rows_kernel.launches = 0


def _whole(q, k, q_offset, q_count, dim) -> bool:
    """Whether a call takes every query row of a q shaped as k."""
    return q.shape == k.shape and q_offset == 0 and q_count in (None, q.shape[dim])


def fused_sdpa_joined(q, k, v, mask_add, num_heads, q_offset=0, q_count=None) -> torch.Tensor:
    """Multi-head SDPA on joined [B, T, E] operands (no split into heads);
    mask_add [B, 1, 1, T_k]. Returns [B, T, E] f32, or with a query slice
    (q [B, T_q, E], rows q_offset .. + q_count) [B, q_count, E]."""
    whole = _whole(q, k, q_offset, q_count, 1)
    if q.is_cuda:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if whole:
            return fused_sdpa_kernel(q, k, v, mask_add, num_heads)
        return fused_sdpa_rows_kernel(q, k, v, mask_add, num_heads, q_offset, q_count)
    if q.device.type == "cpu":
        if whole:
            return sdpa_plain(q, k, v, mask_add, num_heads)
        return sdpa_rows_plain(q, k, v, mask_add, num_heads, q_offset, q_count)
    raise ValueError(f"unsupported device {q.device}")


def blockwise_attention(q, k, v, mask_add, q_offset=0, q_count=None) -> torch.Tensor:
    """SDPA on [B, H, T, D] with the full softmax over T, at any T;
    mask_add [B, 1, 1, T_k]. Returns [B, H, T, D] f32, or with a query
    slice (q [B, H, T_q, D]) [B, H, q_count, D]."""
    whole = _whole(q, k, q_offset, q_count, 2)
    if q.is_cuda:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if whole:
            return blockwise_kernel(q, k, v, mask_add)
        return blockwise_rows_kernel(q, k, v, mask_add, q_offset, q_count)
    if q.device.type == "cpu":
        if whole:
            return blockwise_plain(q, k, v, mask_add)
        return blockwise_rows_plain(q, k, v, mask_add, q_offset, q_count)
    raise ValueError(f"unsupported device {q.device}")
