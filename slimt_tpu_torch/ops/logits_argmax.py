"""The int8 tied projection with its greedy argmax: the counterpart of
slimt_tpu/ops/logits_argmax.py (`argmax_affine`).

    logits = q8(y) W inv + b                       over the S columns
    exact:        the first index of the maximum
    packed_fp16 / packed_bf16: one int32 max over packed keys of the
                  16-bit-rounded logits (`packed_argmax_16`), S <= 65536

On a CUDA tensor `argmax_affine` launches csrc/logits_argmax.cu or
raises; on a CPU tensor it runs `argmax_affine_plain`. The kernel's
index is the plain version's by construction: the same epilogue
rounding, and one max over 64-bit keys whose order is the method's
(`exact_key` models the exact one; the packed keys are
`packed_argmax_16`'s), so the vocab tiles combine in any order.

`argmax_keys` is the key variant a vocab shard runs under tensor
parallelism: W holds the global columns col0 .. col0 + S - 1, and it
returns the global column with the winning key as int64 (the kernel's
unsigned key less 2^63, `method_key`), so the shards' choices meet by one
max over their keys (transformer.output_argmax_tp).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from slimt_tpu_torch.ops import _build, launches, qmm

# Methods of the kernel, in csrc/slimt_kernels.cuh's ArgmaxMode order.
METHODS = ("exact", "packed_fp16", "packed_bf16")
PACKED_DTYPES = {"packed_fp16": torch.float16, "packed_bf16": torch.bfloat16}
MAX_PACKED_WIDTH = 65536  # the reversed column needs 16 bits
# E the kernel takes (csrc/logits_argmax.cu's kMaxEmb: 16 rows of y in
# shared memory); like the TPU kernel, which takes the whole of K as one
# block, it has no other gate on E.
MAX_EMB = 2048


def first_max(logits: torch.Tensor) -> torch.Tensor:
    """jnp.argmax over the last axis: the first index of the maximum."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def packed_argmax_16(logits: torch.Tensor, dtype) -> torch.Tensor:
    """argmax(logits.astype(dtype)) with the first index on ties, for a
    16-bit IEEE-ordered float dtype (float16 or bfloat16), as one int32
    max over packed keys: the sortable transform of the rounded bits
    above, the reversed column below. Needs width <= 65536."""
    bits = logits.to(dtype).view(torch.int16).to(torch.int32) & 0xFFFF
    sortable = torch.where(bits >= 0x8000, 0xFFFF - bits, bits | 0x8000)
    col = torch.arange(logits.shape[-1], dtype=torch.int32, device=logits.device)
    # (sortable - 0x8000) * 2^16 spans [-2^31, 2^31 - 2^16]: no overflow.
    key = (sortable - 0x8000) * 65536 | (0xFFFF - col)
    best = key.amax(-1)
    return (0xFFFF - (best & 0xFFFF)).to(torch.int32)


def exact_key(logits: torch.Tensor) -> torch.Tensor:
    """The kernel's key of each float32 logit for the exact method, as
    int64 (the kernel's unsigned 64-bit key less 2^63, the same order):
    the order-preserving bits of the logit (-0.0 as +0.0) above, the
    reversed column below, so the largest key is the first maximum."""
    bits = torch.where(logits == 0, 0.0, logits).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sortable = torch.where(bits >= 0x80000000, 0xFFFFFFFF - bits, bits | 0x80000000)
    col = torch.arange(logits.shape[-1], dtype=torch.int64, device=logits.device)
    return (sortable - 0x80000000) * 2**32 + (0xFFFFFFFF - col)


def method_key(logits: torch.Tensor, method: str, col0: int = 0) -> torch.Tensor:
    """The kernel's int64 key of each logit of columns col0 .. col0 + S - 1
    for `method`: exact_key's for "exact"; for the packed methods the
    16-bit-rounded sortable bits above the reversed 16-bit column (the
    packed int32 key of packed_argmax_16 as an unsigned 32-bit value),
    less 2^63. The largest key names the method's choice."""
    if method == "exact":
        key = exact_key(logits)
        return key - col0 if col0 else key
    bits = logits.to(PACKED_DTYPES[method]).view(torch.int16).to(torch.int64) & 0xFFFF
    sortable = torch.where(bits >= 0x8000, 0xFFFF - bits, bits | 0x8000)
    col = col0 + torch.arange(logits.shape[-1], dtype=torch.int64, device=logits.device)
    return (sortable << 16 | (0xFFFF - col)) - 2**63


def key_column(key: torch.Tensor, method: str) -> torch.Tensor:
    """The global column a key of method_key names, int32."""
    if method == "exact":
        return (0xFFFFFFFF - (key & 0xFFFFFFFF)).to(torch.int32)
    return (0xFFFF - (key & 0xFFFF)).to(torch.int32)


def argmax_scratch(b: int, s: int) -> int:
    """Floats of device scratch the kernel takes for B rows over S columns
    (its C entry `slimt_argmax_scratch`; the whole step's projection stage
    asks the same)."""
    return _build.library().slimt_argmax_scratch(b, s)


def argmax_affine_plain(y, w, b, aq, inv, method: str = "exact") -> torch.Tensor:
    """Plain PyTorch version: argmax of q8(y) W inv + b by `method`,
    [B] int32."""
    logits = qmm.affine_plain(y, w, b, aq, inv)
    if method == "exact":
        return first_max(logits)
    return packed_argmax_16(logits, PACKED_DTYPES[method])


def argmax_keys_plain(y, w, b, aq, inv, method: str = "exact", col0: int = 0):
    """Plain version of the key variant: (the global column [B] int32, its
    key [B] int64) of q8(y) W inv + b over columns col0 .. col0 + S - 1."""
    key = method_key(qmm.affine_plain(y, w, b, aq, inv), method, col0).amax(-1)
    return key_column(key, method), key


def _check(y, w, b, method: str) -> None:
    rows, e = y.shape
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    if not 0 < e <= MAX_EMB:
        raise ValueError(f"E={e} outside the kernel's range 1..{MAX_EMB}")
    if not y.is_cuda or y.dtype != torch.float32 or not y.is_contiguous():
        raise ValueError("y must be a contiguous float32 CUDA tensor")
    if w.dtype != torch.int8 or w.dim() != 2 or w.shape[0] != e:
        raise ValueError(f"projection W must be int8 [{e}, S], got {w.dtype} {tuple(w.shape)}")
    if b.dtype != torch.float32 or not b.is_contiguous() or b.shape != (w.shape[1],):
        raise ValueError("projection bias must be a contiguous float32 [S] tensor")
    if w.device != y.device or b.device != y.device:
        raise ValueError("projection must be on y's CUDA device")
    if method != "exact" and w.shape[1] > MAX_PACKED_WIDTH:
        raise ValueError(f"{method} needs S <= {MAX_PACKED_WIDTH}, got {w.shape[1]}")


def argmax_affine_kernel(y, w, b, aq, inv, method: str = "exact") -> torch.Tensor:
    """Launch csrc/logits_argmax.cu on CUDA tensors: [B] int32. W may be
    any strided [E, S] int8 view. `launches` counts the launches."""
    _check(y, w, b, method)
    rows, e = y.shape
    choice = torch.empty((rows,), dtype=torch.int32, device=y.device)
    scratch = torch.empty(argmax_scratch(rows, w.shape[1]), dtype=torch.float32,
                          device=y.device)
    lib = _build.library()
    code = lib.slimt_argmax_affine(
        y.data_ptr(), w.data_ptr(), b.data_ptr(), choice.data_ptr(),
        scratch.data_ptr(), rows, e, w.shape[1], w.stride(0), w.stride(1),
        ctypes.c_float(np.float32(aq)), ctypes.c_float(np.float32(inv)),
        METHODS.index(method), torch.cuda.current_stream(y.device).cuda_stream,
    )
    _build.check(lib, code, "slimt_argmax_affine")
    launches.count(argmax_affine_kernel)
    return choice


argmax_affine_kernel.launches = 0


def argmax_keys_kernel(y, w, b, aq, inv, method: str = "exact", col0: int = 0):
    """Launch csrc/logits_argmax.cu's key variant on CUDA tensors: (global
    column [B] int32, key [B] int64). `launches` counts the launches."""
    _check(y, w, b, method)
    if col0 < 0 or (method != "exact" and col0 + w.shape[1] > MAX_PACKED_WIDTH):
        raise ValueError(f"{method} needs 0 <= col0 and col0 + S <= {MAX_PACKED_WIDTH}, "
                         f"got col0={col0}, S={w.shape[1]}")
    rows, e = y.shape
    choice = torch.empty((rows,), dtype=torch.int32, device=y.device)
    keys = torch.empty((rows,), dtype=torch.int64, device=y.device)
    scratch = torch.empty(argmax_scratch(rows, w.shape[1]), dtype=torch.float32,
                          device=y.device)
    lib = _build.library()
    code = lib.slimt_argmax_keys(
        y.data_ptr(), w.data_ptr(), b.data_ptr(), choice.data_ptr(), keys.data_ptr(),
        scratch.data_ptr(), rows, e, w.shape[1], w.stride(0), w.stride(1), int(col0),
        ctypes.c_float(np.float32(aq)), ctypes.c_float(np.float32(inv)),
        METHODS.index(method), torch.cuda.current_stream(y.device).cuda_stream,
    )
    _build.check(lib, code, "slimt_argmax_keys")
    launches.count(argmax_keys_kernel)
    return choice, keys


argmax_keys_kernel.launches = 0


def argmax_keys(x, w, b, aq, inv, method: str = "exact", col0: int = 0):
    """The key variant: x [B, E] f32, w [E, S] int8 holding the global
    columns col0 .. col0 + S - 1, b [S]. Returns (global column [B] int32,
    key [B] int64)."""
    if x.is_cuda:
        return argmax_keys_kernel(x.contiguous(), w, b, aq, inv, method, col0)
    if x.device.type == "cpu":
        return argmax_keys_plain(x, w, b, aq, inv, method, col0)
    raise ValueError(f"unsupported device {x.device}")


def argmax_affine(x, w, b, aq, inv, method: str = "exact") -> torch.Tensor:
    """x [B, E] f32; w [E, S] int8 (any strided view); b [S] f32; inv =
    1 / (aq * bq). Returns the [B] int32 column chosen by `method`."""
    if x.is_cuda:
        return argmax_affine_kernel(x.contiguous(), w, b, aq, inv, method)
    if x.device.type == "cpu":
        return argmax_affine_plain(x, w, b, aq, inv, method)
    raise ValueError(f"unsupported device {x.device}")
