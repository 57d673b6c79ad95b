"""The int8 tied projection with its greedy argmax: the counterpart of
slimt_tpu/ops/logits_argmax.py (`argmax_affine`).

    logits = q8(y) W inv + b                       over the S columns
    exact:        the first index of the maximum
    packed_fp16 / packed_bf16: one int32 max over packed keys of the
                  16-bit-rounded logits (`packed_argmax_16`), S <= 65536
    packed_int:   one int32 max over packed keys of the int32 sums
                  acc = q8(y) W plus b, here the int32 bias in
                  accumulator units (`packed_int_argmax`; no float, inv
                  unused)

On a CUDA tensor `argmax_affine` launches csrc/logits_argmax.cu or
raises; on a CPU tensor it runs `argmax_affine_plain`. The kernel's
index is the plain version's by construction: the same epilogue
rounding, and one max over 64-bit keys whose order is the method's
(`exact_key` models the exact one, `packed_int_key` the packed_int one;
the 16-bit packed keys are `packed_argmax_16`'s), so the vocab tiles
combine in any order. packed_int launches through its own C entry and
counts in `argmax_packed_int_kernel.launches`.

`argmax_keys` is the key variant a vocab shard runs under tensor
parallelism: W holds the global columns col0 .. col0 + S - 1, and it
returns the global column with the winning key as int64 (the kernel's
unsigned key less 2^63, `method_key`), so the shards' choices meet by one
max over their keys (transformer.tp_output_argmax; its packed_int
keys are `packed_int_keys` of #1's accumulators).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from slimt_tpu_torch.ops import _build, launches, qmm

# Methods of the kernel, in csrc/slimt_kernels.cuh's ArgmaxMode order.
METHODS = ("exact", "packed_fp16", "packed_bf16", "packed_int")
# The methods over the f32 logits, which the key variant takes too.
LOGIT_METHODS = METHODS[:3]
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


def packed_int_keys(acc, b_i32, width_bits: int, shift: int, col0: int = 0):
    """(the int32 key of each sum of columns col0 .. col0 + S - 1: the
    shifted value above, the reversed column below; the columns). The
    one place the packed_int key is written in Python; the kernel's is
    csrc/logits_argmax.cu's `column_key`."""
    v = (acc + b_i32) >> shift
    col = col0 + torch.arange(acc.shape[-1], dtype=torch.int32, device=acc.device)
    return (v << width_bits) | (((1 << width_bits) - 1) - col), col


def packed_int_column(best: torch.Tensor, width_bits: int) -> torch.Tensor:
    """The column a packed_int key names, int32."""
    mask_col = (1 << width_bits) - 1
    return (mask_col - (best & mask_col)).to(torch.int32)


def packed_int_argmax(
    acc: torch.Tensor, b_i32: torch.Tensor, width_bits: int, shift: int
) -> torch.Tensor:
    """argmax over floor((acc + b_i32) / 2**shift), first index on
    ties, as one int32 max over packed keys (value above, reversed
    column below)."""
    best = packed_int_keys(acc, b_i32, width_bits, shift)[0].amax(-1)
    return packed_int_column(best, width_bits)


def packed_int_params(width: int, emb_dim: int) -> Tuple[int, int]:
    """(width_bits, shift) for packed_int_argmax: the reversed column
    needs width_bits; the value keeps the rest of the int32 budget
    against the accumulator bound 2*E*127^2."""
    width_bits = max(1, (width - 1).bit_length())
    bound = 2 * emb_dim * 127 * 127 + 1
    value_bits = 31 - width_bits
    shift = max(0, bound.bit_length() - (value_bits - 1))
    return width_bits, shift


def packed_int_key(acc: torch.Tensor, b_i32: torch.Tensor, width_bits: int,
                   shift: int) -> torch.Tensor:
    """The kernel's key of each int32 sum for the packed_int method, as
    int64 (the kernel's unsigned 64-bit key less 2^63, the same order):
    packed_int_argmax's int32 key above (its sign bit flipped in the
    kernel), the reversed 32-bit column below, so that the column reads
    back as from exact_key."""
    key, col = packed_int_keys(acc, b_i32, width_bits, shift)
    return key.to(torch.int64) * 2**32 + (0xFFFFFFFF - col.to(torch.int64))


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
    """The global column a key of method_key (or packed_int_key) names,
    int32."""
    if method in ("exact", "packed_int"):
        return (0xFFFFFFFF - (key & 0xFFFFFFFF)).to(torch.int32)
    return (0xFFFF - (key & 0xFFFF)).to(torch.int32)


def argmax_scratch(b: int, s: int) -> int:
    """Floats of device scratch the kernel takes for B rows over S columns
    (its C entry `slimt_argmax_scratch`; the whole step's projection stage
    asks the same)."""
    return _build.library().slimt_argmax_scratch(b, s)


def argmax_affine_plain(y, w, b, aq, inv, method: str = "exact") -> torch.Tensor:
    """Plain PyTorch version: argmax of q8(y) W inv + b by `method`,
    [B] int32; for "packed_int", packed_int_argmax of q8(y) W's int32
    sums and b, the int32 bias in accumulator units."""
    if method == "packed_int":
        width_bits, shift = _check_packed_int(w, b)
        return packed_int_argmax(qmm.int8_matmul(y, w, aq), b, width_bits, shift)
    logits = qmm.affine_plain(y, w, b, aq, inv)
    if method == "exact":
        return first_max(logits)
    return packed_argmax_16(logits, PACKED_DTYPES[method])


def argmax_keys_plain(y, w, b, aq, inv, method: str = "exact", col0: int = 0):
    """Plain version of the key variant: (the global column [B] int32, its
    key [B] int64) of q8(y) W inv + b over columns col0 .. col0 + S - 1."""
    key = method_key(qmm.affine_plain(y, w, b, aq, inv), method, col0).amax(-1)
    return key_column(key, method), key


def _check_packed_int(w, b_i32) -> Tuple[int, int]:
    """packed_int_params of W's width and E, once b_i32 is a contiguous
    int32 [S] tensor on W's device and the packed key fits in 31 bits."""
    e, s = w.shape
    if (not isinstance(b_i32, torch.Tensor) or b_i32.dtype != torch.int32
            or b_i32.shape != (s,) or b_i32.device != w.device):
        raise ValueError(f"packed_int takes b_i32, the bias in accumulator units: an "
                         f"int32 [{s}] tensor on {w.device}")
    width_bits, shift = packed_int_params(s, e)
    value_bits = ((2 * e * 127 * 127 + 1) >> shift).bit_length() + 1  # with the sign
    if width_bits + value_bits > 31:
        raise ValueError(f"packed_int: {width_bits} column bits and {value_bits} value bits "
                         f"exceed an int32 at S={s}")
    if not b_i32.is_contiguous():
        raise ValueError("packed_int's b_i32 must be contiguous")
    return width_bits, shift


def _check(y, w, b, method: str):
    """Refuse what the kernel cannot take, before any build: b is the f32
    [S] bias, or packed_int's int32 one. Returns packed_int's
    (width_bits, shift), else None."""
    rows, e = y.shape
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    if not 0 < e <= MAX_EMB:
        raise ValueError(f"E={e} outside the kernel's range 1..{MAX_EMB}")
    if w.dtype != torch.int8 or w.dim() != 2 or w.shape[0] != e:
        raise ValueError(f"projection W must be int8 [{e}, S], got {w.dtype} {tuple(w.shape)}")
    packing = None
    if method == "packed_int":
        packing = _check_packed_int(w, b)
    elif (not isinstance(b, torch.Tensor) or b.dtype != torch.float32 or not b.is_contiguous()
          or b.shape != (w.shape[1],)):
        raise ValueError("projection bias must be a contiguous float32 [S] tensor")
    if not y.is_cuda or y.dtype != torch.float32 or not y.is_contiguous():
        raise ValueError("y must be a contiguous float32 CUDA tensor")
    if w.device != y.device or b.device != y.device:
        raise ValueError("projection must be on y's CUDA device")
    if method in PACKED_DTYPES and w.shape[1] > MAX_PACKED_WIDTH:
        raise ValueError(f"{method} needs S <= {MAX_PACKED_WIDTH}, got {w.shape[1]}")
    return packing


def _launch(entry: str, y, w, bias, aq, *mode_args, keys=None, col0=None) -> torch.Tensor:
    """One call of csrc/logits_argmax.cu's C entry `entry` over checked
    tensors: [B] int32 choices. The entries differ only in the bias
    (f32 or int32 words) and their mode arguments, which follow aq; the
    key variant passes its keys and col0 too."""
    rows, e = y.shape
    choice = torch.empty((rows,), dtype=torch.int32, device=y.device)
    scratch = torch.empty(argmax_scratch(rows, w.shape[1]), dtype=torch.float32,
                          device=y.device)
    extra = () if keys is None else (keys.data_ptr(),)
    lib = _build.library()
    code = getattr(lib, entry)(
        y.data_ptr(), w.data_ptr(), bias.data_ptr(), choice.data_ptr(), *extra,
        scratch.data_ptr(), rows, e, w.shape[1], w.stride(0), w.stride(1),
        *(() if col0 is None else (int(col0),)), ctypes.c_float(np.float32(aq)), *mode_args,
        torch.cuda.current_stream(y.device).cuda_stream,
    )
    _build.check(lib, code, entry)
    return choice


def argmax_affine_kernel(y, w, b, aq, inv, method: str = "exact") -> torch.Tensor:
    """Launch csrc/logits_argmax.cu on CUDA tensors: [B] int32. W may be
    any strided [E, S] int8 view. `launches` counts the launches of the
    f32-logit methods; packed_int (b the int32 bias, inv unused) goes to
    argmax_packed_int_kernel, which counts its own."""
    if method == "packed_int":
        return argmax_packed_int_kernel(y, w, b, aq)
    _check(y, w, b, method)
    choice = _launch("slimt_argmax_affine", y, w, b, aq, ctypes.c_float(np.float32(inv)),
                     METHODS.index(method))
    launches.count(argmax_affine_kernel)
    return choice


argmax_affine_kernel.launches = 0


def argmax_packed_int_kernel(y, w, b_i32, aq) -> torch.Tensor:
    """Launch csrc/logits_argmax.cu's packed_int mode on CUDA tensors:
    packed_int_argmax of q8(y) W's int32 sums and b_i32 (int32 [S], the
    bias in accumulator units) with the packing of packed_int_params,
    [B] int32. `launches` counts the launches."""
    width_bits, shift = _check(y, w, b_i32, "packed_int")
    choice = _launch("slimt_argmax_packed_int", y, w, b_i32, aq, width_bits, shift)
    launches.count(argmax_packed_int_kernel)
    return choice


argmax_packed_int_kernel.launches = 0


def argmax_keys_kernel(y, w, b, aq, inv, method: str = "exact", col0: int = 0):
    """Launch csrc/logits_argmax.cu's key variant on CUDA tensors: (global
    column [B] int32, key [B] int64). `launches` counts the launches."""
    if method not in LOGIT_METHODS:
        raise ValueError(f"the key variant takes {LOGIT_METHODS}, got {method!r}")
    _check(y, w, b, method)
    if col0 < 0 or (method != "exact" and col0 + w.shape[1] > MAX_PACKED_WIDTH):
        raise ValueError(f"{method} needs 0 <= col0 and col0 + S <= {MAX_PACKED_WIDTH}, "
                         f"got col0={col0}, S={w.shape[1]}")
    keys = torch.empty((y.shape[0],), dtype=torch.int64, device=y.device)
    choice = _launch("slimt_argmax_keys", y, w, b, aq, ctypes.c_float(np.float32(inv)),
                     METHODS.index(method), keys=keys, col0=col0)
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
    1 / (aq * bq). For "packed_int", b is the int32 [S] bias in
    accumulator units (packed_int_bias) and inv goes unread. Returns the
    [B] int32 column chosen by `method`. The kernel takes E up to
    MAX_EMB in every method."""
    if x.is_cuda:
        return argmax_affine_kernel(x.contiguous(), w, b, aq, inv, method)
    if x.device.type == "cpu":
        return argmax_affine_plain(x, w, b, aq, inv, method)
    raise ValueError(f"unsupported device {x.device}")
