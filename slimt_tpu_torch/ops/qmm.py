"""Quantized matmul: the counterpart of slimt_tpu/ops/qmm.py and
slimt_tpu/ops/qmm_pallas.py.

    affine(x, w):  y = (clip(rint(x*aq), +-127) @ w_q) * inv + b
    dot(x, w):     y = (clip(rint(x*aq), +-127) @ w_q) * inv
    int8_matmul:   acc = clip(rint(x*aq), +-127) @ w_q         (int32)

`inv` = np.float32(1) / (aq * bq) is precomputed on the host
(io/params.py), so the kernel takes both scales by value.

On a CUDA tensor every int8 product launches the hand-written kernel in
csrc/qmm_affine.cu (it replaces qmm_pallas._affine_kernel) or raises;
on a CPU tensor it runs the plain version below. The `f32` provider
(`affine_f32`) is the JAX package's reference-numerics path, which that
package computes with jnp.dot outside any Pallas kernel: an f32
product against the weights dequantized once at load
(io/params.params_from_numpy), by torch.matmul, with TF32 off on the card
(device.py). `w_q` may be any strided int8 [K, N] view: the tied output
projection passes the [V, E] embedding's transpose without a copy.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from slimt_tpu_torch.ops import _build, launches

# Output modes of the kernel (csrc/slimt_kernels.cuh).
AFFINE, AFFINE_RELU, ACCUMULATOR = 0, 1, 2

# |acc| <= K * 127^2 must stay inside int32.
MAX_K = (2**31 - 1) // (127 * 127)


def _f32(value) -> torch.Tensor:
    """0-dim float32 CPU tensor; mixes with tensors on any device."""
    return torch.tensor(np.float32(value), dtype=torch.float32)


def quantize_activations(x: torch.Tensor, aq) -> torch.Tensor:
    """f32 → int8: round half to even, saturate to ±127."""
    scaled = x.to(torch.float32) * _f32(aq)
    return torch.clamp(torch.round(scaled), -127.0, 127.0).to(torch.int8)


def _int8_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 accumulation on any device: a float64 matmul of int8
    values is exact while |acc| < 2^53 (here |acc| <= K*127^2). A
    float32 matmul is not: it is exact only below 2^24."""
    return torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64)).to(
        torch.int32
    )


def affine_plain(x2, w_q, b, aq, inv, mode=AFFINE) -> torch.Tensor:
    """Plain PyTorch version of the kernel on a 2-D [M, K] input."""
    acc = _int8_matmul_plain(quantize_activations(x2, aq), w_q)
    if mode == ACCUMULATOR:
        return acc
    y = acc.to(torch.float32) * _f32(inv)
    if b is not None:
        y = y + b
    if mode == AFFINE_RELU:
        y = torch.relu(y)
    return y


def affine_kernel(x2, w_q, b, aq, inv, mode=AFFINE) -> torch.Tensor:
    """Launch csrc/qmm_affine.cu on CUDA tensors. `launches` counts
    the launches."""
    m, k = x2.shape
    k2, n = w_q.shape
    if k != k2:
        raise ValueError(f"shape mismatch: x {tuple(x2.shape)}, w {tuple(w_q.shape)}")
    if not 0 < k <= MAX_K:
        raise ValueError(f"K={k} outside the kernel's range 1..{MAX_K}")
    if not x2.is_cuda:
        raise ValueError(f"the kernel takes CUDA tensors, got {x2.device}")
    if x2.dtype != torch.float32 or not x2.is_contiguous():
        raise ValueError("x must be a contiguous float32 tensor")
    if w_q.dtype != torch.int8:
        raise ValueError(f"w must be int8, got {w_q.dtype}")
    if b is not None and (
        b.dtype != torch.float32 or not b.is_contiguous() or b.shape != (n,)
    ):
        raise ValueError("bias must be a contiguous float32 [N] tensor")
    for t in (x2, w_q) + ((b,) if b is not None else ()):
        if t.device != x2.device:
            raise ValueError("all operands must be on one CUDA device")
    out_dtype = torch.int32 if mode == ACCUMULATOR else torch.float32
    y = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    lib = _build.library()
    code = lib.slimt_affine(
        x2.data_ptr(), w_q.data_ptr(), b.data_ptr() if b is not None else None,
        y.data_ptr(), m, k, n, w_q.stride(0), w_q.stride(1),
        ctypes.c_float(np.float32(aq)), ctypes.c_float(np.float32(inv)), mode,
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    _build.check(lib, code, "slimt_affine")
    launches.count(affine_kernel)
    if mode == ACCUMULATOR:
        launches.count(int8_matmul)
    return y


affine_kernel.launches = 0


def _run(x, w_q, b, aq, inv, mode) -> torch.Tensor:
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if x.is_cuda:
        y = affine_kernel(x2.contiguous(), w_q, b, aq, inv, mode)
    elif x.device.type == "cpu":
        y = affine_plain(x2, w_q, b, aq, inv, mode)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return y.reshape(*lead, w_q.shape[1])


def affine(x, w_q, b, aq, inv, relu: bool = False) -> torch.Tensor:
    """y = dequant(quant(x) @ w_q) [+ b] [relu]; x is [..., K] f32."""
    return _run(x, w_q, b, aq, inv, AFFINE_RELU if relu else AFFINE)


def dot(x, w_q, aq, inv) -> torch.Tensor:
    """Bias-free variant (SSRU's W)."""
    return _run(x, w_q, None, aq, inv, AFFINE)


def int8_matmul(x, w_q, aq) -> torch.Tensor:
    """quant(x) @ w_q as the raw int32 accumulator [..., N]. On CUDA the
    kernel's ACCUMULATOR launches also count in `launches` here (the
    row-parallel products of tensor parallelism, the mesh's packed_int
    keys)."""
    return _run(x, w_q, None, aq, 1.0, ACCUMULATOR)


int8_matmul.launches = 0


def affine_f32(x, w, b=None, relu: bool = False) -> torch.Tensor:
    """The "f32" provider's affine: x @ w [+ b] [relu] in f32, w [K, N]
    the dequantized weight w_q / bq (io/params.params_from_numpy)."""
    y = torch.matmul(x.to(torch.float32), w)
    if b is not None:
        y = y + b
    return torch.relu(y) if relu else y
