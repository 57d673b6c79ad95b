"""The decoder's SSRU and FFN blocks: the counterpart of
slimt_tpu/ops/fused_blocks.py (`ssru_block`, `ffn_block`), the blocks
of the `fused` provider.

    ssru: f = sigmoid(q8(x) Wf inv + bf);  c' = f c + (1 - f) q8(x) W inv
          h = LN(x + relu(c'))                                -> (h, c')
    ffn:  y = LN((q8(relu(q8(x) W1 inv1 + b1)) W2 inv2 + b2) + x)

Both take [..., E] activations and flatten the leading dims, as the JAX
functions do. On a CUDA tensor `ssru_block` and `ffn_block` launch
csrc/fused_blocks.cu or raise; on a CPU tensor they run the plain
versions below, which call `qmm.affine_plain` directly, so that on the
card they share no kernel with what they are compared against.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from slimt_tpu_torch.ops import _build, qmm
from slimt_tpu_torch.ops.encoder_layer import layer_norm

# Shapes the kernels take (and the whole decode step's).
EMB_DIMS = (256, 512)
FFN_DIMS = (1536, 2048)


def _affine(p: dict, x: torch.Tensor, mode=qmm.AFFINE) -> torch.Tensor:
    return qmm.affine_plain(x, p["q"], p.get("b"), p["aq"], p["inv"], mode)


def ssru_plain(x, state, rnn):
    """Plain PyTorch version of the SSRU block on [M, E] rows."""
    f = torch.sigmoid(_affine(rnn["wf"], x))
    wx = _affine(rnn["w"], x)
    c_t = f * state + (1.0 - f) * wx
    h = layer_norm(x + torch.relu(c_t), rnn["ln"]["scale"], rnn["ln"]["bias"])
    return h, c_t


def ffn_plain(x, ffn):
    """Plain PyTorch version of the FFN block on [M, E] rows."""
    hidden = _affine(ffn["w1"], x, qmm.AFFINE_RELU)
    y = _affine(ffn["w2"], hidden)
    return layer_norm(y + x, ffn["ln"]["scale"], ffn["ln"]["bias"])


def rows_per_block(m: int) -> int:
    """Rows a block of these kernels (and of the whole step's layers
    kernel) takes: one spreads a small batch over the SMs, four cut the
    weight reads at large M."""
    return 1 if m <= 64 else 4


def _check(x, tensors, e: int, f=None) -> None:
    if e not in EMB_DIMS:
        raise ValueError(f"E={e} not in {EMB_DIMS}")
    if f is not None and f not in FFN_DIMS:
        raise ValueError(f"F={f} not in {FFN_DIMS}")
    if not x.is_cuda:
        raise ValueError(f"the kernel takes CUDA tensors, got {x.device}")
    for t in (x,) + tuple(tensors):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("block tensors must be contiguous on one CUDA device")
        if t.data_ptr() % 16:
            raise ValueError("block tensors must be 16-byte aligned")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")


def _scale(value) -> ctypes.c_float:
    return ctypes.c_float(np.float32(value))


def ssru_kernel(x, state, rnn):
    """Launch csrc/fused_blocks.cu's SSRU block on CUDA [M, E] rows.
    `launches` counts the launches."""
    m, e = x.shape
    wf, w, ln = rnn["wf"], rnn["w"], rnn["ln"]
    _check(x, (state, wf["q"], wf["b"], w["q"], ln["scale"], ln["bias"]), e)
    if tuple(state.shape) != (m, e) or state.dtype != torch.float32:
        raise ValueError(f"state must be float32 [{m}, {e}]")
    h = torch.empty_like(x)
    c_t = torch.empty_like(x)
    lib = _build.library()
    code = lib.slimt_ssru_block(
        x.data_ptr(), state.data_ptr(), wf["q"].data_ptr(), wf["b"].data_ptr(),
        w["q"].data_ptr(), ln["scale"].data_ptr(), ln["bias"].data_ptr(),
        h.data_ptr(), c_t.data_ptr(), m, e, rows_per_block(m),
        _scale(wf["aq"]), _scale(wf["inv"]), _scale(w["aq"]), _scale(w["inv"]),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "slimt_ssru_block")
    ssru_kernel.launches += 1
    return h, c_t


ssru_kernel.launches = 0


def ffn_kernel(x, ffn):
    """Launch csrc/fused_blocks.cu's FFN block on CUDA [M, E] rows.
    `launches` counts the launches."""
    m, e = x.shape
    w1, w2, ln = ffn["w1"], ffn["w2"], ffn["ln"]
    f = w1["q"].shape[1]
    _check(x, (w1["q"], w1["b"], w2["q"], w2["b"], ln["scale"], ln["bias"]), e, f)
    out = torch.empty_like(x)
    lib = _build.library()
    code = lib.slimt_ffn_block(
        x.data_ptr(), w1["q"].data_ptr(), w1["b"].data_ptr(), w2["q"].data_ptr(),
        w2["b"].data_ptr(), ln["scale"].data_ptr(), ln["bias"].data_ptr(),
        out.data_ptr(), m, e, f, rows_per_block(m),
        _scale(w1["aq"]), _scale(w1["inv"]), _scale(w2["aq"]), _scale(w2["inv"]),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "slimt_ffn_block")
    ffn_kernel.launches += 1
    return out


ffn_kernel.launches = 0


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).to(torch.float32)


def ssru_block(x: torch.Tensor, state: torch.Tensor, rnn: dict):
    """x, state: [..., E]; rnn = {"wf": affine, "w": linear, "ln"}.
    Returns (h, new_state), each shaped like x."""
    x2, c2 = _flat(x), _flat(state)
    if x.is_cuda:
        h, c_t = ssru_kernel(x2.contiguous(), c2.contiguous(), rnn)
    elif x.device.type == "cpu":
        h, c_t = ssru_plain(x2, c2, rnn)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return h.reshape(x.shape), c_t.reshape(x.shape)


def ffn_block(x: torch.Tensor, ffn: dict) -> torch.Tensor:
    """x: [..., E]; ffn = {"w1", "w2", "ln"}. Returns LN(FFN(x) + x)."""
    x2 = _flat(x)
    if x.is_cuda:
        out = ffn_kernel(x2.contiguous(), ffn)
    elif x.device.type == "cpu":
        out = ffn_plain(x2, ffn)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return out.reshape(x.shape)
