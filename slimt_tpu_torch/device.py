"""Resolve the device a port model runs on.

The port runs where it is told to: "cuda" without a card raises, and
there is no fallback to the CPU. On CUDA, TF32 is switched off for
matmuls (`torch.backends.cuda.matmul.allow_tf32` False) and cuDNN: the
float32 `torch.matmul` products of the decode attention and of the split
encoder's plain SDPA would otherwise round their operands to 10
mantissa bits and drift from the reference numerics.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device` ("cpu", "cuda", "cuda:N" or a
    torch.device); raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cpu' or 'cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("could not switch TF32 off")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
