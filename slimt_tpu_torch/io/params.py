"""Carry the loader's numpy weight pytree over to torch tensors.

`io.loader.load_weights` returns per-layer lists of dicts of
numpy arrays (layout in its module docstring). The port keeps that
layout: arrays become tensors on `device`, and every scale (`aq`,
`bq`, `emb.scale`, `out.aq`) stays a host-side np.float32, so a CUDA
kernel takes it by value without a device round trip.

Each int8 matrix dict also gains `inv` = np.float32(1) / (aq * bq),
the epilogue multiplier, computed in float32 as the JAX package does
(`1.0 / (aq * bq)` on float32 arrays). A Python-float (double)
computation can land one ulp away and break bit-exactness. `emb` gains
`inv` = np.float32(1) / scale for the embedding dequantization. On the
card each encoder layer's int8 matrices also gain their K-major copies,
which the whole-layer kernel reads (ops.encoder_layer.add_k_major).
"""

from __future__ import annotations

import numpy as np
import torch

from slimt_tpu_torch.device import resolve_device
from slimt_tpu_torch.ops.encoder_layer import add_k_major


def _convert(node, device):
    if isinstance(node, dict):
        out = {key: _convert(value, device) for key, value in node.items()}
        if "q" in node and "aq" in node and "bq" in node:
            out["inv"] = np.float32(1) / (
                np.float32(node["aq"]) * np.float32(node["bq"])
            )
        return out
    if isinstance(node, (list, tuple)):
        return [_convert(value, device) for value in node]
    array = np.asarray(node)
    if array.ndim == 0:
        return np.float32(array)
    # A copy: the loader's arrays may be read-only views of the file.
    return torch.from_numpy(np.array(array, order="C")).to(device)


def params_from_numpy(host_params: dict, device) -> dict:
    """Loader pytree (numpy, per-layer lists) → the port's params."""
    if not isinstance(host_params["encoder"], list):
        raise ValueError(
            "params_from_numpy takes per-layer lists (load_weights), "
            "not stacked layers"
        )
    device = resolve_device(device)
    params = _convert(host_params, device)
    params["emb"]["inv"] = np.float32(1) / params["emb"]["scale"]
    if device.type == "cuda":
        for layer in params["encoder"]:
            add_k_major(layer)
    return params
