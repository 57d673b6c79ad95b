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
which the whole-layer kernel reads (ops.encoder_layer.add_k_major). On a
mesh each rank's shard goes to its device (`_place_shards`).

The `f32` provider multiplies by dequantized weights, which the loader
adds where it is asked (`params_from_numpy(..., dequantize=True)`, as a
Model under "f32" does; nothing downstream adds them): `add_dequantized`
gives each int8 matrix dict `w` = q / bq and the embedding `w` = q /
scale, in float32 by division (the JAX provider's `w_q / bq`; a
reciprocal multiply can round differently), once per params, about four
times the int8 bytes.
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


def _dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    """q / scale in float32, divided on the host (numpy's IEEE division)."""
    w = q.cpu().numpy().astype(np.float32) / np.float32(scale)
    return torch.from_numpy(w).to(q.device)


def _add_w(node) -> None:
    if isinstance(node, dict):
        if "q" in node and "bq" in node and "w" not in node:
            node["w"] = _dequantize(node["q"], node["bq"])
        for value in list(node.values()):
            if isinstance(value, (dict, list, tuple)):
                _add_w(value)
    elif isinstance(node, (list, tuple)):
        for value in node:
            _add_w(value)


def add_dequantized(params: dict) -> dict:
    """Give the port's params the f32 provider's weights, in place, where
    they lack them: `w` = q / bq beside each int8 matrix, and `emb.w` =
    emb.q / emb.scale (the tied projection's). Returns params."""
    _add_w(params["encoder"])
    _add_w(params["decoder"])
    if "w" not in params["emb"]:
        params["emb"]["w"] = _dequantize(params["emb"]["q"], params["emb"]["scale"])
    return params


def dequantized_bytes(params: dict) -> int:
    """The bytes of the f32 provider's weights in `params`."""
    total = 0

    def walk(node):
        nonlocal total
        if isinstance(node, dict):
            for key, value in node.items():
                if key == "w" and isinstance(value, torch.Tensor):
                    total += value.numel() * value.element_size()
                else:
                    walk(value)
        elif isinstance(node, (list, tuple)):
            for value in node:
                walk(value)

    walk(params)
    return total


def _place(host_params: dict, device: torch.device, dequantize: bool,
           k_major: bool = True) -> dict:
    params = _convert(host_params, device)
    params["emb"]["inv"] = np.float32(1) / params["emb"]["scale"]
    if k_major and device.type == "cuda":
        for layer in params["encoder"]:
            add_k_major(layer)
    if dequantize:
        add_dequantized(params)
    return params


def _place_shards(shards, dequantize: bool):
    """Each rank's shard on its device: a parallel.sharding.ShardedParams.
    Ranks that share a device and a shard (the data and seq replicas of a
    model rank) share one params dict. Where a rank's shard is the whole
    model (replicated weights, or a mesh without a model axis) it gets the
    K-major copies of the whole-layer kernel; a tensor-parallel shard does
    not (that kernel runs on the gathered params)."""
    from slimt_tpu_torch.parallel.sharding import ShardedParams

    mesh = shards.mesh
    whole = shards.kind == "replicate" or mesh.local_shape["model"] == 1
    placed = {}
    ranks = []
    for rank, device in enumerate(mesh.devices):
        device = resolve_device(device)
        key = (device, 0 if whole else mesh.coords(rank)[1])
        if key not in placed:
            placed[key] = _place(shards[rank], device, dequantize, k_major=whole)
        ranks.append(placed[key])
    return ShardedParams(mesh, ranks, shards.specs, shards.kind)


def params_from_numpy(host_params, device=None, dequantize: bool = False):
    """Loader pytree (numpy, per-layer lists) → the port's params on
    `device`; with `dequantize`, also the f32 provider's weights
    (add_dequantized). Given the per-rank shards of a mesh
    (parallel.sharding.shard_params or replicate_params), each rank's
    shard goes to that rank's device (`device` unused) and the result is a
    parallel.sharding.ShardedParams."""
    from slimt_tpu_torch.parallel.sharding import HostShards

    if isinstance(host_params, HostShards):
        return _place_shards(host_params, dequantize)
    if not isinstance(host_params["encoder"], list):
        raise ValueError(
            "params_from_numpy takes per-layer lists (load_weights), "
            "not stacked layers"
        )
    if device is None:
        raise ValueError("params_from_numpy needs a device")
    return _place(host_params, resolve_device(device), dequantize)
