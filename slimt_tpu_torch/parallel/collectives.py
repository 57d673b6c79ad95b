"""The collectives GSPMD inserted for the JAX package, made explicit.

Two implementations:

  - `Local`: the single controller's own cross-device ops within a
    process, each over a list of per-rank tensors in rank order: an
    int32 sum (the row-parallel products' accumulators, exact in any
    order), a max (the per-row cross-KV absmax, the per-tensor int8 query
    scale, the argmax keys) and a concatenation along a dimension (column
    and sequence shards). Each reduces on the first rank's device in rank
    order (operands copied there) and hands every rank the result on its
    own device; ranks that share a device share the result tensor (a
    collective's result is never written in place).
  - `Process`: across the processes of a torch.distributed group, the
    one collective multi-process serving needs, the all-gather of each
    process's compact results. NCCL takes CUDA tensors as they are; gloo
    takes CUDA tensors staged through pinned host memory, explicitly.

A failed collective raises.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def _to(tensor: torch.Tensor, device: torch.device) -> torch.Tensor:
    return tensor if tensor.device == device else tensor.to(device)


def _spread(result: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    copies = {}
    out = []
    for t in like:
        if t.device not in copies:
            copies[t.device] = _to(result, t.device)
        out.append(copies[t.device])
    return out


class Local:
    """In-process collectives over the mesh's devices."""

    @staticmethod
    def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if len(tensors) == 1:
            return list(tensors)
        device = tensors[0].device
        total = tensors[0]
        for t in tensors[1:]:
            total = total + _to(t, device)
        return _spread(total, tensors)

    @staticmethod
    def all_reduce_max(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if len(tensors) == 1:
            return list(tensors)
        device = tensors[0].device
        best = tensors[0]
        for t in tensors[1:]:
            best = torch.maximum(best, _to(t, device))
        return _spread(best, tensors)

    @staticmethod
    def all_gather(tensors: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
        if len(tensors) == 1:
            return list(tensors)
        device = tensors[0].device
        full = torch.cat([_to(t, device) for t in tensors], dim=dim)
        return _spread(full, tensors)


class Process:
    """Collectives across the processes of a torch.distributed group: each
    process passes its one local tensor."""

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized "
                               "(parallel.multihost.initialize)")
        self.dist = dist
        self.group = group
        self.backend = dist.get_backend(group)
        self.world = dist.get_world_size(group)

    def _stage(self, tensor: torch.Tensor) -> torch.Tensor:
        """The tensor the backend takes: on gloo a CUDA tensor goes through
        pinned host memory."""
        tensor = tensor.contiguous()
        if self.backend == "gloo" and tensor.is_cuda:
            host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            host.copy_(tensor, non_blocking=True)
            torch.cuda.current_stream(tensor.device).synchronize()
            return host
        return tensor

    def all_gather(self, tensor: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every process's tensor (one shape on all, at least 1-D),
        concatenated along `dim` in process order, on the caller's device.
        The bytes travel (gloo takes no int16 or bool), and the result is
        viewed back in the tensor's dtype."""
        staged = self._stage(tensor).view(torch.uint8)
        parts = [torch.empty_like(staged) for _ in range(self.world)]
        self.dist.all_gather(parts, staged, group=self.group)
        return _to(torch.cat(parts, dim=dim).view(tensor.dtype), tensor.device)


def gather_params(shards: Sequence[dict], specs: dict, device: torch.device) -> dict:
    """The whole params from the model ranks' shards (the port's params
    dicts, rank order), each leaf split over "model" concatenated back
    along its dimension on `device`; replicated leaves are taken from the
    first shard. The dequantized `w` of a matrix follows its `q`; the
    K-major copies are made anew on the card (encoder_layer.add_k_major)."""

    def walk(nodes, spec):
        if isinstance(spec, dict):
            out = {}
            for key, value in nodes[0].items():
                if key == "qt":
                    continue
                if key == "inv":
                    out[key] = value
                elif key in spec or key == "w":
                    out[key] = walk([n[key] for n in nodes], spec[key if key in spec else "q"])
                else:
                    raise KeyError(f"no spec for params key {key!r}")
            return out
        if isinstance(spec, list):
            return [walk([n[i] for n in nodes], s) for i, s in enumerate(spec)]
        value = nodes[0]
        if not isinstance(value, torch.Tensor):
            return value
        dims = [i for i, axis in enumerate(spec) if axis == "model"]
        if not dims:
            return _to(value, device)
        return _to(Local.all_gather(list(nodes), dims[0])[0], device)

    params = walk(list(shards), specs)
    if device.type == "cuda":
        from slimt_tpu_torch.ops.encoder_layer import add_k_major

        for layer in params["encoder"]:
            add_k_major(layer)
    return params
