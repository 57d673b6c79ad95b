"""Device mesh and weight sharding: the counterpart of
slimt_tpu/parallel/sharding.py.

A `Mesh` is a data x model x seq grid of torch devices, as the JAX mesh
is of JAX devices; a device may repeat ([cpu] * 8 in the tests, the
counterpart of the JAX tests' virtual 8-device CPU mesh, or [cuda:0] * n
on one card):

  - "data":  the batch dimension of every request batch (DP);
  - "model": tensor parallelism (TP) over attention heads, the FFN hidden
    and the vocabulary, megatron column -> row, the tied embedding and
    logit projection vocab-sharded;
  - "seq":   sequence parallelism (SP) over the tokens of the [B, T] input
    and so of every encoder activation.

The spec tree (`weight_pspecs`) names, per leaf of the loader's params
(io/loader.load_weights), the mesh axis each dimension is split over, with
the JAX package's names and choices. `shard_params` and
`replicate_params` split the numpy params per rank, in the mesh's flat
(C) order; io/params.params_from_numpy places each rank's shard on its
device and returns `ShardedParams`. Where GSPMD inserted the collectives,
the port's single controller runs them itself (parallel/collectives.py,
models/transformer.py, models/decode.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

AXES = ("data", "model", "seq")


class P(tuple):
    """A partition spec: per dimension the mesh axis it is split over, or
    None (jax.sharding.PartitionSpec's meaning; P() replicates)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


class Mesh:
    """A data x model x seq grid of torch devices. Across processes
    (parallel/multihost.py) the grid holds this process's devices and the
    data axis spans `process_count` processes, each holding a contiguous
    block of the data shards, as the JAX global mesh orders them."""

    def __init__(self, grid, process_index: int = 0, process_count: int = 1):
        grid = np.asarray(grid, dtype=object)
        if grid.ndim != 3:
            raise ValueError(f"a mesh grid is data x model x seq, got {grid.ndim} dims")
        self.grid = grid
        self.process_index = int(process_index)
        self.process_count = int(process_count)

    @property
    def local_shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.grid.shape))

    @property
    def shape(self) -> Dict[str, int]:
        """{"data", "model", "seq"}: the global sizes, as the JAX mesh's."""
        shape = self.local_shape
        shape["data"] *= self.process_count
        return shape

    @property
    def devices(self) -> List[torch.device]:
        """This process's devices in rank (flat C) order."""
        return list(self.grid.flat)

    @property
    def size(self) -> int:
        return self.grid.size

    def rank(self, d: int, m: int = 0, s: int = 0) -> int:
        """The flat rank of local coordinates (d, m, s)."""
        return int(np.ravel_multi_index((d, m, s), self.grid.shape))

    def coords(self, rank: int):
        return tuple(int(i) for i in np.unravel_index(rank, self.grid.shape))

    def device(self, d: int, m: int = 0, s: int = 0) -> torch.device:
        return self.grid[d, m, s]

    def __repr__(self):
        return (f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices})}, "
                f"process {self.process_index} of {self.process_count})")


def default_devices() -> List[torch.device]:
    """The cards this process sees (entry points default to the card)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass the mesh's devices (e.g. "
                           "[torch.device('cpu')] * 8) to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    data: int = 1,
    model: int = 1,
    seq: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over the first data * model * seq of `devices` (default:
    every card); a device may repeat."""
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else default_devices())]
    need = data * model * seq
    if need > len(devices):
        raise ValueError(
            f"mesh {data}x{model}x{seq} needs {need} devices, "
            f"have {len(devices)}"
        )
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(data, model, seq))


def repeated_mesh(data: int = 1, model: int = 1, seq: int = 1, device="cuda") -> Mesh:
    """A mesh whose every rank is `device` (the virtual mesh on one card,
    or on the CPU)."""
    return make_mesh(data, model, seq, [device] * (data * model * seq))


# -- the spec tree ------------------------------------------------------


def _affine_spec(kind: str) -> dict:
    """kind: 'col' shards the output dim, 'row' the input dim."""
    if kind == "col":
        return {"q": P(None, "model"), "b": P("model"), "aq": P(), "bq": P()}
    return {"q": P("model", None), "b": P(), "aq": P(), "bq": P()}


def _linear_spec(kind: str) -> dict:
    spec = _affine_spec(kind)
    del spec["b"]
    return spec


def _ln_spec() -> dict:
    return {"scale": P(), "bias": P()}


def _attention_spec() -> dict:
    # Column-parallel QKV (heads split over "model"), row-parallel O.
    return {"q": _affine_spec("col"), "k": _affine_spec("col"),
            "v": _affine_spec("col"), "o": _affine_spec("row"), "ln": _ln_spec()}


def _ffn_spec() -> dict:
    return {"w1": _affine_spec("col"), "w2": _affine_spec("row"), "ln": _ln_spec()}


def _decoder_layer_spec() -> dict:
    # The SSRU runs column-parallel: W/Wf output-sharded, the post-LN over
    # the full feature dim gathers.
    return {
        "rnn": {"w": _linear_spec("col"), "wf": _affine_spec("col"), "ln": _ln_spec()},
        "att": _attention_spec(),
        "ffn": _ffn_spec(),
    }


def weight_pspecs(params: dict) -> dict:
    """The spec tree of the loader's params (per-layer lists): the same
    names and choices as the JAX function's list form."""
    if not isinstance(params["encoder"], list) or not isinstance(params["decoder"], list):
        raise ValueError("weight_pspecs takes per-layer lists (load_weights)")
    return {
        # Vocab-sharded tied embedding and logit projection.
        "emb": {"q": P("model", None), "scale": P()},
        "out": {"aq": P(), "b": P("model")},
        "encoder": [{"att": _attention_spec(), "ffn": _ffn_spec()}
                    for _ in params["encoder"]],
        "decoder": [_decoder_layer_spec() for _ in params["decoder"]],
    }


def batch_pspec(seq: bool = False) -> P:
    """Request batches split B over "data"; with seq=True also T over
    "seq"."""
    return P("data", "seq") if seq else P("data", None)


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (dicts and lists), with the matching
    nodes of `rest`; a spec (P) is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    return fn(tree, *rest)


def _divisible(arr, spec: P, mesh: Mesh) -> bool:
    shape = np.shape(arr)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if dim >= len(shape) or shape[dim] % mesh.local_shape[axis] != 0:
            return False
    return True


def _slice(arr, spec: P, mesh: Mesh, coords) -> np.ndarray:
    """The block of `arr` at mesh coordinates (d, m, s) under `spec`."""
    index = [slice(None)] * np.ndim(arr)
    at = dict(zip(AXES, coords))
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = mesh.local_shape[axis]
            size = np.shape(arr)[dim] // n
            index[dim] = slice(at[axis] * size, (at[axis] + 1) * size)
    return np.asarray(arr)[tuple(index)]


class HostShards:
    """Numpy params split per rank: `ranks[i]` is rank i's tree (the mesh's
    flat order), `specs` the spec each leaf was split by (P() where it is
    replicated), `kind` "tp" or "replicate"."""

    def __init__(self, mesh: Mesh, ranks: list, specs: dict, kind: str):
        self.mesh, self.ranks, self.specs, self.kind = mesh, ranks, specs, kind

    def __getitem__(self, rank: int) -> dict:
        return self.ranks[rank]


def shard_params(params: dict, mesh: Mesh) -> HostShards:
    """Split the loader's params by their specs. A leaf whose dimension
    the mesh axis does not divide (an odd vocabulary, say) is replicated,
    as the JAX function does."""
    specs = tree_map(lambda arr, spec: spec if _divisible(arr, spec, mesh) else P(),
                     params, weight_pspecs(params))
    ranks = [tree_map(lambda arr, spec: _slice(arr, spec, mesh, mesh.coords(r)),
                      params, specs)
             for r in range(mesh.size)]
    return HostShards(mesh, ranks, specs, "tp")


def replicate_params(params: dict, mesh: Mesh) -> HostShards:
    """Every rank holds the whole params (pure DP; best for small models)."""
    specs = tree_map(lambda arr: P(), params)
    return HostShards(mesh, [params] * mesh.size, specs, "replicate")


def batch_blocks(mesh: Mesh, batch: int, t: int, seq: bool = False) -> Dict[tuple, tuple]:
    """`batch_pspec`'s split of this process's [batch, t] rows: {(d, s):
    (row slice, token slice)}, B over the data ranks and, with seq=True, T
    over the seq ranks (else s is 0 alone)."""
    data = mesh.local_shape["data"]
    seqs = mesh.local_shape["seq"] if seq else 1
    if batch % data or t % seqs:
        raise ValueError(f"batch [{batch}, {t}] does not split over {data} data and "
                         f"{seqs} seq ranks")
    b, n = batch // data, t // seqs
    return {(d, s): (slice(d * b, (d + 1) * b), slice(s * n, (s + 1) * n))
            for d in range(data) for s in range(seqs)}


class ShardedParams:
    """The port's params on a mesh: `ranks[i]` is rank i's params dict on
    its device (io/params.params_from_numpy of its shard), `specs` the
    leaves' specs. `gathered(d)` assembles the whole params of data shard d
    on its first device from the model ranks' shards, by the concatenation
    collective, once: the whole-row kernels (the whole encoder layer, the
    fused blocks, the whole decode step) and the f32 provider run there,
    as GSPMD runs a Pallas call on gathered operands."""

    def __init__(self, mesh: Mesh, ranks: list, specs: dict, kind: str):
        self.mesh, self.ranks, self.specs, self.kind = mesh, ranks, specs, kind
        self._gathered = {}

    @property
    def tensor_parallel(self) -> bool:
        return self.kind == "tp" and self.mesh.local_shape["model"] > 1

    @property
    def vocab_size(self) -> int:
        rows = self.ranks[0]["emb"]["q"].shape[0]
        split = "model" in self.specs["emb"]["q"]
        return rows * self.mesh.local_shape["model"] if split else rows

    def at(self, d: int, m: int = 0, s: int = 0) -> dict:
        return self.ranks[self.mesh.rank(d, m, s)]

    def gathered(self, d: int) -> dict:
        if not self.tensor_parallel:
            return self.at(d)
        if d not in self._gathered:
            from slimt_tpu_torch.parallel import collectives

            device = self.mesh.device(d)
            shards = [self.at(d, m) for m in range(self.mesh.local_shape["model"])]
            self._gathered[d] = collectives.gather_params(shards, self.specs, device)
        return self._gathered[d]
