"""Multi-process serving glue: the counterpart of
slimt_tpu/parallel/multihost.py.

The JAX package runs one controller per host over a global
jax.sharding.Mesh, with jax.distributed between the processes. The port
mirrors it: within a process one controller drives a mesh of its local
devices (parallel/sharding.py); across processes torch.distributed joins
them, data-parallel only, as the JAX demo is (replicated weights, one
global "data" axis). Each process runs the same host pipeline on the whole
request stream, feeds its own block of every batch's rows, and the
compact results are all-gathered (models/model.py). The backend is NCCL
where each process has a card of its own, else gloo (the CPU, or several
processes sharing one card: NCCL refuses two ranks on one device).

Scaling efficiency = (throughput at N devices) / (N x throughput at 1).
`scaling_report` measures it on whatever mesh is available.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import List, Optional, Sequence

import torch

from slimt_tpu_torch.parallel.sharding import Mesh, default_devices, make_mesh


def default_backend(num_processes: int) -> str:
    """NCCL where every process can have a card of its own, else gloo."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 300.0,
) -> None:
    """torch.distributed.init_process_group with the JAX function's
    arguments: `coordinator_address` "host:port" (tcp://), the process
    count and this process's id; each falls back to the environment
    (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK). A no-op for one process."""
    import torch.distributed as dist

    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes == 1:
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    dist.init_process_group(
        backend or default_backend(num_processes),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=timedelta(seconds=timeout_s),
    )


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def local_devices(devices: Optional[Sequence] = None) -> List[torch.device]:
    """This process's devices: `devices`, else its own card under NCCL
    (card rank % count) or every card it sees."""
    import torch.distributed as dist

    if devices is not None:
        return [torch.device(d) for d in devices]
    cards = default_devices()
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return [cards[dist.get_rank() % len(cards)]]
    return cards


def global_mesh(data: Optional[int] = None, model: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """A data x model mesh over every process's devices (data: the global
    size, default every device over `model`). The grid holds this
    process's devices; its data axis spans the processes."""
    local = local_devices(devices)
    count = process_count()
    if data is None:
        data = len(local) * count // model
    if data % count:
        raise ValueError(f"data axis {data} does not split over {count} processes")
    mesh = make_mesh(data=data // count, model=model, devices=local)
    return Mesh(mesh.grid, process_index=process_index(), process_count=count)


def shard_lines(lines: Sequence[str], process_id: int, num_processes: int) -> List[str]:
    """Deterministic per-process slice of a corpus (strided, so processes
    get similar length distributions)."""
    return list(lines[process_id::num_processes])


def measure_throughput(model, service, corpus: Sequence[str]) -> float:
    """Steady-state target tokens/s through a Blocking service, on the
    host's clock around whole translate calls."""
    service.translate(model, list(corpus))  # warm every shape bucket
    start = time.perf_counter()
    responses = service.translate(model, list(corpus))
    elapsed = time.perf_counter() - start
    tokens = sum(
        r.target.word_count(s)
        for r in responses
        for s in range(r.target.sentence_count())
    )
    return tokens / elapsed


def scaling_report(make_model, make_service, corpus, device_counts,
                   devices: Optional[Sequence] = None):
    """Throughput at several data-parallel widths of this process's
    devices (`devices`, default its cards): {"throughput": {n: tokens/s},
    "efficiency": {n: ...}}."""
    results = {}
    for n in device_counts:
        mesh = global_mesh(data=n, model=1, devices=devices)
        model = make_model(mesh)
        service = make_service()
        results[n] = measure_throughput(model, service, corpus)
    base = results[device_counts[0]] / device_counts[0]
    return {
        "throughput": results,
        "efficiency": {n: results[n] / (n * base) for n in device_counts},
    }
