"""Multi-process data-parallel translation: the port's counterpart of
scripts/multihost_demo.py, and the worker of the two-process test and of
the smoke's two-process leg.

Each process joins one torch.distributed group (gloo on the CPU or for
processes that share a card, NCCL where each has its own), builds the
same synthetic model on a global data-parallel mesh of every process's
devices (replicated weights), and translates the same corpus twice
through the port's Blocking service: each batch's rows are split over the
processes and the results all-gathered, so every process prints every
translation (the second pass, equal to the first).

    python -m slimt_tpu_torch.parallel.demo PROCESS_ID NUM_PROCESSES HOST:PORT \
        [--device cpu|cuda] [--backend gloo|nccl]

A process holds four mesh ranks on the CPU (as each JAX demo process holds
four virtual devices) and one on a card (cuda:0 under gloo, its own card
under NCCL). Its last line also gives the decode's CUDA-graph replays and
its per-device graph caches' counts (0 and none on the CPU, where the
loop runs eagerly).
"""

from __future__ import annotations

import argparse
import json
import sys

CORPUS = [f"hello world test {i}" for i in range(8)]


def build_package():
    """The demo's package: 2 + 2 layers, 4 heads, a 64-piece vocabulary,
    E = 16, F = 32, seed 0 (the JAX demo's)."""
    from slimt_tpu_torch.config import ModelConfig
    from slimt_tpu_torch.io.synthetic import synthetic_model_bytes
    from slimt_tpu_torch.models.model import Package
    from slimt_tpu_torch.text import spm_proto
    from slimt_tpu_torch.text.synthetic_vocab import build_spm_model

    config = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
    spm = build_spm_model(["hello", "world", "test", "quick", "brown"], target_size=64)
    package = Package(
        model=synthetic_model_bytes(config=config, vocab_size=64, emb_dim=16,
                                    ffn_dim=32, seed=0),
        vocabulary=spm_proto.serialize_model(spm),
    )
    return config, package


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("process_id", type=int)
    parser.add_argument("num_processes", type=int)
    parser.add_argument("coordinator", help="HOST:PORT of process 0")
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    parser.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist

    from slimt_tpu_torch.config import Config
    from slimt_tpu_torch.models.loop_graph import ChunkGraph
    from slimt_tpu_torch.models.model import Model
    from slimt_tpu_torch.parallel import multihost
    from slimt_tpu_torch.runtime.service import Blocking

    if args.device == "cuda" and not torch.cuda.is_available():
        print("demo: --device cuda but torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    backend = args.backend or ("gloo" if args.device == "cpu"
                               else multihost.default_backend(args.num_processes))
    multihost.initialize(args.coordinator, args.num_processes, args.process_id, backend,
                         timeout_s=120.0)
    if args.device == "cpu":
        devices = [torch.device("cpu")] * 4
    elif backend == "nccl":
        devices = [torch.device("cuda", args.process_id % torch.cuda.device_count())]
    else:
        devices = [torch.device("cuda", 0)]
    mesh = multihost.global_mesh(model=1, devices=devices)
    config, package = build_package()
    model = Model(config, package, mesh=mesh, sharding="replicate")
    with Blocking(Config(cache_size=0)) as service:
        # Twice: on a card the first pass captures the decode's graph and
        # the second replays it.
        first = service.translate(model, CORPUS)
        responses = service.translate(model, CORPUS)
    if [r.target.text for r in responses] != [r.target.text for r in first]:
        print(f"demo: proc {args.process_id}: the second pass differs from the first",
              file=sys.stderr)
        return 1
    for line, response in zip(CORPUS, responses):
        print(f"proc {args.process_id} | {line!r} -> {response.target.text!r}", flush=True)
    caches = model._graphs.counts if model._graphs is not None else None
    print(f"proc {args.process_id} DONE devices={mesh.shape['data']} local={len(devices)} "
          f"lines={len(CORPUS)} backend={backend} replays={ChunkGraph.replays} "
          f"caches={json.dumps(caches)}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
