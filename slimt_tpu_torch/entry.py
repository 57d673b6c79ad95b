"""Entry points on the card: the counterpart of __graft_entry__.py.

entry()             -- (fn, example_args): the flagship forward (encoder +
                       greedy decode) of the tiny11-shaped int8 model on the
                       card.
dryrun_multichip(n) -- every leg of the JAX function on an n-rank mesh
                       over the visible cards (rank i on card i % count,
                       so one card hosts every rank): a toy DP x TP step;
                       the flagship DP x TP step with exact numerics and
                       with the declared serving numerics; the DP step
                       with replicated weights, where the whole-layer
                       kernel (#2) and the whole decode step (#7) run on
                       each data shard; the two-stage pipeline; and
                       (data x seq) steps at T = 64 (#8's query slice) and
                       T = 1024 (#9's). Each leg's tokens must be bit-equal
                       to one card's with the same options; it raises
                       otherwise, and returns a report of each leg (its
                       mesh, its walls and the kernels it launched). On
                       the card each leg's decode replays CUDA graphs
                       (per-device caches, loop_graph.DeviceGraphs), but
                       a lockstep leg whose ranks span cards; the same
                       leg through the eager loop is timed beside it.

Every data shard holds 16 rows, so that the LayerNorms' and softmaxes'
torch reductions take one device's configuration (a torch reduction's
thread layout, and so its order of summation, changes below 16 rows).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from slimt_tpu_torch.config import ModelConfig
from slimt_tpu_torch.io import load_items
from slimt_tpu_torch.io.loader import load_weights
from slimt_tpu_torch.io.params import params_from_numpy
from slimt_tpu_torch.io.synthetic import synthetic_model_bytes
from slimt_tpu_torch.models import decode, loop_graph
from slimt_tpu_torch.models.decode import translate_batch
from slimt_tpu_torch.ops import (attention, decode_attn, decoder_step, encoder_layer,
                                 fused_blocks, logits_argmax, qmm)
from slimt_tpu_torch.parallel import sharding as shd
from slimt_tpu_torch.parallel.pipeline import TwoStagePipeline

ROWS_PER_SHARD = 16

# The wrappers whose launches a leg reports (each counts its own).
COUNTERS = {
    "qmm_affine": qmm.affine_kernel,
    "qmm_accumulator": qmm.int8_matmul,
    "encoder_layer": encoder_layer.layer_kernel,
    "decode_attention": decode_attn.decode_attention_kernel,
    "argmax_affine": logits_argmax.argmax_affine_kernel,
    "argmax_keys": logits_argmax.argmax_keys_kernel,
    "argmax_packed_int": logits_argmax.argmax_packed_int_kernel,
    "ssru_block": fused_blocks.ssru_kernel,
    "ffn_block": fused_blocks.ffn_kernel,
    "whole_decode_step": decoder_step.whole_step_kernel,
    "fused_sdpa": attention.fused_sdpa_kernel,
    "fused_sdpa_rows": attention.fused_sdpa_rows_kernel,
    "blockwise_attention": attention.blockwise_kernel,
    "blockwise_rows": attention.blockwise_rows_kernel,
}

# The kernels each leg's mesh run must launch (#1 in ACCUMULATOR mode,
# "qmm_accumulator", is the row-parallel products of a TP leg).
LEG_KERNELS = {
    "toy dp x tp": ("qmm_affine", "qmm_accumulator", "blockwise_attention"),
    "flagship dp x tp, exact": ("qmm_affine", "qmm_accumulator", "fused_sdpa",
                                "argmax_keys"),
    "flagship dp x tp, serving": ("qmm_affine", "qmm_accumulator", "encoder_layer",
                                  "decode_attention"),
    "dp whole layer, serving": ("qmm_affine", "encoder_layer", "decode_attention"),
    "dp whole layer, fused_step": ("qmm_affine", "encoder_layer", "whole_decode_step"),
    "pipeline": ("qmm_affine", "encoder_layer", "argmax_affine"),
    "dp x sp, fused SDPA": ("qmm_affine", "fused_sdpa_rows", "decode_attention"),
    "dp x sp, blockwise": ("qmm_affine", "blockwise_rows", "decode_attention"),
}


def flagship_params(vocab=32000, emb=256, ffn=1536, enc=6, dec=2, heads=8, seed=0):
    """The loader's numpy params of a synthetic model (random int8 weights
    from `seed`), and its config; the defaults are the tiny11 widths."""
    config = ModelConfig(encoder_layers=enc, decoder_layers=dec, num_heads=heads)
    items = load_items(synthetic_model_bytes(config=config, vocab_size=vocab, emb_dim=emb,
                                             ffn_dim=ffn, seed=seed))
    return load_weights(items, config), config


def example_batch(batch=8, seq=32, vocab=32000, seed=1):
    """A [batch, seq] batch of random ids with the last 4 positions padded."""
    rng = np.random.default_rng(seed)
    indices = rng.integers(3, vocab, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.float32)
    mask[:, -4:] = 0.0
    indices[:, -4:] = 0
    return torch.from_numpy(indices), torch.from_numpy(mask)


def entry(device="cuda"):
    """(fn, example_args): the flagship forward, fn(params, indices,
    mask) -> GreedyResult, on `device` (the card; its decode loop replays
    CUDA graphs)."""
    host, config = flagship_params()
    params = params_from_numpy(host, device)
    indices, mask = example_batch()
    max_steps = int(1.5 * indices.shape[1])
    on_card = params["emb"]["q"].is_cuda
    graphs = loop_graph.GraphCache() if on_card else None

    def fn(params, indices, mask):
        return translate_batch(
            params, indices, mask, eos_id=0, max_steps=max_steps,
            num_heads=config.num_heads, provider=config.qmm_provider, kv_dtype=None,
            argmax_method="exact", fused_layer=on_card, graphs=graphs,
        )

    dev = params["emb"]["q"].device
    return fn, (params, indices.to(dev), mask.to(dev))


def mesh_devices(n: int, devices=None) -> List[torch.device]:
    """n ranks over `devices` (default the visible cards), rank i on
    device i % count."""
    devices = [torch.device(d) for d in (devices or shd.default_devices())]
    return [devices[i % len(devices)] for i in range(n)]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _leg(name: str, mesh: Optional[shd.Mesh], run_mesh, run_single, report: list,
         on_card: bool, run_eager=None, replay: bool = True, caches=None) -> None:
    """Run one leg: the single-device run, then the mesh run twice with the
    launch counters read around the first (which captures the graphs) and
    the graph replays and loop chunks around the second; then each, and
    on the card the mesh run through the eager loop (`run_eager`), timed
    in turns (mesh, eager, single, single, eager, mesh). Raise unless
    every mesh run's tokens and valid are bit-equal to the single run's,
    and on the card unless the mesh run launched each kernel of
    LEG_KERNELS[name] and, where `replay`, its second run replayed every
    chunk it ran. `caches()` gives the graph caches' counts for the
    report."""
    want = run_single()
    before = {key: fn.launches for key, fn in COUNTERS.items()}
    got = run_mesh()
    launched = {key: fn.launches - before[key] for key, fn in COUNTERS.items()}
    replays, chunks = loop_graph.ChunkGraph.replays, decode.run_loop.chunks
    outs = [got, run_mesh()]
    replayed = loop_graph.ChunkGraph.replays - replays
    ran = decode.run_loop.chunks - chunks
    timed = {"mesh": run_mesh, "single": run_single}
    turns = ("mesh", "single")
    if on_card and run_eager is not None:
        timed["eager"] = run_eager
        turns = ("mesh", "eager", "single", "single", "eager", "mesh")
    walls = {f"{label}_ms": [] for label in ("mesh", "eager", "single")}
    device = got[0].tokens.device if isinstance(got, list) else got.tokens.device
    for label in turns:
        _sync(device)
        start = time.perf_counter()
        out = timed[label]()
        _sync(device)
        walls[f"{label}_ms"].append((time.perf_counter() - start) * 1e3)
        if label != "single":
            outs.append(out)

    def pairs(out):
        return list(zip(out, want)) if isinstance(out, list) else [(out, want)]

    equal = all(torch.equal(g.tokens.cpu(), w.tokens.cpu())
                and torch.equal(g.valid.cpu(), w.valid.cpu())
                for out in outs for g, w in pairs(out))
    entry_ = {"leg": name, "mesh": None if mesh is None else mesh.shape,
              "devices": sorted({str(d) for d in (mesh.devices if mesh else [])}),
              "equal": equal, "tokens": int(sum(int(g.valid.sum()) for g, _ in pairs(got))),
              **walls, "replays": replayed, "chunks": ran, "replay": replay,
              "caches": caches() if caches is not None else None,
              "launches": {k: v for k, v in launched.items() if v}}
    report.append(entry_)
    if not equal:
        raise AssertionError(f"{name}: tokens differ from one device's: {entry_}")
    missing = [k for k in LEG_KERNELS[name] if not launched[k]]
    if missing and on_card:
        raise AssertionError(f"{name}: kernels never launched on the mesh: {missing}")
    if on_card and replay and not (replayed and replayed == ran):
        raise AssertionError(f"{name}: the mesh run replayed {replayed} of its {ran} chunks "
                             "from CUDA graphs")


def dryrun_multichip(n_devices: int, devices=None, long_t: int = 1024) -> list:
    """Every leg (see the module's note) on an n_devices-rank mesh over
    `devices` (default the visible cards, repeated where fewer); returns
    the legs' reports and raises on any leg whose tokens differ from one
    device's, or (on the card) whose mesh run missed a kernel of
    LEG_KERNELS. `long_t` is the blockwise (data x seq) leg's T."""
    ranks = mesh_devices(n_devices, devices)
    first = ranks[0]
    on_card = first.type == "cuda"
    model_axis = 2 if n_devices % 2 == 0 else 1
    data = n_devices // model_axis
    report: list = []
    graphs = loop_graph.GraphCache() if on_card else None

    def single(host, indices, mask, **options):
        params = params_from_numpy(host, first)
        return lambda: translate_batch(params, indices.to(first), mask.to(first),
                                       graphs=graphs, **options)

    def meshed(host, mesh, indices, mask, replicate=False, **options):
        """The mesh leg's keyword arguments of _leg: its graph and eager
        runs, whether it replays (all but a lockstep loop across cards)
        and its per-device caches' counts."""
        split = shd.replicate_params if replicate else shd.shard_params
        params = params_from_numpy(split(host, mesh))
        caches = loop_graph.DeviceGraphs() if on_card else None
        spans = len(set(mesh.devices)) > 1
        lockstep = decode.mesh_lockstep(params, options.get("provider"),
                                        options.get("kv_dtype", "int16"))
        return dict(
            run_mesh=lambda: translate_batch(params, indices, mask, graphs=caches, **options),
            run_eager=lambda: translate_batch(params, indices, mask, graphs=caches,
                                              _eager=True, **options),
            replay=not (lockstep and spans),
            caches=lambda: caches.counts if caches is not None else None)

    # The toy DP x TP step (every product #1; the blockwise kernel, whose
    # gate takes the toy width).
    toy, toy_config = flagship_params(vocab=512, emb=64, ffn=128, enc=2, dec=2)
    mesh = shd.make_mesh(data=data, model=model_axis, devices=ranks)
    indices, mask = example_batch(ROWS_PER_SHARD * data, 16, vocab=512)
    options = dict(eos_id=0, max_steps=8, num_heads=toy_config.num_heads,
                   provider="xla_int8", flash_attention=True)
    _leg("toy dp x tp", mesh, run_single=single(toy, indices, mask, **options),
         report=report, on_card=on_card, **meshed(toy, mesh, indices, mask, **options))

    # The flagship DP x TP step, exact numerics (the split encoder on #8,
    # the exact argmax by #4's key variant) and the declared serving
    # numerics (the whole layer #2 on the gathered weights, #3 on each
    # rank's heads, packed_int keys from #1).
    flag, config = flagship_params()
    heads = config.num_heads
    indices, mask = example_batch(ROWS_PER_SHARD * data, 16)
    for label, options in (
        ("exact", dict(kv_dtype=None, argmax_method="exact", fused_sdpa=True)),
        ("serving", dict(kv_dtype="int16", argmax_method="packed_int",
                         with_alignment=False, attn_kernel=True, fused_layer=on_card)),
    ):
        options.update(eos_id=0, max_steps=8, num_heads=heads, provider="xla_int8")
        _leg(f"flagship dp x tp, {label}", mesh, run_single=single(flag, indices, mask, **options),
             report=report, on_card=on_card, **meshed(flag, mesh, indices, mask, **options))

    # DP with replicated weights: the whole-layer kernel (and under
    # fused_step the whole decode step) on each data shard.
    dp = shd.make_mesh(data=n_devices, devices=ranks)
    indices, mask = example_batch(ROWS_PER_SHARD * n_devices, 16)
    for label, provider in (("serving", "xla_int8"), ("fused_step", "fused_step")):
        options = dict(eos_id=0, max_steps=8, num_heads=heads, provider=provider,
                       kv_dtype="int16", argmax_method="packed_int", with_alignment=False,
                       attn_kernel=True, fused_layer=on_card)
        _leg(f"dp whole layer, {label}", dp, run_single=single(flag, indices, mask, **options),
             report=report, on_card=on_card,
             **meshed(flag, dp, indices, mask, replicate=True, **options))

    # The two-stage pipeline: encoder on rank 0's device, decode on rank 1's.
    if n_devices >= 2:
        pipe = TwoStagePipeline(flag, heads, ranks[0], ranks[1], provider="xla_int8")
        batches = [example_batch(ROWS_PER_SHARD, 16, seed=s) for s in (1, 2)]
        singles = [single(flag, i, m, eos_id=0, max_steps=8, num_heads=heads,
                          provider="xla_int8", kv_dtype=None, argmax_method="exact",
                          fused_layer=on_card) for i, m in batches]

        def piped(eager=False):
            pipe._eager_loop = eager
            try:
                return pipe.translate_batches(batches, eos_id=0, max_steps=8)
            finally:
                pipe._eager_loop = False

        _leg("pipeline", None, piped, lambda: [run() for run in singles], report, on_card,
             run_eager=lambda: piped(eager=True),
             caches=lambda: None if pipe.decoder.graphs is None
             else {str(pipe.decoder.device): dict(pipe.decoder.graphs.counts)})

    # (data x seq): each seq rank's query rows against K and V gathered
    # along T; #8's query slice at T = 64, #9's at T = 1024.
    if n_devices % 2 == 0:
        sp = shd.make_mesh(data=n_devices // 2, seq=2, devices=ranks)
        for label, t, options in (("fused SDPA", 64, dict(fused_sdpa=True)),
                                  ("blockwise", long_t, dict(flash_attention=True))):
            indices, mask = example_batch(ROWS_PER_SHARD * (n_devices // 2), t)
            options.update(eos_id=0, max_steps=8, num_heads=heads, provider="xla_int8",
                           kv_dtype="int16", argmax_method="packed_int",
                           with_alignment=False, attn_kernel=True)
            _leg(f"dp x sp, {label}", sp, run_single=single(flag, indices, mask, **options),
                 report=report, on_card=on_card,
                 **meshed(flag, sp, indices, mask, replicate=True, shard_sequence=True,
                          **options))
    return report


if __name__ == "__main__":
    import json

    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.tokens.shape))
    for leg in dryrun_multichip(max(2, torch.cuda.device_count())):
        print(json.dumps(leg))
    print("dryrun ok")
