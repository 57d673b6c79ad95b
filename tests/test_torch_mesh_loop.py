"""The port's multi-device decode loops (slimt_tpu_torch/models/decode.py:
run_loops over data shards, the fixed-buffer lockstep MeshLoop) against the
JAX package's translate_batch on the CPU, at tests/test_torch_sharding.py's
small widths: tokens and valid bit-equal on [cpu] * n meshes for
run_loops over the data shards ((8,1,1) and (4,1,1) replicated, and one
process's shard of a two-process mesh), the lockstep loop ((4,2,1) and (2,4,1) tensor
parallel, int8 KV over (2,1,4) data x seq), each at loop_unroll 1, 3 and 8
and under a steps_cap no k divides; a data shard that finishes early
changes no other shard's tokens and is advanced no further; the
pipeline's decoder (its graph cache None on the CPU) equals greedy_decode;
and the per-device graph caches keep their own counts and bounds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slimt_tpu.config import ModelConfig  # noqa: E402
from slimt_tpu.io import load_items  # noqa: E402
from slimt_tpu.io.loader import load_weights  # noqa: E402
from slimt_tpu.io.synthetic import synthetic_model_bytes  # noqa: E402
from slimt_tpu.models.decode import translate_batch as jax_translate  # noqa: E402
from slimt_tpu_torch.io.params import params_from_numpy  # noqa: E402
from slimt_tpu_torch.models import decode, loop_graph  # noqa: E402
from slimt_tpu_torch.models import transformer as tfm  # noqa: E402
from slimt_tpu_torch.parallel import sharding as shd  # noqa: E402
from slimt_tpu_torch.parallel.collectives import Local  # noqa: E402
from slimt_tpu_torch.parallel.pipeline import TwoStagePipeline  # noqa: E402

CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
VOCAB, EMB, FFN = 128, 32, 64
CPU8 = ["cpu"] * 8
B, T, MAX_STEPS = 8, 12, 10
UNROLLS = (1, 3, 8)
BASE = dict(max_steps=MAX_STEPS, num_heads=CONFIG.num_heads, provider="xla_int8",
            kv_dtype=None, argmax_method="exact")


@pytest.fixture(scope="module")
def host():
    return load_weights(load_items(synthetic_model_bytes(
        config=CONFIG, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=FFN, seed=9)), CONFIG)


def _batch(padded_rows=()):
    """tests/test_torch_sharding.py's batch at B=8, T=12; `padded_rows`
    fully masked (complete from the start)."""
    rng = np.random.default_rng(2)
    indices = rng.integers(3, VOCAB, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    mask[B // 2:, -3:] = 0.0
    mask[list(padded_rows)] = 0.0
    return indices, mask


@pytest.fixture(scope="module")
def jax_run(host):
    """JAX translate_batch on one device, memoized by its options. The
    eos is a word row 0 emits at step 1, so that rows finish early."""
    memo = {}

    def run(padded_rows=(), **options):
        key = (tuple(padded_rows), tuple(sorted(options.items())))
        if key not in memo:
            indices, mask = _batch(padded_rows)
            memo[key] = jax_translate(host, jnp.asarray(indices), jnp.asarray(mask),
                                      eos_id=eos(), **{**BASE, **options})
        return memo[key]

    def eos():
        if "eos" not in memo:
            indices, mask = _batch()
            first = jax_translate(host, jnp.asarray(indices), jnp.asarray(mask), eos_id=1,
                                  **BASE)
            memo["eos"] = int(np.asarray(first.tokens)[0, 1])
        return memo["eos"]

    run.eos = eos
    return run


def _sharded(host, layout, kind, devices=CPU8):
    mesh = shd.make_mesh(*layout, devices=devices)
    split = shd.shard_params if kind == "tp" else shd.replicate_params
    return params_from_numpy(split(host, mesh))


def _port(sharded, eos, padded_rows=(), rows=slice(None), **options):
    indices, mask = _batch(padded_rows)
    return decode.translate_batch(sharded, torch.from_numpy(indices[rows]),
                                  torch.from_numpy(mask[rows]), eos_id=eos,
                                  **{**BASE, **options})


def _equal(got, want, rows=slice(None)):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid)[rows])
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens)[rows])


def _equal_outside(got, want, rows):
    """`got` equals `want` on every row but `rows`."""
    others = np.array([r for r in range(B) if r not in rows])
    _equal(decode.GreedyResult(*(t[torch.from_numpy(others)] for t in got)), want, others)


def test_rows_finish_early(jax_run):
    """The eos picked by jax_run ends some rows before the limit, and not
    all: the loops' early exits and masks are exercised."""
    lengths = np.asarray(jax_run().valid).sum(1)
    assert lengths.min() < MAX_STEPS and lengths.max() == MAX_STEPS


@pytest.mark.parametrize("unroll", UNROLLS)
@pytest.mark.parametrize("layout", [(8, 1, 1), (4, 1, 1)], ids=["dp8", "dp4"])
def test_data_shards_run_loops_matches_jax(host, jax_run, layout, unroll):
    sharded = _sharded(host, layout, "replicate")
    assert not decode.mesh_lockstep(sharded, "xla_int8", None)
    chunks = decode.run_loop.chunks
    got = _port(sharded, jax_run.eos(), loop_unroll=unroll)
    _equal(got, jax_run())
    # Each data shard ran its own loop: at least one chunk each.
    assert decode.run_loop.chunks - chunks >= layout[0]


@pytest.mark.parametrize("unroll", UNROLLS)
@pytest.mark.parametrize("process", [0, 1])
def test_one_process_shard_matches_jax(host, jax_run, process, unroll):
    """A multi-process Model's local mesh: one data shard, this process's
    block of the rows (process `process` of two)."""
    grid = np.empty((1, 1, 1), dtype=object)
    grid[0, 0, 0] = torch.device("cpu")
    mesh = shd.Mesh(grid, process_index=process, process_count=2)
    sharded = params_from_numpy(shd.replicate_params(host, mesh))
    rows = slice(process * B // 2, (process + 1) * B // 2)
    got = _port(sharded, jax_run.eos(), rows=rows, loop_unroll=unroll)
    _equal(got, jax_run(), rows)


LOCKSTEP = {
    "tp-4x2": ((4, 2, 1), "tp", {}),
    "tp-2x4": ((2, 4, 1), "tp", {}),
    "int8-dp-sp": ((2, 1, 4), "replicate", {"kv_dtype": "int8", "shard_sequence": True}),
}


@pytest.mark.parametrize("unroll", UNROLLS)
@pytest.mark.parametrize("name", list(LOCKSTEP))
def test_lockstep_loop_matches_jax(host, jax_run, name, unroll):
    layout, kind, options = LOCKSTEP[name]
    sharded = _sharded(host, layout, kind)
    jax_options = {k: v for k, v in options.items() if k != "shard_sequence"}
    assert decode.mesh_lockstep(sharded, "xla_int8", options.get("kv_dtype"))
    got = _port(sharded, jax_run.eos(), loop_unroll=unroll, **options)
    _equal(got, jax_run(**jax_options))


@pytest.mark.parametrize("layout,kind", [((4, 1, 1), "replicate"), ((4, 2, 1), "tp")],
                         ids=["data-shards", "lockstep"])
def test_steps_cap_no_k_divides(host, jax_run, layout, kind):
    """steps_cap 7 at k = 3: the last chunk's steps past the cap are masked."""
    sharded = _sharded(host, layout, kind)
    got = _port(sharded, jax_run.eos(), loop_unroll=3, steps_cap=7)
    want = jax_run(steps_cap=7)
    _equal(got, want)
    assert np.asarray(want.valid)[:, 7:].sum() == 0


def _alone(host, eos, rows, unroll):
    """The chunks the one-device loop runs for `rows` of the batch alone."""
    indices, mask = _batch()
    params = params_from_numpy(host, "cpu")
    chunks = decode.run_loop.chunks
    decode.translate_batch(params, torch.from_numpy(indices[rows]),
                           torch.from_numpy(mask[rows]), eos_id=eos, loop_unroll=unroll,
                           check_every=unroll, **BASE)
    return decode.run_loop.chunks - chunks


@pytest.mark.parametrize("unroll", [1, 3])
def test_a_shard_done_early_is_advanced_no_further(host, jax_run, unroll):
    """(4,1,1) with data shard 2's rows all padding: that shard stops at
    its first flag read (one chunk, the flag read every chunk), the others
    run the chunks their rows need alone, and their tokens are those of
    the batch without the padding (no shard changes another's)."""
    eos = jax_run.eos()
    sharded = _sharded(host, (4, 1, 1), "replicate")
    chunks = decode.run_loop.chunks
    got = _port(sharded, eos, padded_rows=(4, 5), loop_unroll=unroll, check_every=unroll)
    ran = decode.run_loop.chunks - chunks
    want = sum(_alone(host, eos, slice(2 * d, 2 * d + 2), unroll) for d in (0, 1, 3)) + 1
    assert ran == want
    _equal(got, jax_run(padded_rows=(4, 5)))
    _equal_outside(got, jax_run(), (4, 5))
    assert not got.valid[4:6].any()


def test_lockstep_shard_done_early_changes_no_other(host, jax_run):
    """The lockstep loop on (4,2,1) with data shard 2 all padding: the
    other shards' tokens equal those of the batch without the padding."""
    sharded = _sharded(host, (4, 2, 1), "tp")
    got = _port(sharded, jax_run.eos(), padded_rows=(4, 5), loop_unroll=3)
    _equal(got, jax_run(padded_rows=(4, 5)))
    _equal_outside(got, jax_run(), (4, 5))


def test_lockstep_buffers_are_written_in_place(host, jax_run):
    """MeshLoop's state and outputs are fixed buffers: a chunk writes them
    in place (the tensors a capture would fix), never rebinds them."""
    sharded = _sharded(host, (2, 2, 1), "tp", devices=["cpu"] * 4)
    indices, mask = _batch()
    shards = []
    for d in range(2):
        ranks = tfm.ModelRanks([sharded.at(d, m) for m in range(2)],
                               Local, sharded.vocab_size)
        rows = slice(4 * d, 4 * d + 4)
        whole = sharded.gathered(d)
        x = tfm.transform_embedding(tfm.embed(whole, torch.from_numpy(indices[rows])))
        mask_add = tfm.make_additive_mask(torch.from_numpy(mask[rows]))
        out = tfm.encoder_forward(whole, x, mask_add, CONFIG.num_heads)
        caches = tfm.tp_cross_kv([[sharded.at(d, m)] for m in range(2)], [[out]] * 2,
                                 CONFIG.num_heads, None, Local, [False, False])
        shards.append(decode.MeshShard(ranks, caches, [mask_add] * 2, None, [False, False]))
    loop = decode.MeshLoop(shards, **decode.greedy_args(
        jax_run.eos(), CONFIG.num_heads, MAX_STEPS, 3, "xla_int8", "exact", False, True,
        True))
    loop.reset(MAX_STEPS)

    def pointers():
        return [t.data_ptr() for s in loop.shards
                for t in (*s.prev, *s.states, s.complete, s.tokens, s.valid, s.align)] + [
            t.data_ptr() for t in (*loop.step_at.values(), loop.done)]

    before = pointers()
    with torch.inference_mode():
        loop.run_chunk()
    assert pointers() == before
    assert [int(s) for s in loop.step_at.values()] == [3]
    assert loop.shards[0].valid[:, :3].any() and not loop.shards[0].valid[:, 3:].any()


def test_pipeline_decoder_equals_greedy_decode(host):
    """On the CPU the pipeline's decoder has no graph cache (the loop runs
    eagerly there) and each batch's result equals greedy_decode on the
    same encoder output."""
    pipe = TwoStagePipeline(host, CONFIG.num_heads, "cpu", "cpu", provider="xla_int8")
    assert pipe.decoder.graphs is None and pipe.encoder.graphs is None
    params = params_from_numpy(host, "cpu")
    batches = [tuple(torch.from_numpy(a[rows]) for a in _batch())
               for rows in (slice(0, 4), slice(4, 8))]
    got = pipe.translate_batches(batches, eos_id=2, max_steps=MAX_STEPS)
    for (indices, mask), result in zip(batches, got):
        mask_add = tfm.make_additive_mask(mask)
        out = tfm.encoder_forward(params, tfm.transform_embedding(tfm.embed(params, indices)),
                                  mask_add, CONFIG.num_heads, "xla_int8")
        want = decode.greedy_decode(params, out, mask_add, 2, MAX_STEPS, CONFIG.num_heads,
                                    provider="xla_int8", kv_dtype=None,
                                    argmax_method="exact")
        assert torch.equal(result.tokens, want.tokens)
        assert torch.equal(result.valid, want.valid)


class _State:
    def run_chunk(self):
        pass


def test_device_graphs_keep_a_cache_and_a_bound_per_device():
    """One GraphCache per rank, made at its first lookup, each with its own
    LRU bound and counts (misses = shards at the first batch of a bucket,
    hits = shards at the second); no rank evicts another's buckets."""
    graphs = loop_graph.DeviceGraphs(capacity=2)
    cpu = torch.device("cpu")
    for _ in range(2):
        for rank in range(4):
            graphs.on(rank, cpu).bucket(("bucket",), _State, cpu)
    assert graphs.counts == {f"rank {r} (cpu)": {"hits": 1, "misses": 1, "evictions": 0}
                             for r in range(4)}
    for key in ("a", "b", "c"):
        graphs.on(0, cpu).bucket((key,), _State, cpu)
    assert graphs.counts["rank 0 (cpu)"]["evictions"] == 2
    assert graphs.counts["rank 1 (cpu)"]["evictions"] == 0
    assert graphs.on(0, cpu) is graphs.on(0, cpu) and len(graphs.on(0, cpu)) == 2


def test_mesh_on_the_card_needs_device_graphs():
    """A mesh decode on CUDA replays from a DeviceGraphs and refuses a
    single GraphCache (the check comes before any device work, so a mesh
    naming cuda:0 is enough on the CPU)."""
    sharded = shd.ShardedParams(shd.make_mesh(devices=["cuda:0"]), [], {}, "replicate")
    for graphs in (None, loop_graph.GraphCache()):
        with pytest.raises(ValueError, match="DeviceGraphs"):
            decode.translate_batch(sharded, None, None, 1, MAX_STEPS, CONFIG.num_heads,
                                   graphs=graphs)
