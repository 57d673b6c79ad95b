"""The port's mesh (slimt_tpu_torch/parallel/sharding.py) against the JAX
package's on the CPU: every rank's shard of every leaf equals the JAX
shard on the conftest mesh's device (tensor-parallel and replicated, with
the replication fallback), and the port's meshed translate_batch over
[cpu] * n gives the JAX package's tokens and valid at every layout of
tests/test_sharding.py (DP x TP, SP, int8 KV under DP x SP), the flagship
tiny11 DP x TP in both numerics sets, and `fused` and `fused_step` under
TP; then the pieces whose exactness the mesh rests on: the query-slice
plain attention (its rows equal the full call's bit for bit) and the
vocab-sharded keys (equal to the unsharded choice, a tie across the
shard boundary included).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from slimt_tpu.config import ModelConfig  # noqa: E402
from slimt_tpu.io import load_items  # noqa: E402
from slimt_tpu.io.loader import load_weights  # noqa: E402
from slimt_tpu.io.synthetic import synthetic_model_bytes  # noqa: E402
from slimt_tpu.models.decode import translate_batch as jax_translate  # noqa: E402
from slimt_tpu.parallel import sharding as jshd  # noqa: E402
from slimt_tpu_torch.io.params import params_from_numpy  # noqa: E402
from slimt_tpu_torch.models import decode  # noqa: E402
from slimt_tpu_torch.models import transformer as tfm  # noqa: E402
from slimt_tpu_torch.ops import attention  # noqa: E402
from slimt_tpu_torch.ops import encoder_layer as enc  # noqa: E402
from slimt_tpu_torch.ops import logits_argmax as lam  # noqa: E402
from slimt_tpu_torch.parallel import sharding as shd  # noqa: E402
from slimt_tpu_torch.parallel.collectives import Local  # noqa: E402

CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
VOCAB, EMB, FFN = 128, 32, 64
CPU8 = ["cpu"] * 8


def _host(vocab=VOCAB, seed=9):
    return load_weights(load_items(synthetic_model_bytes(
        config=CONFIG, vocab_size=vocab, emb_dim=EMB, ffn_dim=FFN, seed=seed)), CONFIG)


@pytest.fixture(scope="module")
def params():
    return _host()


def _batch(b, t, seed=2):
    """tests/test_sharding.py's batch."""
    rng = np.random.default_rng(seed)
    indices = rng.integers(3, VOCAB, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[b // 2:, -3:] = 0.0
    return indices, mask


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, path + (key,))
    elif isinstance(tree, list):
        for i, value in enumerate(tree):
            yield from _leaves(value, path + (i,))
    else:
        yield path, tree


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def test_mesh_shape_and_error_text():
    assert shd.make_mesh(data=4, model=2, devices=CPU8).shape == {
        "data": 4, "model": 2, "seq": 1}
    assert shd.make_mesh(data=2, seq=4, devices=CPU8).shape == {
        "data": 2, "model": 1, "seq": 4}
    for make in (shd.make_mesh, jshd.make_mesh):
        with pytest.raises(ValueError, match=r"mesh 4x4x1 needs 16 devices, have 8"):
            make(data=4, model=4, devices=CPU8 if make is shd.make_mesh else None)


def test_spec_tree_matches_jax(params):
    port = shd.weight_pspecs(params)
    want = jshd.weight_pspecs(params)
    for path, spec in _leaves(port):
        assert tuple(spec) == tuple(_at(want, path)), path


@pytest.mark.parametrize("vocab", [VOCAB, 127], ids=["vocab-split", "vocab-replicated"])
@pytest.mark.parametrize("kind", ["tp", "replicate"])
@pytest.mark.parametrize("layout", [(4, 2, 1), (2, 4, 1), (2, 1, 4)])
def test_shards_equal_jax_shards(layout, kind, vocab):
    """Each rank's shard of each leaf equals the JAX shard on the device at
    the same mesh position (an odd vocabulary: emb.q and out.b replicated,
    as JAX's _divisible falls back)."""
    host = _host(vocab)
    jmesh = jshd.make_mesh(*layout)
    pmesh = shd.make_mesh(*layout, devices=CPU8)
    jax_split = jshd.shard_params if kind == "tp" else jshd.replicate_params
    port_split = shd.shard_params if kind == "tp" else shd.replicate_params
    jax_tree, port = jax_split(host, jmesh), port_split(host, pmesh)
    devices = list(jmesh.devices.flat)
    replicated = set()
    for path, arr in _leaves(jax_tree):
        by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for rank, device in enumerate(devices):
            np.testing.assert_array_equal(
                np.asarray(_at(port[rank], path)), by_device[device], err_msg=str(path))
        if "model" not in _at(port.specs, path):
            replicated.add(path)
    if kind == "tp" and vocab == 127 and layout[1] > 1:
        assert {("emb", "q"), ("out", "b")} <= replicated


def _translate(params, indices, mask, sharded=None, shard_sequence=False, **options):
    """JAX translate_batch on one device, and the port's on `sharded`, both
    with the JAX defaults unless `options` say otherwise."""
    options = {"kv_dtype": None, "argmax_method": "exact", **options}
    kwargs = dict(eos_id=1, max_steps=6, num_heads=CONFIG.num_heads,
                  provider=options.pop("provider", "xla_int8"))
    want = jax_translate(params, jnp.asarray(indices), jnp.asarray(mask), **kwargs, **options)
    got = decode.translate_batch(sharded, torch.from_numpy(indices), torch.from_numpy(mask),
                                 shard_sequence=shard_sequence, **kwargs, **options)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    return got, want


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4)])
def test_sharded_translate_matches_jax(params, data, model):
    mesh = shd.make_mesh(data=data, model=model, devices=CPU8)
    indices, mask = _batch(b=8, t=12)
    got, want = _translate(params, indices, mask, params_from_numpy(shd.shard_params(params, mesh)))
    np.testing.assert_allclose(got.alignment.numpy(), np.asarray(want.alignment), atol=1e-5)


@pytest.mark.parametrize("data,seq,kv", [(1, 8, None), (2, 4, None), (2, 4, "int8")])
def test_sequence_sharded_translate_matches_jax(params, data, seq, kv):
    mesh = shd.make_mesh(data=data, seq=seq, devices=CPU8)
    indices, mask = _batch(b=4, t=16)
    _translate(params, indices, mask, params_from_numpy(shd.replicate_params(params, mesh)),
               shard_sequence=True, kv_dtype=kv)


@pytest.mark.parametrize("provider", ["fused", "fused_step"])
def test_whole_row_providers_under_tp_match_jax(params, provider):
    """The whole-row kernels' providers on a (4, 2) TP mesh: on the
    gathered params, once per data shard."""
    mesh = shd.make_mesh(data=4, model=2, devices=CPU8)
    sharded = params_from_numpy(shd.shard_params(params, mesh))
    indices, mask = _batch(b=8, t=12)
    _translate(params, indices, mask, sharded, provider=provider, kv_dtype="int16",
               with_alignment=False)
    assert sharded._gathered  # the decode ran on the gathered params


@pytest.fixture(scope="module")
def flagship():
    config = ModelConfig(encoder_layers=6, decoder_layers=2, num_heads=8)
    host = load_weights(load_items(synthetic_model_bytes(
        config=config, vocab_size=32000, emb_dim=256, ffn_dim=1536, seed=3)), config)
    mesh = shd.make_mesh(data=4, model=2, devices=CPU8)
    return host, params_from_numpy(shd.shard_params(host, mesh))


@pytest.mark.parametrize("options", [
    {},
    {"kv_dtype": "float16", "argmax_method": "packed_bf16", "with_alignment": False},
], ids=["exact", "serving"])
def test_flagship_dp_tp_matches_jax(flagship, options):
    """tests/test_sharding.py's flagship tiny11 shapes under (4, 2): the
    vocab-sharded embedding, projection and argmax at 32k columns."""
    host, sharded = flagship
    rng = np.random.default_rng(4)
    indices = rng.integers(3, 32000, (8, 16)).astype(np.int32)
    mask = np.ones((8, 16), np.float32)
    mask[4:, -3:] = 0.0
    jax_options = dict(options)
    want = jax_translate(host, jnp.asarray(indices), jnp.asarray(mask), eos_id=1, max_steps=6,
                         num_heads=8, provider="xla_int8", **jax_options)
    got = decode.translate_batch(sharded, torch.from_numpy(indices), torch.from_numpy(mask),
                                 eos_id=1, max_steps=6, num_heads=8, provider="xla_int8",
                                 **{"kv_dtype": None, "argmax_method": "exact", **options})
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_tensor_parallel_needs_divisible_heads(params):
    mesh = shd.make_mesh(data=1, model=8, devices=CPU8)
    sharded = params_from_numpy(shd.shard_params(params, mesh))
    indices, mask = _batch(b=8, t=12)
    with pytest.raises(ValueError, match="heads"):
        decode.translate_batch(sharded, torch.from_numpy(indices), torch.from_numpy(mask),
                               eos_id=1, max_steps=6, num_heads=4)


@pytest.mark.parametrize("seq", [2, 4, 8])
@pytest.mark.parametrize("form", ["joined", "split"])
def test_query_slice_plain_rows_equal_full_rows(seq, form):
    """The plain versions of #8's and #9's query slice: each rank's rows,
    as a slice of q and at an offset into it, bit for bit the full call's."""
    gen = torch.Generator().manual_seed(seq)
    b, t, e, heads = 3, 16, 32, 4
    mask = torch.zeros((b, 1, 1, t))
    mask[0, ..., 11:] = tfm.MASK_MIN
    n = t // seq
    if form == "joined":
        q, k, v = (torch.randn((b, t, e), generator=gen) for _ in range(3))
        full = enc.sdpa_plain(q, k, v, mask, heads)
        for s in range(seq):
            rows = slice(s * n, (s + 1) * n)
            assert torch.equal(attention.fused_sdpa_joined(q[:, rows], k, v, mask, heads, 0, n),
                               full[:, rows])
            assert torch.equal(attention.fused_sdpa_joined(q, k, v, mask, heads, s * n, n),
                               full[:, rows])
    else:
        q, k, v = (torch.randn((b, heads, t, e // heads), generator=gen) for _ in range(3))
        full = attention.blockwise_plain(q, k, v, mask)
        for s in range(seq):
            rows = slice(s * n, (s + 1) * n)
            assert torch.equal(attention.blockwise_attention(q[:, :, rows], k, v, mask, 0, n),
                               full[:, :, rows])
            assert torch.equal(attention.blockwise_attention(q, k, v, mask, s * n, n),
                               full[:, :, rows])


def test_query_slice_checks_its_rows():
    q = torch.zeros((1, 8, 16))
    with pytest.raises(ValueError, match="query slice"):
        attention.fused_sdpa_joined(q, q, q, torch.zeros((1, 1, 1, 8)), 2, 6, 4)


@pytest.mark.parametrize("method", lam.LOGIT_METHODS)
@pytest.mark.parametrize("shards", [2, 4])
def test_vocab_sharded_keys_equal_unsharded_choice(method, shards):
    """#4's key variant over vocab shards (plain version): the max of the
    shards' keys names the unsharded choice; a tie placed across a shard
    boundary goes to the first column, as the unsharded argmax."""
    gen = torch.Generator().manual_seed(shards)
    e, s = 32, 400
    y = torch.randn((6, e), generator=gen)
    w = torch.randint(-127, 128, (e, s), dtype=torch.int8, generator=gen)
    w[:, s // 2] = w[:, s // 2 - 1]  # equal columns across the middle boundary
    b = torch.randn(s, generator=gen)
    b[s // 2] = b[s // 2 - 1]
    y[0] = 0.0  # row 0: every logit its bias, the two tied columns on top
    b[s // 2 - 1] = b[s // 2] = 50.0
    aq, inv = 0.75, 0.003
    want = lam.argmax_affine_plain(y, w, b, aq, inv, method)
    assert int(want[0]) == s // 2 - 1
    keys = []
    for m in range(shards):
        lo, hi = m * s // shards, (m + 1) * s // shards
        choice, key = lam.argmax_keys(y, w[:, lo:hi], b[lo:hi], aq, inv, method, lo)
        assert bool(((choice >= lo) & (choice < hi)).all())
        keys.append(key)
    best = Local.all_reduce_max(keys)[0]
    assert torch.equal(lam.key_column(best, method), want)


def test_tp_output_argmax_packed_int_equals_single(params):
    """packed_int over vocab shards: keys from #1's accumulators with the
    global width's packing, a tie across the boundary included."""
    mesh = shd.make_mesh(data=1, model=4, devices=CPU8[:4])
    sharded = params_from_numpy(shd.shard_params(params, mesh))
    single = params_from_numpy(params, "cpu")
    ranks = tfm.ModelRanks([sharded.at(0, m) for m in range(4)], Local, VOCAB)
    projections, width = tfm.tp_projections(ranks)
    x = torch.randn((5, EMB), generator=torch.Generator().manual_seed(1))
    want = tfm.output_argmax(single, x, "xla_int8", method="packed_int")
    got = tfm.tp_output_argmax(ranks, [x] * 4, projections, width, "xla_int8", "packed_int")
    assert all(torch.equal(g, want) for g in got)


def test_decode_attention_takes_a_ranks_heads():
    """#3's width gate takes E % 128 (a tensor-parallel rank of the tiny11
    width holds 128 columns), and a mesh forces the kernel the whole batch
    would take (the C entry's rule)."""
    from slimt_tpu_torch.ops import decode_attn

    decode_attn.check_shapes(2, 16, 128, 4)
    with pytest.raises(ValueError, match="multiple of 128"):
        decode_attn.check_shapes(2, 16, 192, 4)
    assert decode_attn.kernel_for(200, 8, 128) == "warp"
    assert decode_attn.kernel_for(199, 8, 128) == "block"
    assert decode_attn.kernel_for(256, 8, 129) == "block"
