"""The port's continuous batching (slimt_tpu_torch/models/continuous.py)
against slimt_tpu.models.continuous: the five cases of
tests/test_continuous.py, each held to the JAX ContinuousEngine's own
output (token lists equal), on the declared and fused_step providers, at
its sizes (2+2 layers, 4 heads, vocab 96, emb 32, ffn 64); and the
port's own contracts (admit drops padding ids, make_pool's caches, the
refusals).
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from slimt_tpu.config import ModelConfig  # noqa: E402
from slimt_tpu.io import load_items  # noqa: E402
from slimt_tpu.io.loader import load_weights  # noqa: E402
from slimt_tpu.io.synthetic import synthetic_model_bytes  # noqa: E402
from slimt_tpu.models import continuous as jcont  # noqa: E402
from slimt_tpu.models import decode as jdecode  # noqa: E402
from slimt_tpu_torch.io.params import add_dequantized, params_from_numpy  # noqa: E402
from slimt_tpu_torch.models import continuous as cont  # noqa: E402

CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
VOCAB, EMB, FFN = 96, 32, 64
T_SLOT = 24
PROVIDERS = pytest.mark.parametrize("provider", [None, "fused_step"],
                                    ids=["declared", "fused_step"])


@pytest.fixture(scope="module")
def weights():
    host = load_weights(load_items(synthetic_model_bytes(
        config=CONFIG, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=FFN, seed=11)), CONFIG)
    return jax.device_put(host), params_from_numpy(host, "cpu")


def segments_fixture(n=12, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, VOCAB, rng.integers(4, 21)).astype(int).tolist()
            for _ in range(n)]


def _engines(weights, **kwargs):
    jp, tp = weights
    kwargs.setdefault("num_heads", CONFIG.num_heads)
    kwargs.setdefault("t_slot", T_SLOT)
    return jcont.ContinuousEngine(jp, **kwargs), cont.ContinuousEngine(tp, **kwargs)


def _natural_eos(weights, segment):
    """A token the model emits midway through `segment`'s decode (JAX,
    B=1, as tests/test_continuous.py picks it)."""
    jp, _ = weights
    indices = np.zeros((1, T_SLOT), np.int32)
    mask = np.zeros((1, T_SLOT), np.float32)
    indices[0, :len(segment)] = segment
    mask[0, :len(segment)] = 1.0
    res = jdecode.translate_batch(
        jp, jnp.asarray(indices), jnp.asarray(mask), eos_id=1,
        max_steps=int(1.5 * T_SLOT), num_heads=CONFIG.num_heads, kv_dtype="int16",
        steps_cap=jnp.int32(max(1, int(1.5 * len(segment)))), with_alignment=False,
        argmax_method="packed_fp16")
    probe = np.asarray(res.tokens)[0][np.asarray(res.valid)[0]].tolist()
    return probe[len(probe) // 2]


@PROVIDERS
@pytest.mark.parametrize("eos_mode", ["cap", "natural"])
def test_continuous_matches_jax(weights, eos_mode, provider):
    segments = segments_fixture()
    # "cap": an eos id the model never emits, so every row stops at its
    # cap; "natural": a token it does emit, so rows free slots midway.
    eos_id = 1 if eos_mode == "cap" else _natural_eos(weights, segments[0])
    want_engine, engine = _engines(
        weights, eos_id=eos_id, slots=4, chunk=5, admit_bucket=4, provider=provider)
    want = want_engine.translate(segments)
    got = engine.translate(segments)
    assert got == want
    assert engine.stats == want_engine.stats
    assert engine.stats["admitted"] == len(segments)
    assert 0.0 < engine.occupancy() <= 1.0
    if eos_mode == "natural":
        assert any(s and s[-1] == eos_id for s in got)


@PROVIDERS
def test_engine_reuse_and_long_tail_match_jax(weights, provider):
    """A second translate() on the same engine (pool and graph reuse), with
    a length-skewed mix: one long straggler and many short segments."""
    rng = np.random.default_rng(9)
    segments = [rng.integers(3, VOCAB, 20).astype(int).tolist()] + [
        rng.integers(3, VOCAB, 4).astype(int).tolist() for _ in range(9)]
    want_engine, engine = _engines(weights, eos_id=1, slots=3, chunk=4, admit_bucket=2,
                                   provider=provider)
    assert engine.translate(segments) == want_engine.translate(segments)
    seg2 = segments_fixture(n=5, seed=77)
    assert engine.translate(seg2) == want_engine.translate(seg2)


def _admitted(weights, provider, slots=4):
    """A pool of 4 segments in each package, admitted at slots 0-3, then
    one chunk of 7 steps."""
    jp, tp = weights
    segs = segments_fixture(n=4, seed=3)
    indices = np.zeros((4, T_SLOT), np.int32)
    mask = np.zeros((4, T_SLOT), np.float32)
    for i, toks in enumerate(segs):
        indices[i, :len(toks)] = toks
        mask[i, :len(toks)] = 1.0
    rows = np.arange(4, dtype=np.int32)
    kw = dict(chunk=7, eos_id=1, num_heads=CONFIG.num_heads, provider=provider)
    kv, mask_add, cap = jcont.encode_segments(
        jp, jnp.asarray(indices), jnp.asarray(mask), num_heads=CONFIG.num_heads,
        provider=provider)
    pool = jcont.admit(jcont.make_pool(jp, slots=slots, t_slot=T_SLOT), jnp.asarray(rows),
                       kv, mask_add, cap)
    _, want = jcont.chunk_decode(jp, pool, **kw)
    tkv, tmask, tcap = cont.encode_segments(
        tp, torch.from_numpy(indices), torch.from_numpy(mask),
        num_heads=CONFIG.num_heads, provider=provider)
    tpool = cont.admit(cont.make_pool(tp, slots=slots, t_slot=T_SLOT), rows, tkv, tmask, tcap)
    tpool, got = cont.chunk_decode(tp, tpool, **kw)
    return np.asarray(want), got, np.asarray(cap), tcap, tpool


@PROVIDERS
def test_chunk_transport_roundtrip_matches_jax(weights, provider):
    """unpack_chunk inverts chunk_decode's buffer, which is the JAX
    buffer bit for bit."""
    want, got, caps, tcap, _ = _admitted(weights, provider)
    np.testing.assert_array_equal(tcap.numpy(), caps)
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)
    tokens, valid, complete = cont.unpack_chunk(got, 7)
    assert tokens.shape == (4, 7) and valid.shape == (4, 7) and complete.shape == (4,)
    for b in range(4):  # rows with cap < 7 stop early
        assert valid[b].sum() == min(7, caps[b])
    np.testing.assert_array_equal(complete, caps <= 7)
    want_tokens, want_valid, want_complete = jcont.unpack_chunk(want, 7)
    np.testing.assert_array_equal(tokens, want_tokens)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_array_equal(complete, want_complete)


def test_admit_drops_padding_ids_and_resets_rows(weights):
    _, _, _, tcap, pool = _admitted(weights, None, slots=6)
    assert pool.steps_done[:4].tolist() == [min(7, c) for c in tcap.tolist()]
    # Slot 2 readmitted from row 0 of a new batch; ids >= 6 are padding.
    _, tp = weights
    indices = torch.full((3, T_SLOT), 5, dtype=torch.int32)
    mask = torch.zeros((3, T_SLOT))
    mask[:, :6] = 1.0
    kv, mask_add, cap = cont.encode_segments(tp, indices, mask, num_heads=CONFIG.num_heads)
    before = pool.mask_add.clone()
    cont.admit(pool, np.array([2, 6, 9]), kv, mask_add, cap)
    assert pool.steps_done.tolist()[2] == 0 and pool.prev.tolist()[2] == 0
    assert not bool(pool.complete[2]) and int(pool.cap[2]) == 9
    assert torch.equal(pool.kv[0]["k"][2], kv[0]["k"][0])
    assert all(float(s[2].abs().sum()) == 0.0 for s in pool.states)
    assert torch.equal(pool.mask_add[[0, 1, 3, 4, 5]], before[[0, 1, 3, 4, 5]])


@pytest.mark.parametrize("kv_dtype", ["int16", "int8", "float16", "bfloat16", "float32"])
def test_make_pool_takes_the_joined_caches(weights, kv_dtype):
    _, tp = weights
    if kv_dtype == "float32":
        with pytest.raises(ValueError, match="joined KV"):
            cont.make_pool(tp, 3, 8, kv_dtype=kv_dtype)
        return
    pool = cont.make_pool(tp, 3, 8, kv_dtype=kv_dtype)
    assert str(pool.kv[0]["k"].dtype) == f"torch.{kv_dtype}"
    assert tuple(pool.kv[1]["v"].shape) == (3, 8, EMB)
    assert pool.complete.all() and len(pool.states) == CONFIG.decoder_layers


def test_overlength_segment_raises(weights):
    _, tp = weights
    engine = cont.ContinuousEngine(tp, eos_id=1, num_heads=CONFIG.num_heads, slots=2,
                                   chunk=4, t_slot=8, admit_bucket=2)
    with pytest.raises(ValueError, match="exceeds the pool"):
        engine.translate([[5] * 9])


def test_vocab_bound_guard():
    big = ModelConfig(encoder_layers=1, decoder_layers=1)
    host = load_weights(load_items(synthetic_model_bytes(
        config=big, vocab_size=70000, emb_dim=32, ffn_dim=64, seed=1)), big)
    with pytest.raises(ValueError, match="65535"):
        cont.ContinuousEngine(params_from_numpy(host, "cpu"), eos_id=1,
                              num_heads=big.num_heads, slots=2, chunk=2, t_slot=8)


def test_refusals(weights):
    """encoder_dtype and provider "f32", which once raised, give the JAX
    engine's tokens (encoder_dtype against the JAX engine run op by op:
    XLA's fused CPU code skips half-precision roundings the JAX functions
    make); a fused_step pool cache it cannot read and an unknown admission
    order still raise."""
    jp, tp = weights
    kw = dict(eos_id=1, num_heads=CONFIG.num_heads, slots=2, chunk=2, t_slot=8)
    segments = segments_fixture(n=3, seed=21)
    # "f32" multiplies by the dequantized weights, which its params carry.
    dequantized = (jp, add_dequantized(copy.deepcopy(tp)))
    for change, pair in (({"encoder_dtype": "bfloat16"}, weights),
                         ({"provider": "f32"}, dequantized)):
        want_engine, engine = _engines(pair, eos_id=1, slots=2, chunk=2, **change)
        with jax.disable_jit():
            want = want_engine.translate(segments)
        assert engine.translate(segments) == want
    with pytest.raises(ValueError, match="fused_step"):
        cont.ContinuousEngine(tp, provider="fused_step", kv_dtype="int8", **kw)
    with pytest.raises(ValueError, match="admit_order"):
        cont.ContinuousEngine(tp, admit_order="longest", **kw)
