"""Every cross-attention cache of the port (slimt_tpu_torch/models/
transformer.py and decode.py) against the JAX package on the CPU:
precompute_cross_kv for each cache dtype, each branch of the joined decode
attention, the exact split decode attention, the int8 branch past 2^24,
translate_batch for each dtype under the declared and `fused` providers
(and `fused_step` on its float caches), and the Models and both lanes of
the service with kv_cache_dtype "float32" and "bfloat16".

Tolerances: quantized caches and the bfloat16/float16 casts bit-equal,
their scales within 1 ulp (both divide in float32); attention outputs
within 1e-5 and weights within 1e-6 (max |diff|; the two sides sum in
different orders); tokens and valid masks equal; alignments within 1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from slimt_tpu.config import Config, ModelConfig  # noqa: E402
from slimt_tpu.io import load_items  # noqa: E402
from slimt_tpu.io.loader import load_weights  # noqa: E402
from slimt_tpu.io.synthetic import synthetic_model_bytes  # noqa: E402
from slimt_tpu.models import decode as jdecode  # noqa: E402
from slimt_tpu.models import transformer as jtfm  # noqa: E402
from slimt_tpu.models.model import Model as JaxModel  # noqa: E402
from slimt_tpu.runtime.service import Blocking  # noqa: E402
from slimt_tpu_torch import Model, Package  # noqa: E402
from slimt_tpu_torch.io.params import params_from_numpy  # noqa: E402
from slimt_tpu_torch.models import decode  # noqa: E402
from slimt_tpu_torch.models import transformer as tfm  # noqa: E402
from tests.helpers import TINY_TEST_CONFIG, make_package  # noqa: E402

HEADS = 4
VOCAB, EMB, FFN = 1000, 32, 64
SHORTLIST = np.arange(0, VOCAB, 3, dtype=np.int32)
JOINED = ("int8", "k8v16", "k16v8", "int16", "bfloat16", "float16", "float32")
OUT_TOL = 1e-5
ATTN_TOL = 1e-6
ALIGN_TOL = 1e-5
SEGMENTS = [[5, 9, 4, 0], [7, 2, 0], [3, 8, 6, 2, 11, 12, 0], [4, 0]]
LINES = ["hello world", "the quick brown fox", "a b c", "dog"]


@pytest.fixture(scope="module")
def weights():
    config = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=HEADS)
    host = load_weights(load_items(synthetic_model_bytes(
        config=config, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=FFN, seed=5)), config)
    return jax.device_put(host), params_from_numpy(host, "cpu")


def _jax_dtype(name):
    """The JAX function's `dtype` argument for a cache name."""
    if name is None or name in ("k8v16", "k16v8"):
        return name
    return jnp.dtype(name)


def _bits(a) -> np.ndarray:
    """A JAX array or torch tensor as numpy, 2-byte floats as their bits."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.element_size() == 2 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def _to_torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor of the same type and bits."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _encoder_out(b=3, t=12, seed=0):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((b, t, EMB)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[1, 7:] = 0
    mask_add = ((1.0 - mask) * np.float32(-99999999.0))[:, None, None, :]
    return enc, mask_add.astype(np.float32)


@pytest.mark.parametrize("dtype", (None,) + JOINED)
def test_precompute_cross_kv_matches_jax(weights, dtype):
    jp, tp = weights
    enc, _ = _encoder_out()
    want = jtfm.precompute_cross_kv(jp, jnp.asarray(enc), HEADS, None, _jax_dtype(dtype))
    got = tfm.precompute_cross_kv(tp, torch.from_numpy(enc), HEADS, dtype)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        if dtype is None:
            for gt, wt in zip(g, w):
                assert tuple(gt.shape) == (3, HEADS, 12, EMB // HEADS)
                np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
            continue
        for name in ("k", "v"):
            assert str(g[name].dtype).replace("torch.", "") == str(w[name].dtype)
            np.testing.assert_array_equal(_bits(g[name]), _bits(w[name]))
        for name in ("kqi", "vqi"):
            assert tuple(g[name].shape) == tuple(np.shape(w[name]))
            np.testing.assert_array_max_ulp(
                g[name].numpy(), np.asarray(w[name], np.float32), maxulp=1)


def test_precompute_cross_kv_rejects_unknown_dtype(weights):
    _, tp = weights
    with pytest.raises(ValueError, match="kv cache dtype"):
        tfm.precompute_cross_kv(tp, torch.zeros((1, 4, EMB)), HEADS, "int4")


def _attention_inputs(jp, dtype, seed):
    """q [B, 1, E], the JAX cache of `dtype` for layer 0, and the mask."""
    enc, mask_add = _encoder_out(seed=seed)
    rng = np.random.default_rng(seed + 1)
    yq = (rng.standard_normal((3, 1, EMB)) * 2).astype(np.float32)
    kv = jtfm.precompute_cross_kv(jp, jnp.asarray(enc), HEADS, None, _jax_dtype(dtype))[0]
    return yq, kv, mask_add


@pytest.mark.parametrize("dtype", JOINED)
def test_decode_attention_branch_matches_jax(weights, dtype):
    jp, _ = weights
    yq, kv, mask_add = _attention_inputs(jp, dtype, seed=JOINED.index(dtype))
    want_out, want_attn = jtfm._decode_attention_joined(
        jnp.asarray(yq), kv, jnp.asarray(mask_add), HEADS)
    cache = {name: _to_torch(value) for name, value in kv.items()}
    out, attn = tfm._decode_attention_joined(
        torch.from_numpy(yq), cache, torch.from_numpy(mask_add), HEADS)
    assert tuple(out.shape) == (3, 1, EMB) and tuple(attn.shape) == (3, HEADS, 1, 12)
    assert float(np.abs(out.numpy() - np.asarray(want_out)).max()) <= OUT_TOL
    assert float(np.abs(attn.numpy() - np.asarray(want_attn)).max()) <= ATTN_TOL


@pytest.mark.parametrize("dtype", [None, "bfloat16", "int8"])
def test_attention_forward_takes_split_and_joined_caches(weights, dtype):
    """The cross-attention block over the exact (K, V) split pair (the
    plain SDPA's f32 branch at T_q = 1) and over joined dicts."""
    jp, tp = weights
    enc, mask_add = _encoder_out(seed=7)
    rng = np.random.default_rng(8)
    q_in = rng.standard_normal((3, 1, EMB)).astype(np.float32)
    kv = jtfm.precompute_cross_kv(jp, jnp.asarray(enc), HEADS, None, _jax_dtype(dtype))[0]
    att = jp["decoder"][0]["att"]
    want, want_attn = jtfm.attention_forward(
        att, jnp.asarray(q_in), jnp.asarray(q_in), jnp.asarray(q_in),
        jnp.asarray(mask_add), HEADS, kv_cache=kv)
    cache = (tuple(_to_torch(a) for a in kv) if dtype is None
             else {name: _to_torch(value) for name, value in kv.items()})
    got, attn = tfm.attention_forward(
        tp["decoder"][0]["att"], torch.from_numpy(q_in), torch.from_numpy(mask_add),
        HEADS, kv_cache=cache)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= OUT_TOL
    assert float(np.abs(attn.numpy() - np.asarray(want_attn)).max()) <= ATTN_TOL


def test_int8_mix_exact_past_2_24():
    """At T = 1200 a uniform attention re-quantizes to 127 on every key,
    and attn . V reaches 127 * 1200 * ~119 > 2^24: the port's mix equals
    the int64 sum rounded once to float32, then divided by the per-(b, h)
    scale, as the TPU's int32 accumulation gives it."""
    b, t, e = 2, 1200, EMB
    rng = np.random.default_rng(11)
    v = rng.integers(110, 128, (b, t, e)).astype(np.int8)
    v[1, :, ::2] *= -1
    kv = {"k": torch.zeros((b, t, e), dtype=torch.int8), "v": torch.from_numpy(v),
          "kqi": torch.full((b, t), 0.01), "vqi": torch.full((b, t), 0.02)}
    yq = torch.from_numpy(rng.standard_normal((b, 1, e)).astype(np.float32))
    out, attn = tfm._decode_attention_joined(yq, kv, torch.zeros((b, 1, 1, t)), HEADS)
    attn_v = attn[:, :, 0, :].numpy() * np.float32(0.02)  # [B, H, T]
    s_a = np.float32(127.0) / np.maximum(attn_v.max(-1, keepdims=True), np.float32(1e-9))
    attn_q = np.rint(attn_v * s_a).astype(np.int64)
    assert (attn_q == 127).all()
    d = e // HEADS
    vh = v.astype(np.int64).reshape(b, t, HEADS, d)
    acc = np.einsum("bht,bthd->bhd", attn_q, vh)
    assert np.abs(acc).max() > 2 ** 24
    want = (acc.astype(np.float32) / s_a).reshape(b, 1, e)
    np.testing.assert_array_equal(out.numpy(), want)


def _batch(seed, b=5, t=9):
    rng = np.random.default_rng(seed)
    indices = rng.integers(3, VOCAB, size=(b, t)).astype(np.int32)
    lengths = rng.integers(3, t + 1, size=b)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    indices[mask == 0] = 0
    return indices, mask


def _both(weights, provider, kv_dtype, with_shortlist, with_alignment, seed):
    jp, tp = weights
    indices, mask = _batch(seed)
    sl = SHORTLIST if with_shortlist else None
    common = dict(eos_id=2, max_steps=12, num_heads=HEADS, provider=provider,
                  kv_dtype=kv_dtype, with_alignment=with_alignment)
    want = jdecode.translate_batch(
        jp, jnp.asarray(indices), jnp.asarray(mask),
        shortlist=None if sl is None else jnp.asarray(sl), **common)
    got = decode.translate_batch(
        tp, torch.from_numpy(indices), torch.from_numpy(mask),
        shortlist=None if sl is None else torch.from_numpy(sl), **common)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.any()
    assert tuple(got.alignment.shape) == tuple(want.alignment.shape)
    if with_alignment:
        np.testing.assert_allclose(
            got.alignment.numpy(), np.asarray(want.alignment), atol=ALIGN_TOL, rtol=0)


@pytest.mark.parametrize("with_alignment", [False, True], ids=["plain", "aligned"])
@pytest.mark.parametrize("with_shortlist", [False, True], ids=["full", "shortlist"])
@pytest.mark.parametrize("provider", [None, "xla_int8", "fused"])
@pytest.mark.parametrize("kv_dtype", JOINED)
def test_translate_batch_matches_jax(weights, kv_dtype, provider, with_shortlist,
                                     with_alignment):
    _both(weights, provider, kv_dtype, with_shortlist, with_alignment,
          seed=JOINED.index(kv_dtype) + 2 * with_shortlist + with_alignment)


@pytest.mark.parametrize("with_alignment", [False, True], ids=["plain", "aligned"])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float32"])
def test_translate_batch_fused_step_float_caches_match_jax(weights, kv_dtype, with_alignment):
    """The whole step's float branch (the JAX kernel in interpret mode)."""
    _both(weights, "fused_step", kv_dtype, True, with_alignment,
          seed=20 + with_alignment)


def test_float32_means_the_exact_split_cache():
    assert decode.cache_dtype(None, "float32") is None
    assert decode.cache_dtype("fused", "float32") is None
    assert decode.cache_dtype("fused_step", "float32") == "float32"
    assert decode.cache_dtype("fused_step", None) == "int16"
    assert decode.cache_dtype("fused_step", "k16v8") == "int16"
    assert decode.cache_dtype("xla_int8", "k16v8") == "k16v8"


@pytest.fixture(scope="module", params=[
    ("float32", None), ("bfloat16", None), ("bfloat16", "fused_step")],
    ids=["float32", "bfloat16", "bfloat16-fused_step"])
def kv_models(request):
    kv, provider = request.param
    config = dataclasses.replace(TINY_TEST_CONFIG, kv_cache_dtype=kv)
    if provider:
        config = dataclasses.replace(config, qmm_provider=provider)
    pkg = make_package(config=config, with_shortlist=True)
    port_pkg = Package(pkg.model, pkg.vocabulary, pkg.shortlist, pkg.ssplit)
    return JaxModel(config, pkg), Model(config, port_pkg, device="cpu")


def test_model_kv_cache_matches_jax(kv_models):
    jax_model, port = kv_models
    for need_alignment in (False, True):
        want = jax_model.forward(SEGMENTS, need_alignment)
        got = port.forward(SEGMENTS, need_alignment)
        assert [h.target for h in got] == [h.target for h in want]
        for g, w in zip(got, want):
            assert len(g.alignment) == len(w.alignment)
            if w.alignment:
                np.testing.assert_allclose(
                    np.asarray(g.alignment), np.asarray(w.alignment),
                    atol=ALIGN_TOL, rtol=0)
    indices = np.zeros((4, 16), np.int32)
    mask = np.zeros((4, 16), np.float32)
    for i, seg in enumerate(SEGMENTS):
        indices[i, :len(seg)] = seg
        mask[i, :len(seg)] = 1.0
    words = np.concatenate([np.asarray(s) for s in SEGMENTS])
    args = (indices, mask, np.array([len(s) for s in SEGMENTS]), len(SEGMENTS))
    got = port.forward_async_arrays(*args, shortlist_words=words, raw=True)()
    want = jax_model.forward_async_arrays(*args, shortlist_words=words, raw=True)()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("prefer_bulk", [False, True], ids=["request", "bulk"])
def test_blocking_kv_cache_matches_jax(kv_models, prefer_bulk):
    jax_model, port = kv_models
    with Blocking(Config(prefer_bulk=prefer_bulk)) as service:
        want = service.translate(jax_model, LINES)
        got = service.translate(port, LINES)
    assert [r.target.text for r in got] == [r.target.text for r in want]
