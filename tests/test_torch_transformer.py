"""The port's transformer pieces (slimt_tpu_torch/models/transformer.py)
against slimt_tpu/models/transformer.py on the declared numerics: int16
per-row cross-attention caches, the SSRU decoder step and the
packed_int argmax. Weights come from synthetic_model_bytes, carried
over by params_from_numpy; inputs from numpy with a seed.
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
from slimt_tpu.models import transformer as jtfm  # noqa: E402
from slimt_tpu_torch.io.params import params_from_numpy  # noqa: E402
from slimt_tpu_torch.models import transformer as tfm  # noqa: E402
from slimt_tpu_torch.ops import logits_argmax  # noqa: E402

HEADS = 4
VOCAB, EMB, FFN = 500, 64, 128


@pytest.fixture(scope="module")
def weights():
    config = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=HEADS)
    host = load_weights(
        load_items(
            synthetic_model_bytes(
                config=config, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=FFN,
                seed=4,
            )
        ),
        config,
    )
    return jax.device_put(host), params_from_numpy(host, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _encoder_out(b=3, t=12, seed=0):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((b, t, EMB)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[1, 7:] = 0
    return enc, mask


def test_embedding_signal_and_mask(weights):
    jp, tp = weights
    ids = np.random.default_rng(1).integers(0, VOCAB, (2, 9)).astype(np.int32)
    want = np.asarray(jtfm.transform_embedding(jtfm.embed(jp, jnp.asarray(ids))))
    got = tfm.transform_embedding(tfm.embed(tp, _t(ids))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        tfm.sinusoidal_signal(0, 1, EMB).numpy(),
        np.asarray(jtfm.sinusoidal_signal(0, 1, EMB)),
    )
    mask = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
    np.testing.assert_array_equal(
        tfm.make_additive_mask(_t(mask)).numpy(),
        np.asarray(jtfm.make_additive_mask(jnp.asarray(mask))),
    )


def test_encoder_forward_matches_jax(weights):
    jp, tp = weights
    rng = np.random.default_rng(2)
    ids = rng.integers(3, VOCAB, (3, 16)).astype(np.int32)
    mask = np.ones((3, 16), np.float32)
    mask[2, 5:] = 0
    jx = jtfm.transform_embedding(jtfm.embed(jp, jnp.asarray(ids)))
    want = np.asarray(
        jtfm.encoder_forward(
            jp, jx, jtfm.make_additive_mask(jnp.asarray(mask)), HEADS
        )
    )
    tx = tfm.transform_embedding(tfm.embed(tp, _t(ids)))
    got = tfm.encoder_forward(
        tp, tx, tfm.make_additive_mask(_t(mask)), HEADS
    ).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_int16_cross_kv_equal(weights):
    jp, tp = weights
    enc, _ = _encoder_out()
    want = jtfm.precompute_cross_kv(
        jp, jnp.asarray(enc), HEADS, dtype=jnp.int16
    )
    got = tfm.precompute_cross_kv(tp, _t(enc), HEADS)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["k"].dtype == torch.int16
        for key in ("k", "v", "kqi", "vqi"):
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))


def test_decode_attention_within_1e5(weights):
    jp, tp = weights
    enc, mask = _encoder_out(seed=3)
    jkv = jtfm.precompute_cross_kv(jp, jnp.asarray(enc), HEADS, dtype=jnp.int16)
    tkv = tfm.precompute_cross_kv(tp, _t(enc), HEADS)
    x = np.random.default_rng(4).standard_normal((3, 1, EMB)).astype(np.float32)
    jmask = jtfm.make_additive_mask(jnp.asarray(mask))
    att = jp["decoder"][0]["att"]
    want_out, want_attn = jtfm.attention_forward(
        att, jnp.asarray(x), None, None, jmask, HEADS, kv_cache=jkv[0]
    )
    got_out, got_attn = tfm.attention_forward(
        tp["decoder"][0]["att"], _t(x), _t(jmask), HEADS, tkv[0]
    )
    assert tuple(got_attn.shape) == (3, HEADS, 1, 12)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn), atol=1e-5, rtol=0)


def test_ssru_and_decoder_step_match(weights):
    jp, tp = weights
    enc, mask = _encoder_out(seed=5)
    jkv = jtfm.precompute_cross_kv(jp, jnp.asarray(enc), HEADS, dtype=jnp.int16)
    tkv = tfm.precompute_cross_kv(tp, _t(enc), HEADS)
    jmask = jtfm.make_additive_mask(jnp.asarray(mask))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 1, EMB)).astype(np.float32)
    state = rng.standard_normal((3, 1, EMB)).astype(np.float32)

    rnn_j, rnn_t = jp["decoder"][0]["rnn"], tp["decoder"][0]["rnn"]
    wh, wc = jtfm.ssru_forward(rnn_j, jnp.asarray(state), jnp.asarray(x))
    gh, gc = tfm.ssru_forward(rnn_t, _t(state), _t(x))
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-5, rtol=0)

    shortlist = np.sort(rng.choice(VOCAB, 96, replace=False)).astype(np.int32)
    for sl in (None, shortlist):
        states = tuple(np.zeros((3, 1, EMB), np.float32) for _ in range(2))
        jshort = None if sl is None else jnp.asarray(sl)
        tshort = None if sl is None else _t(sl)
        for _ in range(3):  # chained steps: states feed forward
            wchoice, wstates, wattn = jtfm.decoder_step(
                jp, tuple(jnp.asarray(s) for s in states), jnp.asarray(x),
                jmask, jkv, HEADS, shortlist=jshort, sample=True,
                argmax_method="packed_int",
            )
            gchoice, gstates, gattn = tfm.decoder_step(
                tp, tuple(_t(s) for s in states), _t(x), _t(jmask), tkv,
                HEADS, shortlist=tshort,
            )
            np.testing.assert_array_equal(gchoice.numpy(), np.asarray(wchoice))
            for g, w in zip(gstates, wstates):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
            np.testing.assert_allclose(gattn.numpy(), np.asarray(wattn), atol=1e-5, rtol=0)
            states = tuple(np.asarray(w) for w in wstates)


@pytest.mark.parametrize("width", [7, 1024, 32000])
def test_packed_int_argmax_equal(width):
    rng = np.random.default_rng(width)
    acc = rng.integers(-5_000_000, 5_000_000, (4, width)).astype(np.int32)
    acc[0, 3 % width] = acc[0].max()  # a tie: the first index wins
    b = rng.integers(-1000, 1000, width).astype(np.int32)
    width_bits, shift = logits_argmax.packed_int_params(width, 256)
    assert (width_bits, shift) == jtfm.packed_int_params(width, 256)
    want = np.asarray(
        jtfm.packed_int_argmax(jnp.asarray(acc), jnp.asarray(b), width_bits, shift)
    )
    got = logits_argmax.packed_int_argmax(_t(acc), _t(b), width_bits, shift)
    np.testing.assert_array_equal(got.numpy(), want)
