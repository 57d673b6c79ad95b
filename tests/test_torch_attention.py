"""The port's split-encoder attention (slimt_tpu_torch/ops/attention.py)
and split encoder (models/transformer.py: attention_forward,
encoder_layer_forward, encoder_forward) against the JAX package on the
CPU, with the JAX Pallas kernels in interpret mode.

Tolerances (max |diff|): fused SDPA 2e-6 (tests/test_fused_sdpa.py:55);
blockwise 2e-5 abs + 1e-5 rel (tests/test_attention.py); encoder_forward
1e-5 at E=256 (test_fused_sdpa.py:80) and 1e-4 at E=32
(test_attention.py:77-79). The two sides sum in different orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slimt_tpu.config import ModelConfig  # noqa: E402
from slimt_tpu.io import load_items  # noqa: E402
from slimt_tpu.io.loader import load_weights  # noqa: E402
from slimt_tpu.io.synthetic import synthetic_model_bytes  # noqa: E402
from slimt_tpu.models import transformer as jtfm  # noqa: E402
from slimt_tpu.ops import attention as jattention  # noqa: E402
from slimt_tpu_torch.io.params import add_dequantized, params_from_numpy  # noqa: E402
from slimt_tpu_torch.models import transformer as tfm  # noqa: E402
from slimt_tpu_torch.ops import attention  # noqa: E402
from slimt_tpu_torch.ops import encoder_layer as enc  # noqa: E402

MASK_MIN = np.float32(-99999999.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _mask_add(mask):
    return ((1.0 - mask) * MASK_MIN)[:, None, None, :].astype(np.float32)


@pytest.mark.parametrize(
    "b,t,heads", [(1, 16, 8), (3, 16, 8), (4, 48, 4), (8, 128, 8), (33, 16, 8)]
)
def test_fused_sdpa_matches_jax(b, t, heads):
    e = 256
    rng = np.random.default_rng(b * 1000 + t)
    q, k, v = (rng.standard_normal((b, t, e)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, t), np.float32)
    mask[-1, t // 2:] = 0  # a padded tail
    if b > 2:
        mask[1] = 0  # a padding row
    mask_add = _mask_add(mask)
    want = jattention.fused_sdpa_joined(*map(jnp.asarray, (q, k, v, mask_add)), heads)
    got = attention.fused_sdpa_joined(_t(q), _t(k), _t(v), _t(mask_add), heads)
    assert tuple(got.shape) == (b, t, e)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)


@pytest.mark.parametrize("pad", [0, 5, 17])
@pytest.mark.parametrize("t", [96, 200, 300])
def test_blockwise_matches_jax(t, pad):
    """T=200: one ragged 128-row query block; T=300: three, the last
    ragged. Row 1 of the batch is padded by 3 more: the mask of a row
    serves all its heads."""
    b, h, d = 2, 2, 32
    rng = np.random.default_rng(t + pad)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, t), np.float32)
    mask[:, t - pad:] = 0
    mask[1, t - pad - 3:] = 0
    mask_add = _mask_add(mask)
    want = jattention.blockwise_attention(*map(jnp.asarray, (q, k, v, mask_add)))
    got = attention.blockwise_attention(_t(q), _t(k), _t(v), _t(mask_add))
    assert tuple(got.shape) == (b, h, t, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


def test_blockwise_fully_masked_row_is_finite():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 2, 40, 16)).astype(np.float32) for _ in range(3))
    mask = np.ones((2, 40), np.float32)
    mask[1] = 0
    got = attention.blockwise_attention(_t(q), _t(k), _t(v), _t(_mask_add(mask)))
    want = jattention.blockwise_attention(
        *map(jnp.asarray, (q, k, v, _mask_add(mask))))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


def test_plain_versions_are_the_encoder_sdpa():
    """The plain versions are the whole-layer kernel's plain SDPA (joined)
    and the split path's SDPA (heads), not copies of them."""
    rng = np.random.default_rng(3)
    q, k, v = (_t(rng.standard_normal((2, 4, 24, 8)).astype(np.float32))
               for _ in range(3))
    mask = _t(np.zeros((2, 1, 1, 24), np.float32))
    assert torch.equal(attention.blockwise_plain(q, k, v, mask),
                       enc.sdpa_heads(q, k, v, mask)[0])
    joined = [a.transpose(1, 2).reshape(2, 24, 32) for a in (q, k, v)]
    assert torch.equal(attention.fused_sdpa_joined(*joined, mask, 4),
                       enc.sdpa_plain(*joined, mask, 4))


def test_kernel_wrappers_reject_cpu_and_bad_shapes():
    """No fallback: the kernel entries take CUDA tensors or raise."""
    x = torch.zeros((2, 16, 256))
    mask = torch.zeros((2, 1, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        attention.fused_sdpa_kernel(x, x, x, mask, 8)
    with pytest.raises(ValueError, match="T=512"):
        big = torch.zeros((1, 512, 256))
        attention.fused_sdpa_kernel(big, big, big, torch.zeros((1, 1, 1, 512)), 4)
    h = torch.zeros((2, 8, 16, 32))
    with pytest.raises(ValueError, match="CUDA"):
        attention.blockwise_kernel(h, h, h, mask)
    odd = torch.zeros((2, 8, 16, 24))
    with pytest.raises(ValueError, match="head dim"):
        attention.blockwise_kernel(odd, odd, odd, mask)


@pytest.fixture(scope="module")
def weights():
    """E=256 (the fused gates' width) and E=32 params, 2 encoder layers."""
    out = {}
    for emb, ffn, heads in ((256, 512, 8), (32, 64, 4)):
        config = ModelConfig(encoder_layers=2, decoder_layers=1, num_heads=heads)
        host = load_weights(load_items(synthetic_model_bytes(
            config=config, vocab_size=300, emb_dim=emb, ffn_dim=ffn, seed=emb)),
            config)
        out[emb] = (host, params_from_numpy(host, "cpu"), heads)
    return out


def _encoder_inputs(params_j, params_t, b, t, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 300, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[0, t // 2:] = 0
    mask[-1, 3:] = 0
    jx = jtfm.transform_embedding(jtfm.embed(params_j, jnp.asarray(ids)))
    tx = tfm.transform_embedding(tfm.embed(params_t, _t(ids)))
    return jx, tx, mask


# Every gate combination at T=16, E=256: the whole-layer kernel, the
# fused SDPA, the blockwise attention, and fused SDPA with flash (the
# fused SDPA wins at T <= 256). flash turns the whole-layer kernel off.
GATES = [
    dict(fused_layer=True), dict(fused_layer=False), dict(fused_sdpa=True),
    dict(flash=True), dict(fused_sdpa=True, flash=True),
    dict(fused_layer=True, flash=True), dict(fused_layer=True, fused_sdpa=True),
]


# The provider reaches the split layer's FFN (the FFN-block kernel under
# "fused") and the whole-layer gate: "fused" with the gates that run the
# split layer, and with the layer kernel.
CASES = [(gates, "xla_int8") for gates in GATES] + [
    (gates, "fused") for gates in GATES[:5]]


@pytest.mark.parametrize(
    "gates,provider", CASES,
    ids=["+".join(f"{k}={v}" for k, v in g.items()) + "-" + p for g, p in CASES])
def test_encoder_forward_gates_match_jax(weights, gates, provider):
    host, tp, heads = weights[256]
    jx, tx, mask = _encoder_inputs(host, tp, 3, 16, seed=len(gates))
    want = jtfm.encoder_forward(
        host, jx, jtfm.make_additive_mask(jnp.asarray(mask)), heads, provider, **gates)
    got = tfm.encoder_forward(
        tp, tx, tfm.make_additive_mask(_t(mask)), heads, provider, **gates)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
def test_encoder_forward_long_matches_jax(weights, flash):
    """E=32, T=272: past the wrap regime the split layer runs; flash takes
    the blockwise attention."""
    host, tp, heads = weights[32]
    jx, tx, mask = _encoder_inputs(host, tp, 2, 272, seed=9)
    want = jtfm.encoder_forward(
        host, jx, jtfm.make_additive_mask(jnp.asarray(mask)), heads, "xla_int8",
        flash=flash, fused_sdpa=True, fused_layer=True)
    got = tfm.encoder_forward(
        tp, tx, tfm.make_additive_mask(_t(mask)), heads, "xla_int8",
        flash=flash, fused_sdpa=True, fused_layer=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_gates_pick_the_kernels_of_the_jax_package(weights, monkeypatch):
    """Which function each gate reaches, in the JAX order of precedence:
    the whole-layer kernel, then the fused SDPA, then blockwise."""
    _, tp, heads = weights[256]
    calls = []
    for module, name in ((enc, "encoder_layer_fused"),
                         (attention, "fused_sdpa_joined"),
                         (attention, "blockwise_attention")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    x = torch.randn((2, 16, 256))
    mask = torch.zeros((2, 1, 1, 16))
    layer = tp["encoder"][0]
    cases = [
        (dict(fused_layer=True, fused_sdpa=True), "encoder_layer_fused"),
        (dict(fused_layer=True, provider=None), "encoder_layer_fused"),
        (dict(fused_sdpa=True, flash=True), "fused_sdpa_joined"),
        (dict(fused_layer=True, flash=True), "blockwise_attention"),
        (dict(fused_layer=True, provider="f32"), None),
        (dict(), None),
    ]
    for kwargs, want in cases:
        calls.clear()
        if kwargs.get("provider") == "f32":  # its dequantized weights
            add_dequantized(tp)
        tfm.encoder_layer_forward(layer, x, mask, heads, **kwargs)
        assert calls == ([want] if want else []), kwargs
    calls.clear()
    x272 = torch.randn((1, 272, 256))
    tfm.encoder_layer_forward(layer, x272, torch.zeros((1, 1, 1, 272)), heads,
                              fused_layer=True, fused_sdpa=True)
    assert calls == []
