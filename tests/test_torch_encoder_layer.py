"""The port's whole encoder layer (slimt_tpu_torch/ops/encoder_layer.py)
against the JAX package: the Pallas kernel in interpret mode and the
XLA encoder layer, with a padded row. Bound: 2e-5, the bound
tests/test_encoder_layer_pallas.py holds the TPU kernel to (f32
summation order only; the int8 affines are bit-exact).
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
from slimt_tpu.ops.encoder_layer_pallas import encoder_layer_fused  # noqa: E402
from slimt_tpu_torch.io.params import params_from_numpy  # noqa: E402
from slimt_tpu_torch.ops import encoder_layer as enc  # noqa: E402


def _layer(emb, ffn, seed):
    config = ModelConfig(encoder_layers=1, decoder_layers=1)
    host = load_weights(
        load_items(
            synthetic_model_bytes(
                config=config, vocab_size=64, emb_dim=emb, ffn_dim=ffn,
                seed=seed,
            )
        ),
        config,
    )
    return host, params_from_numpy(host, "cpu")


def _inputs(b, t, e, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, e)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[-1, t // 2:] = 0
    if b > 2:
        mask[0, :] = 0  # a padding row: fully masked
    return x, mask


@pytest.mark.parametrize(
    "b,t,emb,ffn,heads",
    [(3, 16, 128, 256, 8), (2, 32, 256, 512, 8), (1, 8, 32, 64, 4)],
)
def test_plain_layer_matches_jax(b, t, emb, ffn, heads):
    host, params = _layer(emb, ffn, seed=b + t)
    x, mask = _inputs(b, t, emb, seed=t)
    mask_add = jtfm.make_additive_mask(jnp.asarray(mask))
    ref = np.asarray(
        jtfm.encoder_layer_forward(
            host["encoder"][0], jnp.asarray(x), mask_add, heads
        )
    )
    got = enc.encoder_layer_fused(
        torch.from_numpy(x), params["encoder"][0],
        torch.from_numpy(np.array(mask_add)), heads,
    ).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    if emb % 128 == 0:  # the Pallas kernel's lane tiling
        pallas = np.asarray(
            encoder_layer_fused(
                jnp.asarray(x), host["encoder"][0], mask_add, heads,
                interpret=True,
            )
        )
        np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=0)


def test_sdpa_fully_masked_row_is_finite():
    rng = np.random.default_rng(0)
    q, k, v = (
        torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
        for _ in range(3)
    )
    mask = torch.zeros((2, 1, 1, 8))
    mask[1] = -99999999.0
    out = enc.sdpa_plain(q, k, v, mask, 4)
    assert torch.isfinite(out).all()


def test_gate_rejects_long_t():
    _, params = _layer(32, 64, seed=0)
    x = torch.zeros((1, enc.MAX_T + 16, 32))
    with pytest.raises(ValueError, match="T <= 256"):
        enc.encoder_layer_fused(
            x, params["encoder"][0], torch.zeros((1, 1, 1, x.shape[1])), 4
        )

