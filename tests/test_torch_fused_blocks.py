"""The port's SSRU and FFN blocks (slimt_tpu_torch/ops/fused_blocks.py)
against slimt_tpu.ops.fused_blocks on the CPU, where the JAX functions
run their Pallas kernels in interpret mode: h, c' and the FFN output
within 1e-5 (max |diff|; the two sides sum LayerNorm in different
orders). M = 130 crosses the JAX kernels' 128-row tile.
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
from slimt_tpu.ops import fused_blocks as jfb  # noqa: E402
from slimt_tpu_torch.io.params import params_from_numpy  # noqa: E402
from slimt_tpu_torch.models import transformer as tfm  # noqa: E402
from slimt_tpu_torch.ops import fused_blocks  # noqa: E402

TOL = 1e-5
CONFIG = ModelConfig(encoder_layers=1, decoder_layers=2, num_heads=4)


@pytest.fixture(scope="module", params=[32, 64], ids=["e32", "e64"])
def weights(request):
    emb = request.param
    host = load_weights(
        load_items(synthetic_model_bytes(
            config=CONFIG, vocab_size=4736, emb_dim=emb, ffn_dim=2 * emb, seed=3,
        )),
        CONFIG,
    )
    return jax.device_put(host), params_from_numpy(host, "cpu"), emb


def _rows(m, e, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, 1, e)) * 2).astype(np.float32)
    c = rng.standard_normal((m, 1, e)).astype(np.float32)
    return x, c


def _max_diff(got, want):
    return float(np.abs(got.numpy() - np.asarray(want)).max())


@pytest.mark.parametrize("m", [1, 5, 130])
def test_ssru_block_matches_jax(weights, m):
    jp, tp, e = weights
    x, c = _rows(m, e, seed=m)
    for layer in range(2):
        want_h, want_c = jfb.ssru_block(
            jnp.asarray(x), jnp.asarray(c), jp["decoder"][layer]["rnn"])
        h, c_t = fused_blocks.ssru_block(
            torch.from_numpy(x), torch.from_numpy(c), tp["decoder"][layer]["rnn"])
        assert tuple(h.shape) == tuple(c_t.shape) == (m, 1, e)
        assert _max_diff(h, want_h) <= TOL
        assert _max_diff(c_t, want_c) <= TOL


@pytest.mark.parametrize("m", [1, 5, 130])
def test_ffn_block_matches_jax(weights, m):
    jp, tp, e = weights
    x, _ = _rows(m, e, seed=m + 1)
    for layer in range(2):
        ffn_j = jp["decoder"][layer]["ffn"]
        want = jfb.ffn_block(jnp.asarray(x), ffn_j, ffn_j["ln"])
        got = fused_blocks.ffn_block(torch.from_numpy(x), tp["decoder"][layer]["ffn"])
        assert tuple(got.shape) == (m, 1, e)
        assert _max_diff(got, want) <= TOL


def test_fused_provider_routes_the_blocks(weights):
    """ssru_forward and _ffn_block under "fused" are the blocks; under
    the declared providers they are the separate affines, within the
    same bound of each other."""
    _, tp, e = weights
    x, c = _rows(7, e, seed=9)
    x, c = torch.from_numpy(x), torch.from_numpy(c)
    layer = tp["decoder"][0]
    h, c_t = tfm.ssru_forward(layer["rnn"], c, x, "fused")
    want_h, want_c = fused_blocks.ssru_block(x, c, layer["rnn"])
    assert torch.equal(h, want_h) and torch.equal(c_t, want_c)
    h2, c2 = tfm.ssru_forward(layer["rnn"], c, x)
    assert float((h2 - h).abs().max()) <= TOL and float((c2 - c_t).abs().max()) <= TOL
    y = tfm._ffn_block(layer, x, "fused")
    assert torch.equal(y, fused_blocks.ffn_block(x, layer["ffn"]))
    assert float((tfm._ffn_block(layer, x) - y).abs().max()) <= TOL


def test_kernel_wrappers_reject_cpu_tensors():
    """No fallback: the kernel entries take CUDA tensors or raise."""
    config = ModelConfig(encoder_layers=1, decoder_layers=1, num_heads=8)
    host = load_weights(load_items(synthetic_model_bytes(
        config=config, vocab_size=64, emb_dim=256, ffn_dim=1536, seed=0)), config)
    layer = params_from_numpy(host, "cpu")["decoder"][0]
    x = torch.zeros((2, 256))
    with pytest.raises(ValueError, match="CUDA"):
        fused_blocks.ssru_kernel(x, x, layer["rnn"])
    with pytest.raises(ValueError, match="CUDA"):
        fused_blocks.ffn_kernel(x, layer["ffn"])
    with pytest.raises(ValueError, match="E=32"):
        fused_blocks.ffn_kernel(torch.zeros((2, 32)), layer["ffn"])
