"""The split and long-context encoder through the port's decode and
Model (slimt_tpu_torch/models/decode.py, models/model.py) against the
JAX package on the CPU: tokens and valid equal from translate_batch
with the fused SDPA at T=16, with blockwise attention at T=272, and with
the split encoder at T=272 under the declared, `fused` and `fused_step`
providers; a Model with the fused SDPA; both lanes of the port's own
Blocking on inputs past 256 tokens. The JAX Pallas kernels run in interpret mode.
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
from slimt_tpu.models.model import Model as JaxModel  # noqa: E402
from slimt_tpu.runtime.service import Blocking as JaxBlocking  # noqa: E402
from slimt_tpu.text.synthetic_vocab import DEFAULT_WORDS  # noqa: E402
from slimt_tpu_torch import Blocking, Model, Package  # noqa: E402
from slimt_tpu_torch import Config as PortConfig  # noqa: E402
from slimt_tpu_torch.io.params import params_from_numpy  # noqa: E402
from slimt_tpu_torch.models import decode  # noqa: E402
from tests.helpers import TINY_TEST_CONFIG, make_package  # noqa: E402

VOCAB = 300
CONFIG = ModelConfig(encoder_layers=2, decoder_layers=1)


@pytest.fixture(scope="module")
def weights():
    """E=128 (the smallest width the fused SDPA gate takes; 4 heads) and
    E=32 params, 2 encoder and 1 decoder layers."""
    out = {}
    for emb in (128, 32):
        host = load_weights(load_items(synthetic_model_bytes(
            config=CONFIG, vocab_size=VOCAB, emb_dim=emb, ffn_dim=2 * emb,
            seed=emb)), CONFIG)
        out[emb] = (jax.device_put(host), params_from_numpy(host, "cpu"))
    return out


def _batch(b, t, seed):
    rng = np.random.default_rng(seed)
    indices = rng.integers(3, VOCAB, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[0, t - 7:] = 0
    mask[-1, t // 3:] = 0
    indices[mask == 0] = 0
    return indices, mask


def _both(weights, emb, t, provider, **gates):
    jp, tp = weights[emb]
    indices, mask = _batch(3, t, seed=t + emb)
    kwargs = dict(eos_id=2, max_steps=8, num_heads=4, with_alignment=False)
    want = jdecode.translate_batch(
        jp, jnp.asarray(indices), jnp.asarray(mask), provider=provider,
        kv_dtype="int16", argmax_method="packed_int", **kwargs, **gates)
    got = decode.translate_batch(
        tp, torch.from_numpy(indices), torch.from_numpy(mask), provider=provider,
        **kwargs, **gates)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.any()


def test_translate_batch_fused_sdpa_matches_jax(weights):
    _both(weights, 128, 16, "xla_int8", fused_sdpa=True)


def test_translate_batch_flash_matches_jax(weights):
    _both(weights, 32, 272, "xla_int8", flash_attention=True)


@pytest.mark.parametrize("provider", ["xla_int8", "fused", "fused_step"])
def test_translate_batch_long_split_matches_jax(weights, provider):
    """T=272 on every decode path; the layer-kernel gate is asked for and
    falls to the split encoder past T=256."""
    _both(weights, 32, 272, provider, fused_layer=True)


# The decode of a long input is capped at 0.1 x its length (30 steps
# at T=304) on both sides: the encoder is what these tests are
# about.
CAP = dict(tgt_length_limit_factor=0.1)


def test_model_short_input_fused_sdpa_matches_jax():
    """encoder_sdpa="on" with the layer kernel off at E=128: the fused
    SDPA serves the wrap regime."""
    config = dataclasses.replace(
        TINY_TEST_CONFIG, encoder_layer_kernel="off", encoder_sdpa="on")
    pkg = make_package(config=config, emb_dim=128, ffn_dim=256)
    port = Model(config, Package(pkg.model, pkg.vocabulary), device="cpu")
    segments = [[5, 9, 4, 0], [3, 8, 6, 2, 11, 12, 0]]
    want = JaxModel(config, pkg).forward(segments, need_alignment=False)
    got = port.forward(segments, need_alignment=False)
    assert [h.target for h in got] == [h.target for h in want]


@pytest.mark.parametrize("prefer_bulk", [False, True], ids=["request", "bulk"])
def test_blocking_serves_long_lines(prefer_bulk):
    """The port's own Blocking with a 512-token wrap: lines of some 300
    tokens serve on both lanes with the JAX service's text."""
    pkg = make_package()
    port = Model(TINY_TEST_CONFIG, Package(pkg.model, pkg.vocabulary), device="cpu", **CAP)
    rng = np.random.default_rng(prefer_bulk)
    lines = [" ".join(rng.choice(DEFAULT_WORDS, n)) for n in (300, 12)]
    with JaxBlocking(Config(wrap_length=512, max_words=1024,
                            prefer_bulk=prefer_bulk)) as service:
        want = service.translate(JaxModel(TINY_TEST_CONFIG, pkg, **CAP), lines)
    with Blocking(PortConfig(wrap_length=512, max_words=1024,
                             prefer_bulk=prefer_bulk)) as service:
        got = service.translate(port, lines)
    assert len(port.vocabulary.encode(lines[0])[0]) > 256
    assert [r.target.text for r in got] == [r.target.text for r in want]
