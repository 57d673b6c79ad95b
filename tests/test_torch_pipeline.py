"""The port's two-stage pipeline (slimt_tpu_torch/parallel/pipeline.py)
against the JAX package's TwoStagePipeline and translate_batch on the CPU:
the same batches give the same tokens and valid, on two stage devices
(both the CPU here; on the card two streams, tests/test_torch_gpu.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from slimt_tpu.config import ModelConfig  # noqa: E402
from slimt_tpu.io import load_items  # noqa: E402
from slimt_tpu.io.loader import load_weights, stack_layers  # noqa: E402
from slimt_tpu.io.synthetic import synthetic_model_bytes  # noqa: E402
from slimt_tpu.parallel.pipeline import TwoStagePipeline as JaxPipeline  # noqa: E402
from slimt_tpu_torch.models.decode import translate_batch  # noqa: E402
from slimt_tpu_torch.io.params import params_from_numpy  # noqa: E402
from slimt_tpu_torch.parallel.pipeline import TwoStagePipeline  # noqa: E402

CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
VOCAB, EMB, FFN = 96, 32, 64


@pytest.fixture(scope="module")
def host():
    return load_weights(load_items(synthetic_model_bytes(
        config=CONFIG, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=FFN, seed=4)), CONFIG)


def _batches(n=3, b=2, t=10, seed=0):
    """tests/test_pipeline_health.py's batches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        indices = rng.integers(1, VOCAB, (b, t)).astype(np.int32)
        out.append((indices, np.ones((b, t), np.float32)))
    return out


def test_two_stage_pipeline_matches_jax(host):
    devices = jax.devices()
    jax_pipe = JaxPipeline(stack_layers(host), CONFIG.num_heads, devices[0], devices[1],
                           provider="xla_int8")
    pipe = TwoStagePipeline(host, CONFIG.num_heads, "cpu", "cpu", provider="xla_int8")
    batches = _batches()
    want = jax_pipe.translate_batches([(jnp.asarray(i), jnp.asarray(m)) for i, m in batches],
                                      eos_id=2, max_steps=8)
    got = pipe.translate_batches([(torch.from_numpy(i), torch.from_numpy(m))
                                  for i, m in batches], eos_id=2, max_steps=8)
    single = params_from_numpy(host, "cpu")
    for (indices, mask), g, w in zip(batches, got, want):
        np.testing.assert_array_equal(g.tokens.numpy(), np.asarray(w.tokens))
        np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))
        one = translate_batch(single, torch.from_numpy(indices), torch.from_numpy(mask),
                              eos_id=2, max_steps=8, num_heads=CONFIG.num_heads,
                              provider="xla_int8", kv_dtype=None, argmax_method="exact")
        assert torch.equal(g.tokens, one.tokens) and torch.equal(g.valid, one.valid)
    assert all(r.tokens.device == pipe.decoder.device for r in got)
