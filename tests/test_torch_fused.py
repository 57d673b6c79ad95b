"""The port's `fused` provider path against the JAX package on the CPU:
the decoder step on random states against
slimt_tpu.models.transformer.decoder_step(provider="fused",
attn_kernel=True, sample=True) and the decode loop against
translate_batch, in all four argmax methods, with and without
alignment, over the full vocabulary and a shortlist. The Models are in
tests/test_torch_fused_model.py.

Tolerances: choices and tokens equal; new states within 1e-5 (max
|diff|; the two sides sum in different orders); alignments within
1e-5. On the CPU the JAX package's attn_kernel falls through to its XLA
formulation and the port's runs the plain decode attention.
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
from slimt_tpu.models import decode as jdecode  # noqa: E402
from slimt_tpu.models import transformer as jtfm  # noqa: E402
from slimt_tpu_torch.io.params import params_from_numpy  # noqa: E402
from slimt_tpu_torch.models import decode  # noqa: E402
from slimt_tpu_torch.models import transformer as tfm  # noqa: E402

CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
HEADS = 4
EMB = 32
VOCAB = 4736  # three 2048-column JAX tiles, the last one partial
SHORTLIST = np.arange(0, VOCAB, 5, dtype=np.int32)
METHODS = ("packed_int", "exact", "packed_fp16", "packed_bf16")
STATE_TOL = 1e-5
ALIGN_TOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    host = load_weights(
        load_items(synthetic_model_bytes(
            config=CONFIG, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=64, seed=3,
        )),
        CONFIG,
    )
    return jax.device_put(host), params_from_numpy(host, "cpu")


def _step_inputs(b, t=9):
    """x, per-layer states, additive mask (ragged rows; the last row
    fully masked when b > 1) and int16 per-row caches, from a seed."""
    rng = np.random.default_rng(b)
    x = (rng.standard_normal((b, 1, EMB)) * 2).astype(np.float32)
    states = [rng.standard_normal((b, 1, EMB)).astype(np.float32) for _ in range(2)]
    lengths = rng.integers(1, t + 1, size=b)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    if b > 1:
        mask[-1] = 0.0
    mask_add = ((1.0 - mask) * np.float32(-99999999.0))[:, None, None, :]
    caches = [
        {
            "k": rng.integers(-32767, 32768, (b, t, EMB)).astype(np.int16),
            "v": rng.integers(-32767, 32768, (b, t, EMB)).astype(np.int16),
            "kqi": (rng.uniform(0.5, 2.0, (b, t)) / 32767).astype(np.float32),
            "vqi": (rng.uniform(0.5, 2.0, (b, t)) / 32767).astype(np.float32),
        }
        for _ in range(2)
    ]
    return x, states, mask_add.astype(np.float32), caches


@pytest.mark.parametrize("with_shortlist", [False, True], ids=["full", "shortlist"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("b", [3, 33])
def test_fused_decoder_step_matches_jax(weights, b, method, with_shortlist):
    jp, tp = weights
    x, states, mask_add, caches = _step_inputs(b)
    sl = SHORTLIST if with_shortlist else None
    want_choice, want_states, _ = jtfm.decoder_step(
        jp, tuple(jnp.asarray(s) for s in states), jnp.asarray(x),
        jnp.asarray(mask_add),
        tuple({k: jnp.asarray(v) for k, v in kv.items()} for kv in caches),
        HEADS, provider="fused", shortlist=None if sl is None else jnp.asarray(sl),
        sample=True, argmax_method=method, attn_kernel=True,
    )
    choice, new_states, attn = tfm.decoder_step(
        tp, tuple(torch.from_numpy(s) for s in states), torch.from_numpy(x),
        torch.from_numpy(mask_add),
        tuple({k: torch.from_numpy(v) for k, v in kv.items()} for kv in caches),
        HEADS, shortlist=None if sl is None else torch.from_numpy(sl),
        provider="fused", argmax_method=method, attn_kernel=True,
    )
    assert choice.dtype == torch.int32
    np.testing.assert_array_equal(choice.numpy(), np.asarray(want_choice))
    for got, want in zip(new_states, want_states):
        assert tuple(got.shape) == (b, 1, EMB)
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= STATE_TOL
    assert tuple(attn.shape) == (b, HEADS, 1, 9) and not attn.any()


def _batch(seed, b=5, t=9):
    rng = np.random.default_rng(seed)
    indices = rng.integers(3, VOCAB, size=(b, t)).astype(np.int32)
    lengths = rng.integers(3, t + 1, size=b)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    indices[mask == 0] = 0
    return indices, mask


@pytest.mark.parametrize("with_alignment", [False, True], ids=["plain", "aligned"])
@pytest.mark.parametrize("with_shortlist", [False, True], ids=["full", "shortlist"])
@pytest.mark.parametrize("method", METHODS)
def test_translate_batch_fused_matches_jax(weights, method, with_shortlist, with_alignment):
    jp, tp = weights
    indices, mask = _batch(seed=METHODS.index(method) + 4 * with_shortlist)
    sl = SHORTLIST if with_shortlist else None
    want = jdecode.translate_batch(
        jp, jnp.asarray(indices), jnp.asarray(mask), eos_id=2, max_steps=12,
        num_heads=HEADS, provider="fused", kv_dtype="int16",
        shortlist=None if sl is None else jnp.asarray(sl),
        with_alignment=with_alignment, argmax_method=method, attn_kernel=True,
    )
    got = decode.translate_batch(
        tp, torch.from_numpy(indices), torch.from_numpy(mask), eos_id=2,
        max_steps=12, num_heads=HEADS, provider="fused",
        shortlist=None if sl is None else torch.from_numpy(sl),
        with_alignment=with_alignment, argmax_method=method, attn_kernel=True,
    )
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.any()
    assert tuple(got.alignment.shape) == tuple(want.alignment.shape)
    if with_alignment:
        np.testing.assert_allclose(
            got.alignment.numpy(), np.asarray(want.alignment), atol=ALIGN_TOL, rtol=0)


def test_fused_needs_the_int16_cache(weights):
    """The `fused` provider once needed the int16 cache; over the int8
    cache it now gives the JAX package's tokens."""
    jp, tp = weights
    indices, mask = _batch(seed=7, b=2)
    args = dict(eos_id=2, max_steps=4, num_heads=HEADS, provider="fused",
                kv_dtype="int8")
    got = decode.translate_batch(tp, torch.from_numpy(indices), torch.from_numpy(mask), **args)
    want = jdecode.translate_batch(jp, jnp.asarray(indices), jnp.asarray(mask), **args)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
