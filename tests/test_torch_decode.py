"""The port's greedy decode (slimt_tpu_torch/models/decode.py) against
slimt_tpu.models.decode.translate_batch on the declared numerics
(kv_dtype="int16", argmax_method="packed_int"): tokens and valid equal,
with and without shortlist, alignment and steps_cap, for any
`check_every`; the compact transport matches the JAX buffer.
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
from slimt_tpu_torch.io.params import params_from_numpy  # noqa: E402
from slimt_tpu_torch.models import decode  # noqa: E402

HEADS = 4
VOCAB = 300
EOS = 0


@pytest.fixture(scope="module")
def weights():
    config = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=HEADS)
    host = load_weights(
        load_items(
            synthetic_model_bytes(
                config=config, vocab_size=VOCAB, emb_dim=32, ffn_dim=64,
                seed=2,
            )
        ),
        config,
    )
    return jax.device_put(host), params_from_numpy(host, "cpu")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    b, t = 4, 16
    ids = rng.integers(1, VOCAB, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[1, 9:] = 0
    mask[3, :] = 0  # a padding row: starts complete
    ids[mask == 0] = 0
    return ids, mask


def _shortlist(seed=1):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(np.arange(1, VOCAB), 127, replace=False))
    return np.concatenate([[EOS], ids]).astype(np.int32)


def _both(weights, shortlist, with_alignment, steps_cap, check_every=8,
          position_zero=True, eos=EOS, rows=slice(None)):
    jp, tp = weights
    ids, mask = (a[rows] for a in _batch())
    kwargs = dict(eos_id=eos, max_steps=20, num_heads=HEADS,
                  decoder_position_zero=position_zero)
    want = jdecode.translate_batch(
        jp, jnp.asarray(ids), jnp.asarray(mask), **kwargs,
        shortlist=None if shortlist is None else jnp.asarray(shortlist),
        kv_dtype="int16", argmax_method="packed_int",
        with_alignment=with_alignment,
        steps_cap=None if steps_cap is None else jnp.int32(steps_cap),
    )
    got = decode.translate_batch(
        tp, torch.from_numpy(ids), torch.from_numpy(mask), **kwargs,
        shortlist=None if shortlist is None else torch.from_numpy(shortlist),
        with_alignment=with_alignment, steps_cap=steps_cap,
        check_every=check_every,
    )
    return want, got


# This model emits 107 at step 0 of row 1 and, under the shortlist, 148
# from step 11 of row 1: as EOS ids they end that row early.
@pytest.mark.parametrize(
    "with_shortlist,with_alignment,steps_cap,eos",
    [(False, False, None, 107), (True, False, None, 148),
     (False, True, 11, EOS), (True, True, 7, 148), (True, True, 16, 148)],
)
def test_translate_batch_matches_jax(
    weights, with_shortlist, with_alignment, steps_cap, eos
):
    shortlist = _shortlist() if with_shortlist else None
    want, got = _both(weights, shortlist, with_alignment, steps_cap, eos=eos)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert not got.valid[3].any()  # the padding row records nothing
    if eos != EOS and (steps_cap or 20) > 12:  # EOS recorded, then complete
        steps = int(got.valid[1].sum())
        assert steps < 20 and int(got.tokens[1, steps - 1]) == eos
    assert tuple(got.alignment.shape) == tuple(want.alignment.shape)
    if with_alignment:
        np.testing.assert_allclose(
            got.alignment.numpy(), np.asarray(want.alignment), atol=1e-5,
            rtol=0,
        )
    if steps_cap is not None:
        assert not got.valid[:, steps_cap:].any()


@pytest.mark.parametrize("check_every", [1, 3, 8])
def test_tokens_do_not_depend_on_check_every(weights, check_every):
    # Row 1 ends at step 11 (EOS 148); rows 0, 2 and 3 end at step 0
    # (EOS 225 or padding), so the loop exits early.
    for kwargs in (dict(eos=148), dict(eos=225, rows=[0, 2, 3])):
        want, got = _both(weights, _shortlist(), False, None, check_every,
                          **kwargs)
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        assert got.valid.sum() < got.valid.numel() - got.valid.shape[1]


def test_per_position_signal_matches_jax(weights):
    """decoder_position_zero=False: marian's per-step signal."""
    want, got = _both(weights, None, False, None, position_zero=False)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


@pytest.mark.parametrize("steps", [5, 16, 20])
def test_compact_result_matches_jax(steps):
    rng = np.random.default_rng(steps)
    tokens = rng.integers(0, 32000, (3, steps)).astype(np.int32)
    valid = rng.random((3, steps)) < 0.7
    align = np.zeros((3, steps, 0), np.float32)
    want = jdecode.compact_result(
        jdecode.GreedyResult(jnp.asarray(tokens), jnp.asarray(valid), align)
    )
    got = decode.compact_result(
        decode.GreedyResult(
            torch.from_numpy(tokens), torch.from_numpy(valid),
            torch.from_numpy(align),
        )
    )
    np.testing.assert_array_equal(
        got.packed.numpy().view(np.uint16), np.asarray(want.packed)
    )
    back_tokens, back_valid = decode.unpack_compact(got.packed, steps)
    np.testing.assert_array_equal(back_tokens, tokens)
    np.testing.assert_array_equal(back_valid, valid)
